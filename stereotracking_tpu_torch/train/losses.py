"""YOLOX training losses with SimOTA dynamic-k assignment, fixed shapes.

Port of ``stereotracking_tpu/train/losses.py`` (mmdet ``SimOTAAssigner`` +
mmyolo ``YOLOXHead.loss_by_feat``): center-prior candidate gating, cost =
BCE(sqrt(score), onehot) + 3 * (-log IoU) + INF * not-in-center, dynamic
top-k by the summed top-10 IoUs, conflicts resolved by the least cost;
losses = sigmoid-BCE objectness over all priors, sigmoid-BCE classification
against IoU-soft one-hot targets, (1 - IoU^2) box loss (weight 5), and the
optional L1 on the encoded offsets.

Every image has a fixed number of ground-truth slots (padded, with
``gt_valid``), the images are batched along a leading axis where JAX uses
``vmap``, and nothing reads a value on the host: no boolean-mask indexing,
no ``nonzero``, one-hots by comparison with an ``arange``.  The discrete
steps decide as JAX's do: a stable sort for the cost ranks, the first
index for ``argmin`` / ``argmax``, the top-10 IoUs summed largest first.
As in the JAX package, nothing stops the gradient: the IoU-soft class
target carries one into the decoded boxes.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from ..structures.bbox import bbox_iou_matrix

INF_COST = 100000.0
EPS = 1e-7


class SimOTAConfig(NamedTuple):
    center_radius: float = 2.5
    candidate_topk: int = 10
    iou_weight: float = 3.0
    cls_weight: float = 1.0


class YOLOXLossConfig(NamedTuple):
    num_classes: int = 1
    strides: Tuple[int, ...] = (8, 16, 32)
    assigner: SimOTAConfig = SimOTAConfig()
    loss_cls_weight: float = 1.0
    loss_bbox_weight: float = 5.0
    loss_obj_weight: float = 1.0
    loss_l1_weight: float = 1.0
    use_l1: bool = False


def _bce_logits(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Sigmoid binary cross-entropy with soft targets (``torch.maximum``
    splits the gradient at 0 as ``jnp.maximum`` does)."""
    return torch.maximum(logits, logits.new_zeros(())) - logits * targets + \
        torch.log1p(torch.exp(-logits.abs()))


def _bce_probs(p: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    p = p.clamp(EPS, 1.0 - EPS)
    return -(targets * torch.log(p) + (1.0 - targets) * torch.log(1.0 - p))


def _one_hot(idx: torch.Tensor, n: int) -> torch.Tensor:
    """Boolean one-hot over a last axis of ``n`` (indices out of range give
    a zero row, as ``jax.nn.one_hot``)."""
    return idx[..., None] == torch.arange(n, device=idx.device)


def simota_assign(priors: torch.Tensor, decoded: torch.Tensor,
                  pred_scores: torch.Tensor, gt_bboxes: torch.Tensor,
                  gt_labels: torch.Tensor, gt_valid: torch.Tensor,
                  num_classes: int, cfg: SimOTAConfig
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Assign priors to ground truths for a batch of N images.

    Args:
        priors: (P, 4) = (cx, cy, stride, stride).
        decoded: (N, P, 4) decoded xyxy predictions.
        pred_scores: (N, P, C) sigmoid(cls) * sigmoid(obj).
        gt_bboxes: (N, G, 4) xyxy (padded).
        gt_labels: (N, G) integer.
        gt_valid: (N, G) bool.

    Returns:
        fg_mask (N, P) bool, matched_gt (N, P) int64 (valid only where fg),
        matched_iou (N, P), which carries the gradient of ``decoded``.
    """
    px = priors[None, :, 0, None]                                 # (1, P, 1)
    py = priors[None, :, 1, None]
    stride = priors[None, :, 2, None]
    x1, y1, x2, y2 = (gt_bboxes[:, None, :, i] for i in range(4))  # (N,1,G)

    # candidate gating: center inside the gt box, or inside its center region
    in_box = (px > x1) & (px < x2) & (py > y1) & (py < y2)
    gcx = (x1 + x2) / 2.0
    gcy = (y1 + y2) / 2.0
    r = cfg.center_radius
    in_center = (px > gcx - r * stride) & (px < gcx + r * stride) & \
        (py > gcy - r * stride) & (py < gcy + r * stride)
    valid_gt = gt_valid[:, None, :]
    in_any = (in_box | in_center) & valid_gt
    in_both = in_box & in_center & valid_gt
    valid_prior = in_any.any(2)                                   # (N, P)
    valid = valid_prior[:, :, None] & valid_gt                    # (N, P, G)

    ious = torch.where(valid, bbox_iou_matrix(decoded, gt_bboxes), 0.0)
    with torch.no_grad():
        cost_ious = ious.detach()
        iou_cost = -torch.log(cost_ious + EPS)
        onehot = _one_hot(gt_labels, num_classes).float()         # (N, G, C)
        sq = torch.sqrt(pred_scores.detach().clamp(0.0, 1.0))     # (N, P, C)
        cls_cost = _bce_probs(sq[:, :, None, :],
                              onehot[:, None, :, :]).sum(-1)      # (N, P, G)
        cost = cls_cost * cfg.cls_weight + iou_cost * cfg.iou_weight + \
            torch.where(in_both, 0.0, INF_COST)
        cost = torch.where(valid, cost, INF_COST * 2.0)

        # dynamic k per gt: max(int(sum of its top-10 IoUs), 1), summed
        # largest first
        # (the values of a top-k do not depend on its tie order)
        n_top = min(cfg.candidate_topk, ious.shape[1])
        top = cost_ious.topk(n_top, dim=1).values                 # (N, k, G)
        total = top[:, 0]
        for i in range(1, n_top):
            total = total + top[:, i]
        dynamic_k = total.to(torch.int32).clamp(min=1)            # (N, G)

        # rank of each prior per gt by ascending cost (stable); rank < k
        order = cost.sort(dim=1, stable=True).indices             # (N, P, G)
        ranks = torch.empty_like(order).scatter_(
            1, order, torch.arange(cost.shape[1], device=cost.device)[
                None, :, None].expand_as(order))
        matching = (ranks < dynamic_k[:, None, :]) & (cost < INF_COST)

        # conflict resolution: a prior matched to >1 gt keeps its min-cost
        # gt (mmdet zeroes the row, then sets that gt, even if it was not
        # among the row's matches)
        n_match = matching.sum(2)
        keep = _one_hot(cost.argmin(2), cost.shape[2])
        matching = torch.where((n_match > 1)[:, :, None], keep, matching)

        fg = matching.any(2)
        matched_gt = matching.to(torch.uint8).argmax(2)
    matched_iou = ious.gather(2, matched_gt[:, :, None])[:, :, 0]
    return fg, matched_gt, matched_iou


def yolox_loss(cls_logits: torch.Tensor, reg_preds: torch.Tensor,
               obj_logits: torch.Tensor, priors: torch.Tensor,
               decoded: torch.Tensor, gt_bboxes: torch.Tensor,
               gt_labels: torch.Tensor, gt_valid: torch.Tensor,
               cfg: YOLOXLossConfig) -> dict:
    """Batched YOLOX loss.

    Args:
        cls_logits: (N, P, C); reg_preds: (N, P, 4) raw offsets;
        obj_logits: (N, P, 1); priors: (P, 4); decoded: (N, P, 4) xyxy;
        gt_bboxes: (N, G, 4); gt_labels: (N, G); gt_valid: (N, G).

    Returns dict(loss_cls, loss_bbox, loss_obj[, loss_l1], loss, num_pos),
    every value a tensor (no host read).
    """
    scores = torch.sigmoid(cls_logits) * torch.sigmoid(obj_logits)
    fg, matched_gt, matched_iou = simota_assign(
        priors, decoded, scores, gt_bboxes, gt_labels, gt_valid,
        cfg.num_classes, cfg.assigner)

    num_pos = fg.sum()
    num_total = num_pos.float().clamp(min=1.0)

    # objectness over all priors (target = fg)
    loss_obj = _bce_logits(obj_logits[..., 0], fg.float()).sum() / num_total

    # classification on fg priors: IoU-soft one-hot
    tgt_labels = gt_labels.gather(1, matched_gt)
    cls_target = _one_hot(tgt_labels, cfg.num_classes).float() * \
        matched_iou[..., None]
    per_cls = _bce_logits(cls_logits, cls_target).sum(-1)
    loss_cls = torch.where(fg, per_cls, 0.0).sum() / num_total

    # bbox IoU loss (mode='square'): 1 - iou^2
    tgt_boxes = gt_bboxes.gather(1, matched_gt[..., None].expand(-1, -1, 4))
    iou = _aligned_iou(decoded, tgt_boxes)
    loss_bbox = torch.where(fg, 1.0 - iou.square(), 0.0).sum() / num_total

    losses = dict(
        loss_cls=loss_cls * cfg.loss_cls_weight,
        loss_bbox=loss_bbox * cfg.loss_bbox_weight,
        loss_obj=loss_obj * cfg.loss_obj_weight,
    )
    if cfg.use_l1:
        # encoded targets: xy = gt_c/stride - grid, wh = log(gt_wh/stride)
        stride = priors[None, :, 2:3]
        gxy = (tgt_boxes[..., :2] + tgt_boxes[..., 2:]) / 2.0
        gwh = tgt_boxes[..., 2:] - tgt_boxes[..., :2]
        txy = (gxy - priors[None, :, :2]) / stride
        twh = torch.log(gwh / stride + 1e-8)
        l1 = (reg_preds - torch.cat([txy, twh], -1)).abs().sum(-1)
        losses['loss_l1'] = torch.where(fg, l1, 0.0).sum() / num_total * \
            cfg.loss_l1_weight
    losses['loss'] = sum(losses.values())
    losses['num_pos'] = num_pos
    return losses


def _aligned_iou(b1: torch.Tensor, b2: torch.Tensor,
                 eps: float = 1e-16) -> torch.Tensor:
    lt = torch.maximum(b1[..., :2], b2[..., :2])
    rb = torch.minimum(b1[..., 2:], b2[..., 2:])
    wh = (rb - lt).clamp(min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    a1 = (b1[..., 2] - b1[..., 0]) * (b1[..., 3] - b1[..., 1])
    a2 = (b2[..., 2] - b2[..., 0]) * (b2[..., 3] - b2[..., 1])
    return inter / (a1 + a2 - inter).clamp(min=eps)
