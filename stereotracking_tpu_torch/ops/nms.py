"""Fixed-shape greedy class-aware NMS.

Port of ``stereotracking_tpu/ops/nms.py``: candidates in descending score
order (a STABLE sort, so tied scores keep index order exactly as
``jax.lax.top_k`` does — ``torch.topk`` does not promise it), class offsets
so one IoU pass serves all classes, and the greedy keep set found as the
fixed point of ``keep[j] = not any(keep[i] and iou[i, j] > thr, i < j)``.
The fixed-point loop checks convergence on the host, one sync per pass.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from ..structures.bbox import bbox_iou_matrix


class NMSResult(NamedTuple):
    boxes: torch.Tensor    # (max_out, 4)
    scores: torch.Tensor   # (max_out,)
    labels: torch.Tensor   # (max_out,) int32
    valid: torch.Tensor    # (max_out,) bool


def batched_nms(boxes: torch.Tensor, scores: torch.Tensor,
                labels: torch.Tensor, iou_threshold: float,
                score_threshold: float = 0.0, pre_nms_top_k: int = 2048,
                max_out: int = 300) -> NMSResult:
    """Greedy class-aware NMS; suppresses IoU strictly above the
    threshold.  Output has min(max_out, min(pre_nms_top_k, A)) slots."""
    a = boxes.shape[0]
    k = min(pre_nms_top_k, a)
    valid = scores > score_threshold
    masked = torch.where(valid, scores, float('-inf'))
    top_scores, top_idx = torch.sort(masked, descending=True, stable=True)
    top_scores, top_idx = top_scores[:k], top_idx[:k]
    top_boxes = boxes[top_idx]
    top_labels = labels[top_idx]

    finite = torch.isfinite(top_scores)
    span = torch.where(torch.isfinite(top_boxes), top_boxes, 0.0).max() + 1.0
    offs = top_labels.to(torch.float32)[:, None] * span
    iou = bbox_iou_matrix(top_boxes + offs, top_boxes + offs)
    rows = torch.arange(k, device=boxes.device)
    sup = ((iou > iou_threshold) & (rows[:, None] < rows[None, :])
           & finite[:, None] & finite[None, :])

    keep = finite
    for _ in range(k):
        new = ~(sup & keep[:, None]).any(0)
        if bool((new == keep).all()):
            break
        keep = new
    keep = keep & finite

    order = torch.sort((~keep).to(torch.int8), stable=True).indices[:max_out]
    keep_mask = keep[order]
    keep_mask = keep_mask & (torch.cumsum(keep_mask.to(torch.int32), 0)
                             <= max_out)
    out_boxes = torch.where(keep_mask[:, None], top_boxes[order], 0.0)
    out_scores = torch.where(keep_mask, top_scores[order], 0.0)
    out_labels = torch.where(keep_mask, top_labels[order], 0)
    return NMSResult(out_boxes, out_scores, out_labels.to(torch.int32),
                     keep_mask)


def multiclass_candidates(boxes: torch.Tensor, scores: torch.Tensor,
                          score_threshold: float
                          ) -> Tuple[torch.Tensor, torch.Tensor,
                                     torch.Tensor]:
    """(A, 4) boxes + (A, C) scores -> (A*C,) multi-label candidates."""
    a, c = scores.shape
    flat_scores = scores.reshape(-1)
    flat_labels = torch.arange(c, dtype=torch.int32,
                               device=scores.device).repeat(a)
    flat_boxes = boxes.repeat_interleave(c, dim=0) if c > 1 else boxes
    flat_scores = torch.where(flat_scores > score_threshold, flat_scores, 0.0)
    return flat_boxes, flat_scores, flat_labels
