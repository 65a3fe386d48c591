"""Fixed-shape greedy class-aware NMS.

Port of ``stereotracking_tpu/ops/nms.py``: candidates in descending score
order (a STABLE sort, so tied scores keep index order exactly as
``jax.lax.top_k`` does — ``torch.topk`` does not promise it), class offsets
so one IoU pass serves all classes, and the greedy keep set
(``nms_cuda.nms_keep``, cut at ``max_out`` kept candidates: a CUDA kernel
for CUDA tensors, the dense fixed-point loop for CPU tensors), then the
kept candidates compacted into ``max_out`` slots.  Inputs may carry
leading stream dims, (..., A): all streams are one pass, and on the card
nothing reads a value back to the host.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from .nms_cuda import nms_keep


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
    threshold.  Boxes (..., A, 4), scores and labels (..., A); output has
    min(max_out, min(pre_nms_top_k, A)) slots per stream."""
    lead = scores.shape[:-1]
    a = scores.shape[-1]
    boxes = boxes.reshape(-1, a, 4)
    scores, labels = scores.reshape(-1, a), labels.reshape(-1, a)
    k = min(pre_nms_top_k, a)
    valid = scores > score_threshold
    masked = torch.where(valid, scores, float('-inf'))
    top_scores, top_idx = torch.sort(masked, dim=1, descending=True,
                                     stable=True)
    top_scores, top_idx = top_scores[:, :k], top_idx[:, :k]
    top_boxes = boxes.gather(1, top_idx[..., None].expand(-1, -1, 4))
    top_labels = labels.gather(1, top_idx)

    finite = torch.isfinite(top_scores)
    span = torch.where(torch.isfinite(top_boxes), top_boxes, 0.0).amax(
        dim=(1, 2), keepdim=True) + 1.0
    offs = top_labels.to(torch.float32)[..., None] * span
    # only the first max_out kept candidates leave: the scan stops there
    keep = nms_keep(top_boxes + offs, finite, iou_threshold, max_out)

    order = torch.sort((~keep).to(torch.int8), dim=1,
                       stable=True).indices[:, :max_out]
    keep_mask = keep.gather(1, order)
    keep_mask = keep_mask & (torch.cumsum(keep_mask.to(torch.int32), 1)
                             <= max_out)
    out_boxes = torch.where(keep_mask[..., None],
                            top_boxes.gather(
                                1, order[..., None].expand(-1, -1, 4)), 0.0)
    out_scores = torch.where(keep_mask, top_scores.gather(1, order), 0.0)
    out_labels = torch.where(keep_mask, top_labels.gather(1, order), 0)
    m = order.shape[1]
    return NMSResult(out_boxes.reshape(*lead, m, 4),
                     out_scores.reshape(*lead, m),
                     out_labels.to(torch.int32).reshape(*lead, m),
                     keep_mask.reshape(*lead, m))


def multiclass_candidates(boxes: torch.Tensor, scores: torch.Tensor,
                          score_threshold: float
                          ) -> Tuple[torch.Tensor, torch.Tensor,
                                     torch.Tensor]:
    """(..., A, 4) boxes + (..., A, C) scores -> (..., A*C) multi-label
    candidates."""
    a, c = scores.shape[-2:]
    flat_scores = scores.reshape(*scores.shape[:-2], a * c)
    flat_labels = torch.arange(c, dtype=torch.int32,
                               device=scores.device).repeat(a).expand_as(
                                   flat_scores)
    flat_boxes = boxes.repeat_interleave(c, dim=-2) if c > 1 else boxes
    flat_scores = torch.where(flat_scores > score_threshold, flat_scores, 0.0)
    return flat_boxes, flat_scores, flat_labels
