"""Bounding-box geometry on ``(..., 4)`` tensors.

Port of ``stereotracking_tpu/structures/bbox.py``: the same formulas in the
same float32 operation order, so integer decisions downstream (IoU gates,
depth windows) agree with the JAX package.
"""
from __future__ import annotations

import torch


def bbox_xyxy_to_cxcyah(bboxes: torch.Tensor) -> torch.Tensor:
    """(x1, y1, x2, y2) -> (cx, cy, a=w/h, h)."""
    x1, y1, x2, y2 = bboxes.unbind(-1)
    cx = (x2 + x1) / 2.0
    cy = (y2 + y1) / 2.0
    w = x2 - x1
    h = y2 - y1
    return torch.stack([cx, cy, w / h, h], dim=-1)


def bbox_cxcyah_to_xyxy(bboxes: torch.Tensor) -> torch.Tensor:
    """(cx, cy, a, h) -> (x1, y1, x2, y2)."""
    cx, cy, ratio, h = bboxes.unbind(-1)
    w = ratio * h
    return torch.stack(
        [cx - w / 2.0, cy - h / 2.0, cx + w / 2.0, cy + h / 2.0], dim=-1)


def scale_bbox(bboxes: torch.Tensor, scales) -> torch.Tensor:
    """Center-preserving width/height scaling of xyxy boxes."""
    x1, y1, x2, y2 = bboxes.unbind(-1)
    cx = (x1 + x2) / 2.0
    cy = (y1 + y2) / 2.0
    w = (x2 - x1) * scales
    h = (y2 - y1) * scales
    return torch.stack(
        [cx - w / 2.0, cy - h / 2.0, cx + w / 2.0, cy + h / 2.0], dim=-1)


def bbox_area(bboxes: torch.Tensor) -> torch.Tensor:
    x1, y1, x2, y2 = bboxes.unbind(-1)
    return (x2 - x1) * (y2 - y1)


def bbox_iou_matrix(bboxes1: torch.Tensor, bboxes2: torch.Tensor,
                    eps: float = 1e-6) -> torch.Tensor:
    """Pairwise IoU between two xyxy box sets -> (N, M); degenerate
    intersections clamp to 0."""
    a1 = bbox_area(bboxes1)
    a2 = bbox_area(bboxes2)
    lt = torch.maximum(bboxes1[..., :, None, :2], bboxes2[..., None, :, :2])
    rb = torch.minimum(bboxes1[..., :, None, 2:], bboxes2[..., None, :, 2:])
    wh = (rb - lt).clamp(min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    union = a1[..., :, None] + a2[..., None, :] - inter
    union = union.clamp(min=eps)
    return inter / union
