"""Greedy NMS keep set of S streams' score-sorted candidates: CUDA kernel
+ plain version.

Replaces the fixed-point suppression loop of the JAX package's
``batched_nms`` (``stereotracking_tpu/ops/nms.py:31``, the ``lax.while_loop``
of lines 62-85).  ``nms_keep`` launches ``csrc/nms.cu`` on CUDA tensors
(suppression bitmask and a word-level scan per stream that stops at
``max_keep`` kept candidates, one launch for all streams, no host round
trip) and runs ``nms_keep_plain``, the dense fixed-point loop, on CPU
tensors.  Both give the greedy keep set, the unique fixed point of
``keep[j] = finite[j] and not any(keep[i] and iou[i, j] > thr, i < j)``, cut
after its first ``max_keep`` members, and decide each ``iou > thr`` on the
same float32 IoU bits (``structures.bbox.bbox_iou_matrix``).
"""
from __future__ import annotations

from typing import Optional

import torch

from .. import _kernels
from ..structures.bbox import bbox_iou_matrix

PASSES_PER_CHECK = 8    # plain version: fixed-point passes per host check
EPS = 1e-6              # bbox_iou_matrix's union clamp
MAX_CANDIDATES = 2048   # one scanning warp holds 32 words of 64 columns


def nms_keep_plain(boxes: torch.Tensor, finite: torch.Tensor,
                   iou_threshold: float, max_keep: Optional[int] = None
                   ) -> torch.Tensor:
    """``nms_keep`` as dense passes over the (S, k, k) suppression matrix
    until the keep set stops changing, checked on the host once per
    ``PASSES_PER_CHECK`` passes for all streams (a pass past the fixed
    point changes nothing), then cut after ``max_keep`` kept candidates."""
    k = boxes.shape[1]
    iou = bbox_iou_matrix(boxes, boxes, EPS)
    rows = torch.arange(k, device=boxes.device)
    sup = ((iou > iou_threshold) & (rows[:, None] < rows[None, :])
           & finite[:, :, None] & finite[:, None, :])
    keep = finite
    for _ in range(0, k, PASSES_PER_CHECK):
        for _ in range(PASSES_PER_CHECK):
            prev, keep = keep, ~(sup & keep[:, :, None]).any(1)
        if bool((prev == keep).all()):                  # one host check
            break
    keep = keep & finite
    if max_keep is None:
        return keep
    return keep & (torch.cumsum(keep.to(torch.int32), 1) <= max_keep)


def nms_keep(boxes: torch.Tensor, finite: torch.Tensor,
             iou_threshold: float, max_keep: Optional[int] = None
             ) -> torch.Tensor:
    """(S, k, 4) float32 score-sorted, class-shifted xyxy boxes and (S, k)
    bool finite flags -> (S, k) bool greedy keep set (k <= 2048 on the
    card), holding only the first ``max_keep`` kept candidates of each
    stream (``None``: all of them).  CPU tensors run ``nms_keep_plain``;
    CUDA tensors launch the kernel."""
    if boxes.dim() != 3 or boxes.shape[2] != 4 or \
            boxes.dtype != torch.float32:
        raise ValueError(f'boxes must be (S, k, 4) float32, got '
                         f'{tuple(boxes.shape)} {boxes.dtype}')
    n, k = boxes.shape[:2]
    if finite.shape != (n, k) or finite.dtype != torch.bool:
        raise ValueError(f'finite must be ({n}, {k}) bool, got '
                         f'{tuple(finite.shape)} {finite.dtype}')
    if boxes.device.type == 'cpu':
        return nms_keep_plain(boxes, finite, iou_threshold, max_keep)
    if k > MAX_CANDIDATES:
        raise ValueError(f'nms_keep takes at most {MAX_CANDIDATES} '
                         f'candidates per stream, got {k}')
    boxes, finite = boxes.contiguous(), finite.contiguous()
    _kernels.require_cuda('nms_keep', boxes, finite)
    dev = boxes.device
    keep = torch.empty((n, k), dtype=torch.bool, device=dev)
    if n == 0 or k == 0:
        return keep
    words = -(-k // 64)
    # rows of an even number of words: the scan copies aligned pairs
    mask = torch.empty((n, k, words + words % 2), dtype=torch.int64,
                       device=dev)
    tickets = torch.zeros((n,), dtype=torch.int32, device=dev)
    cap = k if max_keep is None else max(0, min(int(max_keep), k))
    status = _kernels.library().st_nms_keep(
        boxes.data_ptr(), finite.data_ptr(), n, k, float(iou_threshold),
        EPS, cap, mask.data_ptr(), tickets.data_ptr(), keep.data_ptr(),
        _kernels.stream_ptr(boxes))
    _kernels.check(status, 'nms_keep')
    _kernels.count_launch('nms')
    return keep
