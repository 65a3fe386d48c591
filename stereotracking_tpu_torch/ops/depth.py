"""Per-box robust depth (corner-guided truncated mean) from disparity.

Port of ``stereotracking_tpu/ops/depth.py`` (``disp_to_depth``,
``extract_box_depths_disp``, ``extract_box_depths`` in ``corner_guided``
mode).  Semantics are the reference's: valid pixels 0 < depth < 150; the
median ``d_mid``; four 2x2 corner means of the unfiltered map vote the rank
window start ``min(1 - votes/4, 0.4) * n``; depth = mean of the sorted
window [ws, ws + 0.6 n); scale = clip(depth^2, 1, 3); -1 / 1 for invalid
boxes or boxes wider than 800 px.  The JAX package's documented deviations
are kept: boxes with negative corners are empty, a one-pixel box returns its
pixel, boxes larger than the crop window are sampled at stride 2^level.

The fixed-point path is ``depth_cuda.box_depths``: one CUDA kernel launch
for CUDA tensors (box scalars, rank statistics and corner vote together),
its plain version for CPU tensors.  The float path below is torch ops.

Both extractions take maps with optional leading stream dims, (..., H, W),
and the boxes of each map, (..., N, 4): S streams are one pass (one kernel
launch) over their S * N boxes.
"""
from __future__ import annotations

from typing import Tuple

import torch

from .depth_cuda import (MAX_DEPTH, box_depths, box_scalars, box_windows,
                         corner_pixels, finish, rank_windows, skip_mask)


def disp_to_depth(disp: torch.Tensor, baseline: float,
                  focal_length: float) -> torch.Tensor:
    """depth = baseline * focal / (disparity + 1e-6)."""
    num = torch.full((), baseline * focal_length, dtype=torch.float32,
                     device=disp.device)
    return num / (disp + 1e-6)


def _streams(maps: torch.Tensor, bboxes: torch.Tensor, valid: torch.Tensor):
    """(..., H, W) maps and their (..., N, 4) boxes -> (S, H, W),
    (S, N, 4), (S, N), and the leading dims to restore."""
    lead = bboxes.shape[:-2]
    return (maps.reshape(-1, *maps.shape[-2:]),
            bboxes.reshape(-1, *bboxes.shape[-2:]),
            valid.reshape(-1, valid.shape[-1]), lead)


def extract_box_depths_disp(disp: torch.Tensor, bboxes: torch.Tensor,
                            valid: torch.Tensor, baseline: float,
                            focal_length: float, crop: int = 128,
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Corner-guided depth of each box, from the fixed-point disparity
    (``disp * 16`` integral in [0, 65535]) in the integer domain.

    disp (..., H, W) float32, bboxes (..., N, 4) xyxy, valid (..., N) bool
    -> (depth, scale), each (..., N); one kernel launch for all maps."""
    disp, boxes, valid, lead = _streams(disp, bboxes, valid)
    d, scale, _ = box_depths(disp, boxes, valid, crop,
                             float(baseline) * float(focal_length))
    return d.reshape(*lead, -1), scale.reshape(*lead, -1)


def extract_box_depths(depth: torch.Tensor, bboxes: torch.Tensor,
                       valid: torch.Tensor, crop: int = 128,
                       mode: str = 'corner_guided'
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Corner-guided depth of each box from a metric depth map (float
    path, used for the GT-depth column): order statistics by a 31-step
    bisection over the float bit patterns, as in the JAX package.  Maps
    (..., H, W), boxes (..., N, 4), as ``extract_box_depths_disp``."""
    if mode != 'corner_guided':
        raise NotImplementedError(f'depth mode {mode!r} is not ported')
    depth, boxes, valid, lead = _streams(depth, bboxes, valid)
    h, w = depth.shape[1:]
    scal = box_scalars(boxes, crop, 0, h, w)
    sidx = scal[:, 7].long()[:, None, None, None]
    boxes, valid = boxes.reshape(-1, 4), valid.reshape(-1)
    vals, inside = box_windows(depth, scal, crop)
    dvals = torch.where(inside, vals, 0.0)
    ok = (dvals > 0.0) & (dvals < MAX_DEPTH)
    n = ok.sum(1).to(torch.int32)
    bits = dvals.view(torch.int32)

    cand_ws, cand_we, m_fb = rank_windows(n)
    ranks = torch.cat([torch.div(n, 2, rounding_mode='floor')[:, None],
                       cand_we.clamp(min=1) - 1, cand_ws.clamp(min=1) - 1,
                       m_fb[:, None] - 1], 1)                   # (B, 8)
    lo = torch.zeros_like(ranks)
    hi = torch.full_like(ranks, 0x7f7fffff)
    okb = ok[:, None, :]
    for _ in range(31):
        mid = lo + torch.div(hi - lo, 2, rounding_mode='floor')
        cnt = (okb & (bits[:, None, :] <= mid[:, :, None])).sum(2)
        ge = cnt >= ranks + 1
        lo = torch.where(ge, lo, mid + 1)
        hi = torch.where(ge, mid, hi)
    r_vals = hi.view(torch.float32)
    below = okb & (bits[:, None, :] < hi[:, 1:, None])
    cnt_lt = below.sum(2).to(torch.int32)
    sum_lt = torch.where(below, dvals[:, None, :], 0.0).sum(2)
    corners = corner_pixels(lambda y, x: depth[sidx, y, x], boxes, h, w,
                            crop).mean(dim=(2, 3))
    d, scale = finish(n, r_vals, cnt_lt, sum_lt, corners,
                      skip_mask(boxes, valid, h, w))
    return d.reshape(*lead, -1), scale.reshape(*lead, -1)
