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

The fixed-point path runs its per-box statistics through
``depth_cuda.box_depth_stats`` (the CUDA kernel for CUDA tensors) and the
arithmetic after it (``_finish``) as torch ops.

Both extractions take maps with optional leading stream dims, (..., H, W),
and the boxes of each map, (..., N, 4): S streams are one pass (one kernel
launch) over their S * N boxes.
"""
from __future__ import annotations

from typing import Tuple

import torch

from .depth_cuda import (MAX_DEPTH, box_depth_stats, box_scalars,
                         box_windows, depth_rmin, f_depth, rank_windows)

MAX_BOX_W = 800.0


def disp_to_depth(disp: torch.Tensor, baseline: float,
                  focal_length: float) -> torch.Tensor:
    """depth = baseline * focal / (disparity + 1e-6)."""
    num = torch.full((), baseline * focal_length, dtype=torch.float32,
                     device=disp.device)
    return num / (disp + 1e-6)


def _box_ints(boxes: torch.Tensor):
    x1, y1, x2, y2 = boxes.to(torch.int32).unbind(1)
    return x1, y1, x2, y2


def _skip(boxes, valid, h: int, w: int) -> torch.Tensor:
    x1, y1, x2, y2 = _box_ints(boxes)
    bw, bh = x2 - x1, y2 - y1
    degenerate = ((x1 < 0) | (y1 < 0) | (bw <= 0) | (bh <= 0)
                  | (boxes[:, 0] >= w) | (boxes[:, 1] >= h))
    return ~valid | degenerate | (bw.to(torch.float32) > MAX_BOX_W)


def _corner_points(boxes, h: int, w: int, crop: int):
    """The four 2x2 corner origins, clipped as the JAX path clips them."""
    x1, y1, x2, y2 = _box_ints(boxes)
    pw = w + crop + 2
    cy1 = y1.clamp(0, h + crop)
    cy2 = (y2 - 2).clamp(0, h + crop)
    cx1 = x1.clamp(0, pw - 2)
    cx2 = (x2 - 2).clamp(0, pw - 2)
    return ((cy1, cx1), (cy1, cx2), (cy2, cx1), (cy2, cx2))


def _corner_means(values_at, boxes, h: int, w: int, crop: int):
    """(B, 4) means of the 2x2 corners; pixels outside the map count 0."""
    d = torch.arange(2, device=boxes.device)
    out = []
    for y, x in _corner_points(boxes, h, w, crop):
        yy = y[:, None, None] + d[None, :, None]
        xx = x[:, None, None] + d[None, None, :]
        inside = (yy < h) & (xx < w)
        vals = values_at(yy.clamp(0, h - 1), xx.clamp(0, w - 1))
        out.append(torch.where(inside, vals, 0.0).mean(dim=(1, 2)))
    return torch.stack(out, 1)


def _finish(n, r_vals, cnt_lt, sum_lt, corners, skip):
    """Corner vote + truncated-window mean from the rank statistics.

    ``r_vals`` (B, 8): depth at [median, we0..2, ws0..2, fallback];
    ``cnt_lt`` / ``sum_lt`` (B, 7): count and sum of depths strictly below
    each of r_vals[:, 1:]."""
    d_mid = r_vals[:, 0]
    votes = (corners > d_mid[:, None]).sum(1)
    branch = torch.where(votes <= 2, 0, torch.where(votes == 3, 1, 2))
    cand_ws, cand_we, m_fb = rank_windows(n)
    ms = torch.cat([cand_we, cand_ws, m_fb[:, None]], 1).clamp(min=1)
    pref = sum_lt + (ms - cnt_lt).to(torch.float32) * r_vals[:, 1:]
    bi = branch[:, None]
    ws = cand_ws.gather(1, bi)[:, 0]
    we = cand_we.gather(1, bi)[:, 0]
    seg_cnt = (we - ws).to(torch.float32)
    seg_sum = (torch.where(we > ws, pref.gather(1, bi)[:, 0], 0.0)
               - torch.where(ws > 0, pref.gather(1, bi + 3)[:, 0], 0.0))
    fb_cnt = (n - 1).clamp(min=1).to(torch.float32)
    d = torch.where(we <= ws, pref[:, 6] / fb_cnt,
                    seg_sum / seg_cnt.clamp(min=1.0))
    bad = skip | (n < 1)
    d = torch.where(bad, -1.0, d)
    scale = torch.where(bad, 1.0, (d * d).clamp(1.0, 3.0))
    return d, scale


def depth_epilogue(disp: torch.Tensor, boxes: torch.Tensor,
                   valid: torch.Tensor, stats: torch.Tensor, crop: int,
                   bf: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """(depth, scale), each (S, N), from the kernel's (S * N, 24) stats
    rows of the (S, N, 4) boxes on the (S, H, W) maps."""
    h, w = disp.shape[1:]
    n_streams, n_boxes = boxes.shape[:2]
    flat, flat_valid = boxes.reshape(-1, 4), valid.reshape(-1)
    sidx = torch.arange(n_streams, device=disp.device).repeat_interleave(
        n_boxes)[:, None, None]
    n = stats[:, 0].to(torch.int32)
    r_vals = f_depth(stats[:, 1:9].to(torch.int32), bf)
    cnt_lt = stats[:, 9:16].to(torch.int32)
    sum_lt = stats[:, 16:23]

    def values_at(yy, xx):
        return f_depth(torch.round(disp[sidx, yy, xx] * 16.0).to(torch.int32),
                       bf)

    corners = _corner_means(values_at, flat, h, w, crop)
    d, scale = _finish(n, r_vals, cnt_lt, sum_lt, corners,
                       _skip(flat, flat_valid, h, w))
    return d.reshape(n_streams, n_boxes), scale.reshape(n_streams, n_boxes)


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
    h, w = disp.shape[1:]
    bf = float(baseline) * float(focal_length)
    scal = box_scalars(boxes, crop, depth_rmin(bf), h, w)
    stats = box_depth_stats(disp, scal, crop, bf)
    d, scale = depth_epilogue(disp, boxes, valid, stats, crop, bf)
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
    sidx = scal[:, 7].long()[:, None, None]
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
    corners = _corner_means(lambda y, x: depth[sidx, y, x], boxes, h, w,
                            crop)
    d, scale = _finish(n, r_vals, cnt_lt, sum_lt, corners,
                       _skip(boxes, valid, h, w))
    return d.reshape(*lead, -1), scale.reshape(*lead, -1)
