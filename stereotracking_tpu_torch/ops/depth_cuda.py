"""Per-box corner-guided depth from the fixed-point disparity: CUDA kernel
+ plain version.

Replaces the Pallas kernel ``stereotracking_tpu/ops/depth_pallas.py``
(``_stats_pallas`` / ``_kernel_impl``, reached through
``extract_box_depths_disp_pallas``) together with the XLA code that the JAX
package fuses around it: the box scalars (``_prep_scalars``) and the
corner-vote epilogue (``_epilogue``).  One launch covers the boxes of S
streams, each box naming its stream's map, and writes per box its depth,
its scale and the Pallas kernel's 24-float statistics row.

For each box: the pyramid level ``ceil(log2(size / crop))`` and window
(``box_scalars``); the crop x crop window of the map at stride 2^level, as
integer raw values ``round(disp * 16)`` masked to the box, the frame and
``raw >= rmin`` (``box_windows``); n, the value at seven ranks, the max,
and for six of the rank values the count and float32 sum of depths above
them (``box_depth_stats_plain``); then the four 2x2 corner means of the
unfiltered map vote the rank window, whose mean is the depth, and scale =
clip(depth^2, 1, 3); -1 / 1 for skipped boxes (``depth_epilogue``).
``box_depths_plain`` chains those steps in plain PyTorch; ``box_depths``
runs them as one kernel launch on CUDA tensors.

``rmin`` — the smallest raw disparity whose depth lies in (0, 150) — is
found here with numpy's IEEE float32 division, the same exact division the
JAX paths use (``depth_pallas.py:349-357``).
"""
from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

from .. import _kernels

MAX_DEPTH = 150.0
MAX_BOX_W = 800.0   # boxes wider than this are skipped (depth -1, scale 1)
PYR_LEVELS = 4      # strides 1, 2, 4, 8
NSCAL = 8           # level, y0, x0, nrows, ncols, stride, rmin, stream
NOUT = 24           # n, r_raw[8], cnt_lt[7], sum_lt[7], 0


def f_depth(raw: torch.Tensor, bf: float) -> torch.Tensor:
    """depth of an integer raw disparity in the JAX formula's operation
    order; tensor / tensor, so a true IEEE division (``python_float /
    tensor`` would multiply by a reciprocal)."""
    num = torch.full((), bf, dtype=torch.float32, device=raw.device)
    return num / (raw.to(torch.float32) / 16.0 + 1e-6)


@functools.lru_cache(maxsize=8)
def depth_rmin(bf: float) -> int:
    """Smallest raw value with 0 < depth < MAX_DEPTH (65536 if none), by
    numpy's IEEE float32 division."""
    rr = np.arange(65536, dtype=np.float32)
    dd = np.float32(bf) / (rr / np.float32(16.0) + np.float32(1e-6))
    vr = (dd > 0.0) & (dd < MAX_DEPTH)
    return int(np.argmax(vr)) if vr.any() else 65536


def box_scalars(boxes: torch.Tensor, crop: int, rmin: int, h: int,
                w: int) -> torch.Tensor:
    """(S, N, 4) xyxy float boxes -> (S * N, 8) int32 kernel scalars:
    pyramid level, window origin (y0, x0) in level coordinates, rows and
    columns in the box (at most crop), stride, rmin, stream.  Same level
    and window selection as ``extract_box_depths_disp``
    (``ops/depth.py:159-185`` of the JAX package)."""
    n_streams, n_boxes = boxes.shape[:2]
    boxes = boxes.reshape(-1, 4)
    x1 = boxes[:, 0].to(torch.int32)
    y1 = boxes[:, 1].to(torch.int32)
    x2 = boxes[:, 2].to(torch.int32)
    y2 = boxes[:, 3].to(torch.int32)
    bw, bh = x2 - x1, y2 - y1
    # ceil(log2(max(size / crop, 1))) clipped to the levels, in integers:
    # a float ``size / crop`` may become a reciprocal multiply on the card
    size = torch.maximum(bw, bh)
    level = sum((size > crop * 2 ** l).to(torch.int32)
                for l in range(PYR_LEVELS - 1))
    stride = torch.bitwise_left_shift(torch.ones_like(level), level)
    y0 = torch.div(y1.clamp(0, h), stride, rounding_mode='floor')
    x0 = torch.div(x1.clamp(0, w), stride, rounding_mode='floor')
    nr = torch.div(bh + stride - 1, stride, rounding_mode='floor').clamp(
        max=crop)
    nc = torch.div(bw + stride - 1, stride, rounding_mode='floor').clamp(
        max=crop)
    stream = torch.arange(n_streams, dtype=torch.int32,
                          device=boxes.device).repeat_interleave(n_boxes)
    return torch.stack([level, y0, x0, nr, nc, stride,
                        torch.full_like(level, rmin), stream],
                       dim=1).to(torch.int32).contiguous()


def rank_windows(n: torch.Tensor):
    """Candidate rank windows of the corner vote, float32 as in the JAX
    path: starts (0.4 n, 0.25 n, 0), ends (start + 0.6 n), and the
    fallback count max(n - 1, 1) (n if n <= 1)."""
    nf = n.to(torch.float32)
    a04, a025, a06 = 0.4 * nf, 0.25 * nf, 0.6 * nf
    cand_ws = torch.stack([a04.to(torch.int32), a025.to(torch.int32),
                           torch.zeros_like(n)], 1)
    cand_we = torch.stack([(a04 + a06).to(torch.int32),
                           (a025 + a06).to(torch.int32),
                           a06.to(torch.int32)], 1)
    m_fb = torch.where(n > 1, n - 1, n).clamp(min=1)
    return cand_ws, cand_we, m_fb


def box_windows(img: torch.Tensor, scal: torch.Tensor, crop: int):
    """Each box's crop x crop window of its stream's map in ``img``
    (S, H, W) at its pyramid stride, flattened: (values, inside) of shape
    (B, crop * crop); inside = in the box and in the frame."""
    h, w = img.shape[1:]
    y0, x0, nr, nc, stride, sidx = (scal[:, i, None, None]
                                    for i in (1, 2, 3, 4, 5, 7))
    rr = torch.arange(crop, device=img.device)[None, :, None]
    cc = torch.arange(crop, device=img.device)[None, None, :]
    y = (y0 + rr) * stride
    x = (x0 + cc) * stride
    inside = (rr < nr) & (cc < nc) & (y < h) & (x < w)
    vals = img[sidx, y.clamp(max=h - 1), x.clamp(max=w - 1)]
    nb = scal.shape[0]
    return vals.reshape(nb, -1), inside.reshape(nb, -1)


def box_depth_stats_plain(disp: torch.Tensor, scal: torch.Tensor, crop: int,
                          bf: float) -> torch.Tensor:
    """Plain PyTorch version of the kernel: (B, 24) float32 stats."""
    nb = scal.shape[0]
    dev = disp.device
    vals, inside = box_windows(disp, scal, crop)
    raw = torch.round(vals * 16.0).to(torch.int32)
    masked = torch.where(inside & (raw >= scal[:, 6:7]), raw, -1)
    n = (masked >= 0).sum(1).to(torch.int32)

    nf = n.to(torch.float32)
    cand_ws, cand_we, m_fb = rank_windows(n)
    ranks = torch.cat([torch.div(n, 2, rounding_mode='floor')[:, None],
                       cand_we.clamp(min=1) - 1,
                       cand_ws[:, :2].clamp(min=1) - 1,
                       m_fb[:, None] - 1], 1)                    # (B, 7)
    lo = torch.zeros_like(ranks)
    hi = torch.full_like(ranks, 65535)
    for _ in range(16):
        mid = lo + torch.div(hi - lo + 1, 2, rounding_mode='floor')
        cnt = (masked[:, None, :] >= mid[:, :, None]).sum(2)
        ge = cnt >= ranks + 1
        lo = torch.where(ge, mid, lo)
        hi = torch.where(ge, hi, mid - 1)
    vmax = masked.max(1).values.clamp(min=0)

    d = f_depth(masked, bf)
    below = masked[:, None, :] > lo[:, 1:, None]                # (B, 6, M)
    cnt_lt = below.sum(2).to(torch.float32)
    sum_lt = torch.where(below, d[:, None, :], 0.0).sum(2)
    z = torch.zeros((nb, 1), dtype=torch.float32, device=dev)
    r_raw = torch.cat([lo[:, :6], vmax[:, None], lo[:, 6:]], 1)
    return torch.cat([nf[:, None], r_raw.to(torch.float32),
                      cnt_lt[:, :5], z, cnt_lt[:, 5:],
                      sum_lt[:, :5], z, sum_lt[:, 5:], z], 1)


def box_ints(boxes: torch.Tensor):
    """(B, 4) float boxes -> x1, y1, x2, y2 int32, truncated toward 0."""
    return boxes.to(torch.int32).unbind(1)


def skip_mask(boxes, valid, h: int, w: int) -> torch.Tensor:
    """Boxes that get depth -1: invalid, degenerate or wider than
    MAX_BOX_W."""
    x1, y1, x2, y2 = box_ints(boxes)
    bw, bh = x2 - x1, y2 - y1
    degenerate = ((x1 < 0) | (y1 < 0) | (bw <= 0) | (bh <= 0)
                  | (boxes[:, 0] >= w) | (boxes[:, 1] >= h))
    return ~valid | degenerate | (bw.to(torch.float32) > MAX_BOX_W)


def corner_points(boxes, h: int, w: int, crop: int):
    """The four 2x2 corner origins, clipped as the JAX path clips them."""
    x1, y1, x2, y2 = box_ints(boxes)
    pw = w + crop + 2
    cy1 = y1.clamp(0, h + crop)
    cy2 = (y2 - 2).clamp(0, h + crop)
    cx1 = x1.clamp(0, pw - 2)
    cx2 = (x2 - 2).clamp(0, pw - 2)
    return ((cy1, cx1), (cy1, cx2), (cy2, cx1), (cy2, cx2))


def corner_pixels(values_at, boxes, h: int, w: int, crop: int):
    """(B, 4, 2, 2): the 2x2 pixels at each of the four corner origins,
    from ``values_at(yy, xx)``; pixels outside the map count 0."""
    pts = corner_points(boxes, h, w, crop)
    y = torch.stack([p[0] for p in pts], 1)[:, :, None, None]
    x = torch.stack([p[1] for p in pts], 1)[:, :, None, None]
    d = torch.arange(2, device=boxes.device)
    yy, xx = y + d[:, None], x + d[None, :]
    return torch.where((yy < h) & (xx < w),
                       values_at(yy.clamp(0, h - 1), xx.clamp(0, w - 1)), 0.0)


def vote_branch(corners: torch.Tensor, d_mid: torch.Tensor) -> torch.Tensor:
    """The rank window the corners vote for: 0 for at most two corners
    deeper than the median, 1 for three, 2 for four."""
    votes = (corners > d_mid[:, None]).sum(1)
    return torch.where(votes <= 2, 0, torch.where(votes == 3, 1, 2))


def finish(n, r_vals, cnt_lt, sum_lt, corners, skip):
    """Corner vote + truncated-window mean from the rank statistics.

    ``r_vals`` (B, 8): depth at [median, we0..2, ws0..2, fallback];
    ``cnt_lt`` / ``sum_lt`` (B, 7): count and sum of depths strictly below
    each of r_vals[:, 1:]."""
    branch = vote_branch(corners, r_vals[:, 0])
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


def disp_corners(disp: torch.Tensor, boxes: torch.Tensor, crop: int,
                 bf: float) -> torch.Tensor:
    """(S * N, 4) corner means of the (S, N, 4) boxes on the (S, H, W)
    fixed-point disparity maps, in depth.  Each mean adds its pixels in one
    fixed order, the kernel's: ((p[0, 0] + p[0, 1]) + p[1, 0]) + p[1, 1],
    then divides by 4."""
    h, w = disp.shape[1:]
    n_streams, n_boxes = boxes.shape[:2]
    sidx = torch.arange(n_streams, device=disp.device).repeat_interleave(
        n_boxes)[:, None, None, None]

    def values_at(yy, xx):
        return f_depth(torch.round(disp[sidx, yy, xx] * 16.0).to(
            torch.int32), bf)

    p = corner_pixels(values_at, boxes.reshape(-1, 4), h, w, crop)
    return (((p[..., 0, 0] + p[..., 0, 1]) + p[..., 1, 0])
            + p[..., 1, 1]) / 4.0


def depth_epilogue(disp: torch.Tensor, boxes: torch.Tensor,
                   valid: torch.Tensor, stats: torch.Tensor, crop: int,
                   bf: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """(depth, scale), each (S, N), from the (S * N, 24) stats rows of the
    (S, N, 4) boxes on the (S, H, W) maps."""
    h, w = disp.shape[1:]
    n_streams, n_boxes = boxes.shape[:2]
    n = stats[:, 0].to(torch.int32)
    r_vals = f_depth(stats[:, 1:9].to(torch.int32), bf)
    cnt_lt = stats[:, 9:16].to(torch.int32)
    sum_lt = stats[:, 16:23]
    d, scale = finish(n, r_vals, cnt_lt, sum_lt,
                      disp_corners(disp, boxes, crop, bf),
                      skip_mask(boxes.reshape(-1, 4), valid.reshape(-1),
                                h, w))
    return d.reshape(n_streams, n_boxes), scale.reshape(n_streams, n_boxes)


def box_depths_plain(disp: torch.Tensor, boxes: torch.Tensor,
                     valid: torch.Tensor, crop: int, bf: float
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel: (depth, scale) (S, N) and the
    (S * N, 24) stats rows."""
    h, w = disp.shape[1:]
    scal = box_scalars(boxes, crop, depth_rmin(bf), h, w)
    stats = box_depth_stats_plain(disp, scal, crop, bf)
    d, scale = depth_epilogue(disp, boxes, valid, stats, crop, bf)
    return d, scale, stats


def _box_layout(boxes: torch.Tensor, valid: torch.Tensor):
    """Boxes and flags as the kernel reads them: unit stride within a box
    and between a stream's boxes (a stream stride of its own is passed)."""
    if boxes.stride(2) != 1 or boxes.stride(1) != 4:
        boxes = boxes.contiguous()
    if valid.stride(1) != 1:
        valid = valid.contiguous()
    return boxes, valid


def box_depths(disp: torch.Tensor, boxes: torch.Tensor, valid: torch.Tensor,
               crop: int, bf: float
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(S, H, W) float32 disparity, (S, N, 4) float32 xyxy boxes and (S, N)
    bool flags -> (depth, scale), each (S, N), and the (S * N, 24) stats
    rows; one launch for the boxes of all S streams.

    CPU tensors run ``box_depths_plain``; CUDA tensors launch the kernel."""
    if disp.dim() != 3 or disp.dtype != torch.float32:
        raise ValueError(f'disparity must be (S, H, W) float32, got '
                         f'{tuple(disp.shape)} {disp.dtype}')
    n_streams, h, w = disp.shape
    if (boxes.dim() != 3 or boxes.shape[0] != n_streams
            or boxes.shape[2] != 4 or boxes.dtype != torch.float32):
        raise ValueError(f'boxes must be ({n_streams}, N, 4) float32, got '
                         f'{tuple(boxes.shape)} {boxes.dtype}')
    if valid.shape != boxes.shape[:2] or valid.dtype != torch.bool:
        raise ValueError(f'valid must be {tuple(boxes.shape[:2])} bool, got '
                         f'{tuple(valid.shape)} {valid.dtype}')
    if not 1 <= crop <= 128:
        raise ValueError(f'crop must be in [1, 128], got {crop}')
    if disp.device.type == 'cpu':
        return box_depths_plain(disp, boxes, valid, crop, bf)
    boxes, valid = _box_layout(boxes, valid)
    _kernels.require_cuda('box_depths', disp, strided=(boxes, valid))
    n_boxes = boxes.shape[1]
    depth = torch.empty((n_streams, n_boxes), dtype=torch.float32,
                        device=disp.device)
    scale = torch.empty_like(depth)
    stats = torch.empty((n_streams * n_boxes, NOUT), dtype=torch.float32,
                        device=disp.device)
    if depth.numel() == 0:
        return depth, scale, stats       # no box: nothing to launch
    status = _kernels.library().st_box_depths(
        disp.data_ptr(), n_streams, h, w, boxes.data_ptr(), boxes.stride(0),
        valid.data_ptr(), valid.stride(0), n_boxes, crop, float(bf),
        depth_rmin(bf), depth.data_ptr(), scale.data_ptr(),
        stats.data_ptr(), _kernels.stream_ptr(disp))
    _kernels.check(status, 'box_depths')
    _kernels.count_launch('depth')
    return depth, scale, stats
