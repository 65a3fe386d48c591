"""Per-box depth statistics: CUDA kernel + plain version.

Replaces the Pallas kernel ``stereotracking_tpu/ops/depth_pallas.py``
(``_stats_pallas`` / ``_kernel_impl``, reached through
``extract_box_depths_disp_pallas``).  One launch covers the boxes of S
streams, each box naming its stream's map.  For each box it reads a crop x crop
window of the fixed-point disparity map at pyramid level
``ceil(log2(size / crop))`` (stride 2^level, no pyramid copy), as integer
raw values ``round(disp * 16)`` masked to the box, the frame and
``raw >= rmin``; finds seven order statistics by a 16-step bisection over
the uint16 domain, plus the max; and for each boundary the count and float32
sum of depths below it.  The result is the Pallas kernel's 24-float stats
row per box; ``ops.depth.depth_epilogue`` turns it into (depth, scale).

``rmin`` — the smallest raw disparity whose depth lies in (0, 150) — is
found here with numpy's IEEE float32 division, the same exact division the
JAX paths use (``depth_pallas.py:349-357``).
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from .. import _kernels

MAX_DEPTH = 150.0
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


def box_depth_stats(disp: torch.Tensor, scal: torch.Tensor, crop: int,
                    bf: float) -> torch.Tensor:
    """(S, H, W) float32 disparity + (B, 8) int32 scalars -> (B, 24) stats,
    one launch for the boxes of all S streams.

    CPU tensors run ``box_depth_stats_plain``; CUDA tensors launch the
    kernel."""
    if disp.dim() != 3 or disp.dtype != torch.float32:
        raise ValueError(f'disparity must be (S, H, W) float32, got '
                         f'{tuple(disp.shape)} {disp.dtype}')
    if scal.dim() != 2 or scal.shape[1] != NSCAL or scal.dtype != torch.int32:
        raise ValueError(f'scalars must be (B, {NSCAL}) int32')
    if not 1 <= crop <= 128:
        raise ValueError(f'crop must be in [1, 128], got {crop}')
    if disp.device.type == 'cpu':
        return box_depth_stats_plain(disp, scal, crop, bf)
    _kernels.require_cuda('box_depth_stats', disp, scal)
    h, w = disp.shape[1:]
    out = torch.empty((scal.shape[0], NOUT), dtype=torch.float32,
                      device=disp.device)
    if scal.shape[0] == 0:
        return out                   # no box: nothing to launch
    status = _kernels.library().st_box_depth_stats(
        disp.data_ptr(), h, w, scal.data_ptr(), scal.shape[0], crop,
        float(bf), out.data_ptr(), _kernels.stream_ptr(disp))
    _kernels.check(status, 'box_depth_stats')
    _kernels.count_launch('depth')
    return out
