"""Corner-guided per-box depth from the fixed-point disparity, in plain
PyTorch: for each box, the crop x crop window of its stream's map at the
pyramid stride 2^ceil(log2(size / crop)), as integer raw values
round(disp * 16) of depth in (0, 150); the value at seven ranks found by a
16-step bisection; the four 2x2 corner means vote the rank window
[ws, ws + 0.6 n) whose mean depth is the box's depth; scale =
clip(depth^2, 1, 3); -1 / 1 for invalid, degenerate or wider than 800 px
boxes.
"""
from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

MAX_DEPTH = 150.0
MAX_BOX_W = 800.0
PYR_LEVELS = 4


def f_depth(raw: torch.Tensor, bf: float) -> torch.Tensor:
    num = torch.full((), bf, dtype=torch.float32, device=raw.device)
    return num / (raw.to(torch.float32) / 16.0 + 1e-6)


@functools.lru_cache(maxsize=8)
def depth_rmin(bf: float) -> int:
    """Smallest raw value with 0 < depth < MAX_DEPTH (65536 if none)."""
    rr = np.arange(65536, dtype=np.float32)
    dd = np.float32(bf) / (rr / np.float32(16.0) + np.float32(1e-6))
    vr = (dd > 0.0) & (dd < MAX_DEPTH)
    return int(np.argmax(vr)) if vr.any() else 65536


def _box_ints(boxes):
    return boxes.to(torch.int32).unbind(1)


def box_scalars(boxes, crop, rmin, h, w):
    n_streams, n_boxes = boxes.shape[:2]
    x1, y1, x2, y2 = _box_ints(boxes.reshape(-1, 4))
    bw, bh = x2 - x1, y2 - y1
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
                        torch.full_like(level, rmin), stream], 1).to(
                            torch.int32)


def rank_windows(n):
    nf = n.to(torch.float32)
    a04, a025, a06 = 0.4 * nf, 0.25 * nf, 0.6 * nf
    ws = torch.stack([a04.to(torch.int32), a025.to(torch.int32),
                      torch.zeros_like(n)], 1)
    we = torch.stack([(a04 + a06).to(torch.int32),
                      (a025 + a06).to(torch.int32), a06.to(torch.int32)], 1)
    m_fb = torch.where(n > 1, n - 1, n).clamp(min=1)
    return ws, we, m_fb


def box_stats(disp, scal, crop, bf):
    """(B, 24) statistics: n, the raw values at the ranks, and the count
    and sum of depths above six of them."""
    h, w = disp.shape[1:]
    y0, x0, nr, nc, stride, sidx = (scal[:, i, None, None]
                                    for i in (1, 2, 3, 4, 5, 7))
    rr = torch.arange(crop, device=disp.device)[None, :, None]
    cc = torch.arange(crop, device=disp.device)[None, None, :]
    y, x = (y0 + rr) * stride, (x0 + cc) * stride
    inside = (rr < nr) & (cc < nc) & (y < h) & (x < w)
    nb = scal.shape[0]
    vals = disp[sidx, y.clamp(max=h - 1), x.clamp(max=w - 1)].reshape(nb, -1)
    inside = inside.reshape(nb, -1)
    raw = torch.round(vals * 16.0).to(torch.int32)
    masked = torch.where(inside & (raw >= scal[:, 6:7]), raw, -1)
    n = (masked >= 0).sum(1).to(torch.int32)
    ws, we, m_fb = rank_windows(n)
    ranks = torch.cat([torch.div(n, 2, rounding_mode='floor')[:, None],
                       we.clamp(min=1) - 1, ws[:, :2].clamp(min=1) - 1,
                       m_fb[:, None] - 1], 1)
    lo = torch.zeros_like(ranks)
    hi = torch.full_like(ranks, 65535)
    for _ in range(16):
        mid = lo + torch.div(hi - lo + 1, 2, rounding_mode='floor')
        ge = (masked[:, None, :] >= mid[:, :, None]).sum(2) >= ranks + 1
        lo = torch.where(ge, mid, lo)
        hi = torch.where(ge, hi, mid - 1)
    vmax = masked.max(1).values.clamp(min=0)
    d = f_depth(masked, bf)
    below = masked[:, None, :] > lo[:, 1:, None]
    cnt = below.sum(2).to(torch.float32)
    sm = torch.where(below, d[:, None, :], 0.0).sum(2)
    z = torch.zeros((nb, 1), dtype=torch.float32, device=disp.device)
    r_raw = torch.cat([lo[:, :6], vmax[:, None], lo[:, 6:]], 1)
    return torch.cat([n.to(torch.float32)[:, None], r_raw.to(torch.float32),
                      cnt[:, :5], z, cnt[:, 5:], sm[:, :5], z, sm[:, 5:], z],
                     1)


def _corner_means(disp, boxes, crop, bf):
    h, w = disp.shape[1:]
    n_streams, n_boxes = boxes.shape[:2]
    flat = boxes.reshape(-1, 4)
    x1, y1, x2, y2 = _box_ints(flat)
    pw = w + crop + 2
    cy1, cy2 = y1.clamp(0, h + crop), (y2 - 2).clamp(0, h + crop)
    cx1, cx2 = x1.clamp(0, pw - 2), (x2 - 2).clamp(0, pw - 2)
    pts = ((cy1, cx1), (cy1, cx2), (cy2, cx1), (cy2, cx2))
    y = torch.stack([p[0] for p in pts], 1)[:, :, None, None]
    x = torch.stack([p[1] for p in pts], 1)[:, :, None, None]
    d2 = torch.arange(2, device=disp.device)
    yy, xx = y + d2[:, None], x + d2[None, :]
    sidx = torch.arange(n_streams, device=disp.device).repeat_interleave(
        n_boxes)[:, None, None, None]
    vals = f_depth(torch.round(disp[sidx, yy.clamp(0, h - 1),
                                    xx.clamp(0, w - 1)] * 16.0).to(
                                        torch.int32), bf)
    p = torch.where((yy < h) & (xx < w), vals, 0.0)
    return (((p[..., 0, 0] + p[..., 0, 1]) + p[..., 1, 0])
            + p[..., 1, 1]) / 4.0


def box_depths(disp: torch.Tensor, boxes: torch.Tensor, valid: torch.Tensor,
               crop: int, bf: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """(S, H, W) float32 disparity (raw / 16), (S, N, 4) xyxy boxes and
    (S, N) flags -> (depth, scale), each (S, N)."""
    h, w = disp.shape[1:]
    n_streams, n_boxes = boxes.shape[:2]
    flat = boxes.reshape(-1, 4)
    stats = box_stats(disp, box_scalars(boxes, crop, depth_rmin(bf), h, w),
                      crop, bf)
    n = stats[:, 0].to(torch.int32)
    r_vals = f_depth(stats[:, 1:9].to(torch.int32), bf)
    cnt_lt = stats[:, 9:16].to(torch.int32)
    sum_lt = stats[:, 16:23]
    corners = _corner_means(disp, boxes, crop, bf)
    votes = (corners > r_vals[:, 0, None]).sum(1)
    branch = torch.where(votes <= 2, 0, torch.where(votes == 3, 1, 2))
    ws_c, we_c, m_fb = rank_windows(n)
    ms = torch.cat([we_c, ws_c, m_fb[:, None]], 1).clamp(min=1)
    pref = sum_lt + (ms - cnt_lt).to(torch.float32) * r_vals[:, 1:]
    bi = branch[:, None]
    ws = ws_c.gather(1, bi)[:, 0]
    we = we_c.gather(1, bi)[:, 0]
    seg_sum = (torch.where(we > ws, pref.gather(1, bi)[:, 0], 0.0)
               - torch.where(ws > 0, pref.gather(1, bi + 3)[:, 0], 0.0))
    fb_cnt = (n - 1).clamp(min=1).to(torch.float32)
    d = torch.where(we <= ws, pref[:, 6] / fb_cnt,
                    seg_sum / (we - ws).to(torch.float32).clamp(min=1.0))
    x1, y1, x2, y2 = _box_ints(flat)
    bw, bh = x2 - x1, y2 - y1
    skip = (~valid.reshape(-1) | (x1 < 0) | (y1 < 0) | (bw <= 0) | (bh <= 0)
            | (flat[:, 0] >= w) | (flat[:, 1] >= h)
            | (bw.to(torch.float32) > MAX_BOX_W))
    bad = skip | (n < 1)
    d = torch.where(bad, -1.0, d)
    scale = torch.where(bad, 1.0, (d * d).clamp(1.0, 3.0))
    return d.reshape(n_streams, n_boxes), scale.reshape(n_streams, n_boxes)
