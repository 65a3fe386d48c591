"""Camera-motion estimation on the device: plain PyTorch, capturable.

Port of ``stereotracking_tpu/ops/gmc.py`` (the reference's Mesh-Affine
camera-motion compensation with the host's Farneback flow replaced by
per-cell block matching).  Every function takes a leading stream axis S,
has fixed shapes and reads nothing back to the host, so the whole chain
runs inside the step's CUDA graph (models/captured_step.py):

* ``to_small_gray``: BGR -> gray, edge pad and block mean down to
  (size, size), histogram equalization (a 256-bin histogram by
  ``scatter_add_`` into a fixed tensor: ``torch.bincount`` reads its
  maximum back to the host);
* ``mesh_block_flow``: the SSD of every mesh cell at every offset in
  +-search, one pass per row offset; the first-index argmin and the
  parabolic sub-pixel refinement.  The grays hold integers 0-255, so each
  SSD term is an integer and a cell's sum stays below 2^24 (256 * 255^2):
  the SSD and its argmin are exact in any summation order;
* ``ransac_pairs``: the RANSAC hypotheses' point pairs, drawn on the
  device as JAX's ``jax.random.randint(PRNGKey(frame_id), (iters, 2), 0,
  n)`` draws them (Threefry-2x32 with partitionable keys, the default of
  JAX 0.9), bit for bit, in int64 arithmetic masked to 32 bits;
* ``ransac_similarity``: the hypotheses of the given pairs scored, the
  best refitted twice by weighted least squares;
* ``estimate_camera_motion`` and ``apply_warp_to_tracks``.

JAX divides complex numbers by Smith's algorithm and takes the 2x2
determinant from an LU factorisation; here both are written in real
arithmetic (the same Smith steps, the determinant in closed form), so no
complex kernel, cuSOLVER call or host sync enters the graph.  Float32
throughout.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch
import torch.nn.functional as F


class GMCConfig(NamedTuple):
    size: int = 256           # downsampled square side
    step: int = 16            # mesh cell size
    search: int = 8           # +- search radius (pixels, downsampled)
    ransac_iters: int = 128
    ransac_thr: float = 5.0   # reprojection threshold, original pixels
    min_inlier_ratio: float = 0.3
    backend: str = 'device'   # 'device' (this module) | 'opencv' (the
                              # reference's Farneback chain on the host,
                              # ops/gmc_host.py)


def _full(like: torch.Tensor, value) -> torch.Tensor:
    """A float32 device constant of ``like``'s shape (no host-to-device
    copy)."""
    return torch.full_like(like, value, dtype=torch.float32)


def to_small_gray(img_bgr: torch.Tensor, size: int = 256) -> torch.Tensor:
    """(S, H, W, 3) BGR (uint8 or 0-255 float) -> (S, size, size) equalized
    gray, integer-valued float32."""
    s, h, w = img_bgr.shape[:3]
    x = img_bgr.to(torch.float32)
    gray = (0.114 * x[..., 0] + 0.587 * x[..., 1]) + 0.299 * x[..., 2]
    ph, pw = -(-h // size) * size, -(-w // size) * size
    gray = F.pad(gray[:, None], (0, pw - w, 0, ph - h), mode='replicate')
    blocks = gray.reshape(s, size, ph // size, size, pw // size)
    sums = blocks.sum((2, 4))
    # a true division, as jnp.mean's (a scalar divisor would become a
    # reciprocal multiply on the card)
    gray = (sums / _full(sums, (ph // size) * (pw // size))).clamp(0, 255)

    # histogram equalization (cv2.equalizeHist on the floored values)
    g8 = torch.floor(gray).to(torch.int64).reshape(s, -1)
    counts = torch.zeros((s, 256), dtype=torch.int32, device=gray.device)
    counts.scatter_add_(1, g8, torch.ones_like(g8, dtype=torch.int32))
    cdf = torch.cumsum(counts, 1)
    total = cdf[:, -1:]
    nonzero_min = torch.where(counts > 0, cdf, total).amin(1, keepdim=True)
    lut = torch.round((cdf - nonzero_min)
                      / torch.clamp(total - nonzero_min, min=1) * 255.0)
    lut = lut.to(torch.float32).clamp(0, 255)
    return lut.gather(1, g8).reshape(s, size, size)


def block_ssd(prev: torch.Tensor, curr: torch.Tensor, step: int = 16,
              search: int = 8) -> torch.Tensor:
    """(S, n_off, n_off, g, g) SSD of each ``step``-pixel cell of ``prev``
    against ``curr`` shifted by (dy, dx) in [-search, search] (edge
    padding), n_off = 2 search + 1.  One pass per row offset: the
    transient is (S, size, n_off, size) floats."""
    s, size = prev.shape[:2]
    g = size // step
    n_off = 2 * search + 1
    curr_pad = F.pad(curr[:, None], (search,) * 4, mode='replicate')[:, 0]
    rows = []
    for dy in range(n_off):
        band = curr_pad[:, dy:dy + size]                  # (S, size, size+2r)
        shifted = band.unfold(2, size, 1)        # (S, size, n_off, size)
        d = (prev[:, :, None, :] - shifted) ** 2
        rows.append(d.reshape(s, g, step, n_off, g, step).sum((2, 5)))
    # rows: n_off of (S, g, n_off, g) -> (S, dy, dx, gy, gx)
    return torch.stack(rows, 1).permute(0, 1, 3, 2, 4)


def mesh_block_flow(prev: torch.Tensor, curr: torch.Tensor, step: int = 16,
                    search: int = 8) -> Tuple[torch.Tensor, torch.Tensor]:
    """Integer block matching per mesh cell with sub-pixel refinement.

    ``prev``, ``curr``: (S, size, size) integer-valued grays.  Returns
    (src (M, 2), flow (S, M, 2)) in downsampled pixels, M = (size/step)^2
    cells in row-major order, src the cell centres as (x, y)."""
    s, size = prev.shape[:2]
    g = size // step
    n_off = 2 * search + 1
    ssd = block_ssd(prev, curr, step, search)
    best = torch.argmin(ssd.reshape(s, n_off * n_off, g, g), 1)   # first
    by, bx = best // n_off, best % n_off

    # (S, g, g, dy * n_off + dx): the three SSDs around each minimum
    flat = ssd.permute(0, 3, 4, 1, 2).reshape(s, g, g, n_off * n_off)

    def sub(axis_idx, other_idx, along_y):
        i = axis_idx.clamp(1, n_off - 2)

        def at(k):
            idx = k * n_off + other_idx if along_y else other_idx * n_off + k
            return flat.gather(3, idx[..., None])[..., 0]

        c0, c1, c2 = at(i - 1), at(i), at(i + 1)
        denom = c0 - 2 * c1 + c2
        frac = torch.where(denom.abs() > 1e-6,
                           0.5 * (c0 - c2) / torch.clamp(denom, min=1e-6),
                           _full(denom, 0.0))
        return i.to(torch.float32) + frac.clamp(-0.5, 0.5)

    fy = sub(by, bx, True) - search
    fx = sub(bx, by, False) - search
    centres = (torch.arange(g, dtype=torch.float32, device=prev.device)
               + 0.5) * step
    ys, xs = torch.meshgrid(centres, centres, indexing='ij')
    src = torch.stack([xs.reshape(-1), ys.reshape(-1)], -1)
    flow = torch.stack([fx.reshape(s, -1), fy.reshape(s, -1)], -1)
    return src, flow


# ----------------------------------------------------------------- draws ----

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) & _M32) | (x >> (32 - r))


def threefry2x32(k0: torch.Tensor, k1: torch.Tensor, x0: torch.Tensor,
                 x1: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The Threefry-2x32 block function (20 rounds) on int64 tensors that
    hold uint32 values; keys and counters broadcast.  Every sum is masked
    to 32 bits and no product is formed, so nothing nears 2^63."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _M32
    return x0, x1


def ransac_pairs(frame_id: torch.Tensor, iters: int, n: int) -> torch.Tensor:
    """(S,) integer frame ids -> (S, iters, 2) int64 point indices in
    [0, n): ``jax.random.randint(jax.random.PRNGKey(frame_id), (iters, 2),
    0, n)`` bit for bit (JAX 0.9 with ``jax_threefry_partitionable``, its
    default), on the frame ids' device, as a pure function of them.

    The key of a non-negative 32-bit seed is (0, seed); ``randint`` splits
    it into two subkeys (Threefry of the key on the counters (0, 0) and
    (0, 1)), draws 32 random bits per element from each (Threefry of the
    subkey on the counter (0, flat index), the two output words XORed) and
    reduces them to ((hi mod n) * (2^32 mod n) + lo mod n) mod n, with
    2^32 mod n taken as ((2^16 mod n)^2) mod n, as JAX computes it."""
    seed = frame_id.to(torch.int64).reshape(-1, 1, 1) & _M32     # (S, 1, 1)
    zero = torch.zeros_like(seed)
    # split: subkey j = threefry(key, (0, j)), j = 0, 1 -> (S, 2, 1) each word
    j = torch.arange(2, dtype=torch.int64, device=seed.device).reshape(1, 2,
                                                                      1)
    sk0, sk1 = threefry2x32(zero, seed, torch.zeros_like(j), j)
    count = torch.arange(iters * 2, dtype=torch.int64,
                         device=seed.device).reshape(1, 1, -1)
    b0, b1 = threefry2x32(sk0, sk1, torch.zeros_like(count), count)
    bits = b0 ^ b1                                   # (S, 2, iters * 2)
    hi, lo = bits[:, 0], bits[:, 1]
    mult = ((2 ** 16 % n) ** 2) % n
    off = ((hi % n) * mult + lo % n) % n
    return off.reshape(-1, iters, 2)


# ---------------------------------------------------------------- RANSAC ----

def _complex_div(ar, ai, br, bi):
    """(ar + i ai) / (br + i bi) by Smith's algorithm, as XLA divides
    complex numbers (finite operands)."""
    swap = br.abs() < bi.abs()
    ratio = torch.where(swap, br / bi, bi / br)
    denom = torch.where(swap, bi + br * ratio, br + bi * ratio)
    re = torch.where(swap, (ar * ratio + ai) / denom,
                     (ar + ai * ratio) / denom)
    im = torch.where(swap, (ai * ratio - ar) / denom,
                     (ai - ar * ratio) / denom)
    return re, im


def _warp(a, b, tx, ty) -> torch.Tensor:
    """[[a, -b, tx], [b, a, ty]] with the leading axes of its parts."""
    return torch.stack([torch.stack([a, -b, tx], -1),
                        torch.stack([b, a, ty], -1)], -2)


def _similarity_from_pairs(p1, p2, q1, q2) -> torch.Tensor:
    """4-DoF transforms mapping (p1, p2) -> (q1, q2); points (..., 2)."""
    pr, pi = p2[..., 0] - p1[..., 0], p2[..., 1] - p1[..., 1]
    qr, qi = q2[..., 0] - q1[..., 0], q2[..., 1] - q1[..., 1]
    tiny = torch.hypot(pr, pi) < 1e-9
    pr = torch.where(tiny, _full(pr, 1e-9), pr)
    pi = torch.where(tiny, _full(pi, 0.0), pi)
    a, b = _complex_div(qr, qi, pr, pi)
    tx = q1[..., 0] - (a * p1[..., 0] - b * p1[..., 1])
    ty = q1[..., 1] - (b * p1[..., 0] + a * p1[..., 1])
    return _warp(a, b, tx, ty)


def _similarity_lstsq(src, dst, w) -> torch.Tensor:
    """Weighted least-squares 4-DoF fits dst ~ [a -b; b a] src + t per
    stream: ``src`` (S, n, 2), ``dst`` (S, n, 2), ``w`` (S, n)."""
    sw = torch.clamp(w.sum(-1), min=1e-6)
    mx = (w * src[..., 0]).sum(-1) / sw
    my = (w * src[..., 1]).sum(-1) / sw
    nx = (w * dst[..., 0]).sum(-1) / sw
    ny = (w * dst[..., 1]).sum(-1) / sw
    sx, sy = src[..., 0] - mx[:, None], src[..., 1] - my[:, None]
    dx, dy = dst[..., 0] - nx[:, None], dst[..., 1] - ny[:, None]
    denom = (w * (sx * sx + sy * sy)).sum(-1) + 1e-9
    a = (w * (sx * dx + sy * dy)).sum(-1) / denom
    b = (w * (sx * dy - sy * dx)).sum(-1) / denom
    tx = nx - (a * mx - b * my)
    ty = ny - (b * mx + a * my)
    return _warp(a, b, tx, ty)


def _sq_err(src, dst, H) -> torch.Tensor:
    """Squared reprojection error of ``src`` under warps ``H`` (..., 2, 3)
    against ``dst``: src (..., n, 2) -> (..., n)."""
    px = (src[..., 0] * H[..., 0, 0:1] + src[..., 1] * H[..., 0, 1:2]
          + H[..., 0, 2:3])
    py = (src[..., 0] * H[..., 1, 0:1] + src[..., 1] * H[..., 1, 1:2]
          + H[..., 1, 2:3])
    return (px - dst[..., 0]) ** 2 + (py - dst[..., 1]) ** 2


def ransac_similarity(src: torch.Tensor, dst: torch.Tensor,
                      pairs: torch.Tensor, thr: float = 5.0
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fixed-iteration RANSAC similarity per stream: ``src``, ``dst`` (S, n,
    2), ``pairs`` (S, iters, 2) point indices (``ransac_pairs``).  Each
    pair's transform scores its inliers (squared error below thr^2); the
    first best is refitted on its inliers, then once more on the refit's.
    Returns (warps (S, 2, 3), inlier ratios (S,))."""
    s, n = src.shape[:2]
    i, j = pairs[..., 0], pairs[..., 1]

    def take(pts, idx):
        return pts.gather(1, idx[..., None].expand(-1, -1, 2))

    H = _similarity_from_pairs(take(src, i), take(src, j), take(dst, i),
                               take(dst, j))           # (S, iters, 2, 3)
    thr2 = thr * thr
    inl = _sq_err(src[:, None], dst[:, None], H) < thr2       # (S, iters, n)
    best = torch.argmax(inl.sum(-1), 1)                       # first
    w = inl.gather(1, best[:, None, None].expand(-1, 1, n))[:, 0]
    H = _similarity_lstsq(src, dst, w.to(torch.float32))
    w2 = (_sq_err(src, dst, H) < thr2).to(torch.float32)
    H = _similarity_lstsq(src, dst, w2)
    return H, w2.sum(-1) / _full(w2[:, 0], n)


def estimate_camera_motion(prev_small: torch.Tensor,
                           curr_small: torch.Tensor, ori_h: int, ori_w: int,
                           frame_id: torch.Tensor,
                           cfg: GMCConfig = GMCConfig()
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The chain on downsampled grays (S, size, size) -> (warps (S, 2, 3)
    in original pixels, inlier ratios (S,)), the RANSAC pairs drawn from
    ``frame_id`` (S,) as JAX draws them from ``PRNGKey(frame_id)``.  The
    caller gates on ratio >= cfg.min_inlier_ratio."""
    src_s, flow_s = mesh_block_flow(prev_small, curr_small, cfg.step,
                                    cfg.search)
    # float32 divisions of the frame size, as JAX's; host constants, so
    # nothing is copied to the device
    fx = float(np.float32(ori_w) / np.float32(cfg.size))
    fy = float(np.float32(ori_h) / np.float32(cfg.size))

    def scaled(p):
        return torch.stack([p[..., 0] * fx, p[..., 1] * fy], -1)

    src = scaled(src_s).expand(flow_s.shape)
    dst = scaled(src_s + flow_s)
    pairs = ransac_pairs(frame_id, cfg.ransac_iters, src.shape[1])
    return ransac_similarity(src, dst, pairs, cfg.ransac_thr)


def gated_warp(H: torch.Tensor, ratio: torch.Tensor,
               min_inlier_ratio: float) -> torch.Tensor:
    """``H`` where its inlier ratio reaches ``min_inlier_ratio``, else the
    identity (JAX ``OCSORTDisparity._gated_warp``)."""
    ident = torch.zeros_like(H)
    ident[:, 0, 0] = 1.0
    ident[:, 1, 1] = 1.0
    return torch.where((ratio >= min_inlier_ratio)[:, None, None], H, ident)


def apply_warp_to_tracks(mean: torch.Tensor, cov: torch.Tensor,
                         warp: torch.Tensor, mask: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """A 2x3 similarity applied to cxcyah Kalman states where ``mask``
    (reference apply_gmc_to_tracks_cxcyah): ``mean`` (S, K, 8), ``cov``
    (S, K, 8, 8), ``warp`` (S, 2, 3), ``mask`` (S, K).  Elsewhere the
    states are returned bit for bit."""
    R = warp[:, :, :2]
    t = warp[:, :, 2]
    det = R[:, 0, 0] * R[:, 1, 1] - R[:, 0, 1] * R[:, 1, 0]
    s = torch.sqrt(torch.clamp(det, min=1e-12))[:, None]        # (S, 1)
    Rb = R[:, None]                                             # (S, 1, 2, 2)

    def rot(v):                                                 # v @ R.T
        x, y = v[..., 0], v[..., 1]
        return torch.stack([x * Rb[..., 0, 0] + y * Rb[..., 0, 1],
                            x * Rb[..., 1, 0] + y * Rb[..., 1, 1]], -1)

    new_mean = torch.cat([rot(mean[..., 0:2]) + t[:, None],
                          mean[..., 2:3], mean[..., 3:4] * s[..., None],
                          rot(mean[..., 4:6]), mean[..., 6:7],
                          mean[..., 7:8] * s[..., None]], -1)
    R8 = torch.eye(8, dtype=mean.dtype, device=mean.device).repeat(
        warp.shape[0], 1, 1)
    R8[:, 0:2, 0:2] = R
    R8[:, 4:6, 4:6] = R
    R8[:, 3, 3] = s[:, 0]
    R8[:, 7, 7] = s[:, 0]
    R8 = R8[:, None]
    new_cov = R8 @ cov @ R8.transpose(-1, -2)
    return (torch.where(mask[..., None], new_mean, mean),
            torch.where(mask[..., None, None], new_cov, cov))
