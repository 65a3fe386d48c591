"""Synthetic stereo video from a seed, as a camera's decoder hands it over.

Each stream has a fixed background: noise in the image, invalid disparity
(65535) in the upper half and random fixed-point disparity (raw 16-1599,
i.e. 1-100 px) in the lower half; over it ``objects`` bright rectangles
with a constant raw disparity each move at a constant velocity.  ``ring``
frames are made per stream; the benchmark plays them forward then backward,
so the motion stays continuous.  Frames lie step-major in pageable host
memory: ``imgs[r]`` is the (S, H, W, 3) uint8 BGR of ring step r and
``disps[r]`` the (S, H, W) uint16 disparity, each one contiguous block.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

OBJ_H, OBJ_W = 30, 40


def make_video(n_streams: int, h: int, w: int, ring: int, seed: int,
               objects: int = 6, speed: float = 4.0
               ) -> Tuple[np.ndarray, np.ndarray]:
    """(imgs (R, S, H, W, 3) uint8, disps (R, S, H, W) uint16)."""
    rng = np.random.default_rng(seed)
    bg = rng.integers(0, 256, (n_streams, h, w, 3), dtype=np.uint8)
    bgd = np.full((n_streams, h, w), 65535, np.uint16)
    bgd[:, h // 2:] = rng.integers(16, 1600, (n_streams, h - h // 2, w),
                                   dtype=np.uint16)
    imgs = np.empty((ring, n_streams, h, w, 3), np.uint8)
    disps = np.empty((ring, n_streams, h, w), np.uint16)
    imgs[:] = bg
    disps[:] = bgd
    oh, ow = min(OBJ_H, h), min(OBJ_W, w)
    for s in range(n_streams):
        pos = rng.uniform((0, 0), (h - oh, w - ow), (objects, 2))
        vel = rng.uniform(-speed, speed, (objects, 2))
        color = rng.integers(100, 256, (objects, 3), dtype=np.uint8)
        raw = rng.integers(40, 800, objects).astype(np.uint16)
        for r in range(ring):
            for k in range(objects):
                y, x = np.clip(pos[k] + r * vel[k], 0, (h - oh, w - ow))
                y, x = int(y), int(x)
                imgs[r, s, y:y + oh, x:x + ow] = color[k]
                disps[r, s, y:y + oh, x:x + ow] = raw[k]
    return imgs, disps


def ring_index(t: int, ring: int) -> int:
    """The ring step that step ``t`` plays: 0, 1, ..., R-1, R-2, ..., 1, 0,
    1, ..."""
    if ring == 1:
        return 0
    k = t % (2 * ring - 2)
    return k if k < ring else 2 * ring - 2 - k


def rescale(src_hw, img_scale) -> Tuple[Tuple[int, int], Tuple[float, float]]:
    """The keep-ratio resize of a ``src_hw`` frame to fit ``img_scale``
    (the long side to the longer of the two, the short to the shorter), as
    the eval loop does it: the resized (h, w) and the scale factor
    (sf_x, sf_y) that maps boxes back to the source frame."""
    h, w = src_hw
    long_s, short_s = max(img_scale), min(img_scale)
    f = min(long_s / max(h, w), short_s / min(h, w))
    nh, nw = int(h * f + 0.5), int(w * f + 0.5)
    return (nh, nw), (nw / w, nh / h)
