"""The reference's camera-motion chain on the host, through OpenCV.

The port's own copy of ``stereotracking_tpu/ops/gmc_host.py`` (numpy and
OpenCV only; ``cv2`` is imported inside the function): resize both frames
to 255x255, histogram-equalized grayscale, Farneback dense flow (pyr_scale
0.5 / 5 levels / 3 iterations / poly 5 / sigma 1.2), per-16px mesh-cell
median flow, then a RANSAC 4-DoF ``estimateAffinePartial2D`` on the cell
centres in original-image pixels.  It serves ``GMCConfig(backend=
'opencv')``: the warp is computed on the host before the step and enters
the step's CUDA graph as an input (models/captured_step.py).  It takes
numpy frames; a tensor on a device raises.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def host_frame(frame) -> np.ndarray:
    """A frame as a numpy array; a tensor on the CPU is taken as it is, and
    a tensor on a device raises: reading it back would be a host sync in
    the step."""
    if isinstance(frame, np.ndarray):
        return frame
    if getattr(frame, 'device', None) is not None:
        if frame.device.type != 'cpu':
            raise ValueError(
                "camera-motion backend 'opencv' runs on the host: give it "
                f'numpy frames, not a tensor on {frame.device} (reading '
                'it back would stall the step)')
        return frame.numpy()
    return np.asarray(frame)


def glme_affine_host(prev_bgr: np.ndarray, curr_bgr: np.ndarray,
                     step: int = 16, winsize: int = 31,
                     ransac_thr: float = 5.0,
                     min_inlier_ratio: float = 0.3
                     ) -> Tuple[Optional[np.ndarray], float]:
    """(H, W, 3) uint8 BGR frames -> (2x3 affine in original pixels | None,
    inlier ratio).  ``None`` when RANSAC fails or the inlier ratio is below
    ``min_inlier_ratio`` (callers then skip the warp)."""
    import cv2

    prev_bgr, curr_bgr = host_frame(prev_bgr), host_frame(curr_bgr)
    ori_h, ori_w = curr_bgr.shape[:2]
    side = 255
    fx, fy = ori_w / side, ori_h / side

    grays = []
    for frame in (prev_bgr, curr_bgr):
        small = cv2.resize(np.ascontiguousarray(frame[..., :3]),
                           (side, side))
        grays.append(cv2.equalizeHist(
            cv2.cvtColor(small, cv2.COLOR_BGR2GRAY)))
    prev_gray, curr_gray = grays

    flow = cv2.calcOpticalFlowFarneback(
        prev_gray, curr_gray, None, pyr_scale=0.5, levels=5,
        winsize=winsize, iterations=3, poly_n=5, poly_sigma=1.2, flags=0)
    flow = flow * np.array([fx, fy], np.float32)

    grid = side // step
    crop = flow[:grid * step, :grid * step]
    mesh = np.median(crop.reshape(grid, step, grid, step, 2),
                     axis=(1, 3)).reshape(-1, 2)

    ys, xs = np.mgrid[0:grid, 0:grid]
    centers = np.stack([(xs + 0.5) * step * fx,
                        (ys + 0.5) * step * fy],
                       axis=-1).reshape(-1, 2).astype(np.float32)
    moved = (centers + mesh).astype(np.float32)

    warp, inliers = cv2.estimateAffinePartial2D(
        centers, moved, method=cv2.RANSAC,
        ransacReprojThreshold=ransac_thr)
    if warp is None or inliers is None:
        return None, 0.0
    ratio = float(inliers.sum()) / len(centers)
    if ratio < min_inlier_ratio:
        return None, ratio
    return warp.astype(np.float32), ratio
