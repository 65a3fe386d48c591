"""Tracklet post-processing: ByteTrack linear interpolation and StrongSORT
GSI (Gaussian-smoothed interpolation), the eval CLI's ``--interpolate``.

The port's own copy of ``stereotracking_tpu/evaluation/postprocess.py``
(numpy and scipy only, host-side like the reference's
``InterpolateTracklets``):

* ``interpolate_track_rows``: fill frame gaps with ``1 < gap <
  max_num_frames`` (strict upper bound) by linear interpolation, only for
  tracks longer than ``min_num_frames`` (strict); tracks with <= 2 rows are
  dropped entirely;
* ``gaussian_smoothed_interpolation``: the exact Gaussian-process
  regression posterior mean ``K (K + alpha I)^-1 y`` with ``K[i, j] =
  exp(-(t_i - t_j)^2 / (2 ls^2))`` and ``ls = clip(tau * log(tau^3 / N),
  1/tau, tau^2)``, by a small Cholesky solve;
* ``interpolate_tracklets``: the adapter over the MOT metrics'
  ``{frame: (ids, boxes)}`` buffers.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import scipy.linalg


def gpr_rbf_posterior_mean(t: np.ndarray, y: np.ndarray, length_scale: float,
                           alpha: float = 1e-10) -> np.ndarray:
    """GPR posterior mean at the training inputs themselves.

    ``t`` (N,) inputs, ``y`` (N,) or (N, D) targets. Equals
    ``sklearn.gaussian_process.GaussianProcessRegressor(RBF(ls, 'fixed'))
    .fit(t, y).predict(t)`` (zero prior mean, no y-normalization)."""
    t = np.asarray(t, np.float64).reshape(-1)
    d = t[:, None] - t[None, :]
    k = np.exp(-(d ** 2) / (2.0 * length_scale ** 2))
    c = scipy.linalg.cho_factor(k + alpha * np.eye(len(t)), lower=True)
    return k @ scipy.linalg.cho_solve(c, np.asarray(y, np.float64))


def gsi_length_scale(num_rows: int, smooth_tau: float = 10.0) -> float:
    """interpolation.py:103-104."""
    return float(np.clip(smooth_tau * np.log(smooth_tau ** 3 / num_rows),
                         smooth_tau ** -1, smooth_tau ** 2))


def interpolate_track_rows(track: np.ndarray, track_id: int,
                           max_num_frames: int = 20) -> np.ndarray:
    """ByteTrack linear gap fill on (N, 7) rows
    (frame, id, x1, y1, x2, y2, score) — interpolation.py:33-82.
    Interpolated rows carry score 1.0 (``np.ones`` template, :69)."""
    track = np.asarray(track, np.float64)
    assert (track[:, 1] == track_id).all()
    frame_ids = track[:, 0]
    filled = np.zeros((0, 7))
    for i in np.where(np.diff(frame_ids) > 1)[0]:
        gap = int(frame_ids[i + 1] - frame_ids[i])
        if 1 < gap < max_num_frames:
            left, right = track[i, 2:6], track[i + 1, 2:6]
            for j in range(1, gap):
                row = np.ones((7,))
                row[0] = frame_ids[i] + j
                row[1] = track_id
                row[2:6] = left + (j / gap) * (right - left)
                filled = np.concatenate((filled, row[None]), axis=0)
    return np.concatenate((track, filled), axis=0)


def gaussian_smoothed_interpolation(track: np.ndarray,
                                    smooth_tau: float = 10.0) -> np.ndarray:
    """Exact GSI on (N, 7) rows (interpolation.py:84-124): smooth each box
    coordinate with the GPR posterior mean over frame id."""
    track = np.asarray(track, np.float64)
    ls = gsi_length_scale(len(track), smooth_tau)
    out = track.copy()
    out[:, 2:6] = gpr_rbf_posterior_mean(track[:, 0], track[:, 2:6], ls)
    return out


def interpolate_tracks(pred_tracks: np.ndarray, min_num_frames: int = 5,
                       max_num_frames: int = 20, use_gsi: bool = False,
                       smooth_tau: float = 10.0) -> np.ndarray:
    """The reference ``InterpolateTracklets.forward`` on (N, 7) rows
    (interpolation.py:125-161): per id — skip tracks with <= 2 rows, gap
    fill when longer than ``min_num_frames``, optional GSI — then sort by
    frame."""
    pred_tracks = np.asarray(pred_tracks, np.float64)
    out = []
    lo = int(pred_tracks[:, 1].min())
    hi = int(pred_tracks[:, 1].max())
    for tid in range(lo, hi + 1):
        track = pred_tracks[pred_tracks[:, 1] == tid]
        if len(track) <= 2:
            continue
        if len(track) > min_num_frames:
            track = interpolate_track_rows(track, tid, max_num_frames)
        if use_gsi:
            track = gaussian_smoothed_interpolation(track, smooth_tau)
        out.append(track)
    out = np.concatenate(out) if out else np.zeros((0, 7))
    return out[out[:, 0].argsort(kind='stable')]


def interpolate_tracklets(frames: Dict[int, Tuple[np.ndarray, np.ndarray]],
                          min_num_frames: int = 5,
                          max_num_frames: int = 20,
                          use_gsi: bool = False,
                          gsi_tau: float = 10.0
                          ) -> Dict[int, Tuple[np.ndarray, np.ndarray]]:
    """Dict-of-frames adapter over :func:`interpolate_tracks` for the MOT
    metrics' ``{frame: (ids, boxes)}`` buffers."""
    rows = []
    for f in sorted(frames):
        ids, boxes = frames[f]
        for i, b in zip(np.asarray(ids, float), np.asarray(boxes, float)):
            rows.append([f, i, b[0], b[1], b[2], b[3], 1.0])
    out: Dict[int, list] = {f: [] for f in frames}
    if rows:
        for row in interpolate_tracks(np.asarray(rows), min_num_frames,
                                      max_num_frames, use_gsi, gsi_tau):
            out.setdefault(int(row[0]), []).append((int(row[1]), row[2:6]))
    return {
        f: (np.array([t for t, _ in items], int),
            np.stack([b for _, b in items]) if items else np.zeros((0, 4)))
        for f, items in out.items()
    }
