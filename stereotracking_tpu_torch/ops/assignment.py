"""Exact linear assignment with ``lap.lapjv`` cost-limit semantics, on host.

Port of ``stereotracking_tpu/ops/assignment.py``: the trivially-optimal
component fast paths, then the shortest-augmenting-path Jonker-Volgenant
solver on the K x (N + K) embedding, with the same float32 arithmetic and
the same first-index argmin tie order, so matches and track ids agree with
the JAX package.  The solver runs in numpy on a CPU copy of the cost
matrix: one device-to-host copy (a sync) per call when the inputs live on
the GPU, for all the streams of a batch, and one asynchronous copy of the
results back.  A device solver is later work.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..utils.devices import to_device

_BIG = np.float32(1e4)      # forbidden-pair cost
_INF = np.float32(1e18)     # Dijkstra sentinel


def _assign_row(cost, u, v, col2row, row2col, i):
    """Augment row ``i`` into the assignment (in place)."""
    k, c = cost.shape
    minv = cost[i] - u[i] - v
    way = np.full((c,), -1, np.int32)
    used = np.zeros((c,), bool)
    row_used = np.zeros((k,), bool)
    j0 = int(np.argmin(minv))
    delta = minv[j0]
    u[i] += delta
    minv = minv - delta
    while col2row[j0] != -1:
        used[j0] = True
        i0 = col2row[j0]
        row_used[i0] = True
        cur = cost[i0] - u[i0] - v
        improve = ~used & (cur < minv)
        minv = np.where(improve, cur, minv)
        way = np.where(improve, np.int32(j0), way)
        masked = np.where(used, _INF, minv)
        j1 = int(np.argmin(masked))
        delta = masked[j1]
        u[row_used] += delta
        u[i] += delta
        v[used] -= delta
        minv = np.where(used, minv, minv - delta)
        j0 = j1
    while True:
        jprev = way[j0]
        new_row = i if jprev == -1 else col2row[max(jprev, 0)]
        col2row[j0] = new_row
        row2col[new_row] = j0
        if jprev == -1:
            break
        j0 = jprev


def solve_rect_lap(cost: np.ndarray, scan_mask: np.ndarray
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """JV for a K x C float32 problem (K <= C), rows of ``scan_mask``
    assigned in ascending order; returns (row2col, col2row)."""
    k, c = cost.shape
    u = np.zeros((k,), np.float32)
    v = np.zeros((c,), np.float32)
    col2row = np.full((c,), -1, np.int32)
    row2col = np.full((k,), -1, np.int32)
    for i in np.flatnonzero(scan_mask):
        _assign_row(cost, u, v, col2row, row2col, int(i))
    return row2col, col2row


def solve_square_lap(cost: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Exact square LAP: (row_to_col, col_to_row)."""
    cost = np.asarray(cost, np.float32)
    return solve_rect_lap(cost, np.ones((cost.shape[0],), bool))


def linear_assignment_np(cost: np.ndarray, row_mask: np.ndarray,
                         col_mask: np.ndarray, cost_limit: float
                         ) -> Tuple[np.ndarray, np.ndarray]:
    """Masked rectangular LAP with ``lap.lapjv`` cost-limit semantics on
    numpy arrays -> (row_assign (K,), col_assign (N,)), -1 = unmatched."""
    k, n = cost.shape
    limit = np.float32(cost_limit)
    costf = cost.astype(np.float32)
    candidate = row_mask[:, None] & col_mask[None, :] & (costf < limit)
    row_deg = candidate.sum(1)
    col_private = candidate.sum(0) == 1
    star = row_mask & (row_deg > 0) & np.all(
        ~candidate | col_private[None, :], axis=1)
    star_col = np.argmin(np.where(candidate, costf, _INF), axis=1)
    need_jv = row_mask & (row_deg > 0) & ~star

    taken = np.zeros((n,), bool)
    taken[star_col[star]] = True
    col_mask2 = col_mask & ~taken
    real = np.where(need_jv[:, None] & col_mask2[None, :], costf - limit,
                    _BIG).astype(np.float32)
    ext = np.concatenate([real, np.zeros((k, k), np.float32)], axis=1)
    row2col, _ = solve_rect_lap(ext, need_jv)

    row_assign = np.where(need_jv & (row2col < n) & (row2col >= 0),
                          row2col, -1)
    row_assign = np.where(star, star_col, row_assign)
    ok = (row_assign >= 0) & col_mask[np.clip(row_assign, 0, n - 1)]
    row_assign = np.where(ok, row_assign, -1).astype(np.int32)
    col_assign = np.full((n,), -1, np.int32)
    rows = np.flatnonzero(row_assign >= 0)
    col_assign[row_assign[rows]] = rows
    return row_assign, col_assign


def linear_assignment_with_limit(cost: torch.Tensor, row_mask: torch.Tensor,
                                 col_mask: torch.Tensor, cost_limit: float
                                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``linear_assignment_np`` on tensors with optional leading stream
    dims: cost (..., K, N), row_mask (..., K), col_mask (..., N) ->
    (row_assign (..., K), col_assign (..., N)) int32 on the inputs' device.
    All streams' problems go to the host in one copy and come back in one."""
    dev = cost.device
    lead = cost.shape[:-2]
    k, n = cost.shape[-2:]
    s = int(np.prod(lead, dtype=np.int64))
    packed = torch.cat([cost.float().reshape(s, k * n),
                        row_mask.reshape(s, k).float(),
                        col_mask.reshape(s, n).float()], 1).cpu().numpy()
    both = np.empty((s, k + n), np.int32)
    for i, row in enumerate(packed):                 # one sync above
        ra, ca = linear_assignment_np(row[:k * n].reshape(k, n),
                                      row[k * n:k * n + k] > 0.5,
                                      row[k * n + k:] > 0.5, cost_limit)
        both[i, :k], both[i, k:] = ra, ca
    both = to_device(both, dev)
    return both[:, :k].reshape(*lead, k), both[:, k:].reshape(*lead, n)
