"""Jonker-Volgenant assignment of S streams' problems: CUDA kernel + plain
version.

Replaces the JAX package's device JV, ``_solve_rect_lap`` with a scan mask
(``stereotracking_tpu/ops/assignment.py:107``, reached through
``linear_assignment_with_limit``, ``:209``): for each stream the K x C
float32 problem, the rows of ``need`` assigned in ascending order by
shortest augmenting paths.  ``jv_assign`` launches ``csrc/assignment.cu``
(one warp per stream, all streams in one launch; the instance chosen by
shape, ``jv_instance``) on CUDA tensors and runs ``jv_assign_plain``, the
numpy solver the JAX package's ids were matched against, on CPU tensors.
The two are bit-exact: the kernel keeps the plain version's float32
operation order and first-index argmin.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .. import _kernels

_INF = np.float32(1e18)     # Dijkstra sentinel
MAX_COLUMNS = 1024
STAGE_BYTES = 192 * 1024    # the largest cost matrix staged in shared memory


def jv_instance(k: int, c: int) -> Tuple[int, bool]:
    """(columns per lane, staged) of the kernel instance that ``jv_assign``
    launches for a K x C problem: each lane of the stream's warp holds the
    least of 4, 8, 16, 32 columns that covers C, and the cost matrix is
    copied into shared memory when its K * C * 4 bytes fit in
    ``STAGE_BYTES``, else its rows are read from global memory."""
    cpl = next(n for n in (4, 8, 16, 32) if 32 * n >= c)
    return cpl, k * c * 4 <= STAGE_BYTES


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
    assigned in ascending order; returns (row2col, col2row), -1 where
    unassigned."""
    k, c = cost.shape
    u = np.zeros((k,), np.float32)
    v = np.zeros((c,), np.float32)
    col2row = np.full((c,), -1, np.int32)
    row2col = np.full((k,), -1, np.int32)
    for i in np.flatnonzero(scan_mask):
        _assign_row(cost, u, v, col2row, row2col, int(i))
    return row2col, col2row


def jv_assign_plain(cost: torch.Tensor, need: torch.Tensor) -> torch.Tensor:
    """``jv_assign`` in numpy, stream by stream, on CPU tensors."""
    c = cost.numpy()
    m = need.numpy()
    return torch.from_numpy(np.stack([solve_rect_lap(c[s], m[s])[0]
                                      for s in range(c.shape[0])]))


def jv_assign(cost: torch.Tensor, need: torch.Tensor) -> torch.Tensor:
    """(S, K, C) float32 costs and (S, K) bool rows to assign (K <= C <=
    1024) -> (S, K) int32 row2col, -1 for the rows not assigned.  CPU
    tensors run ``jv_assign_plain``; CUDA tensors launch the kernel."""
    if cost.dim() != 3 or cost.dtype != torch.float32:
        raise ValueError(f'cost must be (S, K, C) float32, got '
                         f'{tuple(cost.shape)} {cost.dtype}')
    n, k, c = cost.shape
    if need.shape != (n, k) or need.dtype != torch.bool:
        raise ValueError(f'need must be ({n}, {k}) bool, got '
                         f'{tuple(need.shape)} {need.dtype}')
    if not k <= c <= MAX_COLUMNS:
        raise ValueError(f'jv_assign takes K <= C <= {MAX_COLUMNS}, got '
                         f'K={k} C={c}')
    if cost.device.type == 'cpu':
        return jv_assign_plain(cost, need)
    cost, need = cost.contiguous(), need.contiguous()
    _kernels.require_cuda('jv_assign', cost, need)
    row2col = torch.empty((n, k), dtype=torch.int32, device=cost.device)
    if n == 0 or k == 0:
        return row2col
    status = _kernels.library().st_jv_assign(
        cost.data_ptr(), need.data_ptr(), n, k, c, row2col.data_ptr(),
        _kernels.stream_ptr(cost))
    _kernels.check(status, 'jv_assign')
    _kernels.count_launch('assignment')
    return row2col
