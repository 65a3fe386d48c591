"""Exact linear assignment with ``lap.lapjv`` cost-limit semantics, on the
inputs' device.

Port of ``stereotracking_tpu/ops/assignment.py``: the trivially-optimal
component fast paths (rows with no candidate, private-star rows) as tensor
ops, then the shortest-augmenting-path Jonker-Volgenant solver on the
K x (N + K) embedding for the rows left (``assignment_cuda.jv_assign``: a
CUDA kernel for CUDA tensors, its numpy plain version for CPU tensors),
with the same float32 arithmetic and the same first-index argmin tie
order, so matches and track ids agree with the JAX package.  Nothing here
reads a value back to the host: all streams' problems go to one launch and
the results stay on the device.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .assignment_cuda import jv_assign, solve_rect_lap

_BIG = 1e4      # forbidden-pair cost
_INF = 1e18     # argmin sentinel


def solve_square_lap(cost: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Exact square LAP in numpy: (row_to_col, col_to_row)."""
    cost = np.asarray(cost, np.float32)
    return solve_rect_lap(cost, np.ones((cost.shape[0],), bool))


def _scatter_rows(idx: torch.Tensor, n: int) -> torch.Tensor:
    """Per stream, col[idx[i]] = i for idx (S, K) in [0, n] (n = drop)
    -> (S, n) int32, -1 where no row points."""
    s, k = idx.shape
    out = torch.full((s, n + 1), -1, dtype=torch.int32, device=idx.device)
    rows = torch.arange(k, dtype=torch.int32, device=idx.device)
    out.scatter_(1, idx.long(), rows.expand(s, k).contiguous())
    return out[:, :n]


def jv_problem(cost: torch.Tensor, row_mask: torch.Tensor,
               col_mask: torch.Tensor, cost_limit: float):
    """The fast paths of ``linear_assignment_with_limit`` for (S, K, N)
    costs and (S, K) / (S, N) masks -> (ext, need_jv, star, star_col): the
    (S, K, N + K) embedding and the rows the JV must assign, and the
    private-star rows with their cheapest column."""
    s, k, n = cost.shape
    dev = cost.device
    f32 = torch.float32
    costf = cost.float()
    limit = torch.full((), cost_limit, dtype=f32, device=dev)

    candidate = row_mask[:, :, None] & col_mask[:, None, :] & (costf < limit)
    row_deg = candidate.sum(2)
    col_private = candidate.sum(1) == 1
    star = row_mask & (row_deg > 0) & (
        ~candidate | col_private[:, None, :]).all(2)
    star_col = torch.where(candidate, costf,
                           torch.full((), _INF, dtype=f32, device=dev)
                           ).argmin(2).to(torch.int32)
    need_jv = row_mask & (row_deg > 0) & ~star

    taken = _scatter_rows(torch.where(star, star_col, n), n) >= 0
    col_mask2 = col_mask & ~taken
    real = torch.where(need_jv[:, :, None] & col_mask2[:, None, :],
                       costf - limit,
                       torch.full((), _BIG, dtype=f32, device=dev))
    ext = torch.cat([real, torch.zeros((s, k, k), dtype=f32, device=dev)], 2)
    return ext, need_jv, star, star_col


def linear_assignment_with_limit(cost: torch.Tensor, row_mask: torch.Tensor,
                                 col_mask: torch.Tensor, cost_limit: float
                                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Masked rectangular LAP with ``lap.lapjv`` cost-limit semantics.

    cost (..., K, N), row_mask (..., K), col_mask (..., N), optional
    leading stream dims -> (row_assign (..., K), col_assign (..., N)) int32
    on the inputs' device, -1 = unmatched; pairs at or above the limit
    never match.  All streams' JV problems are one kernel launch."""
    lead = cost.shape[:-2]
    k, n = cost.shape[-2:]
    col_mask = col_mask.reshape(-1, n)
    ext, need_jv, star, star_col = jv_problem(
        cost.reshape(-1, k, n), row_mask.reshape(-1, k), col_mask,
        cost_limit)
    row2col = jv_assign(ext, need_jv)

    row_assign = torch.where(need_jv & (row2col < n) & (row2col >= 0),
                             row2col, -1)
    row_assign = torch.where(star, star_col, row_assign)
    ok = (row_assign >= 0) & col_mask.gather(
        1, row_assign.clamp(0, n - 1).long())
    row_assign = torch.where(ok, row_assign, -1).to(torch.int32)
    col_assign = _scatter_rows(torch.where(row_assign >= 0, row_assign, n), n)
    return row_assign.reshape(*lead, k), col_assign.reshape(*lead, n)
