"""Batched constant-velocity Kalman filter over (cx, cy, a, h) box states.

Port of ``stereotracking_tpu/models/kalman.py``: the same std-weight scheme
and equations over a bank of K slots, float32.  State per slot: mean (8,) =
[cx, cy, a, h, vcx, vcy, va, vh], covariance (8, 8).
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

CHI2INV95 = {
    1: 3.8415, 2: 5.9915, 3: 7.8147, 4: 9.4877, 5: 11.070,
    6: 12.592, 7: 14.067, 8: 15.507, 9: 16.919,
}

_STD_WEIGHT_POS = 1.0 / 20
_STD_WEIGHT_VEL = 1.0 / 160


class KalmanParams(NamedTuple):
    """Static config of the filter (hyperparameters only, no state)."""
    center_only: bool = False
    use_nsa: bool = False

    @property
    def gating_threshold(self) -> float:
        return CHI2INV95[2] if self.center_only else CHI2INV95[4]


def _motion_mat(device) -> torch.Tensor:
    """F: identity plus the position <- velocity couplings."""
    one = torch.ones(4, dtype=torch.float32, device=device)
    return torch.eye(8, dtype=torch.float32, device=device) + \
        torch.diag(one, 4)


def _diag(std: torch.Tensor) -> torch.Tensor:
    return torch.diag_embed(std.square())


def _cholesky(a: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor without an error check: the filter runs over
    every slot, empty ones included (not positive definite), and masks
    their results afterwards, as the JAX filter does with its NaNs.  No
    check also means no device-to-host sync."""
    return torch.linalg.cholesky_ex(a, check_errors=False).L


def initiate(measurement: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(mean, cov) from a cxcyah measurement, batched over leading dims."""
    mean = torch.cat([measurement, torch.zeros_like(measurement)], dim=-1)
    h = measurement[..., 3]
    std = torch.stack([
        2 * _STD_WEIGHT_POS * h, 2 * _STD_WEIGHT_POS * h,
        torch.full_like(h, 1e-2), 2 * _STD_WEIGHT_POS * h,
        10 * _STD_WEIGHT_VEL * h, 10 * _STD_WEIGHT_VEL * h,
        torch.full_like(h, 1e-5), 10 * _STD_WEIGHT_VEL * h,
    ], dim=-1)
    return mean.float(), _diag(std).float()


def predict(mean: torch.Tensor, cov: torch.Tensor
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One prediction step, batched over leading dims."""
    h = mean[..., 3]
    std = torch.stack([
        _STD_WEIGHT_POS * h, _STD_WEIGHT_POS * h,
        torch.full_like(h, 1e-2), _STD_WEIGHT_POS * h,
        _STD_WEIGHT_VEL * h, _STD_WEIGHT_VEL * h,
        torch.full_like(h, 1e-5), _STD_WEIGHT_VEL * h,
    ], dim=-1)
    f = _motion_mat(mean.device)
    return mean @ f.T, f @ cov @ f.T + _diag(std)


def project(mean: torch.Tensor, cov: torch.Tensor,
            bbox_score=0.0, use_nsa: bool = False
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """State -> measurement space, batched over leading dims."""
    h = mean[..., 3]
    std = torch.stack([
        _STD_WEIGHT_POS * h, _STD_WEIGHT_POS * h,
        torch.full_like(h, 1e-1), _STD_WEIGHT_POS * h,
    ], dim=-1)
    if use_nsa:
        std = std * (1.0 - torch.as_tensor(bbox_score)[..., None])
    return mean[..., :4], cov[..., :4, :4] + _diag(std)


def update(mean: torch.Tensor, cov: torch.Tensor, measurement: torch.Tensor,
           bbox_score=0.0, use_nsa: bool = False
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Measurement correction (Cholesky-solve Kalman gain), batched."""
    proj_mean, proj_cov = project(mean, cov, bbox_score, use_nsa)
    b = cov[..., :, :4]                              # cov @ H^T
    chol = _cholesky(proj_cov)
    # the two triangular solves of cholesky_solve, written out: on the card
    # torch sends a batched cholesky_solve to MAGMA, whose queue waits for
    # the stream, while batched triangular solves are cuBLAS launches
    half = torch.linalg.solve_triangular(chol, b.transpose(-1, -2),
                                         upper=False)
    gain = torch.linalg.solve_triangular(chol.transpose(-1, -2), half,
                                         upper=True).transpose(-1, -2)
    innovation = measurement - proj_mean
    new_mean = mean + (gain @ innovation[..., None])[..., 0]
    new_cov = cov - gain @ proj_cov @ gain.transpose(-1, -2)
    return new_mean, new_cov


def gating_distance(mean: torch.Tensor, cov: torch.Tensor,
                    measurements: torch.Tensor,
                    only_position: bool = False) -> torch.Tensor:
    """Squared Mahalanobis distance of N measurements to one state."""
    proj_mean, proj_cov = project(mean, cov)
    if only_position:
        proj_mean = proj_mean[..., :2]
        proj_cov = proj_cov[..., :2, :2]
        measurements = measurements[..., :2]
    chol = _cholesky(proj_cov)
    d = measurements - proj_mean[..., None, :]
    z = torch.linalg.solve_triangular(chol, d.transpose(-1, -2), upper=False)
    return (z * z).sum(-2)
