"""Learning-rate schedule of the canonical run: quadratic warm-up, cosine
annealing, then a constant tail.

Port of ``yolox_schedule`` (``stereotracking_tpu/train/schedules.py``;
reference param_scheduler, configs/stereo_tracking/ocsort/
yolox_s_mmyolo_mot_airdrone_disp.py:163-185).  The schedule is a plain
function of the step that returns a Python float.  It evaluates the JAX
formula in float32, in the same order, so the learning rate of step ``t``
is the float32 value that optax uses at its ``count`` ``t``.
"""
from __future__ import annotations

from typing import Callable

import numpy as np

Schedule = Callable[[int], float]


def yolox_schedule(base_lr: float, steps_per_epoch: int,
                   max_epochs: int = 50, warmup_epochs: int = 2,
                   num_last_epochs: int = 5,
                   eta_min_ratio: float = 0.05) -> Schedule:
    f32 = np.float32
    warmup_steps = warmup_epochs * steps_per_epoch
    cosine_end = (max_epochs - num_last_epochs) * steps_per_epoch
    span = f32(max(cosine_end - warmup_steps, 1))
    eta_min = base_lr * eta_min_ratio
    half_range = f32((base_lr - eta_min) * 0.5)

    def schedule(step: int) -> float:
        step = f32(step)
        if step < warmup_steps:
            # QuadraticWarmupLR: lr * (t / T)^2
            frac = np.clip((step + f32(1)) / f32(warmup_steps), f32(0),
                           f32(1))
            return float(f32(base_lr) * np.square(frac))
        # CosineAnnealingLR between the warm-up's end and cosine_end; the
        # constant tail keeps the last cosine value (factor 1)
        t = np.clip((step - f32(warmup_steps)) / span, f32(0), f32(1))
        return float(f32(eta_min) + half_range
                     * (f32(1) + np.cos(f32(np.pi) * t)))

    return schedule
