"""Train state, optimizer and the training step.

Port of ``stereotracking_tpu/train/train_state.py`` (reference config
configs/stereo_tracking/ocsort/yolox_s_mmyolo_mot_airdrone_disp.py:154-204):
SGD with nesterov momentum 0.9, weight decay 5e-4 on the parameters of rank
> 1 only (norm scales and biases excluded), the quadratic-warm-up -> cosine
schedule, and the exponential-momentum EMA of the parameters and of the
BatchNorm running statistics (``update_buffers=True``).

``torch.optim.SGD(momentum, nesterov=True, weight_decay)`` is the JAX
package's ``optax.add_decayed_weights`` + ``optax.sgd(nesterov=True)``:
the decay is added to the gradient first, the momentum buffer starts as
that sum (optax's zero trace plus the update), and the learning rate of
step ``t`` is ``schedule(t)`` with ``t`` counted from 0 (optax's
``count``).  ``train_step`` reads nothing on the host: the losses it
returns are device tensors that a logger reads after the step.
"""
from __future__ import annotations

import copy
from typing import Callable, Dict, List, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from ..models.detector import YOLOXDetector
from ..models.mot import init_weights
from ..models.yolox_head import decode_predictions, level_priors
from .losses import YOLOXLossConfig, yolox_loss

# marks a train-state checkpoint of this package (``TrainState.state_dict``)
TRAIN_FORMAT = 'stereotracking_tpu_torch.train_state'


def decay_mask(module: torch.nn.Module) -> Dict[str, bool]:
    """Weight decay only for parameters of rank > 1 (conv kernels; norm
    scales and biases excluded): ``paramwise_cfg(norm_decay_mult=0,
    bias_decay_mult=0)``, the JAX ``_decay_mask``."""
    return {n: p.ndim > 1 for n, p in module.named_parameters()}


def make_optimizer(module: torch.nn.Module, schedule: Callable[[int], float],
                   momentum: float = 0.9,
                   weight_decay: float = 5e-4) -> torch.optim.SGD:
    """SGD-nesterov over ``module``'s parameters in two groups: those that
    ``decay_mask`` selects with ``weight_decay``, the rest without."""
    mask = decay_mask(module)
    params = dict(module.named_parameters())
    groups = [
        dict(params=[p for n, p in params.items() if mask[n]],
             weight_decay=weight_decay),
        dict(params=[p for n, p in params.items() if not mask[n]],
             weight_decay=0.0),
    ]
    return torch.optim.SGD(groups, lr=schedule(0), momentum=momentum,
                           nesterov=True)


class TrainState:
    """The module in train mode, its EMA copy in eval mode, the optimizer,
    the schedule and ``step`` (a host int: the number of steps taken)."""

    def __init__(self, module: YOLOXDetector, ema: YOLOXDetector,
                 optimizer: torch.optim.SGD,
                 schedule: Callable[[int], float], step: int = 0):
        self.module = module
        self.ema = ema
        self.optimizer = optimizer
        self.schedule = schedule
        self.step = step
        self._ema_pairs = _ema_pairs(ema, module)

    def state_dict(self) -> dict:
        """The module, the EMA, each parameter's momentum buffer by name
        and ``step``."""
        opt = self.optimizer.state
        return dict(
            format=TRAIN_FORMAT, step=self.step,
            model=self.module.state_dict(), ema=self.ema.state_dict(),
            momentum={n: opt[p]['momentum_buffer']
                      for n, p in self.module.named_parameters()
                      if opt.get(p, {}).get('momentum_buffer') is not None})

    def load_state_dict(self, sd: dict) -> None:
        """Take a ``state_dict`` (or ``utils.convert.train_state_to_torch``
        of a JAX ``TrainState``); a parameter without a momentum buffer
        starts its buffer at its next step, as optax's zero trace does."""
        if sd.get('format') != TRAIN_FORMAT:
            raise ValueError(f'not a train state of this package: format '
                             f'{sd.get("format")!r}')
        self.module.load_state_dict(sd['model'])
        self.ema.load_state_dict(sd['ema'])
        for n, p in self.module.named_parameters():
            buf = sd['momentum'].get(n)
            if buf is None:
                self.optimizer.state.pop(p, None)
            else:
                self.optimizer.state[p]['momentum_buffer'] = \
                    buf.detach().to(p.device, torch.float32).clone()
        self.step = int(sd['step'])


def _ema_pairs(ema: torch.nn.Module, module: torch.nn.Module
               ) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """(EMA tensor, tensor) for every parameter and floating-point buffer
    (the BatchNorm running statistics; ``num_batches_tracked`` is not a
    statistic)."""
    src = dict(module.named_parameters())
    src.update((n, b) for n, b in module.named_buffers()
               if b.is_floating_point())
    dst = dict(ema.named_parameters())
    dst.update(ema.named_buffers())
    return [(dst[n], t) for n, t in src.items()]


def create_train_state(module: YOLOXDetector,
                       schedule: Callable[[int], float],
                       seed: int = 0) -> TrainState:
    """Seeded random weights (``models.mot.init_weights``: LeCun-scaled
    convs, identity BatchNorm), ``module`` put in train mode, its EMA a
    copy of those weights, and the optimizer."""
    with torch.no_grad():
        init_weights(module, torch.Generator().manual_seed(seed))
    module.train()
    ema = copy.deepcopy(module).eval().requires_grad_(False)
    return TrainState(module, ema, make_optimizer(module, schedule),
                      schedule)


def ema_momentum(step: int, base_momentum: float = 1e-4,
                 gamma: float = 2000.0) -> float:
    """mmyolo ExpMomentumEMA: the momentum decays from 1 to
    ``base_momentum``; evaluated in float32 as the JAX package does."""
    f32 = np.float32
    return float(f32(1.0 - base_momentum) * np.exp(
        -(f32(1) + f32(step)) / f32(gamma)) + f32(base_momentum))


def flat_head(cls, reg, obj, strides, device) -> tuple:
    """Per-level NHWC head maps -> priors (P, 4), decoded boxes (N, P, 4)
    and the flat (N, P, C) / (N, P, 4) / (N, P, 1) maps in float32."""
    priors = torch.cat([level_priors(c.shape[1], c.shape[2], s,
                                     device=device)
                        for c, s in zip(cls, strides)], 0)
    decoded, _ = decode_predictions(cls, reg, obj, strides)
    n = cls[0].shape[0]
    flat = [torch.cat([m.reshape(n, -1, m.shape[-1]) for m in maps],
                      1).float() for maps in (cls, reg, obj)]
    return (priors, decoded, *flat)


def train_step(state: TrainState, batch: dict,
               loss_cfg: YOLOXLossConfig) -> dict:
    """One optimizer step, in place on ``state``.  ``batch``: tensors on
    the module's device, 'img' and (for the dual and concatenated
    backbones) 'disp_postp' (N, H, W, 3) float32,
    'gt_bboxes' (N, G, 4), 'gt_labels' (N, G) int64, 'gt_valid' (N, G)
    bool.  Returns the detached losses and ``num_pos``, device tensors.
    Its phases are ``torch.profiler`` ranges (train.forward, train.loss,
    train.backward, train.optimizer_ema)."""
    module = state.module
    with record_function('train.forward'):
        cls, reg, obj = module({k: batch[k] for k in ('img', 'disp_postp')
                                if k in batch})
    with record_function('train.loss'):
        priors, decoded, cls_f, reg_f, obj_f = flat_head(
            cls, reg, obj, module.cfg.strides, batch['img'].device)
        losses = yolox_loss(cls_f, reg_f, obj_f, priors, decoded,
                            batch['gt_bboxes'], batch['gt_labels'],
                            batch['gt_valid'], loss_cfg)
    with record_function('train.backward'):
        state.optimizer.zero_grad(set_to_none=True)
        losses['loss'].backward()
    with record_function('train.optimizer_ema'):
        lr = state.schedule(state.step)
        for group in state.optimizer.param_groups:
            group['lr'] = lr
        state.optimizer.step()
        m = ema_momentum(state.step)
        ema, cur = zip(*state._ema_pairs)
        with torch.no_grad():
            torch._foreach_mul_(ema, float(np.float32(1) - np.float32(m)))
            torch._foreach_add_(ema, cur, alpha=m)
    state.step += 1
    return {k: v.detach() for k, v in losses.items()}
