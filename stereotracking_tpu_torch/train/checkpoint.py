"""Train checkpoints (``.pth``): save, load, rotation with resume, and the
detector export.

Port of ``stereotracking_tpu/train/checkpoint.py`` (the reference's
mmengine CheckpointHook + resume flow): full train-state checkpoints (the
module, the EMA, the momentum buffers and ``step``, ``TrainState.
state_dict``) every ``interval`` epochs, the last ``max_keep`` kept, a
``last_checkpoint`` marker naming the newest; and the EMA weights exported
as a detector checkpoint (the analog of tools/utils/extract_det_model.py)
marked with ``DETECTOR_FORMAT``, which ``apis.inference.init_model`` loads
as it is, the disparity branch's own stem and stage 1 included.
"""
from __future__ import annotations

import os
from typing import Any, Optional, Tuple

import torch

from ..utils.checkpoint import DETECTOR_FORMAT
from .train_state import TRAIN_FORMAT, TrainState


def save_checkpoint(path: str, obj: Any) -> None:
    """``torch.save`` of ``obj`` (nested dicts of tensors and numbers)."""
    os.makedirs(os.path.dirname(path) or '.', exist_ok=True)
    torch.save(obj, path)


def load_checkpoint(path: str) -> Any:
    """A checkpoint written by ``save_checkpoint``, its tensors on the
    CPU."""
    return torch.load(path, map_location='cpu', weights_only=True)


class CheckpointManager:
    """Rotating train-state checkpoints ``epoch_<n>.pth`` (interval +
    max_keep; reference CheckpointHook(interval=5, max_keep_ckpts=3))."""

    def __init__(self, workdir: str, interval: int = 5, max_keep: int = 3):
        self.workdir = workdir
        self.interval = interval
        self.max_keep = max_keep
        os.makedirs(workdir, exist_ok=True)

    def _path(self, epoch: int) -> str:
        return os.path.join(self.workdir, f'epoch_{epoch}.pth')

    def maybe_save(self, epoch: int, state: TrainState) -> None:
        """After 0-based ``epoch``: save ``epoch_<epoch + 1>.pth`` when the
        interval says so, drop all but the newest ``max_keep``, update the
        marker."""
        if (epoch + 1) % self.interval != 0:
            return
        save_checkpoint(self._path(epoch + 1), state.state_dict())
        kept = sorted(
            (f for f in os.listdir(self.workdir)
             if f.startswith('epoch_') and f.endswith('.pth')),
            key=lambda f: int(f.split('_')[1].split('.')[0]))
        for f in kept[:-self.max_keep]:
            os.remove(os.path.join(self.workdir, f))
        with open(os.path.join(self.workdir, 'last_checkpoint'), 'w') as f:
            f.write(self._path(epoch + 1))

    def latest(self) -> Optional[str]:
        marker = os.path.join(self.workdir, 'last_checkpoint')
        if os.path.exists(marker):
            with open(marker) as f:
                p = f.read().strip()
            return p if os.path.exists(p) else None
        return None

    def resume(self, state: TrainState) -> Tuple[TrainState, int]:
        """Load the latest checkpoint into ``state``; returns (state,
        start_epoch), start_epoch 0 when there is none."""
        p = self.latest()
        if p is None:
            return state, 0
        state.load_state_dict(load_checkpoint(p))
        epoch = int(os.path.basename(p).split('_')[1].split('.')[0])
        return state, epoch


def extract_detector_variables(state, ema: bool = True) -> dict:
    """The detector export of ``state`` (a ``TrainState``, or its
    ``state_dict()`` as a train checkpoint holds it): the EMA weights and
    BatchNorm statistics (reference extract_det_model.py +
    EMAHook(update_buffers=True)), or with ``ema=False`` the trained
    module's own, as a detector state dict on the CPU, marked as this
    package's format."""
    sd = state.state_dict() if isinstance(state, TrainState) else state
    if not isinstance(sd, dict) or sd.get('format') != TRAIN_FORMAT:
        raise ValueError(f'not a train state of this package (format '
                         f'{TRAIN_FORMAT!r})')
    return dict(
        state_dict={k: v.detach().cpu() for k, v in
                    sd['ema' if ema else 'model'].items()},
        meta=dict(format=DETECTOR_FORMAT, step=sd['step']))
