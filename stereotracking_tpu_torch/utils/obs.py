"""Observability: pluggable scalar-metrics backends.

A copy of ``stereotracking_tpu/utils/obs.py``.  The reference wires a
``LoggerHook(interval=50)`` plus configurable ``vis_backends``
(``LocalVisBackend`` by default; Tensorboard/Wandb variants) through its
runner (``configs/_base_/default_runtime.py:4,18-20``).  This module is the
analog: a :class:`MetricsLogger` fans scalar series out to

* ``jsonl``  — one JSON object per line in ``<work_dir>/scalars.jsonl``
  (``LocalVisBackend`` analog; trivially machine-readable),
* ``tensorboard`` — event files under ``<work_dir>/tb`` via
  ``torch.utils.tensorboard`` (``TensorboardVisBackend`` analog),
* ``print`` — the classic console line.

Loggers are built from the config key ``vis_backends`` (same shape as the
reference's: a list of ``dict(type=...)``) and the ``log_interval`` key.
Only rank 0 writes.
"""
from __future__ import annotations

import json
import os
import time
from typing import Dict, Iterable, Optional


_TYPE_ALIASES = {
    'localvisbackend': 'jsonl',
    'jsonl': 'jsonl',
    'tensorboardvisbackend': 'tensorboard',
    'tensorboard': 'tensorboard',
    'print': 'print',
}


class MetricsLogger:
    """Fan scalar metrics out to the configured backends.

    ``log`` writes unconditionally; ``log_every`` applies the LoggerHook
    interval (write when ``step % interval == 0``).
    """

    def __init__(self, work_dir: Optional[str] = None,
                 backends: Iterable = ('jsonl',),
                 interval: int = 50, rank: int = 0):
        self.interval = max(int(interval), 1)
        self.rank = rank
        self._jsonl = None
        self._tb = None
        self._print = False
        self._t0 = time.time()
        if rank != 0:
            return
        for b in backends:
            kind = b.get('type', 'jsonl') if isinstance(b, dict) else str(b)
            kind = _TYPE_ALIASES.get(kind.lower())
            if kind == 'jsonl':
                assert work_dir is not None, 'jsonl backend needs work_dir'
                os.makedirs(work_dir, exist_ok=True)
                self._jsonl = open(os.path.join(work_dir, 'scalars.jsonl'),
                                   'a', buffering=1)
            elif kind == 'tensorboard':
                assert work_dir is not None, 'tb backend needs work_dir'
                from torch.utils.tensorboard import SummaryWriter
                self._tb = SummaryWriter(os.path.join(work_dir, 'tb'))
            elif kind == 'print':
                self._print = True

    def log(self, step: int, scalars: Dict[str, float],
            prefix: str = 'train') -> None:
        if self.rank != 0:
            return
        vals = {k: float(v) for k, v in scalars.items()}
        if self._jsonl is not None:
            self._jsonl.write(json.dumps(
                {'step': int(step), 'prefix': prefix,
                 'time': round(time.time() - self._t0, 3), **vals}) + '\n')
        if self._tb is not None:
            for k, v in vals.items():
                self._tb.add_scalar(f'{prefix}/{k}', v, int(step))
        if self._print:
            body = ' '.join(f'{k} {v:.4g}' for k, v in vals.items())
            print(f'[{prefix}] step {step} {body}', flush=True)

    def log_every(self, step: int, scalars: Dict[str, float],
                  prefix: str = 'train') -> None:
        if step % self.interval == 0:
            self.log(step, scalars, prefix)

    def close(self) -> None:
        if self._jsonl is not None:
            self._jsonl.close()
            self._jsonl = None
        if self._tb is not None:
            self._tb.close()
            self._tb = None


def build_logger(cfg: Dict, work_dir: Optional[str],
                 rank: int = 0) -> MetricsLogger:
    """Build from config: ``vis_backends`` (reference shape) +
    ``log_interval`` (LoggerHook interval analog; default 50)."""
    backends = cfg.get('vis_backends', [dict(type='LocalVisBackend')])
    return MetricsLogger(work_dir=work_dir, backends=backends,
                         interval=cfg.get('log_interval', 50), rank=rank)
