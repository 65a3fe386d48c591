"""Multi-stream batched tracking: S concurrent videos through one step.

Port of ``stereotracking_tpu/parallel/multistream.py``.  The JAX package
``vmap``s the per-frame program over a leading stream axis; here every
function of the step takes that axis itself: each kernel launches once for
all S streams (a grid axis, as ``vmap`` over a ``pallas_call`` adds one),
the detector's float32 layers batch the streams, the depth statistics of
all S * N boxes are one launch, the tracker's assignments of all streams
are one launch each, and nothing is read back to the host.  ``track_raw``
replays the step as one CUDA graph on the card (models/captured_step.py)
and runs it eagerly on the CPU.

Not ported: the device mesh (``mesh`` / ``shard_inputs``, multi-GPU stream
sharding) and the TPU stem-pack layout (``pack_frames`` / ``track_packed*``:
the port's stem kernel reads raw frames).  A config with camera-motion
compensation raises: the JAX ``MultiStreamTracker`` passes no warp and
silently tracks such a config without it, and a batched warp would be a
feature the reference lacks.
"""
from __future__ import annotations

import functools
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..models import tracker as trk
from ..models.detector import YOLOXDetector
from ..models.captured_step import CapturedStep
from ..models.mot import (FrameResult, MOTConfig, detector_module,
                          predict_frames_batched, step_raw)
from ..utils.devices import checked_device, to_device


def init_stream_states(cfg: MOTConfig, n_streams: int,
                       device='cuda') -> trk.TrackState:
    """Empty track states of ``n_streams`` streams (leading stream axis)."""
    return trk.init_state(cfg.tracker, checked_device(device), n_streams)


class MultiStreamTracker:
    """Holds the detector, its weights and the S streams' track states;
    each call advances every stream one frame (or T frames), on the card
    unless ``device`` says otherwise.  ``dtype`` is the detector's compute
    dtype, as ``OCSORTDisparity``'s.  The states (``states``) are updated
    in place.  Each stream's frame ids grow by at least one per step or
    restart at 0 (host ids out of that order raise)."""

    def __init__(self, cfg: MOTConfig, n_streams: int,
                 module: Optional[YOLOXDetector] = None, device='cuda',
                 seed: int = 0, dtype: Optional[torch.dtype] = None):
        if cfg.cmc is not None:
            raise NotImplementedError(
                'MultiStreamTracker: camera-motion compensation (cfg.cmc) '
                'runs one stream at a time, through OCSORTDisparity; the '
                'JAX MultiStreamTracker drops it silently')
        self.cfg = cfg
        self.n_streams = n_streams
        self.device = checked_device(device)
        module = detector_module(cfg, module, dtype, seed)
        self.module = module.to(self.device).eval()
        self.states = init_stream_states(cfg, n_streams, self.device)
        self._step = CapturedStep(self.module,
                                  functools.partial(step_raw, self.module,
                                                    cfg))
        self._order = trk.FrameIdOrder()

    def reset(self):
        trk.assign_state(self.states, init_stream_states(
            self.cfg, self.n_streams, self.device))
        self._order.reset()

    def _as_tensor(self, x) -> torch.Tensor:
        if isinstance(x, np.ndarray):
            return to_device(x, self.device)   # pinned: no host sync
        return x.to(self.device)

    def _frame_ids(self, frame_ids):
        """(S,) frame ids: a tensor as it is, host values as a list, held to
        ``tracker.FrameIdOrder``."""
        fids = (frame_ids.reshape(-1) if torch.is_tensor(frame_ids) else
                np.asarray(frame_ids, np.int64).reshape(-1).tolist())
        if len(fids) != self.n_streams:
            raise ValueError(f'{self.n_streams} frame ids expected, got '
                             f'{len(fids)}')
        self._order.check(fids)
        return fids

    def track(self, inputs: dict, frame_ids,
              scale_factor: Tuple[float, float] = (1.0, 1.0)) -> FrameResult:
        """Advance all streams one frame from preprocessed inputs, eagerly:
        dict of (S, 1, H, W, C) tensors (stream-major, the per-frame batch
        dim of ``preprocess_frame_pure`` kept, as the JAX tracker takes
        them; the raw 'img_u8' (S, h, w, 3) / 'disp_u16' (S, h, w) too when
        the stems run as kernels); ``frame_ids``: (S,)."""
        inputs = {k: self._as_tensor(v) for k, v in inputs.items()}
        inputs = {k: v if k in ('img_u8', 'disp_u16') else v.flatten(0, 1)
                  for k, v in inputs.items()}
        new, result = predict_frames_batched(
            self.module, self.states, inputs, self._frame_ids(frame_ids),
            self.cfg, scale_factor)
        trk.assign_state(self.states, new)
        return result

    def track_raw(self, imgs_u8, disps_u16, frame_ids,
                  scale_factor: Tuple[float, float] = (1.0, 1.0)
                  ) -> FrameResult:
        """Advance all streams one frame from RAW decoded frames:
        ``imgs_u8`` (S, H, W, 3) uint8, ``disps_u16`` (S, H, W) uint16,
        ``frame_ids`` (S,); numpy or torch.  Every FrameResult field has a
        leading S."""
        imgs_u8 = self._as_tensor(imgs_u8)
        disps_u16 = self._as_tensor(disps_u16)
        if imgs_u8.shape[0] != self.n_streams:
            raise ValueError(f'{self.n_streams} streams expected, got '
                             f'{tuple(imgs_u8.shape)}')
        return self._step(self.states, imgs_u8, disps_u16,
                          self._frame_ids(frame_ids), scale_factor)

    def track_raw_chunk(self, imgs_u8, disps_u16, frame_ids: Sequence,
                        scale_factor: Tuple[float, float] = (1.0, 1.0)
                        ) -> FrameResult:
        """``track_raw`` over T frames per stream: ``imgs_u8``
        (T, S, H, W, 3), ``disps_u16`` (T, S, H, W), ``frame_ids`` (T, S);
        the states carry from frame to frame as in the JAX ``lax.scan``, one
        graph replay per frame on the card.  Returns the FrameResults
        stacked on a leading T axis."""
        results = [self.track_raw(imgs_u8[t], disps_u16[t], frame_ids[t],
                                  scale_factor)
                   for t in range(len(frame_ids))]
        return FrameResult(*(torch.stack(f) for f in zip(*results)))
