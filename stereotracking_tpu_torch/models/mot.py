"""Depth-guided OC-SORT: detector -> depth -> tracker, one frame at a time.

Port of ``stereotracking_tpu/models/mot.py`` (``MOTConfig``,
``FrameResult``, ``predict_frame``, ``predict_frame_raw``, ``track_video``
and the ``OCSORTDisparity`` streaming wrapper).  Steps per frame: preprocess;
detector (stems, stage 1, stage 2, the rest); decode and NMS; depth of the
first ``num_dets`` detections; depth^2 box inflation; tracker step; box
un-inflation; depth re-extracted on the un-inflated boxes (unless
``reuse_det_depth``).  Camera-motion compensation is not ported.

``predict_frames_batched`` advances S streams one frame each in one pass
(every kernel launched once for all S); ``predict_frame`` is its one-stream
case.  ``fetch_result`` / ``result_to_host`` take a ``FrameResult`` off the
card in one synchronisation, as the JAX package's one ``jax.device_get``.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops.depth import (disp_to_depth, extract_box_depths,
                         extract_box_depths_disp)
from ..structures.bbox import scale_bbox
from ..utils.devices import checked_device, to_device
from . import tracker as trk
from .csp_darknet import StageBackends
from .detector import DetectorConfig, YOLOXDetector, detector_predict
from .preprocessor import padded_shape, preprocess_frame_pure


class MOTConfig(NamedTuple):
    detector: DetectorConfig = DetectorConfig()
    tracker: trk.TrackerConfig = trk.TrackerConfig()
    baseline: float = 0.25
    focal_length: float = 640.0
    depth_crop: int = 96
    depth_mode: str = 'corner_guided'
    reuse_det_depth: bool = True
    disp_fixed_point: bool = True
    # per stage, 'torch' (float32 modules) | 'cuda' (its kernel, which
    # needs the kernel of the stage before it: StageBackends.check)
    backends: StageBackends = StageBackends()


class FrameResult(NamedTuple):
    det_bboxes: torch.Tensor
    det_scores: torch.Tensor
    det_labels: torch.Tensor
    det_valid: torch.Tensor
    track_bboxes: torch.Tensor     # un-inflated xyxy
    track_scores: torch.Tensor
    track_labels: torch.Tensor
    track_scales: torch.Tensor
    track_depths: torch.Tensor
    track_gt_depths: torch.Tensor
    track_ids: torch.Tensor
    track_valid: torch.Tensor


@torch.no_grad()
def predict_frames_batched(module: YOLOXDetector, states: trk.TrackState,
                           inputs: dict, frame_ids: Sequence[int],
                           cfg: MOTConfig,
                           scale_factor: Tuple[float, float] = (1.0, 1.0),
                           ) -> Tuple[trk.TrackState, FrameResult]:
    """Advance S streams one frame each.

    ``states``: a ``TrackState`` with a leading stream axis; ``inputs``:
    dict of (S, H, W, C) tensors from ``preprocess_frame_pure`` (and the
    raw (S, h, w, 3) 'img_u8' / (S, h, w) 'disp_u16' when the stems run as
    kernels); ``frame_ids``: S host ints.  Every FrameResult field has a
    leading S."""
    det = detector_predict(module, inputs, scale_factor, cfg.backends)
    disp = inputs['disp_postp'][..., 0]
    if cfg.depth_mode == 'corner_guided' and cfg.disp_fixed_point:
        disp = disp.contiguous()

        def extract(bxs, vld):
            return extract_box_depths_disp(disp, bxs, vld, cfg.baseline,
                                           cfg.focal_length, cfg.depth_crop)
    else:
        depth_map = disp_to_depth(disp, cfg.baseline, cfg.focal_length)

        def extract(bxs, vld):
            return extract_box_depths(depth_map, bxs, vld, cfg.depth_crop,
                                      cfg.depth_mode)

    nd = cfg.tracker.num_dets
    d_vals, scales = extract(det.boxes[:, :nd], det.valid[:, :nd])
    dets = trk.Detections(
        bboxes=scale_bbox(det.boxes[:, :nd], scales),
        scores=det.scores[:, :nd], labels=det.labels[:, :nd], scales=scales,
        depths=d_vals, valid=det.valid[:, :nd])
    states, out = trk.step(states, dets, frame_ids, cfg.tracker)

    unscaled = scale_bbox(out.bboxes, 1.0 / out.scales)
    if cfg.reuse_det_depth:
        track_depths = out.depths
    else:
        track_depths, _ = extract(unscaled, out.valid)
    if 'depth_postp' in inputs:
        gt_depths, _ = extract_box_depths(
            inputs['depth_postp'][..., 0], unscaled, out.valid,
            cfg.depth_crop, cfg.depth_mode)
    else:
        gt_depths = torch.full_like(track_depths, -1.0)

    return states, FrameResult(
        det_bboxes=det.boxes, det_scores=det.scores, det_labels=det.labels,
        det_valid=det.valid, track_bboxes=unscaled,
        track_scores=out.scores, track_labels=out.labels,
        track_scales=out.scales, track_depths=track_depths,
        track_gt_depths=gt_depths, track_ids=out.ids, track_valid=out.valid)


def predict_frame(module: YOLOXDetector, state: trk.TrackState,
                  inputs: dict, frame_id: int, cfg: MOTConfig,
                  scale_factor: Tuple[float, float] = (1.0, 1.0),
                  ) -> Tuple[trk.TrackState, FrameResult]:
    """Advance one stream one frame from preprocessed inputs (see
    ``preprocess_frame_pure``: (1, H, W, C); raw (h, w, 3) 'img_u8' /
    (h, w) 'disp_u16' as well when the stems run as kernels)."""
    inputs = {k: v[None] if k in ('img_u8', 'disp_u16') else v
              for k, v in inputs.items()}
    states, res = predict_frames_batched(module, trk.add_stream_axis(state),
                                         inputs, [frame_id], cfg,
                                         scale_factor)
    return trk.first_stream(states), trk.first_stream(res)


def preprocess_raw(img_u8: torch.Tensor, disp_u16: torch.Tensor,
                   out_h: int, out_w: int,
                   depth_raw: Optional[torch.Tensor] = None) -> dict:
    """(S, H, W, 3) uint8 + (S, H, W) uint16 raw frames -> the inputs of
    ``predict_frames_batched``, the raw frames included for the stem
    kernels."""
    inputs = preprocess_frame_pure(img_u8, disp_u16, out_h, out_w, depth_raw)
    inputs['img_u8'] = img_u8.contiguous()
    inputs['disp_u16'] = disp_u16.contiguous()
    return inputs


def predict_frame_raw(module: YOLOXDetector, state: trk.TrackState,
                      img_u8: torch.Tensor, disp_u16: torch.Tensor,
                      frame_id: int, cfg: MOTConfig, out_h: int, out_w: int,
                      scale_factor: Tuple[float, float] = (1.0, 1.0),
                      depth_raw: Optional[torch.Tensor] = None,
                      ) -> Tuple[trk.TrackState, FrameResult]:
    """``predict_frame`` from raw frames: (H, W, 3) uint8 BGR and (H, W)
    uint16 disparity (65535 = invalid), padded to (out_h, out_w)."""
    inputs = preprocess_raw(img_u8[None], disp_u16[None], out_h, out_w,
                            None if depth_raw is None else depth_raw[None])
    states, res = predict_frames_batched(module, trk.add_stream_axis(state),
                                         inputs, [frame_id], cfg,
                                         scale_factor)
    return trk.first_stream(states), trk.first_stream(res)


def track_video(module: YOLOXDetector, state: trk.TrackState,
                frames: dict, frame_ids: Sequence[int], cfg: MOTConfig,
                scale_factor: Tuple[float, float] = (1.0, 1.0),
                ) -> Tuple[trk.TrackState, FrameResult]:
    """Track one stream over a stacked clip: ``frames`` is a dict of
    (T, 1, H, W, C) tensors from ``preprocess_frame_pure`` (and the raw
    (T, h, w, 3) 'img_u8' / (T, h, w) 'disp_u16' when the stems run as
    kernels), ``frame_ids`` T ints.  The state carries from frame to frame
    as in the JAX ``lax.scan``; returns the final state and the
    FrameResults stacked on a leading T axis."""
    results = []
    for t, fid in enumerate(torch.as_tensor(frame_ids).tolist()):
        state, res = predict_frame(module, state,
                                   {k: v[t] for k, v in frames.items()},
                                   fid, cfg, scale_factor)
        results.append(res)
    return state, FrameResult(*(torch.stack(f) for f in zip(*results)))


def fetch_result(res: FrameResult) -> Callable[[], FrameResult]:
    """Start taking ``res`` off its device: on the card every field is
    copied into pinned host memory with ``non_blocking=True`` on the
    current stream.  Returns a function that waits for those copies, one
    synchronisation for all fields (a ``.cpu()`` per field would be one
    each), and gives the FrameResult of numpy arrays."""
    if res.det_bboxes.device.type != 'cuda':
        host = FrameResult(*(np.array(t) for t in res))
        return lambda: host
    pinned = []
    for t in res:
        h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        pinned.append(h.copy_(t, non_blocking=True))
    done = torch.cuda.Event()
    done.record()

    def wait() -> FrameResult:
        done.synchronize()
        return FrameResult(*(h.numpy() for h in pinned))
    return wait


def result_to_host(res: FrameResult) -> FrameResult:
    """``res`` as a FrameResult of numpy arrays, in one synchronisation."""
    return fetch_result(res)()


def detector_module(cfg: MOTConfig, module: Optional[YOLOXDetector],
                    dtype: Optional[torch.dtype], seed: int
                    ) -> YOLOXDetector:
    """``module``, or without one a detector in ``dtype`` (float32 by
    default) with seeded random weights.  A ``dtype`` that ``module`` was
    not built with raises: the compute dtype is fixed when the modules are
    built."""
    if module is None:
        module = YOLOXDetector(cfg.detector, dtype=dtype or torch.float32)
        init_weights(module, torch.Generator().manual_seed(seed))
    elif dtype is not None and dtype != module.dtype:
        raise ValueError(f'dtype {dtype} given with a detector built for '
                         f'{module.dtype}')
    return module


class OCSORTDisparity:
    """Streaming wrapper: holds the detector, its weights and the track
    state, and runs one frame per call, on the card unless ``device`` says
    otherwise.  ``dtype`` is the detector's compute dtype (float32 unless
    given; see ``detector_module``)."""

    def __init__(self, cfg: MOTConfig = MOTConfig(),
                 module: Optional[YOLOXDetector] = None,
                 device='cuda', seed: int = 0,
                 dtype: Optional[torch.dtype] = None):
        self.cfg = cfg
        self.device = checked_device(device)
        module = detector_module(cfg, module, dtype, seed)
        self.module = module.to(self.device).eval()
        self.state = trk.init_state(cfg.tracker, self.device)

    def reset(self):
        self.state = trk.init_state(self.cfg.tracker, self.device)

    def _as_tensor(self, x):
        if isinstance(x, np.ndarray):
            return to_device(x, self.device)   # pinned: no host sync
        return x.to(self.device)

    def track(self, inputs: dict, frame_id: int,
              scale_factor: Tuple[float, float] = (1.0, 1.0)) -> FrameResult:
        inputs = {k: self._as_tensor(v) for k, v in inputs.items()}
        self.state, result = predict_frame(self.module, self.state, inputs,
                                           frame_id, self.cfg, scale_factor)
        return result

    def track_raw(self, img_u8, disp_u16, frame_id: int,
                  scale_factor: Tuple[float, float] = (1.0, 1.0),
                  depth_raw=None) -> FrameResult:
        """``track`` from raw frames: (H, W, 3) uint8 BGR + (H, W) uint16
        fixed-point disparity (65535 = invalid), numpy or torch."""
        img_u8 = self._as_tensor(img_u8)
        disp_u16 = self._as_tensor(disp_u16)
        oh, ow = padded_shape(*img_u8.shape[:2])
        self.state, result = predict_frame_raw(
            self.module, self.state, img_u8, disp_u16, frame_id, self.cfg,
            oh, ow, scale_factor,
            None if depth_raw is None else self._as_tensor(depth_raw))
        return result


@torch.no_grad()
def init_weights(module: torch.nn.Module, gen: torch.Generator) -> None:
    """Seeded random weights: normal convs with std fan_in^-1/2 (LeCun
    scaling), zero conv biases, identity BatchNorm; drawn on the CPU from
    ``gen`` so a seed gives the same model on every device."""
    for m in module.modules():
        if isinstance(m, torch.nn.Conv2d):
            fan_in = m.weight[0].numel()
            m.weight.copy_(torch.randn(m.weight.shape, generator=gen)
                           * fan_in ** -0.5)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, torch.nn.BatchNorm2d):
            m.reset_parameters()
