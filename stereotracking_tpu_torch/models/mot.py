"""Depth-guided OC-SORT: detector -> depth -> tracker, one frame at a time.

Port of ``stereotracking_tpu/models/mot.py`` (``MOTConfig``,
``FrameResult``, ``predict_frame``, ``predict_frame_raw``, ``track_video``
and the ``OCSORTDisparity`` streaming wrapper).  Steps per frame: preprocess;
detector (stems, stage 1, stage 2, the rest); decode and NMS; depth of the
first ``num_dets`` detections; depth^2 box inflation; tracker step; box
un-inflation; depth re-extracted on the un-inflated boxes (unless
``reuse_det_depth``).  With ``cfg.cmc`` (camera-motion compensation), the
step also estimates the warp from the previous frame to this one on the
device (ops/gmc.py; a ``CMCState`` keeps the previous small gray) or takes
it from the host (``backend='opencv'``, ops/gmc_host.py), and the tracker
warps its confirmed tracks' Kalman states with it.

``predict_frames_batched`` advances S streams one frame each in one pass
(every kernel launched once for all S), reading nothing back to the host;
``predict_frame`` is its one-stream case and ``step_raw`` the step from raw
frames that ``OCSORTDisparity.track_raw`` and
``MultiStreamTracker.track_raw`` replay as one CUDA graph on the card
(models/captured_step.py).  ``fetch_result`` / ``result_to_host`` take a
``FrameResult`` off the card in one synchronisation, as the JAX package's
one ``jax.device_get``.
"""
from __future__ import annotations

import functools
from typing import Callable, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops.depth import (disp_to_depth, extract_box_depths,
                         extract_box_depths_disp)
from ..ops.gmc import (GMCConfig, estimate_camera_motion, gated_warp,
                       to_small_gray)
from ..structures.bbox import scale_bbox
from ..utils.devices import checked_device, to_device
from . import tracker as trk
from .captured_step import CapturedStep
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
    cmc: Optional[GMCConfig] = None   # camera-motion compensation (off in
                                      # the canonical config)
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


class CMCState(NamedTuple):
    """The camera-motion chain's state of S streams, beside their
    ``TrackState``: the previous frame's small gray and whether there is
    one (JAX ``OCSORTDisparity._cmc_prev``)."""
    prev: torch.Tensor        # (S, size, size) float32
    has_prev: torch.Tensor    # (S,) bool


def init_cmc_state(cmc: GMCConfig, device, n_streams: int = 1) -> CMCState:
    return CMCState(
        prev=torch.zeros((n_streams, cmc.size, cmc.size),
                         dtype=torch.float32, device=device),
        has_prev=torch.zeros(n_streams, dtype=torch.bool, device=device))


def camera_warp(cmc: GMCConfig, state: CMCState, frame: torch.Tensor,
                frame_ids) -> Tuple[torch.Tensor, torch.Tensor]:
    """The device chain of one step for S streams: ``frame`` (S, H, W, 3)
    BGR (uint8 or 0-255 float), ``frame_ids`` S ints or an (S,) tensor.
    Returns the warp from the previous frame ((S, 2, 3), the identity
    where the inlier ratio is below ``min_inlier_ratio``) and where it
    applies ((S,) bool: a previous frame exists and the frame id is not 0),
    and writes this frame's small gray into ``state`` in place, as JAX's
    ``OCSORTDisparity._cmc_warp`` keeps it.  Nothing is read back to the
    host."""
    s, h, w = frame.shape[:3]
    fid = trk.frame_ids_on(frame_ids, s, frame.device)
    curr = to_small_gray(frame, cmc.size)
    H, ratio = estimate_camera_motion(state.prev, curr, h, w, fid, cmc)
    warp = gated_warp(H, ratio, cmc.min_inlier_ratio)
    warp_on = state.has_prev & (fid != 0)
    state.prev.copy_(curr)
    state.has_prev.fill_(True)
    return warp, warp_on


@torch.no_grad()
def predict_frames_batched(module: YOLOXDetector, states: trk.TrackState,
                           inputs: dict, frame_ids, cfg: MOTConfig,
                           scale_factor=(1.0, 1.0),
                           cmc: Optional[CMCState] = None,
                           cmc_frame: Optional[torch.Tensor] = None,
                           host_warp: Optional[Tuple[torch.Tensor,
                                                     torch.Tensor]] = None,
                           ) -> Tuple[trk.TrackState, FrameResult]:
    """Advance S streams one frame each.

    ``states``: a ``TrackState`` with a leading stream axis; ``inputs``:
    dict of (S, H, W, C) tensors from ``preprocess_frame_pure`` (and the
    raw (S, h, w, 3) 'img_u8' / (S, h, w) 'disp_u16' when the stems run as
    kernels); ``frame_ids``: S host ints or an (S,) int32 tensor on the
    device; ``scale_factor`` as ``detector_predict`` takes it.  Every
    FrameResult field has a leading S.  Nothing is read back to the
    host.

    With ``cfg.cmc``: the device backend estimates the warp from
    ``cmc_frame`` ((S, H, W, 3), by default ``inputs['img']``) against the
    previous frame kept in ``cmc`` (updated in place: ``camera_warp``);
    the opencv backend takes ``host_warp`` = (warps (S, 2, 3), on (S,)),
    computed on the host (ops/gmc_host.py).  Given neither, the step runs
    without a warp, as the JAX ``predict_frame`` does without one (so do
    ``predict_frame``, ``predict_frame_raw`` and ``track_video``)."""
    warp = warp_on = None
    if host_warp is not None:
        warp, warp_on = host_warp
    elif cfg.cmc is not None and cmc is not None:
        warp, warp_on = camera_warp(
            cfg.cmc, cmc, inputs['img'] if cmc_frame is None else cmc_frame,
            frame_ids)
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
    states, out = trk.step(states, dets, frame_ids, cfg.tracker, warp,
                           warp_on)

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


def step_raw(module: YOLOXDetector, cfg: MOTConfig,
             states: trk.TrackState, img_u8: torch.Tensor,
             disp_u16: torch.Tensor, frame_ids, scale_factor=(1.0, 1.0),
             depth_raw: Optional[torch.Tensor] = None,
             cmc: Optional[CMCState] = None,
             host_warp: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
             ) -> FrameResult:
    """One step of S streams from raw (S, H, W, 3) uint8 / (S, H, W)
    uint16 frames (and optional (S, H, W) ground-truth depth), the new
    track state written into ``states`` (and ``cmc``) in place: the step
    that ``CapturedStep`` captures.  Camera motion is estimated on the raw
    frame at its own size, as the JAX ``track_raw`` does."""
    oh, ow = padded_shape(*img_u8.shape[1:3])
    inputs = preprocess_raw(img_u8, disp_u16, oh, ow, depth_raw)
    new, res = predict_frames_batched(module, states, inputs, frame_ids, cfg,
                                      scale_factor, cmc=cmc,
                                      cmc_frame=img_u8, host_warp=host_warp)
    trk.assign_state(states, new)
    return res


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
    given; see ``detector_module``).  ``track_raw`` replays one CUDA graph
    per frame on the card (models/captured_step.py) and runs eagerly on the
    CPU; the state (``states``, one stream, and with ``cfg.cmc`` the
    camera-motion state ``cmc``) is updated in place.  Frame ids grow by at
    least one per frame or restart at 0 (host ids out of that order raise:
    ``tracker.FrameIdOrder``).  With ``cfg.cmc.backend == 'opencv'`` the
    warp is computed on the host from numpy frames (ops/gmc_host.py) and
    the frame ids must be host ints."""

    def __init__(self, cfg: MOTConfig = MOTConfig(),
                 module: Optional[YOLOXDetector] = None,
                 device='cuda', seed: int = 0,
                 dtype: Optional[torch.dtype] = None):
        self.cfg = cfg
        self.device = checked_device(device)
        module = detector_module(cfg, module, dtype, seed)
        self.module = module.to(self.device).eval()
        self.states = trk.init_state(cfg.tracker, self.device, 1)
        self.cmc = (None if cfg.cmc is None or cfg.cmc.backend == 'opencv'
                    else init_cmc_state(cfg.cmc, self.device, 1))
        self._host_prev = None      # the opencv route's previous frame
        self._step = CapturedStep(self.module,
                                  functools.partial(step_raw, self.module,
                                                    cfg), cmc=cfg.cmc)
        self._order = trk.FrameIdOrder()

    @property
    def state(self) -> trk.TrackState:
        """The one stream's track state (views of ``states``)."""
        return trk.first_stream(self.states)

    def reset(self):
        trk.assign_state(self.states, trk.init_state(self.cfg.tracker,
                                                     self.device, 1))
        if self.cmc is not None:
            trk.assign_state(self.cmc, init_cmc_state(self.cfg.cmc,
                                                      self.device, 1))
        self._host_prev = None
        self._order.reset()

    def _as_tensor(self, x):
        if isinstance(x, np.ndarray):
            return to_device(x, self.device)   # pinned: no host sync
        return x.to(self.device)

    def _host_warp(self, img_hw3, frame_id) -> Optional[Tuple]:
        """The opencv route's (warp (1, 2, 3), on (1,)) as numpy, from the
        host frame and the previous one (JAX ``_cmc_warp``); None unless
        ``cfg.cmc.backend == 'opencv'``."""
        cmc = self.cfg.cmc
        if cmc is None or cmc.backend != 'opencv':
            return None
        from ..ops.gmc_host import host_frame, glme_affine_host
        if torch.is_tensor(frame_id):
            raise ValueError("cmc backend 'opencv' takes host frame ids")
        if int(frame_id) == 0:
            self._host_prev = None
        curr = np.clip(host_frame(img_hw3), 0, 255).astype(np.uint8)
        warp = np.eye(2, 3, dtype=np.float32)
        on = False
        if self._host_prev is not None:
            H, _ = glme_affine_host(
                self._host_prev, curr, ransac_thr=cmc.ransac_thr,
                min_inlier_ratio=cmc.min_inlier_ratio)
            if H is not None:
                warp, on = H.astype(np.float32), True
        self._host_prev = curr
        return warp[None], np.array([on])

    def track(self, inputs: dict, frame_id: int,
              scale_factor: Tuple[float, float] = (1.0, 1.0)) -> FrameResult:
        """One frame from preprocessed inputs (``preprocess_frame_pure``;
        the raw frames too when the stems run as kernels), eagerly.  Camera
        motion is estimated on ``inputs['img']``, as the JAX ``track``
        does."""
        self._order.check(frame_id)
        host = self._host_warp(
            None if self.cfg.cmc is None else inputs['img'][0], frame_id)
        inputs = {k: self._as_tensor(v) for k, v in inputs.items()}
        img = inputs['img']
        inputs = {k: v[None] if k in ('img_u8', 'disp_u16') else v
                  for k, v in inputs.items()}
        new, result = predict_frames_batched(
            self.module, trk.add_stream_axis(self.state), inputs, [frame_id],
            self.cfg, scale_factor, cmc=self.cmc, cmc_frame=img,
            host_warp=None if host is None else tuple(
                self._as_tensor(x) for x in host))
        trk.assign_state(self.states, new)
        return trk.first_stream(result)

    def track_raw(self, img_u8, disp_u16, frame_id,
                  scale_factor: Tuple[float, float] = (1.0, 1.0),
                  depth_raw=None) -> FrameResult:
        """``track`` from raw frames: (H, W, 3) uint8 BGR + (H, W) uint16
        fixed-point disparity (65535 = invalid), numpy or torch; ``frame_id``
        an int or a 0-d tensor."""
        host = self._host_warp(img_u8, frame_id)
        img_u8 = self._as_tensor(img_u8)
        disp_u16 = self._as_tensor(disp_u16)
        depth = None if depth_raw is None else self._as_tensor(depth_raw)[None]
        fid = frame_id.reshape(1) if torch.is_tensor(frame_id) else [frame_id]
        self._order.check(fid)
        result = self._step(self.states, img_u8[None], disp_u16[None], fid,
                            scale_factor, depth, cmc=self.cmc,
                            host_warp=host)
        return trk.first_stream(result)


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
