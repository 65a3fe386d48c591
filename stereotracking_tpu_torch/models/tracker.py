"""OC-SORT tracker with depth/scale plumbing over K fixed track slots.

Port of ``stereotracking_tpu/models/tracker.py``.  The state is a
``TrackState`` of tensors with leading dimension K, advanced by
``step(state, dets, frame_id, cfg)``; S streams advance together when every
field carries a leading stream axis (the port of ``jax.vmap`` over
``step``).  The algorithm and its order are the JAX package's: gate
detections; Kalman predict on confirmed tracks; OCM association on
confirmed tracks, then on tentative tracks; OCR on the leftovers; online
smoothing of recovered tracks; Kalman update and bookkeeping; new tracks;
eviction.  With camera-motion compensation, a warp is applied to the
confirmed tracks' Kalman states right after the prediction.

Where the JAX package branches on device (``lax.cond`` between the init
path and the main path and for the reset at frame 0, the smoothing
``while_loop``), this port stays branch-free: both paths run for every
stream and ``torch.where`` selects per stream, as ``vmap`` of ``lax.cond``
does.  The smoothing replay, the Kalman update of matched tracks and their
bookkeeping run as one kernel on the card, which replays each recovered
track's own ``unmatch_len``; on the CPU as an op chain of a fixed trip
count (``replay_bound``) whose extra iterations are exact no-ops
(ops/slot_update_cuda.py).  The three assignments run on the inputs'
device (ops/assignment.py).  So a step reads nothing back to the host and
can be captured in a CUDA graph (models/captured_step.py).
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..ops.assignment import linear_assignment_with_limit
from ..ops.gmc import apply_warp_to_tracks
from ..ops.slot_update_cuda import slot_update
from ..structures.bbox import (bbox_area, bbox_cxcyah_to_xyxy,
                               bbox_iou_matrix, bbox_xyxy_to_cxcyah)
from ..utils.devices import to_device
from . import kalman


class TrackerConfig(NamedTuple):
    num_slots: int = 64
    num_dets: int = 64
    obj_score_thr: float = 0.3
    init_track_thr: float = 0.7
    weight_iou_with_det_scores: bool = False
    match_iou_thr: float = 0.1
    num_tentatives: int = 3
    vel_consist_weight: float = 0.2
    vel_delta_t: int = 3
    num_frames_retain: int = 30
    min_det_area: float = 100.0

    @property
    def ring_size(self) -> int:
        return self.vel_delta_t + 1


class TrackState(NamedTuple):
    active: torch.Tensor       # (K,) bool
    tentative: torch.Tensor    # (K,) bool
    tracked: torch.Tensor      # (K,) bool
    ids: torch.Tensor          # (K,) int32
    labels: torch.Tensor       # (K,) int32
    mean: torch.Tensor         # (K, 8)
    cov: torch.Tensor          # (K, 8, 8)
    saved_mean: torch.Tensor   # (K, 8)
    saved_cov: torch.Tensor    # (K, 8, 8)
    last_bbox: torch.Tensor    # (K, 4)
    scores: torch.Tensor       # (K,)
    scales: torch.Tensor       # (K,)
    depths: torch.Tensor       # (K,)
    velocity: torch.Tensor     # (K, 2)
    last_frame: torch.Tensor   # (K,) int32
    hits: torch.Tensor         # (K,) int32
    miss_count: torch.Tensor   # (K,) int32
    obs_count: torch.Tensor    # (K,) int32
    obs_ring: torch.Tensor     # (K, R, 4)
    obs_ring_valid: torch.Tensor  # (K, R) bool
    num_tracks: torch.Tensor   # () int32


class Detections(NamedTuple):
    bboxes: torch.Tensor   # (Nd, 4) xyxy, inflated
    scores: torch.Tensor
    labels: torch.Tensor   # int32
    scales: torch.Tensor
    depths: torch.Tensor
    valid: torch.Tensor    # bool


class TrackerOutput(NamedTuple):
    bboxes: torch.Tensor
    scores: torch.Tensor
    labels: torch.Tensor
    scales: torch.Tensor
    depths: torch.Tensor
    ids: torch.Tensor      # (Nd,) int32, -1 invalid
    valid: torch.Tensor


def init_state(cfg: TrackerConfig, device=None,
               n_streams: Optional[int] = None) -> TrackState:
    """Empty slots; with ``n_streams`` every field gets a leading stream
    axis of that size."""
    K, R = cfg.num_slots, cfg.ring_size
    f32, i32 = torch.float32, torch.int32
    lead = () if n_streams is None else (n_streams,)

    def z(*shape, dtype=f32, fill=0):
        return torch.full(lead + shape, fill, dtype=dtype, device=device)

    return TrackState(
        active=z(K, dtype=torch.bool), tentative=z(K, dtype=torch.bool),
        tracked=z(K, dtype=torch.bool), ids=z(K, dtype=i32, fill=-1),
        labels=z(K, dtype=i32), mean=z(K, 8), cov=z(K, 8, 8),
        saved_mean=z(K, 8), saved_cov=z(K, 8, 8), last_bbox=z(K, 4),
        scores=z(K), scales=z(K, fill=1), depths=z(K, fill=-1),
        velocity=z(K, 2, fill=-1), last_frame=z(K, dtype=i32, fill=-1),
        hits=z(K, dtype=i32), miss_count=z(K, dtype=i32),
        obs_count=z(K, dtype=i32), obs_ring=z(K, R, 4),
        obs_ring_valid=z(K, R, dtype=torch.bool),
        num_tracks=z(dtype=i32))


def _select_streams(mask: torch.Tensor, a: NamedTuple, b: NamedTuple):
    """Per stream, the fields of ``a`` where ``mask`` (S,) holds, else
    those of ``b`` (both with a leading stream axis)."""
    return type(a)(*(torch.where(mask.view(-1, *[1] * (x.dim() - 1)), x, y)
                     for x, y in zip(a, b)))


def _k_step_observation(state: TrackState, cfg: TrackerConfig,
                        obs_count: torch.Tensor) -> torch.Tensor:
    R = cfg.ring_size
    pos = torch.remainder(obs_count - 1 - cfg.vel_delta_t, R).long()
    k_obs = state.obs_ring.gather(
        2, pos[..., None, None].expand(-1, -1, 1, 4))[:, :, 0]
    k_valid = state.obs_ring_valid.gather(2, pos[..., None])[..., 0]
    use_ring = (obs_count > cfg.vel_delta_t) & k_valid
    return torch.where(use_ring[..., None], k_obs, state.last_bbox)


def _centers(b):
    return (b[..., :2] + b[..., 2:]) / 2.0


def _vel_direction_batch(boxes_from, boxes_to):
    c_from, c_to = _centers(boxes_from), _centers(boxes_to)
    dy = c_to[:, None, :, 1] - c_from[:, :, None, 1]
    dx = c_to[:, None, :, 0] - c_from[:, :, None, 0]
    speed = torch.stack([dy, dx], -1)
    norm = torch.sqrt(speed[..., 0] ** 2 + speed[..., 1] ** 2) + 1e-6
    return speed / norm[..., None]


def _ocm_cost(track_boxes, state: TrackState, dets: Detections,
              cfg: TrackerConfig) -> torch.Tensor:
    ious = bbox_iou_matrix(track_boxes, dets.bboxes)
    if cfg.weight_iou_with_det_scores:
        ious = ious * dets.scores[:, None, :]
    cost = 1.0 - ious
    k_obs = _k_step_observation(state, cfg, state.obs_count)
    valid = (state.velocity.sum(-1) != -2.0) & (k_obs.sum(-1) != -4.0)
    vel_to_match = _vel_direction_batch(k_obs, dets.bboxes)
    angle_cos = (vel_to_match * state.velocity[:, :, None, :]).sum(-1)
    angle = torch.arccos(angle_cos.clamp(-1.0, 1.0))
    norm_angle = (angle - math.pi / 2.0) / math.pi
    return cost + torch.where(valid[..., None], norm_angle, 0.0) * \
        cfg.vel_consist_weight


def _assign(cost, row_mask, col_mask, cfg: TrackerConfig):
    return linear_assignment_with_limit(cost, row_mask, col_mask,
                                        1.0 - cfg.match_iou_thr)


def replay_bound(cfg: TrackerConfig) -> int:
    """The largest ``miss_count`` a track can carry into the step that
    recovers it, and so the smoothing replay's fixed trip count on the CPU
    and the most updates the kernel replays for one slot.

    A track's ``miss_count`` is reset to 0 whenever it is matched (its
    ``last_frame`` set to that frame) or spawned, and grows by one per main
    path step that leaves it unmatched, while the frame id grows by at
    least one per step: so ``miss_count <= f - last_frame`` after the step
    of frame f.  ``_evict`` drops a track once ``f - last_frame >=
    num_frames_retain``, so a track still active after a step has
    ``miss_count <= num_frames_retain - 1``, and that is its
    ``unmatch_len`` when the next step recovers it.  This holds while each
    stream's frame ids increase by at least one per step or restart at 0:
    the tracker objects hold host ids to that order (``FrameIdOrder``), and
    a caller giving ids as device tensors keeps them in it."""
    return max(cfg.num_frames_retain - 1, 0)


class FrameIdOrder:
    """The frame-id order ``replay_bound`` relies on, for one tracker
    object's streams: each stream's id is 0 (a restart) or larger than its
    id of the step before.  ``check`` raises on host ids out of that order
    and reads nothing from the device; ids given as a tensor are not
    checked (that would read them back to the host), and the check starts
    afresh after them and after ``reset``."""

    def __init__(self):
        self.last: Optional[np.ndarray] = None

    def reset(self) -> None:
        self.last = None

    def check(self, frame_ids) -> None:
        if torch.is_tensor(frame_ids):
            self.last = None
            return
        ids = np.asarray(frame_ids, np.int64).reshape(-1)
        if self.last is not None and ids.shape == self.last.shape:
            bad = np.flatnonzero((ids != 0) & (ids <= self.last))
            if bad.size:
                s = int(bad[0])
                raise ValueError(
                    f'stream {s}: frame id {ids[s]} after {self.last[s]}; a '
                    f'stream\'s frame ids must grow by at least one per step '
                    f'or restart at 0')
        self.last = ids


def frame_ids_on(frame_id, n_streams: int, device) -> torch.Tensor:
    """Frame ids as an (S,) int32 tensor on ``device``: a tensor stays on
    the device it is on (moved only when it is elsewhere); host ints go
    through pinned memory (``to_device``), so neither reads the device."""
    if torch.is_tensor(frame_id):
        fid = frame_id.to(device=device, dtype=torch.int32).reshape(-1)
    else:
        fid = to_device(np.asarray(frame_id, np.int32).reshape(-1), device)
    if fid.shape[0] != n_streams:
        raise ValueError(f'{n_streams} frame ids expected, got '
                         f'{fid.shape[0]}')
    return fid


def step(state: TrackState, dets: Detections, frame_id,
         cfg: TrackerConfig, warp: Optional[torch.Tensor] = None,
         warp_on: Optional[torch.Tensor] = None
         ) -> Tuple[TrackState, TrackerOutput]:
    """Advance the tracker one frame.  One stream: fields (K, ...) and
    (Nd, ...), ``frame_id`` an int or a 0-d tensor.  S streams: every field
    with a leading stream axis and ``frame_id`` S ints or an (S,) int32
    tensor (a stream at frame 0 starts afresh; each stream's ids grow by at
    least one per step or restart at 0, see ``replay_bound``).  Branch-free: both the
    init and the main path run and are selected per stream, and nothing is
    read back to the host.

    ``warp``: optional camera-motion affine, (2, 3) for one stream or
    (S, 2, 3), applied to the confirmed tracks' Kalman states right after
    the prediction, on the main path only (as the JAX ``step``); it applies
    to the streams where ``warp_on`` ((S,) bool, or a 0-d bool for one
    stream; all streams when not given) is set.  A stream with the warp
    off steps bit for bit as without one."""
    if state.num_tracks.dim() == 0:
        st, out = step(add_stream_axis(state), add_stream_axis(dets),
                       frame_id if torch.is_tensor(frame_id) else [frame_id],
                       cfg, None if warp is None else warp[None],
                       None if warp_on is None else warp_on.reshape(1))
        return first_stream(st), first_stream(out)
    dev = state.active.device
    n_streams = state.active.shape[0]
    fid = frame_ids_on(frame_id, n_streams, dev)
    state = _select_streams(fid == 0, init_state(cfg, dev, n_streams), state)
    use_init = ~state.active.any(1) | ~dets.valid.any(1)
    if warp is not None and warp_on is None:
        warp_on = torch.ones(n_streams, dtype=torch.bool, device=dev)
    a = _init_path(state, dets, fid, cfg)
    b = _main_path(state, dets, fid, cfg, warp, warp_on)
    return (_select_streams(use_init, a[0], b[0]),
            _select_streams(use_init, a[1], b[1]))


def assign_state(dst: TrackState, src: TrackState) -> None:
    """Write ``src`` into ``dst``'s tensors in place: a captured step
    (models/captured_step.py) reads and writes those very tensors."""
    for d, s in zip(dst, src):
        if d is not s:
            d.copy_(s)


def add_stream_axis(t: NamedTuple):
    """A one-stream tuple of tensors as a batch of one stream."""
    return type(t)(*(x[None] for x in t))


def first_stream(t: NamedTuple):
    """Stream 0 of a tuple of tensors with a leading stream axis."""
    return type(t)(*(x[0] for x in t))


def _new_ids(state: TrackState, is_new: torch.Tensor) -> torch.Tensor:
    ids = state.num_tracks[:, None] + torch.cumsum(
        is_new.to(torch.int32), 1) - 1
    return torch.where(is_new, ids, -1).to(torch.int32)


def _count_new(state: TrackState, is_new: torch.Tensor) -> TrackState:
    return state._replace(num_tracks=(
        state.num_tracks + is_new.sum(1, dtype=torch.int32)).to(torch.int32))


def _init_path(state, dets, fid, cfg):
    is_new = dets.valid & (dets.scores > cfg.init_track_thr)
    new_ids = _new_ids(state, is_new)
    state = _spawn_tracks(state, dets, is_new, new_ids, fid, cfg)
    state = _count_new(_evict(state, fid, cfg), is_new)
    out = TrackerOutput(bboxes=dets.bboxes, scores=dets.scores,
                        labels=dets.labels, scales=dets.scales,
                        depths=dets.depths, ids=new_ids, valid=is_new)
    return state, out


def _main_path(state, dets, fid, cfg, warp=None, warp_on=None):
    K = cfg.num_slots
    gate = dets.valid & (dets.scores > cfg.obj_score_thr) & \
        (bbox_area(dets.bboxes) > cfg.min_det_area)

    # 1. Kalman predict on confirmed tracks
    confirmed = state.active & ~state.tentative
    lost = state.last_frame != (fid - 1)[:, None]
    mean = state.mean.clone()
    mean[..., 7] = torch.where(confirmed & lost, 0.0, state.mean[..., 7])
    save = confirmed & state.tracked
    saved_mean = torch.where(save[..., None], mean, state.saved_mean)
    saved_cov = torch.where(save[..., None, None], state.cov,
                            state.saved_cov)
    pmean, pcov = kalman.predict(mean, state.cov)
    mean = torch.where(confirmed[..., None], pmean, mean)
    cov = torch.where(confirmed[..., None, None], pcov, state.cov)
    if warp is not None:
        # camera-motion compensation of the persistent Kalman states (not
        # of the saved ones), where the stream's warp is on
        mean, cov = apply_warp_to_tracks(mean, cov, warp,
                                         confirmed & warp_on[:, None])
    state = state._replace(mean=mean, cov=cov, saved_mean=saved_mean,
                           saved_cov=saved_cov)
    track_boxes = bbox_cxcyah_to_xyxy(mean[..., :4])

    # 2-4. OCM on confirmed, OCM on tentative, OCR on the rest
    cost = _ocm_cost(track_boxes, state, dets, cfg)
    row1, col1 = _assign(cost, confirmed, gate, cfg)
    det_matched1 = col1 >= 0
    tentative = state.active & state.tentative
    row2, col2 = _assign(cost, tentative, gate & ~det_matched1, cfg)
    det_matched2 = col2 >= 0
    ocr_rows = state.active & ~((row1 >= 0) | (row2 >= 0))
    ocr_ious = bbox_iou_matrix(state.last_bbox, dets.bboxes)
    if cfg.weight_iou_with_det_scores:
        ocr_ious = ocr_ious * dets.scores[:, None, :]
    row3, col3 = _assign(1.0 - ocr_ious, ocr_rows,
                         gate & ~det_matched1 & ~det_matched2, cfg)

    det_slot = torch.where(det_matched1, col1,
                           torch.where(det_matched2, col2, col3))
    det_matched = det_slot >= 0
    slot_det = torch.where(row1 >= 0, row1, torch.where(row2 >= 0, row2,
                                                        row3))

    # 5-7. online smoothing of recovered tracks, Kalman update and
    # bookkeeping of matched tracks: one kernel on the card
    state = slot_update(state, slot_det, dets, fid, cfg)

    # 8. new tracks for unmatched gated dets; 9. eviction
    is_new = gate & ~det_matched
    new_ids = _new_ids(state, is_new)
    state = _spawn_tracks(state, dets, is_new, new_ids, fid, cfg)
    state = _count_new(_evict(state, fid, cfg), is_new)

    safe_slot = det_slot.clamp(0, K - 1).long()
    out_ids = torch.where(det_matched, state.ids.gather(1, safe_slot),
                          new_ids)
    out = TrackerOutput(bboxes=dets.bboxes, scores=dets.scores,
                        labels=dets.labels, scales=dets.scales,
                        depths=dets.depths, ids=out_ids.to(torch.int32),
                        valid=gate)
    return state, out


def _scatter(target: torch.Tensor, idx: torch.Tensor, values) -> torch.Tensor:
    """Per stream, target.at[idx].set(values, mode='drop') for idx (S, Nd)
    in [0, K] (K = drop): written through a padded copy, so no host sync.
    ``values``: (S, Nd, ...) or a scalar."""
    S, K = target.shape[:2]
    pad = torch.cat([target, target[:, :1]], 1)
    if not torch.is_tensor(values):
        values = torch.full(idx.shape + target.shape[2:], values,
                            dtype=target.dtype, device=target.device)
    rows = torch.arange(S, device=idx.device)[:, None].expand_as(idx)
    pad[rows, idx.long()] = values.to(target.dtype)
    return pad[:, :K]


def _spawn_tracks(state: TrackState, dets: Detections, is_new, new_ids,
                  fid: torch.Tensor, cfg: TrackerConfig) -> TrackState:
    K, R = cfg.num_slots, cfg.ring_size
    S, Nd = dets.bboxes.shape[:2]
    dev = dets.bboxes.device
    free = ~state.active
    free_order = torch.sort((~free).to(torch.int8), dim=1,
                            stable=True).indices
    num_free = free.sum(1, dtype=torch.int32)
    new_rank = torch.cumsum(is_new.to(torch.int32), 1) - 1
    fits = is_new & (new_rank < num_free[:, None])
    slot = torch.where(
        fits, free_order.gather(1, new_rank.clamp(0, K - 1).long()), K)

    imean, icov = kalman.initiate(bbox_xyxy_to_cxcyah(dets.bboxes))
    ring = torch.zeros((S, Nd, R, 4), dtype=torch.float32, device=dev)
    ring[:, :, 0] = dets.bboxes
    ring_valid = torch.zeros((S, Nd, R), dtype=torch.bool, device=dev)
    ring_valid[:, :, 0] = True
    per_det = fid[:, None].expand(-1, Nd)
    st = state
    return st._replace(
        active=_scatter(st.active, slot, True),
        tentative=_scatter(st.tentative, slot, per_det != 0),
        tracked=_scatter(st.tracked, slot, True),
        ids=_scatter(st.ids, slot, new_ids),
        labels=_scatter(st.labels, slot, dets.labels),
        mean=_scatter(st.mean, slot, imean),
        cov=_scatter(st.cov, slot, icov),
        saved_mean=_scatter(st.saved_mean, slot, imean),
        saved_cov=_scatter(st.saved_cov, slot, icov),
        last_bbox=_scatter(st.last_bbox, slot, dets.bboxes),
        scores=_scatter(st.scores, slot, dets.scores),
        scales=_scatter(st.scales, slot, dets.scales),
        depths=_scatter(st.depths, slot, dets.depths),
        velocity=_scatter(st.velocity, slot, -1.0),
        last_frame=_scatter(st.last_frame, slot, per_det),
        hits=_scatter(st.hits, slot, 1),
        miss_count=_scatter(st.miss_count, slot, 0),
        obs_count=_scatter(st.obs_count, slot, 1),
        obs_ring=_scatter(st.obs_ring, slot, ring),
        obs_ring_valid=_scatter(st.obs_ring_valid, slot, ring_valid))


def _evict(state: TrackState, fid: torch.Tensor, cfg: TrackerConfig
           ) -> TrackState:
    case1 = (fid[:, None] - state.last_frame) >= cfg.num_frames_retain
    case2 = state.tentative & (state.last_frame != fid[:, None])
    return state._replace(active=state.active & ~(case1 | case2))
