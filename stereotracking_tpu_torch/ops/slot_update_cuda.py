"""Steps 5-7 of the tracker's main path for S streams' track slots: CUDA
kernel + plain version.

Steps 5-7 are the smoothing replay of recovered tracks, the Kalman update
of matched tracks and the per-slot bookkeeping.  They replace the JAX
package's smoothing ``while_loop`` (``stereotracking_tpu/models/
tracker.py:334-348``), which runs up to the step's largest
``unmatch_len``, and the update and bookkeeping after it.
``slot_update`` launches ``csrc/slot_update.cu`` (eight threads per
(stream, slot), all streams in one launch) on CUDA tensors and runs
``slot_update_plain`` on CPU tensors.  The plain version is the op chain
of ``models/tracker.py``: to stay branch-free in a CUDA graph it runs
``replay_bound(cfg)`` full ``kalman.update`` calls on every slot and
selects their results away past each slot's ``unmatch_len``, exact no-ops.
The kernel runs each recovered slot's ``unmatch_len`` updates and no more;
it agrees with the plain version to float32 rounding (its matrix products
fuse in another order than PyTorch's), and exactly in every integer and
boolean field.

Both add the replay updates they applied, and the step, to the tracer's
counter (``utils/trace.py``, ``replay_counter``): the kernel on the card,
the plain version on the CPU.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import torch

from .. import _kernels
from ..models import kalman
from ..structures.bbox import bbox_xyxy_to_cxcyah
from ..utils import trace

# the fields that steps 5-7 write; the others pass through
OUT_FIELDS = ('mean', 'cov', 'hits', 'tentative', 'tracked', 'obs_ring',
              'obs_ring_valid', 'obs_count', 'velocity', 'miss_count',
              'last_bbox', 'last_frame', 'scores', 'scales', 'depths',
              'labels')
# the state fields the kernel reads, and their dtypes
IN_FIELDS = {'mean': torch.float32, 'cov': torch.float32,
             'saved_mean': torch.float32, 'saved_cov': torch.float32,
             'active': torch.bool, 'tentative': torch.bool,
             'tracked': torch.bool, 'hits': torch.int32,
             'miss_count': torch.int32, 'obs_count': torch.int32,
             'last_frame': torch.int32, 'labels': torch.int32,
             'last_bbox': torch.float32, 'velocity': torch.float32,
             'scores': torch.float32, 'scales': torch.float32,
             'depths': torch.float32, 'obs_ring': torch.float32,
             'obs_ring_valid': torch.bool}
DET_FIELDS = {'bboxes': torch.float32, 'scores': torch.float32,
              'scales': torch.float32, 'depths': torch.float32,
              'labels': torch.int32}
# csrc/slot_update.cu's enum Ptr and enum Dim, in order
POINTERS = (*IN_FIELDS, 'slot_det', 'frame_id',
            *(f'det_{f}' for f in DET_FIELDS),
            *(f'o_{f}' for f in OUT_FIELDS), 'counts')
DIMS = ('streams', 'slots', 'dets', 'ring', 'vel_delta_t', 'num_tentatives',
        'max_replay', *(f'det_{f}_stride' for f in DET_FIELDS))


def _vel_direction(box_from, box_to):
    c1 = (box_from[..., :2] + box_from[..., 2:]) / 2.0
    c2 = (box_to[..., :2] + box_to[..., 2:]) / 2.0
    speed = torch.stack([c2[..., 1] - c1[..., 1], c2[..., 0] - c1[..., 0]],
                        -1)
    norm = torch.sqrt(speed[..., 0] ** 2 + speed[..., 1] ** 2) + 1e-6
    direction = speed / norm[..., None]
    invalid = (box_from.sum(-1) < 0) | (box_to.sum(-1) < 0)
    return torch.where(invalid[..., None], -1.0, direction)


def slot_update_plain(state: NamedTuple, slot_det: torch.Tensor,
                      dets: NamedTuple, fid: torch.Tensor, cfg,
                      trips: Optional[int] = None
                      ) -> Tuple[NamedTuple, torch.Tensor]:
    """Steps 5-7 as the op chain: ``state`` (a ``TrackState``, each field
    with a leading stream axis) after the prediction, ``slot_det`` (S, K)
    the detection matched to each slot (-1: none), ``dets`` the step's
    ``Detections`` and ``fid`` (S,) int32.  The replay runs ``trips``
    iterations (``replay_bound(cfg)`` when not given) whose updates land
    where ``i < unmatch_len``.  Returns the state with ``OUT_FIELDS``
    replaced and the number of replay updates applied (a 0-d int64
    tensor)."""
    from ..models import tracker as trk
    if trips is None:
        trips = trk.replay_bound(cfg)
    Nd = dets.bboxes.shape[1]
    slot_matched = slot_det >= 0
    safe_det = slot_det.clamp(0, Nd - 1).long()
    match_bbox = dets.bboxes.gather(1, safe_det[..., None].expand(-1, -1, 4))
    recovered = slot_matched & ~state.tracked
    unmatch_len = torch.where(recovered, state.miss_count, 0)
    shift = (match_bbox - state.last_bbox) / \
        (unmatch_len[..., None].to(torch.float32) + 1.0)
    mean = torch.where(recovered[..., None], state.saved_mean, state.mean)
    cov = torch.where(recovered[..., None, None], state.saved_cov, state.cov)
    for i in range(trips):                  # no-ops past unmatch_len
        virtual = state.last_bbox + float(i + 1) * shift
        m2, c2 = kalman.update(mean, cov, bbox_xyxy_to_cxcyah(virtual))
        apply = recovered & (i < unmatch_len)
        mean = torch.where(apply[..., None], m2, mean)
        cov = torch.where(apply[..., None, None], c2, cov)
    updates = unmatch_len.clamp(0, trips).sum(dtype=torch.int64)

    umean, ucov = kalman.update(mean, cov, bbox_xyxy_to_cxcyah(match_bbox))
    mean = torch.where(slot_matched[..., None], umean, mean)
    cov = torch.where(slot_matched[..., None, None], ucov, cov)
    new_hits = torch.where(slot_matched, state.hits + 1, state.hits)
    now_confirmed = state.tentative & slot_matched & \
        (new_hits >= cfg.num_tentatives)
    new_tentative = torch.where(now_confirmed, False, state.tentative)

    R = cfg.ring_size
    onehot = ((torch.remainder(state.obs_count, R)[..., None]
               == torch.arange(R, device=state.obs_count.device))
              & state.active[..., None])
    obs_ring = torch.where(onehot[..., None], match_bbox[:, :, None, :],
                           state.obs_ring)
    obs_ring_valid = torch.where(onehot, slot_matched[..., None],
                                 state.obs_ring_valid)
    obs_count = torch.where(state.active, state.obs_count + 1,
                            state.obs_count)
    last_bbox = torch.where(slot_matched[..., None], match_bbox,
                            state.last_bbox)
    tmp = state._replace(obs_ring=obs_ring, obs_ring_valid=obs_ring_valid,
                         last_bbox=last_bbox)
    vel = _vel_direction(trk._k_step_observation(tmp, cfg, obs_count),
                         match_bbox)
    velocity = torch.where(slot_matched[..., None], vel, state.velocity)

    def at_det(x):
        return x.gather(1, safe_det)

    return state._replace(
        mean=mean, cov=cov, hits=new_hits, tentative=new_tentative,
        tracked=torch.where(state.active, slot_matched, state.tracked),
        obs_ring=obs_ring, obs_ring_valid=obs_ring_valid,
        obs_count=obs_count, velocity=velocity,
        miss_count=torch.where(
            slot_matched, 0,
            torch.where(state.active, state.miss_count + 1,
                        state.miss_count)).to(torch.int32),
        last_bbox=last_bbox,
        last_frame=torch.where(slot_matched, fid[:, None],
                               state.last_frame).to(torch.int32),
        scores=torch.where(slot_matched, at_det(dets.scores), state.scores),
        scales=torch.where(slot_matched, at_det(dets.scales), state.scales),
        depths=torch.where(slot_matched, at_det(dets.depths), state.depths),
        labels=torch.where(slot_matched, at_det(dets.labels),
                           state.labels)), updates


def slot_update(state: NamedTuple, slot_det: torch.Tensor,
                dets: NamedTuple, fid: torch.Tensor, cfg) -> NamedTuple:
    """Steps 5-7 of the main path (see ``slot_update_plain`` for the
    arguments): CPU tensors run ``slot_update_plain``, CUDA tensors launch
    the kernel.  Either adds its replay updates and the step to the
    tracer's counter."""
    counter = trace.replay_counter(slot_det)
    if slot_det.device.type == 'cpu':
        new, updates = slot_update_plain(state, slot_det, dets, fid, cfg)
        if counter is not None:
            counter.add_(torch.stack((updates, torch.ones_like(updates))))
        return new
    from ..models import tracker as trk
    S, K = slot_det.shape
    Nd = dets.bboxes.shape[1]
    R = cfg.ring_size
    shapes = {'mean': (8,), 'cov': (8, 8), 'saved_mean': (8,),
              'saved_cov': (8, 8), 'last_bbox': (4,), 'velocity': (2,),
              'obs_ring': (R, 4), 'obs_ring_valid': (R,)}
    ins = {}
    for name, dtype in IN_FIELDS.items():
        t = getattr(state, name)
        want = (S, K, *shapes.get(name, ()))
        if t.shape != want or t.dtype != dtype:
            raise ValueError(f'slot_update: state.{name} must be {want} '
                             f'{dtype}, got {tuple(t.shape)} {t.dtype}')
        ins[name] = t.contiguous()
    det_ins = {}
    for name, dtype in DET_FIELDS.items():
        t = getattr(dets, name)
        want = (S, Nd, 4) if name == 'bboxes' else (S, Nd)
        if t.shape != want or t.dtype != dtype:
            raise ValueError(f'slot_update: dets.{name} must be {want} '
                             f'{dtype}, got {tuple(t.shape)} {t.dtype}')
        det_ins[name] = t
    if slot_det.dtype != torch.int32 or fid.shape != (S,) or \
            fid.dtype != torch.int32:
        raise ValueError(f'slot_update: slot_det must be (S, K) int32 and '
                         f'fid ({S},) int32, got {slot_det.dtype} and '
                         f'{tuple(fid.shape)} {fid.dtype}')
    if Nd < 1:
        raise ValueError('slot_update: the step needs at least one '
                         'detection row')
    if S == 0 or K == 0:
        return state
    # a detection field is read dense inside a stream, streams strided
    det_ins = {n: t if t[0].is_contiguous() else t.contiguous()
               for n, t in det_ins.items()}
    slot_det, fid = slot_det.contiguous(), fid.contiguous()
    _kernels.require_cuda('slot_update', slot_det, fid, *ins.values(),
                          strided=det_ins.values())
    outs = {f: torch.empty_like(ins[f]) for f in OUT_FIELDS}
    tensors = [*ins.values(), slot_det, fid, *det_ins.values(),
               *outs.values()]
    ptrs = (ctypes.c_void_p * len(POINTERS))(
        *(t.data_ptr() for t in tensors),
        None if counter is None else counter.data_ptr())
    dims = (ctypes.c_int * len(DIMS))(
        S, K, Nd, R, cfg.vel_delta_t, cfg.num_tentatives,
        trk.replay_bound(cfg),
        *(t.stride(0) for t in det_ins.values()))
    status = _kernels.library().st_slot_update(
        ptrs, len(POINTERS), dims, len(DIMS), _kernels.stream_ptr(slot_det))
    _kernels.check(status, 'slot_update')
    _kernels.count_launch('slot_update')
    return state._replace(**outs)
