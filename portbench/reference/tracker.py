"""OC-SORT with depth-scaled boxes over K fixed slots per stream, in plain
PyTorch with a numpy Jonker-Volgenant solver: gate detections; Kalman
predict on confirmed tracks; velocity-consistent association (OCM) on
confirmed, then tentative tracks; observation-centric recovery (OCR) on
the rest; online smoothing of recovered tracks; Kalman update and
bookkeeping; new tracks; eviction.  Every field carries a leading stream
axis; a stream at frame 0, or with no live track or no detection, takes
the init path.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

_STD_POS = 1.0 / 20
_STD_VEL = 1.0 / 160
_BIG = 1e4
_INF = 1e18


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
    active: torch.Tensor
    tentative: torch.Tensor
    tracked: torch.Tensor
    ids: torch.Tensor
    labels: torch.Tensor
    mean: torch.Tensor
    cov: torch.Tensor
    saved_mean: torch.Tensor
    saved_cov: torch.Tensor
    last_bbox: torch.Tensor
    scores: torch.Tensor
    scales: torch.Tensor
    depths: torch.Tensor
    velocity: torch.Tensor
    last_frame: torch.Tensor
    hits: torch.Tensor
    miss_count: torch.Tensor
    obs_count: torch.Tensor
    obs_ring: torch.Tensor
    obs_ring_valid: torch.Tensor
    num_tracks: torch.Tensor


class Detections(NamedTuple):
    bboxes: torch.Tensor
    scores: torch.Tensor
    labels: torch.Tensor
    scales: torch.Tensor
    depths: torch.Tensor
    valid: torch.Tensor


def tracker_config(trk: dict) -> TrackerConfig:
    """The tracker's settings from a config's ``model['tracker']`` dict."""
    return TrackerConfig(
        num_slots=trk.get('num_slots', 64), num_dets=trk.get('num_dets', 64),
        obj_score_thr=trk.get('obj_score_thr', 0.3),
        init_track_thr=trk.get('init_track_thr', 0.7),
        weight_iou_with_det_scores=trk.get('weight_iou_with_det_scores',
                                           True),
        match_iou_thr=trk.get('match_iou_thr', 0.3),
        num_tentatives=trk.get('num_tentatives', 3),
        vel_consist_weight=trk.get('vel_consist_weight', 0.2),
        vel_delta_t=trk.get('vel_delta_t', 3),
        num_frames_retain=trk.get('num_frames_retain', 10))


def init_state(cfg: TrackerConfig, device, n_streams: int) -> TrackState:
    K, R = cfg.num_slots, cfg.ring_size
    f32, i32 = torch.float32, torch.int32

    def z(*shape, dtype=f32, fill=0):
        return torch.full((n_streams,) + shape, fill, dtype=dtype,
                          device=device)

    return TrackState(
        active=z(K, dtype=torch.bool), tentative=z(K, dtype=torch.bool),
        tracked=z(K, dtype=torch.bool), ids=z(K, dtype=i32, fill=-1),
        labels=z(K, dtype=i32), mean=z(K, 8), cov=z(K, 8, 8),
        saved_mean=z(K, 8), saved_cov=z(K, 8, 8), last_bbox=z(K, 4),
        scores=z(K), scales=z(K, fill=1), depths=z(K, fill=-1),
        velocity=z(K, 2, fill=-1), last_frame=z(K, dtype=i32, fill=-1),
        hits=z(K, dtype=i32), miss_count=z(K, dtype=i32),
        obs_count=z(K, dtype=i32), obs_ring=z(K, R, 4),
        obs_ring_valid=z(K, R, dtype=torch.bool), num_tracks=z(dtype=i32))


# ---------------------------------------------------------------- geometry

def xyxy_to_cxcyah(b):
    x1, y1, x2, y2 = b.unbind(-1)
    return torch.stack([(x2 + x1) / 2.0, (y2 + y1) / 2.0,
                        (x2 - x1) / (y2 - y1), y2 - y1], -1)


def cxcyah_to_xyxy(b):
    cx, cy, ratio, h = b.unbind(-1)
    w = ratio * h
    return torch.stack([cx - w / 2.0, cy - h / 2.0, cx + w / 2.0,
                        cy + h / 2.0], -1)


def scale_bbox(b, scales):
    x1, y1, x2, y2 = b.unbind(-1)
    cx, cy = (x1 + x2) / 2.0, (y1 + y2) / 2.0
    w, h = (x2 - x1) * scales, (y2 - y1) * scales
    return torch.stack([cx - w / 2.0, cy - h / 2.0, cx + w / 2.0,
                        cy + h / 2.0], -1)


def area(b):
    return (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])


def iou_matrix(b1, b2, eps=1e-6):
    lt = torch.maximum(b1[..., :, None, :2], b2[..., None, :, :2])
    rb = torch.minimum(b1[..., :, None, 2:], b2[..., None, :, 2:])
    wh = (rb - lt).clamp(min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    union = (area(b1)[..., :, None] + area(b2)[..., None, :]
             - inter).clamp(min=eps)
    return inter / union


# ------------------------------------------------------------------ Kalman

def _motion_mat(device):
    return torch.eye(8, dtype=torch.float32, device=device) + torch.diag(
        torch.ones(4, dtype=torch.float32, device=device), 4)


def _diag(std):
    return torch.diag_embed(std.square())


def k_initiate(m):
    mean = torch.cat([m, torch.zeros_like(m)], -1)
    h = m[..., 3]
    std = torch.stack([2 * _STD_POS * h, 2 * _STD_POS * h,
                       torch.full_like(h, 1e-2), 2 * _STD_POS * h,
                       10 * _STD_VEL * h, 10 * _STD_VEL * h,
                       torch.full_like(h, 1e-5), 10 * _STD_VEL * h], -1)
    return mean.float(), _diag(std).float()


def k_predict(mean, cov):
    h = mean[..., 3]
    std = torch.stack([_STD_POS * h, _STD_POS * h, torch.full_like(h, 1e-2),
                       _STD_POS * h, _STD_VEL * h, _STD_VEL * h,
                       torch.full_like(h, 1e-5), _STD_VEL * h], -1)
    f = _motion_mat(mean.device)
    return mean @ f.T, f @ cov @ f.T + _diag(std)


def k_update(mean, cov, meas):
    h = mean[..., 3]
    std = torch.stack([_STD_POS * h, _STD_POS * h, torch.full_like(h, 1e-1),
                       _STD_POS * h], -1)
    proj_mean, proj_cov = mean[..., :4], cov[..., :4, :4] + _diag(std)
    chol = torch.linalg.cholesky_ex(proj_cov, check_errors=False).L
    half = torch.linalg.solve_triangular(
        chol, cov[..., :, :4].transpose(-1, -2), upper=False)
    gain = torch.linalg.solve_triangular(chol.transpose(-1, -2), half,
                                         upper=True).transpose(-1, -2)
    new_mean = mean + (gain @ (meas - proj_mean)[..., None])[..., 0]
    return new_mean, cov - gain @ proj_cov @ gain.transpose(-1, -2)


# -------------------------------------------------------------- assignment

def _assign_row(cost, u, v, col2row, row2col, i):
    k, c = cost.shape
    minv = cost[i] - u[i] - v
    way = np.full((c,), -1, np.int32)
    used = np.zeros((c,), bool)
    row_used = np.zeros((k,), bool)
    j0 = int(np.argmin(minv))
    delta = minv[j0]
    u[i] += delta
    minv = minv - delta
    while col2row[j0] != -1:
        used[j0] = True
        i0 = col2row[j0]
        row_used[i0] = True
        cur = cost[i0] - u[i0] - v
        improve = ~used & (cur < minv)
        minv = np.where(improve, cur, minv)
        way = np.where(improve, np.int32(j0), way)
        masked = np.where(used, np.float32(_INF), minv)
        j1 = int(np.argmin(masked))
        delta = masked[j1]
        u[row_used] += delta
        u[i] += delta
        v[used] -= delta
        minv = np.where(used, minv, minv - delta)
        j0 = j1
    while True:
        jprev = way[j0]
        new_row = i if jprev == -1 else col2row[max(jprev, 0)]
        col2row[j0] = new_row
        row2col[new_row] = j0
        if jprev == -1:
            break
        j0 = jprev


def jv(cost: np.ndarray, rows: np.ndarray) -> np.ndarray:
    """Shortest-augmenting-path assignment of the K x C float32 ``cost``,
    the rows in ``rows`` in ascending order; row -> column, -1 if none."""
    k, c = cost.shape
    u, v = np.zeros((k,), np.float32), np.zeros((c,), np.float32)
    col2row = np.full((c,), -1, np.int32)
    row2col = np.full((k,), -1, np.int32)
    for i in np.flatnonzero(rows):
        _assign_row(cost, u, v, col2row, row2col, int(i))
    return row2col


def _scatter_rows(idx, n):
    s, k = idx.shape
    out = torch.full((s, n + 1), -1, dtype=torch.int32, device=idx.device)
    rows = torch.arange(k, dtype=torch.int32, device=idx.device)
    out.scatter_(1, idx.long(), rows.expand(s, k).contiguous())
    return out[:, :n]


def assign(cost, row_mask, col_mask, limit_value):
    """Masked rectangular assignment where pairs at or above the limit never
    match: (row_assign (S, K), col_assign (S, N)), -1 unmatched.  Rows with
    one private candidate take it; the rest go to the JV solver."""
    s, k, n = cost.shape
    dev = cost.device
    costf = cost.float()
    limit = torch.full((), limit_value, dtype=torch.float32, device=dev)
    cand = row_mask[:, :, None] & col_mask[:, None, :] & (costf < limit)
    row_deg = cand.sum(2)
    col_private = cand.sum(1) == 1
    star = row_mask & (row_deg > 0) & (~cand | col_private[:, None, :]).all(2)
    star_col = torch.where(cand, costf, torch.full(
        (), _INF, dtype=torch.float32, device=dev)).argmin(2).to(torch.int32)
    need = row_mask & (row_deg > 0) & ~star
    taken = _scatter_rows(torch.where(star, star_col, n), n) >= 0
    col_mask2 = col_mask & ~taken
    real = torch.where(need[:, :, None] & col_mask2[:, None, :],
                       costf - limit,
                       torch.full((), _BIG, dtype=torch.float32, device=dev))
    ext = torch.cat([real, torch.zeros((s, k, k), dtype=torch.float32,
                                       device=dev)], 2).cpu().numpy()
    need_np = need.cpu().numpy()
    row2col = torch.from_numpy(np.stack(
        [jv(ext[i], need_np[i]) for i in range(s)])).to(dev)
    ra = torch.where(need & (row2col < n) & (row2col >= 0), row2col, -1)
    ra = torch.where(star, star_col, ra)
    ok = (ra >= 0) & col_mask.gather(1, ra.clamp(0, n - 1).long())
    ra = torch.where(ok, ra, -1).to(torch.int32)
    return ra, _scatter_rows(torch.where(ra >= 0, ra, n), n)


# ----------------------------------------------------------------- tracker

def _select(mask, a, b):
    return type(a)(*(torch.where(mask.view(-1, *[1] * (x.dim() - 1)), x, y)
                     for x, y in zip(a, b)))


def _k_obs(state, cfg, obs_count):
    R = cfg.ring_size
    pos = torch.remainder(obs_count - 1 - cfg.vel_delta_t, R).long()
    k_obs = state.obs_ring.gather(
        2, pos[..., None, None].expand(-1, -1, 1, 4))[:, :, 0]
    k_valid = state.obs_ring_valid.gather(2, pos[..., None])[..., 0]
    use = (obs_count > cfg.vel_delta_t) & k_valid
    return torch.where(use[..., None], k_obs, state.last_bbox)


def _centers(b):
    return (b[..., :2] + b[..., 2:]) / 2.0


def _vel_dir_batch(b_from, b_to):
    c_from, c_to = _centers(b_from), _centers(b_to)
    dy = c_to[:, None, :, 1] - c_from[:, :, None, 1]
    dx = c_to[:, None, :, 0] - c_from[:, :, None, 0]
    speed = torch.stack([dy, dx], -1)
    norm = torch.sqrt(speed[..., 0] ** 2 + speed[..., 1] ** 2) + 1e-6
    return speed / norm[..., None]


def _vel_dir(b_from, b_to):
    c1, c2 = _centers(b_from), _centers(b_to)
    speed = torch.stack([c2[..., 1] - c1[..., 1], c2[..., 0] - c1[..., 0]],
                        -1)
    norm = torch.sqrt(speed[..., 0] ** 2 + speed[..., 1] ** 2) + 1e-6
    direction = speed / norm[..., None]
    invalid = (b_from.sum(-1) < 0) | (b_to.sum(-1) < 0)
    return torch.where(invalid[..., None], -1.0, direction)


def _ocm_cost(track_boxes, state, dets, cfg):
    ious = iou_matrix(track_boxes, dets.bboxes)
    if cfg.weight_iou_with_det_scores:
        ious = ious * dets.scores[:, None, :]
    k_obs = _k_obs(state, cfg, state.obs_count)
    valid = (state.velocity.sum(-1) != -2.0) & (k_obs.sum(-1) != -4.0)
    vel = _vel_dir_batch(k_obs, dets.bboxes)
    angle = torch.arccos((vel * state.velocity[:, :, None, :]).sum(-1).clamp(
        -1.0, 1.0))
    norm_angle = (angle - math.pi / 2.0) / math.pi
    return 1.0 - ious + torch.where(valid[..., None], norm_angle, 0.0) * \
        cfg.vel_consist_weight


def _new_ids(state, is_new):
    ids = state.num_tracks[:, None] + torch.cumsum(
        is_new.to(torch.int32), 1) - 1
    return torch.where(is_new, ids, -1).to(torch.int32)


def _count_new(state, is_new):
    return state._replace(num_tracks=(
        state.num_tracks + is_new.sum(1, dtype=torch.int32)).to(torch.int32))


def _scatter(target, idx, values):
    S, K = target.shape[:2]
    pad = torch.cat([target, target[:, :1]], 1)
    if not torch.is_tensor(values):
        values = torch.full(idx.shape + target.shape[2:], values,
                            dtype=target.dtype, device=target.device)
    rows = torch.arange(S, device=idx.device)[:, None].expand_as(idx)
    pad[rows, idx.long()] = values.to(target.dtype)
    return pad[:, :K]


def _spawn(st, dets, is_new, new_ids, fid, cfg):
    K, R = cfg.num_slots, cfg.ring_size
    S, Nd = dets.bboxes.shape[:2]
    dev = dets.bboxes.device
    free = ~st.active
    free_order = torch.sort((~free).to(torch.int8), dim=1,
                            stable=True).indices
    num_free = free.sum(1, dtype=torch.int32)
    rank = torch.cumsum(is_new.to(torch.int32), 1) - 1
    fits = is_new & (rank < num_free[:, None])
    slot = torch.where(fits, free_order.gather(1, rank.clamp(0, K - 1).long()),
                       K)
    imean, icov = k_initiate(xyxy_to_cxcyah(dets.bboxes))
    ring = torch.zeros((S, Nd, R, 4), dtype=torch.float32, device=dev)
    ring[:, :, 0] = dets.bboxes
    ring_valid = torch.zeros((S, Nd, R), dtype=torch.bool, device=dev)
    ring_valid[:, :, 0] = True
    per_det = fid[:, None].expand(-1, Nd)
    return st._replace(
        active=_scatter(st.active, slot, True),
        tentative=_scatter(st.tentative, slot, per_det != 0),
        tracked=_scatter(st.tracked, slot, True),
        ids=_scatter(st.ids, slot, new_ids),
        labels=_scatter(st.labels, slot, dets.labels),
        mean=_scatter(st.mean, slot, imean), cov=_scatter(st.cov, slot, icov),
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


def _evict(state, fid, cfg):
    case1 = (fid[:, None] - state.last_frame) >= cfg.num_frames_retain
    case2 = state.tentative & (state.last_frame != fid[:, None])
    return state._replace(active=state.active & ~(case1 | case2))


def _init_path(state, dets, fid, cfg):
    is_new = dets.valid & (dets.scores > cfg.init_track_thr)
    new_ids = _new_ids(state, is_new)
    state = _spawn(state, dets, is_new, new_ids, fid, cfg)
    return _count_new(_evict(state, fid, cfg), is_new), new_ids, is_new


def _main_path(state, dets, fid, cfg):
    K, Nd = cfg.num_slots, dets.bboxes.shape[1]
    gate = dets.valid & (dets.scores > cfg.obj_score_thr) & \
        (area(dets.bboxes) > cfg.min_det_area)
    confirmed = state.active & ~state.tentative
    lost = state.last_frame != (fid - 1)[:, None]
    mean = state.mean.clone()
    mean[..., 7] = torch.where(confirmed & lost, 0.0, state.mean[..., 7])
    save = confirmed & state.tracked
    saved_mean = torch.where(save[..., None], mean, state.saved_mean)
    saved_cov = torch.where(save[..., None, None], state.cov,
                            state.saved_cov)
    pmean, pcov = k_predict(mean, state.cov)
    mean = torch.where(confirmed[..., None], pmean, mean)
    cov = torch.where(confirmed[..., None, None], pcov, state.cov)
    state = state._replace(mean=mean, cov=cov, saved_mean=saved_mean,
                           saved_cov=saved_cov)
    track_boxes = cxcyah_to_xyxy(mean[..., :4])

    limit = 1.0 - cfg.match_iou_thr
    cost = _ocm_cost(track_boxes, state, dets, cfg)
    row1, col1 = assign(cost, confirmed, gate, limit)
    m1 = col1 >= 0
    tentative = state.active & state.tentative
    row2, col2 = assign(cost, tentative, gate & ~m1, limit)
    m2 = col2 >= 0
    ocr_rows = state.active & ~((row1 >= 0) | (row2 >= 0))
    ocr_ious = iou_matrix(state.last_bbox, dets.bboxes)
    if cfg.weight_iou_with_det_scores:
        ocr_ious = ocr_ious * dets.scores[:, None, :]
    row3, col3 = assign(1.0 - ocr_ious, ocr_rows, gate & ~m1 & ~m2, limit)

    det_slot = torch.where(m1, col1, torch.where(m2, col2, col3))
    det_matched = det_slot >= 0
    slot_det = torch.where(row1 >= 0, row1, torch.where(row2 >= 0, row2,
                                                        row3))
    slot_matched = slot_det >= 0

    safe_det = slot_det.clamp(0, Nd - 1).long()
    match_bbox = dets.bboxes.gather(1, safe_det[..., None].expand(-1, -1, 4))
    recovered = slot_matched & ~state.tracked
    unmatch_len = torch.where(recovered, state.miss_count, 0)
    shift = (match_bbox - state.last_bbox) / \
        (unmatch_len[..., None].to(torch.float32) + 1.0)
    mean = torch.where(recovered[..., None], state.saved_mean, state.mean)
    cov = torch.where(recovered[..., None, None], state.saved_cov, state.cov)
    for i in range(max(cfg.num_frames_retain - 1, 0)):
        virtual = state.last_bbox + float(i + 1) * shift
        m2_, c2_ = k_update(mean, cov, xyxy_to_cxcyah(virtual))
        apply = recovered & (i < unmatch_len)
        mean = torch.where(apply[..., None], m2_, mean)
        cov = torch.where(apply[..., None, None], c2_, cov)

    umean, ucov = k_update(mean, cov, xyxy_to_cxcyah(match_bbox))
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
    vel = _vel_dir(_k_obs(tmp, cfg, obs_count), match_bbox)
    velocity = torch.where(slot_matched[..., None], vel, state.velocity)

    def at_det(x):
        return x.gather(1, safe_det)

    state = state._replace(
        mean=mean, cov=cov, hits=new_hits, tentative=new_tentative,
        tracked=torch.where(state.active, slot_matched, state.tracked),
        obs_ring=obs_ring, obs_ring_valid=obs_ring_valid,
        obs_count=obs_count, velocity=velocity,
        miss_count=torch.where(slot_matched, 0, torch.where(
            state.active, state.miss_count + 1,
            state.miss_count)).to(torch.int32),
        last_bbox=last_bbox,
        last_frame=torch.where(slot_matched, fid[:, None],
                               state.last_frame).to(torch.int32),
        scores=torch.where(slot_matched, at_det(dets.scores), state.scores),
        scales=torch.where(slot_matched, at_det(dets.scales), state.scales),
        depths=torch.where(slot_matched, at_det(dets.depths), state.depths),
        labels=torch.where(slot_matched, at_det(dets.labels), state.labels))

    is_new = gate & ~det_matched
    new_ids = _new_ids(state, is_new)
    state = _spawn(state, dets, is_new, new_ids, fid, cfg)
    state = _count_new(_evict(state, fid, cfg), is_new)
    safe_slot = det_slot.clamp(0, K - 1).long()
    ids = torch.where(det_matched, state.ids.gather(1, safe_slot), new_ids)
    return state, ids.to(torch.int32), gate


@torch.no_grad()
def step(state: TrackState, dets: Detections, fid: torch.Tensor,
         cfg: TrackerConfig):
    """One frame of S streams; ``fid`` (S,) int32.  Returns the new state,
    the ids (S, Nd) (-1 none) and the validity (S, Nd) of the detections'
    tracks."""
    n = state.active.shape[0]
    state = _select(fid == 0, init_state(cfg, fid.device, n), state)
    use_init = ~state.active.any(1) | ~dets.valid.any(1)
    sa, ida, va = _init_path(state, dets, fid, cfg)
    sb, idb, vb = _main_path(state, dets, fid, cfg)
    m = use_init[:, None]
    return (_select(use_init, sa, sb), torch.where(m, ida, idb),
            torch.where(m, va, vb))
