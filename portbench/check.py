"""The comparison that decides ``correct``.

What is judged: the ``FrameResult`` fields that ``track_raw`` returned in
the run, at the run's own sizes.  The detector's part is a function of the
frames alone, so the reference recomputes it for every kept step; the
tracker's part depends on the whole history of a stream, so the reference
follows the tracker step by step from a known state, on the detections the
program itself handed its tracker (the first ``num_dets`` rows of each
step), as a served model's reference reads the served tokens: from the
empty state over the window's first steps, and from the program's own state
after the window over the steps that follow it.

Numbers, over every stream of every step compared (``NUMBERS``; those
that ``limits/<workload>.json`` lists decide ``correct``):

- each detection of the program is matched to the reference's candidate
  of its class nearest in box and score (box gap over the box's size, at
  least 8 px, plus ten times the score gap); ``det_box_max``,
  ``det_box_p99`` and ``det_box_p50`` are the largest, the 99th percentile
  and the median of the matches' box gaps, as a share of that size;
  ``det_score_max``, ``det_score_rms`` and ``det_score_p50`` the largest,
  the root mean square and the median of their score gaps;
- ``det_count_mismatch``: streams of a step whose number of detections
  differs from the reference's (exact: limit 0);
- ``det_rank_gap``: the program's detections, scored by the reference and
  sorted, against the reference's own NMS output sorted, rank by rank
  (a missing or extra detection counts its whole score);
- ``nms_overlap_max``: the largest IoU of two of the program's detections
  of one class in one stream.  Greedy NMS keeps no two above the
  configuration's threshold; its limit is that threshold;
- ``nms_miss_gap``: what greedy NMS keeps unless a kept box suppresses it,
  held against the reference's candidates.  A candidate counts when its
  reference score clears the program's last kept score (where the program
  filled every slot) and the reference's ``pre_nms_top_k``-th by
  ``NMS_SCORE_TOL``, and no detection of the program was matched to it.
  Its shortfall is the threshold less its largest IoU with a detection of
  the program of its class that scores at least its own score less
  ``NMS_SCORE_TOL`` (the threshold itself where none does); the number is
  the largest shortfall, or 0.  A suppression across classes, or one at
  a lower threshold, leaves candidates that nothing of their class
  overlaps;
- ``track_id_mismatch``: detection rows whose track validity, id or label
  differs from the reference tracker's (exact: limit 0);
- ``track_value_err``: the largest relative gap of a valid row's track box,
  score, scale and depth.
"""
from __future__ import annotations

from typing import Dict, Iterable, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from .reference.model import iou_matrix
from .reference.pipeline import Reference

NUMBERS = ('det_box_max', 'det_box_p99', 'det_box_p50', 'det_score_max',
           'det_score_rms', 'det_score_p50', 'det_count_mismatch', 'det_rank_gap', 'nms_overlap_max',
           'nms_miss_gap', 'track_id_mismatch', 'track_value_err')
MIN_BOX_PX = 8.0
SCORE_WEIGHT = 10.0
NMS_SCORE_TOL = 0.004


class DetGaps(NamedTuple):
    boxes: torch.Tensor       # box gap of each matched detection
    scores: torch.Tensor      # score gap of each matched detection
    counts: int               # streams with another number of detections
    rank_gap: float
    overlap: float            # nms_overlap_max
    miss_gap: float           # nms_miss_gap


def _t(a, device):
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def detector_gaps(ref: Reference, img, disp, sf, out: Dict[str, np.ndarray]
                  ) -> DetGaps:
    """One step's numbers of the detector, over every stream."""
    dev = ref.device
    cfg = ref.det_cfg
    cand, kept = ref.detect(_t(img, dev), _t(disp, dev), sf)
    top_k = min(cfg.pre_nms_top_k, cand.scores.shape[1])
    kth = cand.scores.topk(top_k, dim=1).values[:, -1]
    boxes, scores, counts, rank_gap = [], [], 0, 0.0
    overlap, miss_gap = 0.0, 0.0
    min_size = MIN_BOX_PX / min(sf)
    for s in range(img.shape[0]):
        valid = torch.from_numpy(out['det_valid'][s]).to(dev)
        pb = _t(out['det_bboxes'][s], dev)[valid]
        ps = _t(out['det_scores'][s], dev)[valid]
        pl = _t(out['det_labels'][s], dev)[valid].to(torch.int32)
        ref_sorted = kept.scores[s][kept.valid[s]].sort(descending=True)[0]
        counts += int(pb.shape[0] != ref_sorted.shape[0])
        cb, cs, cl = cand.boxes[s], cand.scores[s], cand.labels[s]
        matched = torch.zeros(0, device=dev)
        taken = torch.zeros(cs.shape, dtype=torch.bool, device=dev)
        if pb.shape[0]:
            size = torch.maximum(cb[:, 2] - cb[:, 0], cb[:, 3] - cb[:, 1])
            size = size.clamp(min=min_size)
            gap = torch.zeros((pb.shape[0], cb.shape[0]), device=dev)
            for k in range(4):
                gap = torch.maximum(gap, (pb[:, None, k]
                                          - cb[None, :, k]).abs())
            gap = gap / size[None]
            sgap = (ps[:, None] - cs[None]).abs()
            joint = torch.where(pl[:, None] == cl[None], gap
                                + SCORE_WEIGHT * sgap, float('inf'))
            j = joint.argmin(1)
            rows = torch.arange(pb.shape[0], device=dev)
            boxes.append(gap[rows, j])
            scores.append(sgap[rows, j])
            matched = cs[j].sort(descending=True)[0]
            taken[j] = True
            pair = iou_matrix(pb.double(), pb.double())
            same = (pl[:, None] == pl[None]) & ~torch.eye(
                pb.shape[0], dtype=torch.bool, device=dev)
            if bool(same.any()):
                overlap = max(overlap, float(pair[same].max()))
        n = max(matched.shape[0], ref_sorted.shape[0])
        if n:
            a = torch.zeros(n, device=dev)
            b = torch.zeros(n, device=dev)
            a[:ref_sorted.shape[0]] = ref_sorted
            b[:matched.shape[0]] = matched
            rank_gap = max(rank_gap, float((a - b).abs().max()))
        # candidates that greedy NMS keeps unless a kept box suppresses them
        edge = float(ps.min()) if pb.shape[0] >= cfg.max_per_img \
            else cfg.score_thr
        due = ((cs > max(edge, float(kth[s])) + NMS_SCORE_TOL)
               & (cs > cfg.score_thr) & ~taken)
        if bool(due.any()):
            db, ds, dl = cb[due], cs[due], cl[due]
            if pb.shape[0]:
                iou = iou_matrix(db.double(), pb.double())
                may = (dl[:, None] == pl[None]) & \
                    (ps[None] >= ds[:, None] - NMS_SCORE_TOL)
                best = torch.where(may, iou, 0.0).amax(1)
            else:
                best = torch.zeros(db.shape[0], device=dev)
            miss_gap = max(miss_gap, cfg.nms_iou_thr - float(best.min()))
    empty = torch.zeros(0, device=dev)
    return DetGaps(torch.cat(boxes) if boxes else empty,
                   torch.cat(scores) if scores else empty, counts, rank_gap,
                   overlap, miss_gap)


def _rel(a: torch.Tensor, b: torch.Tensor, floor: float) -> torch.Tensor:
    return (a - b).abs() / b.abs().clamp(min=floor)


def tracker_gaps(ref: Reference, state, steps: Iterable, video, sf
                 ) -> Tuple[int, float]:
    """Follow the tracker from ``state`` over ``steps`` = [(frame id, ring
    index, out)], each on the program's own detection rows; returns
    (mismatched rows, largest relative value gap)."""
    dev = ref.device
    nd = ref.trk_cfg.num_dets
    imgs, disps = video
    mismatch, value_err = 0, 0.0
    min_size = MIN_BOX_PX / min(sf)
    for fid, r, out in steps:
        disp = ref.disparity(_t(disps[r], dev))
        n = disp.shape[0]
        state, tf = ref.track(
            state, _t(out['det_bboxes'][:, :nd], dev),
            _t(out['det_scores'][:, :nd], dev),
            _t(out['det_labels'][:, :nd], dev),
            _t(out['det_valid'][:, :nd], dev), disp,
            torch.full((n,), fid, dtype=torch.int32, device=dev))
        pv = _t(out['track_valid'], dev)
        pid = _t(out['track_ids'], dev)
        plab = _t(out['track_labels'], dev).to(torch.int32)
        bad = (pv != tf.track_valid) | (tf.track_valid & (
            (pid != tf.track_ids) | (plab != tf.track_labels)))
        mismatch += int(bad.sum())
        both = pv & tf.track_valid
        if bool(both.any()):
            pb = _t(out['track_bboxes'], dev)
            size = torch.maximum(tf.track_bboxes[..., 2] - tf.track_bboxes[..., 0],
                                 tf.track_bboxes[..., 3] - tf.track_bboxes[..., 1])
            box = (pb - tf.track_bboxes).abs().amax(-1) / size.clamp(
                min=min_size)
            gaps = [box,
                    _rel(_t(out['track_scores'], dev), tf.track_scores, 1e-3),
                    _rel(_t(out['track_scales'], dev), tf.track_scales, 1.0),
                    _rel(_t(out['track_depths'], dev), tf.track_depths, 1.0)]
            value_err = max(value_err, max(float(g[both].max())
                                           for g in gaps))
    return mismatch, value_err


def judge(ref: Reference, video, sf, detector_steps: List[Tuple[int, dict]],
          tracker_runs: List[Tuple[object, list]]) -> Dict[str, float]:
    """Every number of ``NUMBERS``.  ``detector_steps``: [(ring index,
    out)]; ``tracker_runs``: [(start state, [(frame id, ring index,
    out)])]."""
    imgs, disps = video
    boxes, scores, counts, rank, overlap, miss = [], [], 0, 0.0, 0.0, 0.0
    for r, out in detector_steps:
        g = detector_gaps(ref, imgs[r], disps[r], sf, out)
        boxes.append(g.boxes)
        scores.append(g.scores)
        counts += g.counts
        rank = max(rank, g.rank_gap)
        overlap = max(overlap, g.overlap)
        miss = max(miss, g.miss_gap)
    boxes, scores = torch.cat(boxes), torch.cat(scores)
    if not boxes.numel():
        # no detection to match: every number of the detector fails
        boxes = scores = torch.full((1,), float('inf'))
    mismatch, value = 0, 0.0
    for state, steps in tracker_runs:
        m, v = tracker_gaps(ref, state, steps, video, sf)
        mismatch, value = mismatch + m, max(value, v)
    box_q = torch.quantile(boxes.float().cpu(), torch.tensor([0.5, 0.99]))
    return dict(det_box_max=float(boxes.max()),
                det_box_p99=float(box_q[1]), det_box_p50=float(box_q[0]),
                det_score_max=float(scores.max()),
                det_score_rms=float(scores.double().pow(2).mean().sqrt()),
                det_score_p50=float(torch.quantile(scores.float().cpu(), 0.5)),
                det_count_mismatch=float(counts), det_rank_gap=rank,
                nms_overlap_max=overlap, nms_miss_gap=miss,
                track_id_mismatch=float(mismatch),
                track_value_err=value)


def verdict(values: Dict[str, float], limits: Optional[Dict[str, float]]
            ) -> Tuple[bool, Dict[str, dict]]:
    """(correct, {name: {value, limit}} of the numbers ``limits`` lists):
    correct when each is at or under its limit; without limits, false."""
    if not limits:
        return False, {}
    rows = {n: {'value': values.get(n), 'limit': lim}
            for n, lim in limits.items()}
    ok = all(r['value'] is not None and r['value'] <= r['limit']
             for r in rows.values())
    return ok, rows
