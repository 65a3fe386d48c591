"""CLEAR / Identity / HOTA tracking metrics (host-side numpy).

A copy of ``stereotracking_tpu/evaluation/clear_identity_hota.py`` (numpy
and scipy only), kept here because the port imports nothing of the JAX
package.  The reference bridges to the TrackEval package (mmtrack
``evaluation/metrics/mot_drone_metrics.py:254-321``); the three metric
families are implemented from their definitions with the same matching
conventions TrackEval uses:

* CLEAR: per-frame Hungarian matching on IoU >= 0.5 with a large bonus for
  continuing the previous frame's match; MOTA/MOTP/IDSW/Frag/MT/PT/ML/TP/FP/FN.
* Identity: one global Hungarian over trajectory pairs maximizing IDTP
  (per-frame IoU >= 0.5 hits), giving IDF1/IDR/IDP.
* HOTA: 19 alpha thresholds; per-frame matching maximizes the global
  alignment (Jaccard) score; HOTA = mean_alpha sqrt(DetA * AssA).

Inputs are per-video dicts mapping frame -> (ids, boxes xyxy) arrays.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
from scipy.optimize import linear_sum_assignment


def _iou(b1: np.ndarray, b2: np.ndarray) -> np.ndarray:
    if len(b1) == 0 or len(b2) == 0:
        return np.zeros((len(b1), len(b2)))
    lt = np.maximum(b1[:, None, :2], b2[None, :, :2])
    rb = np.minimum(b1[:, None, 2:], b2[None, :, 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    a1 = (b1[:, 2] - b1[:, 0]) * (b1[:, 3] - b1[:, 1])
    a2 = (b2[:, 2] - b2[:, 0]) * (b2[:, 3] - b2[:, 1])
    return inter / np.maximum(a1[:, None] + a2[None, :] - inter, 1e-10)


class VideoData:
    """Dense per-video GT/pred storage with contiguous re-labelled ids."""

    def __init__(self, gt: Dict[int, Tuple[np.ndarray, np.ndarray]],
                 pred: Dict[int, Tuple[np.ndarray, np.ndarray]]):
        frames = sorted(set(gt) | set(pred))
        gt_idmap, tr_idmap = {}, {}
        self.gt_ids, self.tr_ids, self.sims = [], [], []
        for f in frames:
            gids, gboxes = gt.get(f, (np.zeros(0, int), np.zeros((0, 4))))
            tids, tboxes = pred.get(f, (np.zeros(0, int), np.zeros((0, 4))))
            for g in gids:
                gt_idmap.setdefault(int(g), len(gt_idmap))
            for t in tids:
                tr_idmap.setdefault(int(t), len(tr_idmap))
            self.gt_ids.append(
                np.array([gt_idmap[int(g)] for g in gids], int))
            self.tr_ids.append(
                np.array([tr_idmap[int(t)] for t in tids], int))
            self.sims.append(_iou(np.asarray(gboxes, float),
                                  np.asarray(tboxes, float)))
        self.num_gt_ids = len(gt_idmap)
        self.num_tr_ids = len(tr_idmap)
        self.num_gt_dets = sum(len(g) for g in self.gt_ids)
        self.num_tr_dets = sum(len(t) for t in self.tr_ids)


def clear_metrics(data: VideoData, threshold: float = 0.5) -> dict:
    """CLEAR metrics, a faithful transcription of TrackEval's algorithm
    (trackeval/metrics/clear.py::eval_sequence — what the reference's
    MOTDroneMetrics delegates to via mot_drone_metrics.py:254-321):

    * per-timestep score is ``1000 * continuation + similarity`` with
      entries below the threshold zeroed BEFORE matching;
    * the continuation memory (``prev_timestep_tracker_id``) is NOT reset
      on timesteps with no GT or no tracker detections (TrackEval skips
      those timesteps entirely), so a match resumed across an empty frame
      is a continuation, not a fragmentation;
    * Frag counts tracked-segment starts per GT id minus one;
    * MT uses strict ``ratio > 0.8`` and PT ``ratio >= 0.2`` (TrackEval uses
      ``np.greater`` / ``np.greater_equal``; ML is the strict ``< 0.2``
      remainder). This intentionally differs from the inclusive thresholds
      in some MOT papers — the parity target is TrackEval's code.
    """
    eps = np.finfo(float).eps
    num_gt_ids = data.num_gt_ids
    gt_id_count = np.zeros(num_gt_ids)
    gt_matched_count = np.zeros(num_gt_ids)
    gt_frag_count = np.zeros(num_gt_ids)
    prev_tracker = np.full(num_gt_ids, -1)          # last matched, ever
    prev_timestep_tracker = np.full(num_gt_ids, -1)  # matched last timestep
    tp = fp = fn = idsw = 0
    motp_sum = 0.0

    for gids, tids, sim in zip(data.gt_ids, data.tr_ids, data.sims):
        if len(gids) == 0:
            fp += len(tids)
            continue
        if len(tids) == 0:
            fn += len(gids)
            gt_id_count[gids] += 1
            continue

        score = 1000.0 * (prev_timestep_tracker[gids][:, None]
                          == tids[None, :]) + sim
        score[sim < threshold - eps] = 0.0
        rows, cols = linear_sum_assignment(-score)
        matched = score[rows, cols] > 0 + eps
        rows, cols = rows[matched], cols[matched]
        mg, mtr = gids[rows], tids[cols]

        prev_m = prev_tracker[mg]
        idsw += int(np.sum((prev_m != -1) & (mtr != prev_m)))

        gt_id_count[gids] += 1
        gt_matched_count[mg] += 1

        not_previously_tracked = prev_timestep_tracker == -1
        prev_tracker[mg] = mtr
        prev_timestep_tracker = np.full(num_gt_ids, -1)
        prev_timestep_tracker[mg] = mtr
        currently_tracked = prev_timestep_tracker != -1
        gt_frag_count += not_previously_tracked & currently_tracked

        n_match = len(mg)
        tp += n_match
        fn += len(gids) - n_match
        fp += len(tids) - n_match
        motp_sum += float(sim[rows, cols].sum())

    seen = gt_id_count > 0
    ratio = gt_matched_count[seen] / gt_id_count[seen]
    mt = int(np.sum(ratio > 0.8))
    pt = int(np.sum(ratio >= 0.2)) - mt
    ml = int(seen.sum()) - mt - pt
    frag = int(np.maximum(gt_frag_count[gt_frag_count > 0] - 1, 0).sum())
    num_gt = data.num_gt_dets
    mota = 1.0 - (fn + fp + idsw) / max(num_gt, 1)
    motp = motp_sum / max(tp, 1)
    return dict(MOTA=mota, MOTP=motp, IDSW=idsw, CLR_TP=tp, CLR_FP=fp,
                CLR_FN=fn, Frag=frag, MT=mt, PT=pt, ML=ml,
                CLR_Re=tp / max(tp + fn, 1), CLR_Pr=tp / max(tp + fp, 1),
                sMOTA=(motp_sum - fp - idsw) / max(tp + fn, 1))


def identity_metrics(data: VideoData, threshold: float = 0.5) -> dict:
    ng, nt = data.num_gt_ids, data.num_tr_ids
    matches = np.zeros((ng, nt))
    gt_count = np.zeros(ng)
    tr_count = np.zeros(nt)
    for gids, tids, sim in zip(data.gt_ids, data.tr_ids, data.sims):
        gt_count[gids] += 1
        tr_count[tids] += 1
        hit = sim >= threshold - np.finfo(float).eps
        for r, c in zip(*np.where(hit)):
            matches[gids[r], tids[c]] += 1
    # pad to square with fp/fn "tracks"
    size = ng + nt
    cost = np.zeros((size, size))
    cost[:ng, :nt] = matches
    rows, cols = linear_sum_assignment(-cost)
    idtp = cost[rows, cols].sum()
    idfn = data.num_gt_dets - idtp
    idfp = data.num_tr_dets - idtp
    return dict(
        IDTP=idtp, IDFN=idfn, IDFP=idfp,
        IDF1=idtp / max(idtp + 0.5 * idfn + 0.5 * idfp, 1e-10),
        IDR=idtp / max(idtp + idfn, 1e-10),
        IDP=idtp / max(idtp + idfp, 1e-10))


HOTA_ALPHAS = np.arange(0.05, 0.99, 0.05)  # TrackEval's 19 thresholds


def hota_metrics(data: VideoData) -> dict:
    """HOTA, a faithful transcription of TrackEval's algorithm
    (trackeval/metrics/hota.py::eval_sequence): a first pass accumulates
    the global alignment score (per-frame Jaccard-normalized similarity
    summed per id pair), a second pass matches per frame by
    ``global_alignment * similarity`` with scipy Hungarian, and per-alpha
    TP/FN/FP plus per-pair match counts give DetA/AssA. Per-alpha count
    arrays are returned so cross-sequence pooling can follow TrackEval's
    ``combine_sequences`` (sum counts, TP-weighted AssA) instead of
    averaging per-video HOTA values.
    """
    eps = np.finfo(float).eps
    alphas = HOTA_ALPHAS
    ng, nt = data.num_gt_ids, data.num_tr_ids

    potential = np.zeros((ng, nt))
    gt_count = np.zeros(ng)
    tr_count = np.zeros(nt)
    for gids, tids, sim in zip(data.gt_ids, data.tr_ids, data.sims):
        gt_count[gids] += 1
        tr_count[tids] += 1
        if len(gids) and len(tids):
            denom = sim.sum(0)[None, :] + sim.sum(1)[:, None] - sim
            s = np.zeros_like(sim)
            nz = denom > 0 + eps
            s[nz] = sim[nz] / denom[nz]
            potential[np.ix_(gids, tids)] += s
    global_align = potential / np.maximum(
        gt_count[:, None] + tr_count[None, :] - potential, 1e-10)

    tp_a = np.zeros(len(alphas))
    fn_a = np.zeros(len(alphas))
    fp_a = np.zeros(len(alphas))
    match_counts = [np.zeros((ng, nt)) for _ in alphas]
    for gids, tids, sim in zip(data.gt_ids, data.tr_ids, data.sims):
        if len(gids) == 0:
            fp_a += len(tids)
            continue
        if len(tids) == 0:
            fn_a += len(gids)
            continue
        score = global_align[np.ix_(gids, tids)] * sim
        rows, cols = linear_sum_assignment(-score)
        for ai, alpha in enumerate(alphas):
            ok = sim[rows, cols] >= alpha - eps
            tp = int(ok.sum())
            tp_a[ai] += tp
            fn_a[ai] += len(gids) - tp
            fp_a[ai] += len(tids) - tp
            match_counts[ai][gids[rows[ok]], tids[cols[ok]]] += 1

    det_a = tp_a / np.maximum(tp_a + fn_a + fp_a, 1.0)
    ass_a = np.zeros(len(alphas))
    for ai in range(len(alphas)):
        mc = match_counts[ai]
        union = np.maximum(gt_count[:, None] + tr_count[None, :] - mc, 1.0)
        ass_iou = mc / union
        ass_a[ai] = (ass_iou * mc).sum() / np.maximum(tp_a[ai], 1.0)
    hota_alpha = np.sqrt(det_a * ass_a)
    return dict(HOTA=float(hota_alpha.mean()), DetA=float(det_a.mean()),
                AssA=float(ass_a.mean()), HOTA_alpha=hota_alpha,
                DetA_alpha=det_a, AssA_alpha=ass_a,
                HOTA_TP=tp_a, HOTA_FN=fn_a, HOTA_FP=fp_a)


def combine_videos(datas: List[VideoData]) -> dict:
    """Aggregate per-video results the way TrackEval's
    ``combine_sequences`` does for MotChallenge:

    * CLEAR/Identity: integer count fields are summed across sequences and
      the final ratios recomputed from the pooled counts;
    * HOTA: per-alpha HOTA_TP/FN/FP are pooled, per-alpha AssA is the
      HOTA_TP-weighted mean of per-sequence AssA, DetA is recomputed from
      the pooled counts, and HOTA = mean_alpha sqrt(DetA * AssA)
      (trackeval/metrics/hota.py::combine_sequences — NOT a det-weighted
      mean of per-sequence HOTA values).
    """
    agg = {}
    clears = [clear_metrics(d) for d in datas]
    for k in ('CLR_TP', 'CLR_FP', 'CLR_FN', 'IDSW', 'Frag', 'MT', 'PT', 'ML'):
        agg[k] = sum(c[k] for c in clears)
    num_gt = sum(d.num_gt_dets for d in datas)
    agg['MOTA'] = 1.0 - (agg['CLR_FN'] + agg['CLR_FP'] + agg['IDSW']) / \
        max(num_gt, 1)
    motp_num = sum(c['MOTP'] * c['CLR_TP'] for c in clears)
    agg['MOTP'] = motp_num / max(agg['CLR_TP'], 1)

    idents = [identity_metrics(d) for d in datas]
    idtp = sum(i['IDTP'] for i in idents)
    idfn = sum(i['IDFN'] for i in idents)
    idfp = sum(i['IDFP'] for i in idents)
    agg['IDF1'] = idtp / max(idtp + 0.5 * idfn + 0.5 * idfp, 1e-10)
    agg['IDR'] = idtp / max(idtp + idfn, 1e-10)
    agg['IDP'] = idtp / max(idtp + idfp, 1e-10)

    hotas = [hota_metrics(d) for d in datas]
    tp_a = sum(h['HOTA_TP'] for h in hotas)
    fn_a = sum(h['HOTA_FN'] for h in hotas)
    fp_a = sum(h['HOTA_FP'] for h in hotas)
    ass_a = sum(h['AssA_alpha'] * h['HOTA_TP'] for h in hotas) / \
        np.maximum(tp_a, 1.0)
    det_a = tp_a / np.maximum(tp_a + fn_a + fp_a, 1.0)
    agg['HOTA'] = float(np.sqrt(det_a * ass_a).mean())
    agg['DetA'] = float(det_a.mean())
    agg['AssA'] = float(ass_a.mean())
    return agg
