"""COCO-style bbox mAP evaluator (standalone numpy; pycocotools semantics).

A copy of ``stereotracking_tpu/evaluation/coco_metric.py``.

The reference uses mmdet ``CocoMetric`` -> pycocotools (canonical config
:214-231); neither is installed here, so the evaluation protocol is
re-implemented: per-class greedy matching in score order against IoU
thresholds 0.50:0.95:0.05, gt 'ignore'/crowd handling, area ranges, maxDets,
101-point interpolated precision.
"""
from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Optional, Sequence

import numpy as np

IOU_THRS = np.round(np.arange(0.5, 1.0, 0.05), 2)
REC_THRS = np.linspace(0.0, 1.0, 101)
AREA_RANGES = {
    'all': (0.0, 1e10),
    'small': (0.0, 32.0 ** 2),
    'medium': (32.0 ** 2, 96.0 ** 2),
    'large': (96.0 ** 2, 1e10),
}


def _iou_xywh(dt: np.ndarray, gt: np.ndarray,
              iscrowd: np.ndarray) -> np.ndarray:
    if len(dt) == 0 or len(gt) == 0:
        return np.zeros((len(dt), len(gt)))
    dx1, dy1 = dt[:, 0], dt[:, 1]
    dx2, dy2 = dt[:, 0] + dt[:, 2], dt[:, 1] + dt[:, 3]
    gx1, gy1 = gt[:, 0], gt[:, 1]
    gx2, gy2 = gt[:, 0] + gt[:, 2], gt[:, 1] + gt[:, 3]
    ix1 = np.maximum(dx1[:, None], gx1[None, :])
    iy1 = np.maximum(dy1[:, None], gy1[None, :])
    ix2 = np.minimum(dx2[:, None], gx2[None, :])
    iy2 = np.minimum(dy2[:, None], gy2[None, :])
    inter = np.clip(ix2 - ix1, 0, None) * np.clip(iy2 - iy1, 0, None)
    da = (dt[:, 2] * dt[:, 3])[:, None]
    ga = (gt[:, 2] * gt[:, 3])[None, :]
    union = np.where(iscrowd[None, :], da, da + ga - inter)
    return inter / np.maximum(union, 1e-10)


class CocoMAPEvaluator:
    """Accumulate detections + GT per image; compute mAP/mAP50/mAP75/...

    Boxes are xyxy on input (converted internally to xywh like COCO).
    """

    def __init__(self, num_classes: int = 1, max_dets: int = 100):
        self.num_classes = num_classes
        self.max_dets = max_dets
        self.reset()

    def reset(self):
        self._gts = defaultdict(list)   # (img, cls) -> list of dict
        self._dts = defaultdict(list)
        self._imgs = set()

    def add_gt(self, img_id, bboxes_xyxy, labels, ignore=None, iscrowd=None):
        bboxes_xyxy = np.asarray(bboxes_xyxy, float).reshape(-1, 4)
        labels = np.asarray(labels, int)
        ignore = np.zeros(len(labels), bool) if ignore is None else \
            np.asarray(ignore, bool)
        iscrowd = np.zeros(len(labels), bool) if iscrowd is None else \
            np.asarray(iscrowd, bool)
        self._imgs.add(img_id)
        for b, l, ig, cr in zip(bboxes_xyxy, labels, ignore, iscrowd):
            xywh = [b[0], b[1], b[2] - b[0], b[3] - b[1]]
            self._gts[(img_id, int(l))].append(
                dict(bbox=np.array(xywh), ignore=bool(ig or cr),
                     iscrowd=bool(cr)))

    def add_dt(self, img_id, bboxes_xyxy, scores, labels):
        bboxes_xyxy = np.asarray(bboxes_xyxy, float).reshape(-1, 4)
        scores = np.asarray(scores, float)
        labels = np.asarray(labels, int)
        self._imgs.add(img_id)
        for b, s, l in zip(bboxes_xyxy, scores, labels):
            xywh = [b[0], b[1], b[2] - b[0], b[3] - b[1]]
            self._dts[(img_id, int(l))].append(
                dict(bbox=np.array(xywh), score=float(s)))

    def _evaluate_img(self, img_id, cls, area_rng):
        gts = self._gts.get((img_id, cls), [])
        dts = sorted(self._dts.get((img_id, cls), []),
                     key=lambda d: -d['score'])[:self.max_dets]
        if not gts and not dts:
            return None
        g = np.array([x['bbox'] for x in gts]).reshape(-1, 4)
        d = np.array([x['bbox'] for x in dts]).reshape(-1, 4)
        crowd = np.array([x['iscrowd'] for x in gts], bool)
        gig = np.array(
            [x['ignore'] or not (area_rng[0] <= x['bbox'][2] * x['bbox'][3]
                                 < area_rng[1]) for x in gts], bool) \
            if gts else np.zeros(0, bool)
        ious = _iou_xywh(d, g, crowd)

        T = len(IOU_THRS)
        dt_m = -np.ones((T, len(dts)))
        gt_m = -np.ones((T, len(gts)))
        dt_ig = np.zeros((T, len(dts)), bool)
        # gt order: non-ignored first (pycocotools sorts by ignore flag)
        gorder = np.argsort(gig, kind='stable')
        for ti, thr in enumerate(IOU_THRS):
            for di in range(len(dts)):
                best = thr - 1e-10
                best_g = -1
                for gi in gorder:
                    if gt_m[ti, gi] >= 0 and not crowd[gi]:
                        continue
                    if best_g >= 0 and not gig[best_g] and gig[gi]:
                        break   # can't improve: rest are ignored
                    if ious[di, gi] < best:
                        continue
                    best = ious[di, gi]
                    best_g = gi
                if best_g >= 0:
                    dt_m[ti, di] = best_g
                    gt_m[ti, best_g] = di
                    dt_ig[ti, di] = gig[best_g]
        # detections outside area range & unmatched -> ignored
        d_area = d[:, 2] * d[:, 3] if len(dts) else np.zeros(0)
        out = (d_area < area_rng[0]) | (d_area >= area_rng[1])
        dt_ig |= (dt_m == -1) & out[None, :]
        scores = np.array([x['score'] for x in dts])
        return dict(dt_m=dt_m, dt_ig=dt_ig, scores=scores,
                    num_gt=int((~gig).sum()))

    def evaluate(self, areas: Sequence[str] = ('all', 'small', 'medium',
                                               'large')) -> Dict[str, float]:
        results = {}
        ap_all = None
        for area in areas:
            rng = AREA_RANGES[area]
            ap_t = np.full((len(IOU_THRS), self.num_classes), np.nan)
            for cls in range(self.num_classes):
                evals = [self._evaluate_img(i, cls, rng) for i in
                         sorted(self._imgs, key=str)]
                evals = [e for e in evals if e is not None]
                if not evals:
                    continue
                scores = np.concatenate([e['scores'] for e in evals])
                dt_m = np.concatenate([e['dt_m'] for e in evals], axis=1)
                dt_ig = np.concatenate([e['dt_ig'] for e in evals], axis=1)
                num_gt = sum(e['num_gt'] for e in evals)
                if num_gt == 0:
                    continue
                order = np.argsort(-scores, kind='mergesort')
                dt_m = dt_m[:, order]
                dt_ig = dt_ig[:, order]
                tps = (dt_m >= 0) & ~dt_ig
                fps = (dt_m < 0) & ~dt_ig
                tp_cum = np.cumsum(tps, axis=1)
                fp_cum = np.cumsum(fps, axis=1)
                for ti in range(len(IOU_THRS)):
                    tp, fp = tp_cum[ti], fp_cum[ti]
                    rc = tp / num_gt
                    pr = tp / np.maximum(tp + fp, 1e-10)
                    # monotone decreasing precision envelope
                    for i in range(len(pr) - 1, 0, -1):
                        pr[i - 1] = max(pr[i - 1], pr[i])
                    inds = np.searchsorted(rc, REC_THRS, side='left')
                    q = np.zeros(len(REC_THRS))
                    valid = inds < len(pr)
                    q[valid] = pr[inds[valid]]
                    ap_t[ti, cls] = q.mean()
            mean_ap = np.nanmean(ap_t) if not np.isnan(ap_t).all() else -1.0
            if area == 'all':
                ap_all = ap_t
                results['mAP'] = float(mean_ap)
                results['mAP_50'] = float(np.nanmean(ap_t[0])) \
                    if not np.isnan(ap_t[0]).all() else -1.0
                i75 = int(np.where(IOU_THRS == 0.75)[0][0])
                results['mAP_75'] = float(np.nanmean(ap_t[i75])) \
                    if not np.isnan(ap_t[i75]).all() else -1.0
            else:
                results[f'mAP_{area[0]}'] = float(mean_ap)
        return results
