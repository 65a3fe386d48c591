"""KITTI 2D-box tracking evaluation protocol (host-side numpy and scipy).

A copy of ``stereotracking_tpu/evaluation/kitti_protocol.py``: the KITTI
devkit's rules (evaluate_tracking.cpp) as the reference applies them
through TrackEval's ``Kitti2DBox`` adapter (mmtrack
``evaluation/functional/kitti_2d_box.py`` and
``evaluation/metrics/mot_kitti_metrics.py``):

* Per evaluated class (``car``, ``pedestrian``) the *neighboring* class is a
  distractor: ``van`` for car, ``person`` (person sitting) for pedestrian
  (kitti_2d_box.py:193-198).
* A GT box is IGNORED when occlusion > 2, truncation > 0, pixel height < 25,
  or it belongs to the neighboring class (kitti_2d_box.py:56-58 sets
  max_occlusion=2, max_truncation=0, min_height=25).
* Tracker detections Hungarian-matched (IoU >= 0.5) to an ignored GT box are
  removed before scoring; unmatched tracker detections lying > 50% inside a
  ``DontCare`` region (intersection-over-area) are removed too
  (kitti_2d_box.py:188 crowd_ignore_filter).
* Remaining GT of other classes and ignored GT are dropped; CLEAR / Identity
  / HOTA are then computed per class exactly as for MOT-Challenge.

KITTI class-name ids follow the reference's table
(mot_kitti_metrics.py:90-91).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
from scipy.optimize import linear_sum_assignment

from .clear_identity_hota import VideoData, _iou, combine_videos

KITTI_CLASS_IDS = {
    'car': 1, 'van': 2, 'truck': 3, 'pedestrian': 4, 'person': 5,
    'cyclist': 6, 'tram': 7, 'misc': 8, 'dontcare': 9,
}
# evaluated class -> neighboring (distractor) class
KITTI_DISTRACTORS = {'car': ('van',), 'pedestrian': ('person',)}

MAX_OCCLUSION = 2
MAX_TRUNCATION = 0
MIN_HEIGHT = 25.0


def _ioa(boxes: np.ndarray, regions: np.ndarray) -> np.ndarray:
    """Intersection over (box) area of ``boxes`` against ``regions``."""
    if len(boxes) == 0 or len(regions) == 0:
        return np.zeros((len(boxes), len(regions)))
    lt = np.maximum(boxes[:, None, :2], regions[None, :, :2])
    rb = np.minimum(boxes[:, None, 2:], regions[None, :, 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    area = ((boxes[:, 2] - boxes[:, 0]) *
            (boxes[:, 3] - boxes[:, 1]))[:, None]
    return inter / np.maximum(area, 1e-10)


def preprocess_frame(cls: str,
                     gt_ids: np.ndarray, gt_boxes: np.ndarray,
                     gt_classes: np.ndarray, gt_occlusion: np.ndarray,
                     gt_truncation: np.ndarray,
                     pred_ids: np.ndarray, pred_boxes: np.ndarray,
                     pred_classes: np.ndarray,
                     dontcare: Optional[np.ndarray] = None,
                     match_iou: float = 0.5,
                     ) -> Tuple[Tuple[np.ndarray, np.ndarray],
                                Tuple[np.ndarray, np.ndarray]]:
    """Apply the devkit preprocessing for one frame and one class.

    Returns ``(kept_gt_ids, kept_gt_boxes), (kept_pred_ids, kept_pred_boxes)``.
    """
    cls_id = KITTI_CLASS_IDS[cls]
    distractor_ids = [KITTI_CLASS_IDS[d] for d in KITTI_DISTRACTORS[cls]]

    gt_ids = np.asarray(gt_ids, int)
    gt_boxes = np.asarray(gt_boxes, float).reshape(-1, 4)
    gt_classes = np.asarray(gt_classes, int)
    gt_occlusion = np.asarray(gt_occlusion, float)
    gt_truncation = np.asarray(gt_truncation, float)
    pred_ids = np.asarray(pred_ids, int)
    pred_boxes = np.asarray(pred_boxes, float).reshape(-1, 4)
    pred_classes = np.asarray(pred_classes, int)
    dontcare = (np.zeros((0, 4)) if dontcare is None
                else np.asarray(dontcare, float).reshape(-1, 4))

    # tracker dets of this class only
    tr_keep = pred_classes == cls_id
    pred_ids, pred_boxes = pred_ids[tr_keep], pred_boxes[tr_keep]

    heights = gt_boxes[:, 3] - gt_boxes[:, 1]
    gt_ignored = ((gt_occlusion > MAX_OCCLUSION)
                  | (gt_truncation > MAX_TRUNCATION)
                  | (heights < MIN_HEIGHT)
                  | np.isin(gt_classes, distractor_ids))
    # GT of entirely unrelated classes takes no part at all (neither kept
    # nor used to swallow matched tracker dets).
    gt_relevant = (gt_classes == cls_id) | np.isin(gt_classes, distractor_ids)

    # Hungarian match tracker dets against relevant GT (IoU >= thr),
    # remove tracker dets matched to ignored GT.
    to_remove = np.zeros(len(pred_ids), bool)
    unmatched = np.ones(len(pred_ids), bool)
    rel_idx = np.flatnonzero(gt_relevant)
    if len(rel_idx) and len(pred_ids):
        sim = _iou(gt_boxes[rel_idx], pred_boxes)
        scores = np.where(sim >= match_iou - np.finfo(float).eps, sim, 0.0)
        rows, cols = linear_sum_assignment(-scores)
        hit = scores[rows, cols] > np.finfo(float).eps
        rows, cols = rows[hit], cols[hit]
        unmatched[cols] = False
        to_remove[cols] = gt_ignored[rel_idx[rows]]

    # unmatched tracker dets > 50% inside a DontCare region
    if len(dontcare) and unmatched.any():
        ioa = _ioa(pred_boxes[unmatched], dontcare)
        in_dc = np.any(ioa > 0.5 + np.finfo(float).eps, axis=1)
        idx = np.flatnonzero(unmatched)
        to_remove[idx[in_dc]] = True

    gt_keep = (gt_classes == cls_id) & ~gt_ignored
    return ((gt_ids[gt_keep], gt_boxes[gt_keep]),
            (pred_ids[~to_remove], pred_boxes[~to_remove]))


class KittiEvaluator:
    """Per-class KITTI tracking evaluation over buffered videos.

    Streaming use: ``process_frame`` per frame (full GT including neighboring
    / DontCare annotations), then ``evaluate()`` returns
    ``{class: {metric: value}}`` plus ``{class}_{metric}`` flat keys.
    """

    def __init__(self, classes: Sequence[str] = ('car', 'pedestrian'),
                 match_iou: float = 0.5):
        for c in classes:
            if c not in KITTI_DISTRACTORS:
                raise ValueError(f'invalid KITTI eval class {c}')
        self.classes = tuple(classes)
        self.match_iou = match_iou
        self._frames: Dict[str, Dict[int, dict]] = {}

    def process_frame(self, video: str, frame: int, *,
                      gt_ids, gt_boxes, gt_classes, gt_occlusion,
                      gt_truncation, pred_ids, pred_boxes, pred_classes,
                      dontcare=None):
        self._frames.setdefault(video, {})[frame] = dict(
            gt_ids=np.asarray(gt_ids, int),
            gt_boxes=np.asarray(gt_boxes, float).reshape(-1, 4),
            gt_classes=np.asarray(gt_classes, int),
            gt_occlusion=np.asarray(gt_occlusion, float),
            gt_truncation=np.asarray(gt_truncation, float),
            pred_ids=np.asarray(pred_ids, int),
            pred_boxes=np.asarray(pred_boxes, float).reshape(-1, 4),
            pred_classes=np.asarray(pred_classes, int),
            dontcare=(np.zeros((0, 4)) if dontcare is None
                      else np.asarray(dontcare, float).reshape(-1, 4)))

    def evaluate(self) -> Dict[str, dict]:
        out: Dict[str, dict] = {}
        for cls in self.classes:
            datas: List[VideoData] = []
            for video in sorted(self._frames):
                gt, pred = {}, {}
                for frame, d in self._frames[video].items():
                    g, p = preprocess_frame(
                        cls, d['gt_ids'], d['gt_boxes'], d['gt_classes'],
                        d['gt_occlusion'], d['gt_truncation'],
                        d['pred_ids'], d['pred_boxes'], d['pred_classes'],
                        d['dontcare'], self.match_iou)
                    gt[frame], pred[frame] = g, p
                datas.append(VideoData(gt, pred))
            if datas:
                out[cls] = combine_videos(datas)
        flat = {f'{cls}_{k}': v for cls, m in out.items()
                for k, v in m.items() if np.isscalar(v)}
        out.update(flat)
        return out


def load_kitti_label_file(path: str, classes: Sequence[str] =
                          ('car', 'pedestrian'), is_gt: bool = True,
                          num_frames: Optional[int] = None) -> Dict[int,
                                                                    dict]:
    """Parse a KITTI tracking label/result text file with the reference
    adapter's exact row handling (kitti_2d_box.py:186-276 _load_raw_file):

    * columns: frame, track_id, type, truncated, occluded, alpha,
      bbox x1 y1 x2 y2, ... [, score last];
    * GT keeps the evaluated classes plus their distractors ('van' with
      'car', 'person' with 'pedestrian'); tracker files keep only the
      evaluated classes;
    * GT 'dontcare' rows are routed to per-frame ignore regions;
    * rows with negative track ids are dropped.

    Returns {frame: dict(ids, classes, dets, truncation, occlusion,
    dontcare, scores)} with class *ids* per KITTI_CLASS_IDS.
    """
    valid = {c.lower() for c in classes}
    if is_gt:
        if 'car' in valid:
            valid.add('van')
        if 'pedestrian' in valid:
            valid.add('person')

    raw: Dict[int, dict] = {}

    def frame_slot(t: int) -> dict:
        return raw.setdefault(t, dict(
            ids=[], classes=[], dets=[], truncation=[], occlusion=[],
            dontcare=[], scores=[]))

    with open(path) as fh:
        for line in fh:
            parts = line.split()
            if not parts:
                continue
            t = int(float(parts[0]))
            name = parts[2].lower()
            slot = frame_slot(t)
            if is_gt and name == 'dontcare':
                slot['dontcare'].append(
                    [float(v) for v in parts[6:10]])
                continue
            if name not in valid:
                continue
            tid = int(float(parts[1]))
            if tid < 0:
                continue
            slot['ids'].append(tid)
            slot['classes'].append(KITTI_CLASS_IDS[name])
            slot['dets'].append([float(v) for v in parts[6:10]])
            slot['truncation'].append(int(float(parts[3])))
            slot['occlusion'].append(int(float(parts[4])))
            slot['scores'].append(
                float(parts[17]) if len(parts) > 17 else 1.0)

    frames = range(num_frames) if num_frames is not None \
        else sorted(raw)
    out: Dict[int, dict] = {}
    for t in frames:
        slot = raw.get(t, dict(ids=[], classes=[], dets=[], truncation=[],
                               occlusion=[], dontcare=[], scores=[]))
        out[t] = dict(
            ids=np.asarray(slot['ids'], int),
            classes=np.asarray(slot['classes'], int),
            dets=np.asarray(slot['dets'], float).reshape(-1, 4),
            truncation=np.asarray(slot['truncation'], int),
            occlusion=np.asarray(slot['occlusion'], int),
            dontcare=np.asarray(slot['dontcare'], float).reshape(-1, 4),
            scores=np.asarray(slot['scores'], float))
    return out
