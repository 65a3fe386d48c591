"""MOT evaluation front-end with the drone depth-range protocol.

Copied from ``stereotracking_tpu/evaluation/mot_metrics.py``.
``MOTDroneMetrics`` mirrors the reference mmtrack ``MOTDroneMetrics``
(``evaluation/metrics/mot_drone_metrics.py:37-427``):
per-frame GT and prediction rows are buffered per video, predictions are
kept only when ``0 < depth <= depth_thr`` and ground truth only when the 3D
location's Z is within ``depth_thr`` (:188,206), MOT-Challenge txt files can
be dumped for external tooling, and HOTA/CLEAR/Identity are computed (here
by the in-repo implementations instead of the TrackEval package).
``MOTChallengeMetrics`` is the same without the depth filter, and
``MOTKittiMetrics`` adds the KITTI txt layout and the devkit protocol
(``kitti_protocol.KittiEvaluator``).  The multi-host gather is not ported
(ROADMAP.md Queue 1 item 6).
"""
from __future__ import annotations

import os
from collections import defaultdict
from typing import Dict, List, Optional, Sequence

import numpy as np

from .clear_identity_hota import VideoData, combine_videos


class MOTDroneMetrics:
    """Accumulate per-frame track predictions + GT; compute MOT metrics."""

    def __init__(self, depth_thr: float = 80.0, ignore_depth: bool = False,
                 iou_threshold: float = 0.5, outfile_dir: Optional[str] = None):
        self.depth_thr = depth_thr
        self.ignore_depth = ignore_depth
        self.iou_threshold = iou_threshold
        self.outfile_dir = outfile_dir
        self.reset()

    def reset(self):
        self._gt = defaultdict(dict)      # video -> frame -> (ids, boxes)
        self._pred = defaultdict(dict)

    # ---- streaming API --------------------------------------------------
    def process_frame(self, video: str, frame: int,
                      gt_ids: np.ndarray, gt_bboxes: np.ndarray,
                      gt_depths: Optional[np.ndarray],
                      pred_ids: np.ndarray, pred_bboxes: np.ndarray,
                      pred_depths: Optional[np.ndarray]):
        """Add one frame. ``gt_depths`` is the GT location Z per instance;
        ``pred_depths`` the tracker's estimated depth per prediction."""
        gt_ids = np.asarray(gt_ids, int)
        gt_bboxes = np.asarray(gt_bboxes, float).reshape(-1, 4)
        pred_ids = np.asarray(pred_ids, int)
        pred_bboxes = np.asarray(pred_bboxes, float).reshape(-1, 4)

        if not self.ignore_depth and gt_depths is not None:
            keep = np.asarray(gt_depths, float) <= self.depth_thr
            gt_ids, gt_bboxes = gt_ids[keep], gt_bboxes[keep]
        if not self.ignore_depth and pred_depths is not None:
            d = np.asarray(pred_depths, float)
            keep = (d > 0) & (d <= self.depth_thr)
            pred_ids, pred_bboxes = pred_ids[keep], pred_bboxes[keep]

        self._gt[video][frame] = (gt_ids, gt_bboxes)
        self._pred[video][frame] = (pred_ids, pred_bboxes)

    # ---- txt bridge (MOT-Challenge format) ------------------------------
    def dump_txt(self, out_dir: Optional[str] = None):
        out_dir = out_dir or self.outfile_dir
        assert out_dir is not None
        os.makedirs(out_dir, exist_ok=True)
        for video, frames in self._pred.items():
            with open(os.path.join(out_dir, f'{video}.txt'), 'w') as f:
                for frame in sorted(frames):
                    ids, boxes = frames[frame]
                    for i, b in zip(ids, boxes):
                        x, y = b[0], b[1]
                        w, h = b[2] - b[0], b[3] - b[1]
                        f.write(f'{frame + 1},{i},{x:.3f},{y:.3f},'
                                f'{w:.3f},{h:.3f},1,-1,-1,-1\n')
        for video, frames in self._gt.items():
            gt_dir = os.path.join(out_dir, 'gt', video)
            os.makedirs(gt_dir, exist_ok=True)
            with open(os.path.join(gt_dir, 'gt.txt'), 'w') as f:
                for frame in sorted(frames):
                    ids, boxes = frames[frame]
                    for i, b in zip(ids, boxes):
                        x, y = b[0], b[1]
                        w, h = b[2] - b[0], b[3] - b[1]
                        f.write(f'{frame + 1},{i},{x:.3f},{y:.3f},'
                                f'{w:.3f},{h:.3f},1,1,1.0\n')

    # ---- metric computation ---------------------------------------------
    def evaluate(self, metrics: Sequence[str] = ('HOTA', 'CLEAR', 'Identity')
                 ) -> Dict[str, float]:
        videos = sorted(set(self._gt) | set(self._pred))
        datas = [VideoData(self._gt[v], self._pred[v]) for v in videos]
        if not datas:
            return {}
        out = combine_videos(datas)
        wanted = {
            'HOTA': ('HOTA', 'DetA', 'AssA'),
            'CLEAR': ('MOTA', 'MOTP', 'IDSW', 'CLR_TP', 'CLR_FP', 'CLR_FN',
                      'Frag', 'MT', 'PT', 'ML'),
            'Identity': ('IDF1', 'IDR', 'IDP'),
        }
        keys = [k for m in metrics for k in wanted.get(m, ())]
        return {k: out[k] for k in keys if k in out}


class MOTChallengeMetrics(MOTDroneMetrics):
    """MOT-Challenge evaluation: same HOTA/CLEAR/Identity machinery without
    the drone depth filter (reference mot_challenge_metrics.py)."""

    def __init__(self, iou_threshold: float = 0.5,
                 outfile_dir: Optional[str] = None, **kwargs):
        super().__init__(depth_thr=float('inf'), ignore_depth=True,
                         iou_threshold=iou_threshold,
                         outfile_dir=outfile_dir)


class MOTKittiMetrics(MOTDroneMetrics):
    """KITTI-format tracking evaluation (reference mot_kitti_metrics.py):
    no depth filter; ``dump_kitti_txt`` writes the KITTI row layout;
    ``process_frame_kitti`` + ``evaluate_kitti`` run the devkit protocol
    (per-class car/pedestrian scoring with neighboring-class distractors,
    occlusion/truncation/height ignores and DontCare regions — see
    kitti_protocol.py)."""

    def __init__(self, iou_threshold: float = 0.5,
                 outfile_dir: Optional[str] = None,
                 class_names: Sequence[str] = ('Car', 'Pedestrian'),
                 classes_eval: Sequence[str] = ('car', 'pedestrian'),
                 **kwargs):
        super().__init__(depth_thr=float('inf'), ignore_depth=True,
                         iou_threshold=iou_threshold,
                         outfile_dir=outfile_dir)
        self.class_names = class_names
        self._pred_labels = defaultdict(dict)
        from .kitti_protocol import KittiEvaluator
        self.kitti = KittiEvaluator(classes_eval, iou_threshold)

    def process_frame_kitti(self, video, frame, **kw):
        """Full-annotation streaming entry for the devkit protocol; see
        KittiEvaluator.process_frame for the keyword surface."""
        self.kitti.process_frame(video, frame, **kw)

    def evaluate_kitti(self):
        return self.kitti.evaluate()

    def process_frame(self, video, frame, gt_ids, gt_bboxes, gt_depths,
                      pred_ids, pred_bboxes, pred_depths,
                      pred_labels=None):
        super().process_frame(video, frame, gt_ids, gt_bboxes, gt_depths,
                              pred_ids, pred_bboxes, pred_depths)
        if pred_labels is not None:
            self._pred_labels[video][frame] = np.asarray(pred_labels, int)

    def dump_kitti_txt(self, out_dir: Optional[str] = None):
        out_dir = out_dir or self.outfile_dir
        if out_dir is None:
            raise ValueError('dump_kitti_txt: no out_dir and no outfile_dir')
        os.makedirs(out_dir, exist_ok=True)
        for video, frames in self._pred.items():
            with open(os.path.join(out_dir, f'{video}.txt'), 'w') as f:
                for frame in sorted(frames):
                    ids, boxes = frames[frame]
                    labels = self._pred_labels.get(video, {}).get(
                        frame, np.zeros(len(ids), int))
                    for i, b, l in zip(ids, boxes, labels):
                        name = self.class_names[int(l) %
                                                len(self.class_names)]
                        f.write(f'{frame} {i} {name} 0 0 -10 '
                                f'{b[0]:.2f} {b[1]:.2f} {b[2]:.2f} '
                                f'{b[3]:.2f} -1 -1 -1 -1000 -1000 -1000 '
                                f'-10 1\n')
