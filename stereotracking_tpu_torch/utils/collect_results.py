"""Per-frame CSV dump of tracking predictions.

A copy of ``stereotracking_tpu/utils/collect_results.py``: the behavior of
the reference mmtrack ``save_prediction_results`` decorator
(``utils/collect_results.py:1-44``): appends one row per
tracked instance — frame, id, label, box, depth, gt_depth, score — for
offline depth-accuracy analysis.
"""
from __future__ import annotations

import csv
import os
from typing import Optional

import numpy as np


class ResultsCSV:
    HEADER = ['frame', 'id', 'label', 'x1', 'y1', 'x2', 'y2', 'depth',
              'gt_depth', 'score']

    def __init__(self, file_path: str = 'results.csv'):
        self.file_path = file_path
        self._started = os.path.exists(file_path)

    def append_frame(self, frame_id: int, result) -> None:
        """result: a FrameResult (models/mot.py) of host arrays, as
        ``models.mot.result_to_host`` returns it."""
        valid = np.asarray(result.track_valid)
        rows = zip(np.asarray(result.track_ids)[valid],
                   np.asarray(result.track_labels)[valid],
                   np.asarray(result.track_bboxes)[valid],
                   np.asarray(result.track_depths)[valid],
                   np.asarray(result.track_gt_depths)[valid],
                   np.asarray(result.track_scores)[valid])
        mode = 'a' if self._started else 'w'
        with open(self.file_path, mode, newline='') as f:
            w = csv.writer(f)
            if not self._started:
                w.writerow(self.HEADER)
                self._started = True
            for tid, label, box, d, gd, s in rows:
                w.writerow([frame_id, int(tid), int(label),
                            f'{box[0]:.2f}', f'{box[1]:.2f}',
                            f'{box[2]:.2f}', f'{box[3]:.2f}',
                            f'{float(d):.3f}', f'{float(gd):.3f}',
                            f'{float(s):.4f}'])
