"""Tracking visualization: the port's copy of
``stereotracking_tpu/visualization/visualizer.py``.

Per-id colors seeded from the id, boxes with "#id | score" labels, the
ground-truth panel stacked over the prediction panel (the eval CLI's
``--show-dir``), TP / FP / FN / ID-switch color coding of one frame
(``--show-errors``), and the mask helpers.  Host numpy in, RGB uint8
numpy out, bit-equal to the JAX package's module.  Pillow and scipy are
imported inside the functions that draw or match, so that importing this
module needs neither.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np


def id_color(instance_id: int) -> tuple:
    """Deterministic per-id color (a random state seeded by the id)."""
    rng = np.random.RandomState(int(instance_id) % (2 ** 31))
    return tuple(int(c) for c in rng.randint(50, 255, 3))


def _canvas(img_bgr: np.ndarray):
    """A Pillow RGB image of the BGR frame and a drawing context on it."""
    from PIL import Image, ImageDraw
    im = Image.fromarray(np.ascontiguousarray(img_bgr[:, :, ::-1]))
    return im, ImageDraw.Draw(im)


class TrackVisualizer:
    def __init__(self, line_width: int = 2, show_score: bool = True):
        self.line_width = line_width
        self.show_score = show_score

    def draw(self, img_bgr: np.ndarray, bboxes: np.ndarray,
             ids: Optional[np.ndarray] = None,
             scores: Optional[np.ndarray] = None,
             labels: Optional[np.ndarray] = None,
             color: Optional[tuple] = None) -> np.ndarray:
        """An RGB uint8 image of the BGR frame with the boxes drawn."""
        im, d = _canvas(img_bgr)
        for i, box in enumerate(np.asarray(bboxes).reshape(-1, 4)):
            tid = int(ids[i]) if ids is not None else -1
            c = color or (id_color(tid) if tid >= 0 else (0, 255, 0))
            d.rectangle([float(box[0]), float(box[1]),
                         float(box[2]), float(box[3])],
                        outline=c, width=self.line_width)
            text = []
            if tid >= 0:
                text.append(f'#{tid}')
            if scores is not None and self.show_score:
                text.append(f'{float(scores[i]):.2f}')
            if text:
                d.text((float(box[0]), max(float(box[1]) - 12, 0)),
                       ' | '.join(text), fill=c)
        return np.asarray(im)

    def draw_gt_pred(self, img_bgr: np.ndarray,
                     gt_bboxes: np.ndarray, gt_ids: np.ndarray,
                     pred_bboxes: np.ndarray, pred_ids: np.ndarray,
                     pred_scores: Optional[np.ndarray] = None) -> np.ndarray:
        """The ground-truth panel stacked over the prediction panel."""
        gt = self.draw(img_bgr, gt_bboxes, gt_ids)
        pred = self.draw(img_bgr, pred_bboxes, pred_ids, pred_scores)
        return np.concatenate([gt, pred], axis=0)


ERROR_COLORS = {
    'FP': (255, 0, 0),
    'FN': (255, 165, 0),
    'IDSW': (255, 0, 255),
    'TP': (0, 200, 0),
}


def draw_mot_errors(img_bgr: np.ndarray, gt_bboxes: np.ndarray,
                    gt_ids: np.ndarray, pred_bboxes: np.ndarray,
                    pred_ids: np.ndarray, prev_match: Dict[int, int],
                    iou_thr: float = 0.5) -> tuple:
    """TP / FP / FN / ID switches of one frame, color-coded: returns (RGB
    image, the updated ``prev_match`` gt id -> predicted id)."""
    from scipy.optimize import linear_sum_assignment

    gt_bboxes = np.asarray(gt_bboxes, float).reshape(-1, 4)
    pred_bboxes = np.asarray(pred_bboxes, float).reshape(-1, 4)
    n, m = len(gt_bboxes), len(pred_bboxes)
    statuses = ['FP'] * m
    missed = set(range(n))
    new_match = dict(prev_match)
    if n and m:
        lt = np.maximum(gt_bboxes[:, None, :2], pred_bboxes[None, :, :2])
        rb = np.minimum(gt_bboxes[:, None, 2:], pred_bboxes[None, :, 2:])
        wh = np.clip(rb - lt, 0, None)
        inter = wh[..., 0] * wh[..., 1]
        a1 = np.prod(gt_bboxes[:, 2:] - gt_bboxes[:, :2], -1)[:, None]
        a2 = np.prod(pred_bboxes[:, 2:] - pred_bboxes[:, :2], -1)[None, :]
        iou = inter / np.maximum(a1 + a2 - inter, 1e-9)
        score = np.where(iou >= iou_thr, iou, 0)
        rows, cols = linear_sum_assignment(-score)
        for r, c in zip(rows, cols):
            if score[r, c] <= 0:
                continue
            gid, pid = int(gt_ids[r]), int(pred_ids[c])
            if gid in prev_match and prev_match[gid] != pid:
                statuses[c] = 'IDSW'
            else:
                statuses[c] = 'TP'
            new_match[gid] = pid
            missed.discard(r)

    im, d = _canvas(img_bgr)
    for c, box in enumerate(pred_bboxes):
        d.rectangle(list(map(float, box)),
                    outline=ERROR_COLORS[statuses[c]], width=2)
        d.text((float(box[0]), max(float(box[1]) - 12, 0)), statuses[c],
               fill=ERROR_COLORS[statuses[c]])
    for r in missed:
        box = gt_bboxes[r]
        d.rectangle(list(map(float, box)), outline=ERROR_COLORS['FN'],
                    width=2)
        d.text((float(box[0]), float(box[3])), 'FN',
               fill=ERROR_COLORS['FN'])
    return np.asarray(im), new_match


def paste_mask(mask_prob: np.ndarray, box_xyxy, height: int, width: int
               ) -> np.ndarray:
    """A small mask-probability patch (e.g. a 28 x 28 head output) pasted
    bilinearly over the box into an (height, width) bool mask."""
    from PIL import Image
    x1, y1, x2, y2 = [int(round(float(v))) for v in box_xyxy]
    x1, y1 = max(x1, 0), max(y1, 0)
    x2 = min(max(x2, x1 + 1), width)
    y2 = min(max(y2, y1 + 1), height)
    patch = Image.fromarray(
        (np.asarray(mask_prob, np.float32) * 255).astype(np.uint8))
    patch = patch.resize((x2 - x1, y2 - y1), Image.BILINEAR)
    out = np.zeros((height, width), bool)
    out[y1:y2, x1:x2] = np.asarray(patch) > 127
    return out


def overlay_masks(img_rgb: np.ndarray, masks: np.ndarray,
                  ids: np.ndarray, alpha: float = 0.5) -> np.ndarray:
    """Per-instance bool masks (N, H, W) blended into the RGB image in
    their id's color."""
    out = np.asarray(img_rgb, np.float32).copy()
    for m, tid in zip(masks, ids):
        color = np.asarray(id_color(int(tid)), np.float32)
        out[m] = out[m] * (1 - alpha) + color * alpha
    return out.astype(np.uint8)
