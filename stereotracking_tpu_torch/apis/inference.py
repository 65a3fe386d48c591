"""User-facing inference APIs: ``init_model`` and ``inference_mot``.

Port of ``stereotracking_tpu/apis/inference.py`` (the reference mmtrack
``init_model`` / ``inference_mot``): build a model from a config file or
dict and an optional ``.pth`` checkpoint (a reference one, or this
package's detector export), then feed it frames one by one.  Every frame
goes through ``OCSORTDisparity.track_raw``, the port's one raw-frame path
for every backend mix; the result leaves the card in one synchronisation
(``models.mot.result_to_host``).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..config import load_config
from ..data import transforms as T
from ..models.detector import YOLOXDetector
from ..models.mot import OCSORTDisparity, result_to_host
from ..utils.checkpoint import detector_state_dict
from .builder import build_mot_config, build_model


def init_model(config, checkpoint: Optional[str] = None, device='cuda',
               dtype: Optional[torch.dtype] = None) -> OCSORTDisparity:
    """Config path or dict (+ optional PyTorch checkpoint, ``.pth`` /
    ``.pt``) -> model on ``device`` (the card unless the caller asks for
    the CPU), computing in ``dtype`` (float32 unless given).  A checkpoint
    is this package's detector export (the trainer's, loaded as it is) or
    a reference checkpoint (the RGB stem and stage 1 copied into the
    disparity branch: ``utils.checkpoint.detector_state_dict``).  Without
    a checkpoint the detector gets seeded random weights."""
    cfg = load_config(config) if isinstance(config, str) else config
    module = None
    if checkpoint is not None:
        if not str(checkpoint).endswith(('.pth', '.pt')):
            raise NotImplementedError(
                f'checkpoint {checkpoint!r}: only PyTorch checkpoints '
                f'(.pth / .pt) load here; JAX-native (orbax / '
                f'msgpack) checkpoints are not ported (ROADMAP.md Queue 1 '
                f'item 3)')
        mot = build_mot_config(cfg['model'], device)
        module = YOLOXDetector(mot.detector, dtype=dtype or torch.float32)
        module.load_state_dict(detector_state_dict(checkpoint, module))
    model = build_model(cfg, device=device, module=module, dtype=dtype)
    model.config_dict = cfg
    return model


def raw_frame(sample: dict) -> Tuple[np.ndarray, np.ndarray]:
    """A sample's (H, W, 3) uint8 image and (H, W) uint16 fixed-point
    disparity (``disp_postp * 16``, 65535 where ``disp_mask`` is 0)."""
    img_u8 = np.clip(np.rint(np.asarray(sample['img'], np.float32)),
                     0, 255).astype(np.uint8)
    disp_fixed = np.where(sample['disp_mask'] > 0,
                          (sample['disp_postp'] * 16.0).astype(np.uint16),
                          np.uint16(65535)).astype(np.uint16)
    return img_u8, disp_fixed


def inference_mot(model: OCSORTDisparity, img: np.ndarray,
                  disparity: np.ndarray, frame_id: int,
                  depth: Optional[np.ndarray] = None,
                  scale: Optional[Tuple[int, int]] = None) -> Dict:
    """Track one frame.

    Args:
        model: from ``init_model``.
        img: (H, W, 3) uint8 BGR left frame.
        disparity: (H, W) uint16 SGBM /16 fixed-point disparity
            (65535 = invalid) or float32 already-postprocessed disparity.
        frame_id: 0-based; 0 resets the tracker.
        depth: optional (H, W) float32 GT depth in meters.
        scale: optional (h, w) keep-ratio resize target (reference
            test-pipeline Resize); default: no resize.

    Returns dict with 'det_instances' and 'track_instances' numpy arrays.
    """
    sample = dict(img=img)
    if disparity.dtype == np.uint16:
        sample.update(T.disparity_postprocess(disparity))
    else:
        sample['disp_postp'] = disparity.astype(np.float32)
        sample['disp_mask'] = (disparity > 0).astype(np.float32)
    if depth is not None:
        sample['depth_postp'] = depth.astype(np.float32)

    sf = (1.0, 1.0)
    if scale is not None:
        sample = T.resize_keep_ratio(sample, scale)
        sf = sample['scale_factor']
    img_u8, disp_fixed = raw_frame(sample)
    res = result_to_host(model.track_raw(
        img_u8, disp_fixed, frame_id, scale_factor=sf,
        depth_raw=None if depth is None else sample['depth_postp']))
    dv, tv = res.det_valid, res.track_valid
    return dict(
        det_instances=dict(
            bboxes=res.det_bboxes[dv], scores=res.det_scores[dv],
            labels=res.det_labels[dv]),
        track_instances=dict(
            bboxes=res.track_bboxes[tv], scores=res.track_scores[tv],
            labels=res.track_labels[tv], instances_id=res.track_ids[tv],
            depth=res.track_depths[tv], gt_depth=res.track_gt_depths[tv],
            scales=res.track_scales[tv]))
