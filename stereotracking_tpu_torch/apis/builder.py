"""Config dicts (reference key layout) -> the port's configs and model.

Port of ``stereotracking_tpu/apis/builder.py`` (``build_mot_config``,
``build_model``).  Backend keys: ``'auto'`` means the hand-written kernels
when the model lives on a CUDA device and the float32 modules elsewhere;
``'cuda'`` / ``'torch'`` force one (``'pallas'`` / ``'xla'`` from JAX
configs mean the same).  ``stem_backend``, ``stage1_backend`` and
``stage2_backend`` must resolve alike: the three kernels run together
(``MOTConfig.backbone_backend``).  ``stage3_backend`` resolves as the JAX
package's ``_resolve_stage_backends`` does: ``'auto'`` is the float32
modules everywhere, and an explicit ``'cuda'`` needs the stage-2 kernel.
``pack_backend`` has no meaning here and is ignored.  Everything runs on
the card unless ``device`` says otherwise.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from ..models.detector import DetectorConfig, YOLOXDetector
from ..models.mot import MOTConfig, OCSORTDisparity
from ..models.tracker import TrackerConfig
from ..utils.devices import checked_device

_BACKBONE_KINDS = {
    'YOLOXCSPDarknet_Disparity_V1_MMYOLO': 'dual',
    'YOLOXCSPDarknet_Disparity_V0_MMYOLO': 'concat',
    'YOLOXCSPDarknet': 'single',
    'CSPDarknet': 'single',
}
_ALIASES = {'pallas': 'cuda', 'xla': 'torch'}


def _strip(kind: str) -> str:
    return kind.split('.')[-1]


def build_detector_config(det_cfg: Dict[str, Any]) -> DetectorConfig:
    backbone = det_cfg.get('backbone', {})
    head_module = det_cfg.get('bbox_head', {}).get('head_module', {})
    test_cfg = det_cfg.get('test_cfg', {})
    return DetectorConfig(
        num_classes=head_module.get('num_classes', 1),
        deepen_factor=backbone.get('deepen_factor', 0.33),
        widen_factor=backbone.get('widen_factor', 0.5),
        backbone=_BACKBONE_KINDS.get(_strip(backbone.get('type', '')),
                                     'dual'),
        score_thr=test_cfg.get('score_thr', 0.01),
        nms_iou_thr=test_cfg.get('nms', {}).get('iou_threshold', 0.65),
        max_per_img=test_cfg.get('max_per_img', 300),
    )


def build_tracker_config(trk_cfg: Dict[str, Any]) -> TrackerConfig:
    return TrackerConfig(
        num_slots=trk_cfg.get('num_slots', 64),
        num_dets=trk_cfg.get('num_dets', 64),
        obj_score_thr=trk_cfg.get('obj_score_thr', 0.3),
        init_track_thr=trk_cfg.get('init_track_thr', 0.7),
        weight_iou_with_det_scores=trk_cfg.get(
            'weight_iou_with_det_scores', True),
        match_iou_thr=trk_cfg.get('match_iou_thr', 0.3),
        num_tentatives=trk_cfg.get('num_tentatives', 3),
        vel_consist_weight=trk_cfg.get('vel_consist_weight', 0.2),
        vel_delta_t=trk_cfg.get('vel_delta_t', 3),
        num_frames_retain=trk_cfg.get('num_frames_retain', 10),
    )


def resolve_backend(val: str, device) -> str:
    """'auto' -> 'cuda' on a CUDA device, 'torch' elsewhere."""
    val = _ALIASES.get(val, val)
    if val == 'auto':
        return 'cuda' if torch.device(device).type == 'cuda' else 'torch'
    if val not in ('torch', 'cuda'):
        raise ValueError(f'unknown backend {val!r}')
    return val


def _backbone_backend(model_cfg: Dict[str, Any], device) -> str:
    keys = ('stem_backend', 'stage1_backend', 'stage2_backend')
    vals = {resolve_backend(model_cfg.get(k, 'torch'), device) for k in keys}
    if len(vals) != 1:
        raise ValueError(f'{keys} must resolve to one backend, got '
                         f'{[model_cfg.get(k, "torch") for k in keys]}')
    return vals.pop()


def _stage3_backend(model_cfg: Dict[str, Any], backbone: str) -> str:
    """'auto' -> 'torch' (the JAX builder resolves it to XLA everywhere);
    'cuda' only on top of the stage-2 kernel."""
    val = _ALIASES.get(model_cfg.get('stage3_backend', 'auto'),
                       model_cfg.get('stage3_backend', 'auto'))
    if val == 'auto':
        return 'torch'
    if val not in ('torch', 'cuda'):
        raise ValueError(f'unknown stage3_backend {val!r}')
    if val == 'cuda' and backbone != 'cuda':
        raise ValueError("stage3_backend='cuda' requires the stage-2 kernel "
                         "(stage2_backend='cuda'): it consumes its bf16 "
                         f"activations; got {backbone!r}")
    return val


def build_mot_config(model_cfg: Dict[str, Any], device='cuda') -> MOTConfig:
    kind = _strip(model_cfg.get('type', 'OCSORT_Disparity'))
    if kind not in ('OCSORT_Disparity', 'OCSORT'):
        raise ValueError(f'unsupported model type {kind!r}')
    if model_cfg.get('cmc'):
        raise NotImplementedError('camera-motion compensation is not ported')
    device = checked_device(device)
    backbone = _backbone_backend(model_cfg, device)
    depth = _ALIASES.get(model_cfg.get('depth_backend', 'auto'),
                         model_cfg.get('depth_backend', 'auto'))
    if depth not in ('auto', 'cuda', 'torch'):
        raise ValueError(f'unknown depth_backend {depth!r}')
    return MOTConfig(
        detector=build_detector_config(model_cfg.get('detector', {})),
        tracker=build_tracker_config(model_cfg.get('tracker', {})),
        baseline=model_cfg.get('baseline', 0.25),
        focal_length=model_cfg.get('focal_length', 640),
        depth_crop=model_cfg.get('depth_crop', 96),
        depth_mode=model_cfg.get('depth_mode', 'corner_guided'),
        reuse_det_depth=model_cfg.get('reuse_det_depth', True),
        disp_fixed_point=model_cfg.get('disp_fixed_point', True),
        backbone_backend=backbone,
        stage3_backend=_stage3_backend(model_cfg, backbone))


def build_model(cfg: Dict[str, Any], device='cuda',
                module: Optional[YOLOXDetector] = None,
                seed: int = 0) -> OCSORTDisparity:
    """cfg: a full config dict with a 'model' entry; the model lives on
    ``device`` (the card unless the caller asks for the CPU).  Without
    ``module`` the detector gets seeded random weights
    (``models.mot.init_weights``).
    The per-box depth statistics run through the depth kernel wrapper
    whatever ``depth_backend`` says: CUDA tensors launch the kernel."""
    mot = build_mot_config(cfg['model'], device)
    return OCSORTDisparity(mot, module=module, device=device, seed=seed)
