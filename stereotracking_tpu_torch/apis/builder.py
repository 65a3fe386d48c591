"""Config dicts (reference key layout) -> the port's configs and model.

Port of ``stereotracking_tpu/apis/builder.py`` (``build_mot_config``,
``build_model``).  Backend keys ``stem_backend``, ``stage1_backend``,
``stage2_backend`` and ``stage3_backend`` take ``'auto'``, ``'cuda'`` (the
stage's hand-written kernel) or ``'torch'`` (the float32 modules);
``'pallas'`` / ``'xla'`` from JAX configs mean ``'cuda'`` / ``'torch'``.
``resolve_stage_backends`` resolves them as the JAX package's
``_resolve_stage_backends`` does, along the chain stem -> stage 1 ->
stage 2 -> stage 3 (each kernel reads the previous kernel's output):
``'auto'`` is the kernel on a CUDA device and the float32 modules
elsewhere, and falls back to the modules when its predecessor is off or,
on a CUDA device, when the kernel is not built for the model's widths or
depth; an explicit ``'cuda'`` in either case raises here, not at the first
frame.  ``stage3_backend='auto'`` is the float32 modules everywhere, as in
the JAX builder.  On the CPU, ``'cuda'`` runs the kernels' plain versions,
which take any width.  ``pack_backend`` has no meaning here and is
ignored.  Everything runs on the card unless ``device`` says otherwise.
"""
from __future__ import annotations

import warnings
from typing import Any, Dict, Optional

from ..models.csp_darknet import StageBackends, backbone_dims
from ..models.detector import DetectorConfig, YOLOXDetector
from ..models.mot import MOTConfig, OCSORTDisparity
from ..models.tracker import TrackerConfig
from ..ops import stage1_cuda, stage2_cuda, stage3_cuda, stem_cuda
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


def kernel_problems(det: DetectorConfig) -> StageBackends:
    """Per stage, why its kernel cannot run this detector's widths and
    depth, or None; the limits are the kernel wrappers' own."""
    stem_ch, dims = backbone_dims(det.deepen_factor, det.widen_factor)
    return StageBackends(stem_cuda.dims_problem(stem_ch),
                         stage1_cuda.dims_problem(dims[0]),
                         stage2_cuda.stage_csp_dims_problem(dims[1]),
                         stage3_cuda.dims_problem(dims[2]))


def resolve_stage_backends(model_cfg: Dict[str, Any],
                           device_type: str) -> StageBackends:
    """The ``<stage>_backend`` keys of ``model_cfg`` resolved to 'cuda' or
    'torch' for its detector on a device of type ``device_type`` ('cuda'
    or 'cpu'); a pure function, so it runs without a card.  Each 'auto'
    that a kernel's dims move to the float32 modules is reported by a
    warning."""
    det = build_detector_config(model_cfg.get('detector', {}))
    raw = []
    for name in StageBackends._fields:
        val = model_cfg.get(f'{name}_backend', 'torch')
        raw.append(_ALIASES.get(val, val))
        if raw[-1] not in ('auto', 'cuda', 'torch'):
            raise ValueError(f'unknown {name}_backend {val!r}')
    on_card = device_type == 'cuda'
    problems = (kernel_problems(det) if on_card
                else StageBackends(*[None] * len(raw)))
    where = (f'(stem O, or stage (C_in, C_out, mid, num_blocks), at '
             f'widen_factor {det.widen_factor}, deepen_factor '
             f'{det.deepen_factor})')
    out = []
    for name, req, problem in zip(StageBackends._fields, raw, problems):
        if req == 'cuda' and problem:
            raise ValueError(f"{name}_backend='cuda': {problem} {where}")
        val = req
        if req == 'auto':
            # stage3 'auto' stays on the float32 modules, as the JAX
            # builder decides (stereotracking_tpu/apis/builder.py:86-96)
            if problem and name != 'stage3':
                warnings.warn(f"{name}_backend='auto' runs on the float32 "
                              f"modules: {problem} {where}")
            val = ('cuda' if on_card and not problem and name != 'stage3'
                   else 'torch')
            # an 'auto' kernel whose predecessor runs on the float32
            # modules follows it there; an explicit one raises in check()
            if out and out[-1] != 'cuda':
                val = 'torch'
        out.append(val)
    backends = StageBackends(*out)
    backends.check()
    return backends


def build_mot_config(model_cfg: Dict[str, Any], device='cuda') -> MOTConfig:
    kind = _strip(model_cfg.get('type', 'OCSORT_Disparity'))
    if kind not in ('OCSORT_Disparity', 'OCSORT'):
        raise ValueError(f'unsupported model type {kind!r}')
    if model_cfg.get('cmc'):
        raise NotImplementedError('camera-motion compensation is not ported')
    device = checked_device(device)
    depth = _ALIASES.get(model_cfg.get('depth_backend', 'auto'),
                         model_cfg.get('depth_backend', 'auto'))
    if depth not in ('auto', 'cuda', 'torch'):
        raise ValueError(f'unknown depth_backend {depth!r}')
    depth_mode = model_cfg.get('depth_mode', 'corner_guided')
    if depth_mode != 'corner_guided':
        raise NotImplementedError(
            f'depth_mode {depth_mode!r} is not ported (only '
            f"'corner_guided'; the other modes are ROADMAP.md Queue 1 "
            f'item 4)')
    return MOTConfig(
        detector=build_detector_config(model_cfg.get('detector', {})),
        tracker=build_tracker_config(model_cfg.get('tracker', {})),
        baseline=model_cfg.get('baseline', 0.25),
        focal_length=model_cfg.get('focal_length', 640),
        depth_crop=model_cfg.get('depth_crop', 96),
        depth_mode=depth_mode,
        reuse_det_depth=model_cfg.get('reuse_det_depth', True),
        disp_fixed_point=model_cfg.get('disp_fixed_point', True),
        backends=resolve_stage_backends(model_cfg, device.type))


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
