"""YOLOX detector: backbone + PAFPN + head, and the fused postprocess.

Port of ``stereotracking_tpu/models/detector.py`` (``DetectorConfig``,
``YOLOXDetector`` with its backbone switch: ``'dual'``, ``'single'`` or
``'concat'``, and ``detector_predict``: forward, decode, score filter,
class-aware NMS, ``scale_factor`` rescale).
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
from torch import nn

from ..ops.nms import NMSResult, batched_nms, multiclass_candidates
from .csp_darknet import (CSPDarknet, CSPDarknetConcat, CSPDarknetDual,
                          StageBackends)
from .pafpn import YOLOXPAFPN
from .yolox_head import YOLOXHead, decode_predictions


class DetectorConfig(NamedTuple):
    num_classes: int = 1
    deepen_factor: float = 0.33
    widen_factor: float = 0.5
    strides: Tuple[int, ...] = (8, 16, 32)
    backbone: str = 'dual'          # 'dual' | 'single' | 'concat'
    score_thr: float = 0.01
    nms_iou_thr: float = 0.5
    max_per_img: int = 300
    pre_nms_top_k: int = 2048


BACKBONES = {'dual': CSPDarknetDual, 'single': CSPDarknet,
             'concat': CSPDarknetConcat}


class YOLOXDetector(nn.Module):
    """Backbone (``cfg.backbone``) -> PAFPN -> decoupled head (mm key
    names).
    Parameters are float32; the layers that run on the modules compute in
    ``dtype`` (the JAX ``YOLOXDetector.dtype``).  Built in eval mode;
    ``.train()`` (the trainer's) normalises with batch statistics, float32
    and the modules only (the JAX ``train=True``)."""

    def __init__(self, cfg: DetectorConfig = DetectorConfig(),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if cfg.backbone not in BACKBONES:
            raise ValueError(f'unknown backbone {cfg.backbone!r}; one of '
                             f'{tuple(BACKBONES)}')
        self.cfg = cfg
        self.dtype = dtype
        self.backbone = BACKBONES[cfg.backbone](
            cfg.deepen_factor, cfg.widen_factor, dtype=dtype)
        self.neck = YOLOXPAFPN(deepen_factor=cfg.deepen_factor,
                               widen_factor=cfg.widen_factor, dtype=dtype)
        self.bbox_head = YOLOXHead(num_classes=cfg.num_classes,
                                   widen_factor=cfg.widen_factor,
                                   strides=cfg.strides, dtype=dtype)
        self.eval()         # serving semantics unless a trainer asks

    def forward(self, inputs: dict,
                backends: StageBackends = StageBackends()):
        """-> (cls, reg, obj): per-level (S, h, w, C) maps in ``dtype``;
        backends as ``CSPDarknetDual.forward`` (all 'torch' for the other
        backbones)."""
        feats = self.backbone(inputs, backends)
        return self.bbox_head(self.neck(feats))


@torch.no_grad()
def detector_predict(module: YOLOXDetector, inputs: dict,
                     scale_factor=(1.0, 1.0),
                     backends: StageBackends = StageBackends()
                     ) -> NMSResult:
    """Predict for the S frames of ``inputs``: forward + decode + NMS +
    rescale (boxes are divided by ``scale_factor``: (sf_x, sf_y), or a (4,)
    float32 tensor (sf_x, sf_y, sf_x, sf_y) on the boxes' device), each
    NMSResult field with a leading S."""
    cfg = module.cfg
    cls, reg, obj = module(inputs, backends)
    boxes, scores = decode_predictions(cls, reg, obj, cfg.strides)
    fb, fs, fl = multiclass_candidates(boxes, scores, cfg.score_thr)
    res = batched_nms(fb, fs, fl, cfg.nms_iou_thr, cfg.score_thr,
                      cfg.pre_nms_top_k, cfg.max_per_img)
    if not torch.is_tensor(scale_factor):
        if tuple(scale_factor) == (1.0, 1.0):
            return res                   # x / 1 == x
        # filled on the device (no host-to-device copy, which a CUDA graph
        # would replay from its captured host buffer)
        sf = torch.full((4,), float(scale_factor[0]), dtype=torch.float32,
                        device=res.boxes.device)
        sf[1::2] = float(scale_factor[1])
        scale_factor = sf
    # divided tensor by tensor, an IEEE division
    return res._replace(boxes=res.boxes / scale_factor)
