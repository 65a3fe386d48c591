"""YOLOX decoupled head (module + decode).

Port of ``stereotracking_tpu/models/yolox_head.py`` with mmyolo
``YOLOXHeadModule`` names (multi_level_cls_convs, multi_level_reg_convs,
multi_level_conv_cls / _reg / _obj).  The module takes NCHW features and
returns per-level NHWC maps, the JAX package's layout.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
from torch import nn

from .layers import ConvBNAct, widen


class YOLOXHeadModule(nn.Module):
    def __init__(self, num_classes: int = 1, in_channels: int = 256,
                 feat_channels: int = 256, widen_factor: float = 0.5,
                 stacked_convs: int = 2, strides: Sequence[int] = (8, 16, 32)):
        super().__init__()
        cin = widen(in_channels, widen_factor)
        feat = widen(feat_channels, widen_factor)

        def stack():
            return nn.Sequential(*[ConvBNAct(cin if i == 0 else feat, feat, 3)
                                   for i in range(stacked_convs)])

        n = len(strides)
        self.multi_level_cls_convs = nn.ModuleList(stack() for _ in range(n))
        self.multi_level_reg_convs = nn.ModuleList(stack() for _ in range(n))
        self.multi_level_conv_cls = nn.ModuleList(
            nn.Conv2d(feat, num_classes, 1) for _ in range(n))
        self.multi_level_conv_reg = nn.ModuleList(
            nn.Conv2d(feat, 4, 1) for _ in range(n))
        self.multi_level_conv_obj = nn.ModuleList(
            nn.Conv2d(feat, 1, 1) for _ in range(n))

    def forward(self, feats):
        cls_scores, bbox_preds, objectnesses = [], [], []
        for lvl, x in enumerate(feats):
            cls_feat = self.multi_level_cls_convs[lvl](x)
            reg_feat = self.multi_level_reg_convs[lvl](x)
            for out, conv, f in (
                    (cls_scores, self.multi_level_conv_cls[lvl], cls_feat),
                    (bbox_preds, self.multi_level_conv_reg[lvl], reg_feat),
                    (objectnesses, self.multi_level_conv_obj[lvl], reg_feat)):
                out.append(conv(f).permute(0, 2, 3, 1))
        return cls_scores, bbox_preds, objectnesses


class YOLOXHead(nn.Module):
    """Container giving the head module its mm key prefix
    (``bbox_head.head_module``)."""

    def __init__(self, **kwargs):
        super().__init__()
        self.head_module = YOLOXHeadModule(**kwargs)

    def forward(self, feats):
        return self.head_module(feats)


def level_priors(feat_h: int, feat_w: int, stride: int, offset: float = 0.0,
                 device=None) -> torch.Tensor:
    """(h*w, 4) table of (cx, cy, stride, stride) grid-corner priors."""
    ys = (torch.arange(feat_h, dtype=torch.float32, device=device)
          + offset) * stride
    xs = (torch.arange(feat_w, dtype=torch.float32, device=device)
          + offset) * stride
    gy, gx = torch.meshgrid(ys, xs, indexing='ij')
    s = torch.full((feat_h, feat_w), float(stride), dtype=torch.float32,
                   device=device)
    return torch.stack([gx, gy, s, s], -1).reshape(-1, 4)


def decode_predictions(cls_scores: List[torch.Tensor],
                       bbox_preds: List[torch.Tensor],
                       objectnesses: List[torch.Tensor],
                       strides: Sequence[int] = (8, 16, 32)
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-level NHWC maps -> boxes (N, A, 4) xyxy and scores (N, A, C) =
    sigmoid(cls) * sigmoid(obj)."""
    all_boxes, all_scores = [], []
    for cls, reg, obj, stride in zip(cls_scores, bbox_preds, objectnesses,
                                     strides):
        n, h, w, nc = cls.shape
        priors = level_priors(h, w, stride, device=cls.device)
        reg = reg.reshape(n, h * w, 4).float()
        xy = reg[..., :2] * stride + priors[None, :, :2]
        wh = torch.exp(reg[..., 2:]) * stride
        all_boxes.append(torch.cat([xy - wh / 2.0, xy + wh / 2.0], -1))
        all_scores.append(
            torch.sigmoid(cls.reshape(n, h * w, nc).float())
            * torch.sigmoid(obj.reshape(n, h * w, 1).float()))
    return torch.cat(all_boxes, 1), torch.cat(all_scores, 1)
