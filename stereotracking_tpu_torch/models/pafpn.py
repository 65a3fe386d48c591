"""YOLOX PAFPN neck (top-down + bottom-up path aggregation).

Port of ``stereotracking_tpu/models/pafpn.py`` with mmdet ``YOLOXPAFPN``
module names (reduce_layers, top_down_blocks, downsamples,
bottom_up_blocks, out_convs).  NCHW float tensors.
"""
from __future__ import annotations

from typing import List, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .layers import ConvBNAct, CSPLayer, make_round, widen


class YOLOXPAFPN(nn.Module):
    def __init__(self, in_channels: Sequence[int] = (256, 512, 1024),
                 out_channels: int = 256, deepen_factor: float = 0.33,
                 widen_factor: float = 0.5):
        super().__init__()
        ch = [widen(c, widen_factor) for c in in_channels]
        n = len(ch)
        num_csp = make_round(3, deepen_factor)
        self.reduce_layers = nn.ModuleList(
            ConvBNAct(ch[idx], ch[idx - 1], 1) for idx in range(n - 1, 0, -1))
        self.top_down_blocks = nn.ModuleList(
            CSPLayer(2 * ch[idx - 1], ch[idx - 1], num_csp,
                     add_identity=False) for idx in range(n - 1, 0, -1))
        self.downsamples = nn.ModuleList(
            ConvBNAct(ch[idx], ch[idx], 3, 2) for idx in range(n - 1))
        self.bottom_up_blocks = nn.ModuleList(
            CSPLayer(2 * ch[idx], ch[idx + 1], num_csp, add_identity=False)
            for idx in range(n - 1))
        out_ch = widen(out_channels, widen_factor)
        self.out_convs = nn.ModuleList(ConvBNAct(c, out_ch, 1) for c in ch)

    def forward(self, feats: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        n = len(feats)
        inner_outs = [feats[-1]]
        for idx in range(n - 1, 0, -1):
            j = n - 1 - idx
            feat_high = self.reduce_layers[j](inner_outs[0])
            inner_outs[0] = feat_high
            up = F.interpolate(feat_high, scale_factor=2, mode='nearest')
            inner_outs.insert(0, self.top_down_blocks[j](
                torch.cat([up, feats[idx - 1]], 1)))
        outs = [inner_outs[0]]
        for idx in range(n - 1):
            low = self.downsamples[idx](outs[-1])
            outs.append(self.bottom_up_blocks[idx](
                torch.cat([low, inner_outs[idx + 1]], 1)))
        return [conv(o) for conv, o in zip(self.out_convs, outs)]
