"""Seed-made detector weights, drawn on the device in a few large calls.

Convolution weights are normal with std fan_in^-1/2; BatchNorm's scale is
1 + 0.1 z and its shift 0.1 z, so the comparison covers its arithmetic;
convolution biases are zero except the head's class and objectness biases,
``HEAD_BIAS``, which lift every candidate's score so that every detection
and track slot of the fixed-slot step is in use, and the box regression's
size biases, ``BOX_LOG_SIZE``, which make each box about that many strides
wide and high: neighbouring anchors' boxes overlap as a trained
detector's do around one object, and NMS suppresses many candidates
before it has kept its ``max_per_img``.  The state
dict carries mmyolo's key names, which the program's detector and the
reference's share.
"""
from __future__ import annotations

import math
from typing import Dict

import torch

from .reference import model as md

HEAD_BIAS = 3.0
BOX_LOG_SIZE = math.log(4.0)


def seeded_state_dict(det_cfg: md.DetectorConfig, seed: int, device
                      ) -> Dict[str, torch.Tensor]:
    device = torch.device(device)
    with torch.device('meta'):
        shapes = md.YOLOXDetector(det_cfg)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed % (2 ** 63))
    convs = [(n, m) for n, m in shapes.named_modules()
             if isinstance(m, torch.nn.Conv2d)]
    bns = [n for n, m in shapes.named_modules()
           if isinstance(m, torch.nn.BatchNorm2d)]
    sd = {}
    total = sum(m.weight.numel() for _, m in convs)
    z = torch.randn(total, generator=gen, device=device)
    off = 0
    for name, m in convs:
        n = m.weight.numel()
        fan_in = n // m.weight.shape[0]
        sd[f'{name}.weight'] = z[off:off + n].view(m.weight.shape) * \
            fan_in ** -0.5
        off += n
        if m.bias is not None:
            kind = name.split('.')[-2]
            bias = torch.zeros(m.bias.shape, device=device)
            if kind in ('multi_level_conv_cls', 'multi_level_conv_obj'):
                bias.fill_(HEAD_BIAS)
            elif kind == 'multi_level_conv_reg':
                bias[2:] = BOX_LOG_SIZE
            sd[f'{name}.bias'] = bias
    widths = [shapes.get_submodule(n).num_features for n in bns]
    z = torch.randn((4, sum(widths)), generator=gen, device=device)
    off = 0
    for name, c in zip(bns, widths):
        zz = z[:, off:off + c]
        off += c
        sd[f'{name}.weight'] = 1.0 + 0.1 * zz[0]
        sd[f'{name}.bias'] = 0.1 * zz[1]
        sd[f'{name}.running_mean'] = 0.1 * zz[2]
        sd[f'{name}.running_var'] = 1.0 + 0.1 * zz[3].abs()
        sd[f'{name}.num_batches_tracked'] = torch.zeros(
            (), dtype=torch.long, device=device)
    return sd
