"""Dual-branch CSPDarknet-P5 backbone (RGB + disparity), canonical form.

Port of ``CSPDarknetDual`` (``stereotracking_tpu/models/csp_darknet.py``):
a Focus stem and stage 1 per branch, averaged at stride 4, then the shared
stages 2-4 (SPPF in the last).  Module names follow mmyolo
(``stem``, ``stageN.{0,1[,2]}``, ``disp_stem``, ``disp_stage1``).

Backend: ``'torch'`` evaluates the float32 modules (the JAX package's XLA
path); ``'cuda'`` evaluates the stems, the dual stage 1 and stage 2 through
the fused kernels (ops/*_cuda.py), which work in bf16 NHWC, and with
``stage3_backend='cuda'`` stage 3 as well.  Every kernel takes the S frames
of a batch in one launch.  A kernel wrapper given a CPU tensor runs its
plain PyTorch version.
"""
from __future__ import annotations

import itertools
from typing import Dict, Tuple

import torch
from torch import nn

from ..ops.stage1_cuda import stage1_dual
from ..ops.stage2_cuda import stage_csp, stage_weights
from ..ops.stage3_cuda import stage3_csp
from ..ops.stem_cuda import focus_stem, stem_weights
from .layers import (ConvBNAct, CSPLayer, Focus, SPPFBottleneck, make_round,
                     widen)

# in_ch, out_ch, num_blocks, add_identity, use_spp
P5_ARCH = [
    (64, 128, 3, True, False),
    (128, 256, 9, True, False),
    (256, 512, 9, True, False),
    (512, 1024, 3, False, True),
]
BACKENDS = ('torch', 'cuda')


def _stage(cin: int, cout: int, num_blocks: int, add_identity: bool,
           use_spp: bool, spp_kernel_sizes) -> nn.Sequential:
    layers = [ConvBNAct(cin, cout, 3, 2)]
    if use_spp:
        layers.append(SPPFBottleneck(cout, cout, spp_kernel_sizes))
    layers.append(CSPLayer(cout, cout, num_blocks, add_identity))
    return nn.Sequential(*layers)


class CSPDarknetDual(nn.Module):
    def __init__(self, deepen_factor: float = 0.33,
                 widen_factor: float = 0.5,
                 spp_kernel_sizes: Tuple[int, ...] = (5, 9, 13)):
        super().__init__()
        stem_ch = widen(64, widen_factor)
        self.stem = Focus(3, stem_ch)
        self.disp_stem = Focus(3, stem_ch)
        cin = stem_ch
        for i, (_, out, n, ident, spp) in enumerate(P5_ARCH):
            cout = widen(out, widen_factor)
            args = (cin, cout, make_round(n, deepen_factor), ident, spp,
                    spp_kernel_sizes)
            setattr(self, f'stage{i + 1}', _stage(*args))
            if i == 0:
                self.disp_stage1 = _stage(*args)
            cin = cout
        self._kernel_cache = (None, None)

    @torch.no_grad()
    def kernel_weights(self) -> Dict[str, object]:
        """Weights of the fused kernels, packed as the kernels read them
        and rebuilt only when a parameter or buffer changed (keyed on their
        storage and version counters)."""
        key = tuple((t.data_ptr(), t._version) for t in itertools.chain(
            self.parameters(), self.buffers()))
        if self._kernel_cache[0] != key:
            kw = {
                'stem': stem_weights(self.stem, sum_channels=False),
                'disp_stem': stem_weights(self.disp_stem, sum_channels=True),
                'stage1': stage_weights(self.stage1),
                'disp_stage1': stage_weights(self.disp_stage1),
                'stage2': stage_weights(self.stage2),
                'stage3': stage_weights(self.stage3),
            }
            self._kernel_cache = (key, kw)
        return self._kernel_cache[1]

    def forward(self, inputs: dict, backend: str = 'torch',
                stage3_backend: str = 'torch'):
        """``inputs``: 'img' and 'disp_postp' (S, H, W, 3) float32; with
        ``backend='cuda'`` also the raw frames 'img_u8' (S, h, w, 3) and
        'disp_u16' (S, h, w).  ``stage3_backend='cuda'`` needs
        ``backend='cuda'`` (the stage-3 kernel reads stage 2's bf16 NHWC
        output).  Returns the (stage 2, 3, 4) NCHW float32 features."""
        if backend not in BACKENDS or stage3_backend not in BACKENDS:
            raise ValueError(f'backends must be in {BACKENDS}: '
                             f'{backend!r}, {stage3_backend!r}')
        if stage3_backend == 'cuda' and backend != 'cuda':
            raise ValueError("stage3_backend='cuda' needs backend='cuda'")
        if backend == 'cuda':
            kw = self.kernel_weights()
            oh, ow = inputs['img'].shape[1:3]
            rgb = focus_stem(inputs['img_u8'], *kw['stem'], oh, ow)
            dsp = focus_stem(inputs['disp_u16'], *kw['disp_stem'], oh, ow)
            y = stage1_dual(rgb, dsp, kw['stage1'], kw['disp_stage1'])
            y2k = stage_csp(y, kw['stage2'])
            y2 = _nchw(y2k)
            y3 = (_nchw(stage3_csp(y2k, kw['stage3']))
                  if stage3_backend == 'cuda' else self.stage3(y2))
        else:
            rgb = self.stem(inputs['img'].permute(0, 3, 1, 2))
            dsp = self.disp_stem(inputs['disp_postp'].permute(0, 3, 1, 2))
            y = (self.stage1(rgb) + self.disp_stage1(dsp)) / 2.0
            y2 = self.stage2(y)
            y3 = self.stage3(y2)
        return y2, y3, self.stage4(y3)


def _nchw(y: torch.Tensor) -> torch.Tensor:
    """A kernel's (S, H, W, C) bf16 output as an NCHW float32 view."""
    return y.float().permute(0, 3, 1, 2)
