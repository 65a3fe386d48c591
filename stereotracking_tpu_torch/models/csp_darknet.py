"""Dual-branch CSPDarknet-P5 backbone (RGB + disparity), canonical form.

Port of ``CSPDarknetDual`` (``stereotracking_tpu/models/csp_darknet.py``):
a Focus stem and stage 1 per branch, averaged at stride 4, then the shared
stages 2-4 (SPPF in the last).  Module names follow mmyolo
(``stem``, ``stageN.{0,1[,2]}``, ``disp_stem``, ``disp_stage1``).

Backends, one per stage (``StageBackends``): ``'torch'`` evaluates the
float32 modules (the JAX package's XLA path); ``'cuda'`` evaluates the
stage through its fused kernel (ops/*_cuda.py), which works in bf16 NHWC.
Each kernel consumes the previous kernel's output, so a stage's kernel
needs the kernel of the stage before it (stem -> stage 1 -> stage 2 ->
stage 3), as in the JAX detector; where a kernel hands over to the float32
modules, its bf16 NHWC output becomes NCHW float32.  Every kernel takes the
S frames of a batch in one launch.  A kernel wrapper given a CPU tensor
runs its plain PyTorch version.
"""
from __future__ import annotations

import itertools
from typing import Dict, List, NamedTuple, Tuple

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


class StageBackends(NamedTuple):
    """The backend of each stage whose kernel the port has, in chain
    order; the field names are the stage names (config key
    ``<stage>_backend``)."""
    stem: str = 'torch'
    stage1: str = 'torch'
    stage2: str = 'torch'
    stage3: str = 'torch'

    def check(self) -> None:
        """Raise on an unknown backend, or on a kernel whose predecessor
        runs on the float32 modules."""
        for name, val in zip(self._fields, self):
            if val not in BACKENDS:
                raise ValueError(f'{name}_backend must be in {BACKENDS}, '
                                 f'got {val!r}')
        names = self._fields
        for prev, name, a, b in zip(names, names[1:], self, self[1:]):
            if b == 'cuda' and a != 'cuda':
                raise ValueError(
                    f"{name}_backend='cuda' requires {prev}_backend='cuda': "
                    f"its kernel reads the {prev} kernel's bf16 output; got "
                    f"{prev}_backend={a!r}")


def backbone_dims(deepen_factor: float, widen_factor: float
                  ) -> Tuple[int, List[Tuple[int, int, int, int]]]:
    """The stem's output channels and each stage's (C_in, C_out, mid,
    num_blocks), stages 1-4."""
    stem_ch = widen(64, widen_factor)
    dims, cin = [], stem_ch
    for _, out, n, _, _ in P5_ARCH:
        cout = widen(out, widen_factor)
        dims.append((cin, cout, cout // 2, make_round(n, deepen_factor)))
        cin = cout
    return stem_ch, dims


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
        stem_ch, dims = backbone_dims(deepen_factor, widen_factor)
        self.stem = Focus(3, stem_ch)
        self.disp_stem = Focus(3, stem_ch)
        for i, ((cin, cout, _, n), (_, _, _, ident, spp)) in enumerate(
                zip(dims, P5_ARCH)):
            args = (cin, cout, n, ident, spp, spp_kernel_sizes)
            setattr(self, f'stage{i + 1}', _stage(*args))
            if i == 0:
                self.disp_stage1 = _stage(*args)
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

    def forward(self, inputs: dict,
                backends: StageBackends = StageBackends()):
        """``inputs``: 'img' and 'disp_postp' (S, H, W, 3) float32; with
        the stem kernels also the raw frames 'img_u8' (S, h, w, 3) and
        'disp_u16' (S, h, w).  Returns the (stage 2, 3, 4) NCHW float32
        features."""
        backends.check()        # a kernel runs only after its predecessor's
        if backends.stem == 'cuda':
            kw = self.kernel_weights()
            oh, ow = inputs['img'].shape[1:3]
            rgb = focus_stem(inputs['img_u8'], *kw['stem'], oh, ow)
            dsp = focus_stem(inputs['disp_u16'], *kw['disp_stem'], oh, ow)
        else:
            rgb = self.stem(inputs['img'].permute(0, 3, 1, 2))
            dsp = self.disp_stem(inputs['disp_postp'].permute(0, 3, 1, 2))
        if backends.stage1 == 'cuda':
            y = stage1_dual(rgb, dsp, kw['stage1'], kw['disp_stage1'])
        else:
            if backends.stem == 'cuda':
                rgb, dsp = _nchw(rgb), _nchw(dsp)
            y = (self.stage1(rgb) + self.disp_stage1(dsp)) / 2.0
        if backends.stage2 == 'cuda':
            y2k = stage_csp(y, kw['stage2'])
            y2 = _nchw(y2k)
        else:
            y2 = self.stage2(_nchw(y) if backends.stage1 == 'cuda' else y)
        y3 = (_nchw(stage3_csp(y2k, kw['stage3']))
              if backends.stage3 == 'cuda' else self.stage3(y2))
        return y2, y3, self.stage4(y3)


def _nchw(y: torch.Tensor) -> torch.Tensor:
    """A kernel's (S, H, W, C) bf16 output as an NCHW float32 view."""
    return y.float().permute(0, 3, 1, 2)
