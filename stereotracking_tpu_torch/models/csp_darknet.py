"""CSPDarknet-P5 backbones, single- and dual-branch, canonical form.

Port of ``stereotracking_tpu/models/csp_darknet.py``:

- ``CSPDarknetDual`` (the flagship's): a Focus stem and stage 1 per
  branch (RGB, disparity), averaged at stride 4, then the shared stages 2-4
  (SPPF in the last);
- ``CSPDarknet`` (the monocular configs'): one Focus stem and stages 1-4
  on the image alone;
- ``CSPDarknetConcat`` (the V0 variant): the image and the disparity
  concatenated to 6 channels before one ``CSPDarknet``, named ``trunk`` as
  in the Flax tree.

Module names follow mmyolo (``stem``, ``stageN.{0,1[,2]}``, ``disp_stem``,
``disp_stage1``).  The JAX package's space-to-depth and W-fold forms of
the single branch (``_use_s2d``) are the same math in another layout and
are not ported: the port evaluates the canonical form.

Backends, one per stage (``StageBackends``): ``'torch'`` evaluates the
modules in the compute ``dtype`` (the JAX package's XLA path; float32 by
default, bfloat16 as the JAX ``dtype=jnp.bfloat16``); ``'cuda'`` evaluates
the stage through its fused kernel (ops/*_cuda.py), which works in bf16
NHWC whatever ``dtype`` says.  Each kernel consumes the previous kernel's
output, so a stage's kernel needs the kernel of the stage before it (stem
-> stage 1 -> stage 2 -> stage 3), as in the JAX detector; where a kernel
hands over to the modules, its bf16 NHWC output becomes an NCHW view in
``dtype``: float32 a converted copy, bfloat16 the kernel's own tensor
(channels-last, as cuDNN's bf16 convolutions take it).  Every kernel takes
the S frames of a batch in one launch.  A kernel wrapper given a CPU
tensor runs its plain PyTorch version.  In train mode (``.train()``) every
stage must be ``'torch'``: the kernels have no backward.  The single and
concat backbones have no kernel (the JAX package reaches none for them):
every stage of theirs is ``'torch'``.
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
           use_spp: bool, spp_kernel_sizes, dtype) -> nn.Sequential:
    layers = [ConvBNAct(cin, cout, 3, 2, dtype=dtype)]
    if use_spp:
        layers.append(SPPFBottleneck(cout, cout, spp_kernel_sizes,
                                     dtype=dtype))
    layers.append(CSPLayer(cout, cout, num_blocks, add_identity, dtype=dtype))
    return nn.Sequential(*layers)


class CSPDarknet(nn.Module):
    """Single-branch CSPDarknet-P5: a Focus stem on ``in_channels`` input
    channels and stages 1-4, all on the modules."""

    def __init__(self, deepen_factor: float = 0.33,
                 widen_factor: float = 0.5, in_channels: int = 3,
                 spp_kernel_sizes: Tuple[int, ...] = (5, 9, 13),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        stem_ch, dims = backbone_dims(deepen_factor, widen_factor)
        self.stem = Focus(in_channels, stem_ch, dtype=dtype)
        for i, ((cin, cout, _, n), (_, _, _, ident, spp)) in enumerate(
                zip(dims, P5_ARCH)):
            setattr(self, f'stage{i + 1}', _stage(
                cin, cout, n, ident, spp, spp_kernel_sizes, dtype))

    def features(self, x: torch.Tensor):
        """NCHW input -> the (stage 2, 3, 4) NCHW features."""
        y2 = self.stage2(self.stage1(self.stem(x)))
        y3 = self.stage3(y2)
        return y2, y3, self.stage4(y3)

    def forward(self, inputs: dict,
                backends: StageBackends = StageBackends()):
        """``inputs``: 'img' (S, H, W, 3) float32; returns the (stage 2,
        3, 4) NCHW features in the compute dtype."""
        assert 'cuda' not in backends, backends  # the builder refuses it
        return self.features(inputs['img'].permute(0, 3, 1, 2))


class CSPDarknetConcat(nn.Module):
    """V0 variant: 'img' and 'disp_postp' concatenated to 6 channels, then
    one ``CSPDarknet`` (``trunk``)."""

    def __init__(self, deepen_factor: float = 0.33,
                 widen_factor: float = 0.5,
                 spp_kernel_sizes: Tuple[int, ...] = (5, 9, 13),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.trunk = CSPDarknet(deepen_factor, widen_factor, 6,
                                spp_kernel_sizes, dtype)

    def forward(self, inputs: dict,
                backends: StageBackends = StageBackends()):
        """``inputs``: 'img' and 'disp_postp' (S, H, W, 3) float32;
        returns the (stage 2, 3, 4) NCHW features in the compute dtype."""
        assert 'cuda' not in backends, backends  # the builder refuses it
        x = torch.cat((inputs['img'], inputs['disp_postp']), dim=-1)
        return self.trunk.features(x.permute(0, 3, 1, 2))


class CSPDarknetDual(nn.Module):
    def __init__(self, deepen_factor: float = 0.33,
                 widen_factor: float = 0.5,
                 spp_kernel_sizes: Tuple[int, ...] = (5, 9, 13),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        stem_ch, dims = backbone_dims(deepen_factor, widen_factor)
        self.stem = Focus(3, stem_ch, dtype=dtype)
        self.disp_stem = Focus(3, stem_ch, dtype=dtype)
        for i, ((cin, cout, _, n), (_, _, _, ident, spp)) in enumerate(
                zip(dims, P5_ARCH)):
            args = (cin, cout, n, ident, spp, spp_kernel_sizes, dtype)
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
        'disp_u16' (S, h, w).  Returns the (stage 2, 3, 4) NCHW features
        in the compute dtype."""
        backends.check()        # a kernel runs only after its predecessor's
        if self.training and 'cuda' in backends:
            raise ValueError(
                f'train mode runs the float32 modules only: the kernels have '
                f'no backward, and the JAX package does not train through '
                f'its Pallas kernels; got {backends}')
        dt = self.dtype
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
                rgb, dsp = _nchw(rgb, dt), _nchw(dsp, dt)
            y = (self.stage1(rgb) + self.disp_stage1(dsp)) / 2.0
        if backends.stage2 == 'cuda':
            y2k = stage_csp(y, kw['stage2'])
            y2 = _nchw(y2k, dt)
        else:
            y2 = self.stage2(_nchw(y, dt) if backends.stage1 == 'cuda'
                             else y)
        y3 = (_nchw(stage3_csp(y2k, kw['stage3']), dt)
              if backends.stage3 == 'cuda' else self.stage3(y2))
        return y2, y3, self.stage4(y3)


def _nchw(y: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """A kernel's (S, H, W, C) bf16 output as an NCHW view in ``dtype``
    (channels-last strides; no copy when ``dtype`` is bf16)."""
    return y.to(dtype).permute(0, 3, 1, 2)
