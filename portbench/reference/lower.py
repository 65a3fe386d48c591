"""The reference one precision step down, for the control of ``correct``.

The step is chosen per layer, from the precision in which the program
computes that layer.  A stage that the program runs as its fused kernel
(the stem, stage 1, 2 or 3 whose backend is 'cuda') is computed in
bfloat16 whatever the configuration's serving ``dtype`` says, so its
layers step down from bfloat16; every other layer steps down from
``dtype``.  A control that stepped the whole detector down from a float32
``dtype`` would be TF32 in the kernels' layers: more precise there than
the program's bfloat16, and no number could tell it from the program.

The steps (``CONTROL``): from bfloat16 (or float16) to float8 (e4m3):
every convolution's input, weight and output, and every
conv-BatchNorm-SiLU block's output, rounded to float8 with one scale per
tensor for the format's range, as a float8 path stores every activation,
the head's outputs among them; from float32, which the benchmark runs with
TF32 off, to TF32: every convolution's input and weight rounded to TF32's
10-bit mantissa, the arithmetic in between float32.  The tracker's float
inputs and state are rounded to bfloat16 at every step, for its float32
arithmetic.

A second control, ``kernels_as_run=True``, keeps the kernels' layers in
bfloat16, as the program computes them (input, weight and output rounded
to bfloat16), and steps only the other layers down from ``dtype``: the
control of the float32 layers alone, for a float32 configuration the
reference with TF32 convolutions and a tracker rounded to TF32.  The
kernels' bfloat16 rounding sets the program's error floor, so this
control reads close to the program in the detector's numbers.
"""
from __future__ import annotations

from typing import Dict

import torch
from torch import nn

FP8 = torch.float8_e4m3fn
FP8_MAX = 448.0


def round_fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` through float8 e4m3 with one scale for the tensor."""
    amax = x.detach().abs().amax().clamp(min=1e-12)
    scale = FP8_MAX / amax
    return (x * scale).to(FP8).to(x.dtype) / scale


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 ``x`` with its mantissa rounded to TF32's 10 bits (to
    nearest, ties away from zero)."""
    bits = x.float().contiguous().view(torch.int32)
    bits = (bits + 0x1000) & ~0x1FFF
    return bits.view(torch.float32).to(x.dtype)


def round_bf16_tensor(x: torch.Tensor) -> torch.Tensor:
    """``x`` through bfloat16."""
    return x.to(torch.bfloat16).to(x.dtype)


# the serving dtype -> (rounding of conv inputs and weights, whether every
# convolution's and conv-BatchNorm-SiLU block's output is stored rounded too)
CONTROL = {'bfloat16': (round_fp8, True), 'float16': (round_fp8, True),
           'float32': (round_tf32, False)}
# a layer computed as the program computes it: only the kernels' bfloat16
AS_RUN = {'bfloat16': (round_bf16_tensor, True)}


# the reference's modules that each stage kernel of the program computes
KERNEL_MODULES = {'stem': ('backbone.stem', 'backbone.disp_stem'),
                  'stage1': ('backbone.stage1', 'backbone.disp_stage1'),
                  'stage2': ('backbone.stage2',),
                  'stage3': ('backbone.stage3',)}
KERNEL_DTYPE = 'bfloat16'


def lower_detector(module: nn.Module, dtype: str,
                   backends: Dict[str, str],
                   kernels_as_run: bool = False) -> nn.Module:
    """The detector one step below what the program computes each layer
    in (in place): every convolution's weight, and at each call its
    input, rounded; for a 16-bit layer every convolution's and
    ``ConvBNAct``'s output too.  Layers of the stages that ``backends``
    ({stage: 'cuda' or 'torch'}) runs as kernels step down from bfloat16,
    the others from ``dtype``; with ``kernels_as_run`` the kernels' layers
    are rounded to bfloat16 alone, as the program computes them."""
    from .model import ConvBNAct
    kernels = tuple(p for stage, b in backends.items() if b == 'cuda'
                    for p in KERNEL_MODULES[stage])
    with torch.no_grad():
        for name, m in module.named_modules():
            inside = any(name == p or name.startswith(p + '.')
                         for p in kernels)
            if inside:
                rnd, outputs = (AS_RUN if kernels_as_run
                                else CONTROL)[KERNEL_DTYPE]
            else:
                rnd, outputs = CONTROL[dtype]
            if isinstance(m, nn.Conv2d):
                m.weight.copy_(rnd(m.weight))
                m.register_forward_pre_hook(
                    lambda _m, args, rnd=rnd: (rnd(args[0]),) + args[1:])
            if outputs and isinstance(m, (nn.Conv2d, ConvBNAct)):
                m.register_forward_hook(
                    lambda _m, _a, out, rnd=rnd: rnd(out))
    return module


def round_bf16(t):
    """A tuple of tensors with its float tensors rounded to bfloat16."""
    return type(t)(*(x.to(torch.bfloat16).to(x.dtype)
                     if x.is_floating_point() else x for x in t))


def round_tf32_state(t):
    """A tuple of tensors with its float32 tensors rounded to TF32."""
    return type(t)(*(round_tf32(x) if x.dtype == torch.float32 else x
                     for x in t))
