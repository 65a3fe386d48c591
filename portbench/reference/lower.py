"""The reference one precision step down, for the control of ``correct``.

The detector's step down follows the configuration's serving ``dtype``
(``CONTROL``): a detector served in bfloat16 (or float16) is computed in
float8 (e4m3): every convolution's input, weight and output, and every
conv-BatchNorm-SiLU block's output, rounded to float8 with one scale per
tensor for the format's range, as a float8 path stores every activation,
the head's outputs among them; one served in float32, which the benchmark
runs with TF32 off, is computed with TF32: every convolution's input and
weight rounded to TF32's 10-bit mantissa, the arithmetic in between
float32.  The tracker's float inputs and state are rounded to bfloat16 at
every step, for its float32 arithmetic.
"""
from __future__ import annotations

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


# the serving dtype -> (rounding of conv inputs and weights, whether every
# convolution's and conv-BatchNorm-SiLU block's output is stored rounded too)
CONTROL = {'bfloat16': (round_fp8, True), 'float16': (round_fp8, True),
           'float32': (round_tf32, False)}


def lower_detector(module: nn.Module, dtype: str) -> nn.Module:
    """The detector one step below ``dtype`` (in place): every
    convolution's weight, and at each call its input, rounded; for a
    16-bit ``dtype`` every convolution's and ``ConvBNAct``'s output too."""
    from .model import ConvBNAct
    rnd, outputs = CONTROL[dtype]
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, nn.Conv2d):
                m.weight.copy_(rnd(m.weight))
                m.register_forward_pre_hook(
                    lambda _m, args: (rnd(args[0]),) + args[1:])
            if outputs and isinstance(m, (nn.Conv2d, ConvBNAct)):
                m.register_forward_hook(lambda _m, _a, out: rnd(out))
    return module


def round_bf16(t):
    """A tuple of tensors with its float tensors rounded to bfloat16."""
    return type(t)(*(x.to(torch.bfloat16).to(x.dtype)
                     if x.is_floating_point() else x for x in t))
