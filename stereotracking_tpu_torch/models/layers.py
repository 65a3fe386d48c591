"""YOLOX building blocks as ``nn.Module``s (NCHW inside, mm key names).

Port of the canonical blocks of ``stereotracking_tpu/models/layers.py``:
``ConvBNAct`` (mmcv ConvModule: conv without bias + BatchNorm + SiLU),
``Focus``, ``DarknetBottleneck``, ``CSPLayer`` and ``SPPFBottleneck``.
Module and parameter names follow the mmdet/mmyolo modules, so a reference
``.pth`` state dict loads with ``load_state_dict``.

Every block takes a compute ``dtype``, float32 by default, as the Flax
modules do: the parameters and BatchNorm statistics stay float32 and the
compute runs in ``dtype``.  A ``ConvBNAct`` is built in eval mode, and
``.train()`` is the only way into train mode, which the trainer takes
(``train/train_state.py``): there BatchNorm normalises with the batch
statistics as Flax's ``nn.BatchNorm`` does (``batch_norm_train``), float32
only.  In eval mode and float32, BatchNorm is folded into a per-channel
(scale, bias) pair applied after the convolution, as the fused kernels
apply it.  In another dtype (bfloat16) a ``ConvBNAct``
rounds to ``dtype`` where Flax's ``ConvBNAct`` does (``conv_bn_act``): the
convolution of the cast input and kernel, BatchNorm computed in float32
from that output, and the SiLU, which torch rounds once where Flax rounds
after each of its four operations (tests/test_torch_port_dtype.py derives
the tolerance this needs).
"""
from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

BN_EPS = 0.001
BN_MOMENTUM = 0.03      # torch convention (flax 0.97)
BN_DECAY = 0.97         # flax convention: the running statistics' weight


def widen(channels: int, widen_factor: float, divisor: int = 8) -> int:
    """mmyolo.make_divisible: ceil(channels * widen_factor) to /8."""
    return math.ceil(channels * widen_factor / divisor) * divisor


def make_round(x: float, deepen_factor: float) -> int:
    """mmyolo.make_round."""
    return max(round(x * deepen_factor), 1) if x > 1 else int(x)


def fold_bn(bn: nn.BatchNorm2d) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inference BatchNorm as y = x * scale + bias (float32)."""
    inv = bn.weight / torch.sqrt(bn.running_var + bn.eps)
    return inv, bn.bias - bn.running_mean * inv


def compute_weight(conv: nn.Conv2d, dtype: torch.dtype) -> torch.Tensor:
    """``conv``'s weight in ``dtype``, channels-last (the layout cuDNN's
    bf16 convolutions take), cast again only when the weight changed."""
    w = conv.weight
    key = (w.data_ptr(), w._version, dtype)
    cached = conv.__dict__.get('_compute_weight')
    if cached is None or cached[0] != key:
        cached = (key, w.detach().to(dtype).contiguous(
            memory_format=torch.channels_last))
        conv.__dict__['_compute_weight'] = cached
    return cached[1]


def conv_bn_act(conv: nn.Conv2d, bn: nn.BatchNorm2d, x: torch.Tensor,
                dtype: torch.dtype) -> torch.Tensor:
    """Conv + BatchNorm + SiLU in a compute dtype other than float32, each
    rounded to ``dtype``: the convolution's output, BatchNorm ``(y - mean)
    * rsqrt(var + eps) * scale + bias`` evaluated in float32, and the SiLU
    (cuDNN runs the convolution channels-last)."""
    y = F.conv2d(x.to(dtype), compute_weight(conv, dtype), None, conv.stride,
                 conv.padding)
    y = F.batch_norm(y, bn.running_mean, bn.running_var, bn.weight, bn.bias,
                     False, 0.0, bn.eps)
    return F.silu(y)


def batch_norm_train(bn: nn.BatchNorm2d, y: torch.Tensor) -> torch.Tensor:
    """Flax ``nn.BatchNorm(use_running_average=False)`` on an NCHW float32
    ``y``: the mean over N, H and W, the variance as ``max(0, E[y^2] -
    E[y]^2)`` (``use_fast_variance``), ``(y - mean) * (rsqrt(var + eps) *
    scale) + bias`` with the gradient through both statistics; then the
    running statistics become ``0.97 * old + 0.03 * batch``, with the
    biased variance (torch's own BatchNorm keeps the unbiased one)."""
    mean = y.mean((0, 2, 3))
    var = torch.maximum((y * y).mean((0, 2, 3)) - mean * mean,
                        mean.new_zeros(()))
    with torch.no_grad():
        for run, stat in ((bn.running_mean, mean), (bn.running_var, var)):
            run.copy_(BN_DECAY * run + (1 - BN_DECAY) * stat)
    mul = torch.rsqrt(var + bn.eps) * bn.weight
    return (y - mean[:, None, None]) * mul[:, None, None] + \
        bn.bias[:, None, None]


def conv_bias(conv: nn.Conv2d, x: torch.Tensor,
              dtype: torch.dtype) -> torch.Tensor:
    """A plain biased conv in ``dtype``: as Flax's ``nn.Conv``, the bias is
    added to the rounded convolution in ``dtype``."""
    if dtype == torch.float32:
        return conv(x)
    y = F.conv2d(x.to(dtype), compute_weight(conv, dtype), None, conv.stride,
                 conv.padding)
    return y + conv.bias.to(dtype)[:, None, None]


class ConvBNAct(nn.Module):
    """Conv2d (no bias) + BatchNorm + SiLU (mmcv ConvModule), computed in
    ``dtype``; built in eval mode."""

    def __init__(self, cin: int, cout: int, k: int = 1, stride: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, k, stride, k // 2, bias=False)
        self.bn = nn.BatchNorm2d(cout, eps=BN_EPS, momentum=BN_MOMENTUM)
        self.dtype = dtype
        self.eval()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            if self.dtype != torch.float32:
                raise ValueError(f'train mode computes in float32 only, not '
                                 f'{self.dtype}')
            return F.silu(batch_norm_train(self.bn, self.conv(x)))
        if self.dtype != torch.float32:
            return conv_bn_act(self.conv, self.bn, x, self.dtype)
        scale, bias = fold_bn(self.bn)
        y = self.conv(x) * scale[:, None, None] + bias[:, None, None]
        return F.silu(y)

    def hwio(self) -> torch.Tensor:
        """Conv kernel in HWIO (the JAX package's layout)."""
        return self.conv.weight.permute(2, 3, 1, 0)


def focus_kernel_to_strided(w: torch.Tensor) -> torch.Tensor:
    """Focus kernel (k, k, 4C, O) HWIO -> the equivalent (2k, 2k, C, O)
    stride-2 kernel on the raw image (slice index s = dx*2 + dy; tap
    (ky, kx) of slice s reads raw (2ky + dy, 2kx + dx))."""
    k, _, c4, o = w.shape
    c = c4 // 4
    w = w.reshape(k, k, 2, 2, c, o)        # (ky, kx, dx, dy, c, o)
    w = w.permute(0, 3, 1, 2, 4, 5)        # (ky, dy, kx, dx, c, o)
    return w.reshape(2 * k, 2 * k, c, o)


class Focus(nn.Module):
    """2x2 pixel-unshuffle (tl, bl, tr, br) then a 3x3 ConvBNAct."""

    def __init__(self, cin: int, cout: int, k: int = 3,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv = ConvBNAct(4 * cin, cout, k, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        tl = x[..., ::2, ::2]
        bl = x[..., 1::2, ::2]
        tr = x[..., ::2, 1::2]
        br = x[..., 1::2, 1::2]
        return self.conv(torch.cat((tl, bl, tr, br), dim=1))

    def strided_kernel(self) -> torch.Tensor:
        """(6, 6, C, O) kernel of the stem as one stride-2 conv on the raw
        image, padded 2 before and 3 after."""
        return focus_kernel_to_strided(self.conv.hwio())


class DarknetBottleneck(nn.Module):
    """1x1 -> 3x3 with optional residual (expansion 1.0)."""

    def __init__(self, c: int, add_identity: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv1 = ConvBNAct(c, c, 1, dtype=dtype)
        self.conv2 = ConvBNAct(c, c, 3, dtype=dtype)
        self.add_identity = add_identity

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.conv2(self.conv1(x))
        return out + x if self.add_identity else out


class CSPLayer(nn.Module):
    """Cross-stage-partial block (expand_ratio 0.5)."""

    def __init__(self, cin: int, cout: int, num_blocks: int = 1,
                 add_identity: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        mid = cout // 2
        self.main_conv = ConvBNAct(cin, mid, 1, dtype=dtype)
        self.short_conv = ConvBNAct(cin, mid, 1, dtype=dtype)
        self.blocks = nn.Sequential(*[
            DarknetBottleneck(mid, add_identity, dtype=dtype)
            for _ in range(num_blocks)])
        self.final_conv = ConvBNAct(2 * mid, cout, 1, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        main = self.blocks(self.main_conv(x))
        return self.final_conv(torch.cat((main, self.short_conv(x)), dim=1))


class SPPFBottleneck(nn.Module):
    """Parallel max-pool spatial pyramid (mmyolo SPPFBottleneck with tuple
    kernel sizes)."""

    def __init__(self, cin: int, cout: int,
                 kernel_sizes: Sequence[int] = (5, 9, 13),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        mid = cin // 2
        self.conv1 = ConvBNAct(cin, mid, 1, dtype=dtype)
        self.kernel_sizes = tuple(kernel_sizes)
        self.conv2 = ConvBNAct(mid * (len(self.kernel_sizes) + 1), cout, 1,
                               dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv1(x)
        pools = [F.max_pool2d(x, k, 1, k // 2) for k in self.kernel_sizes]
        return self.conv2(torch.cat([x] + pools, dim=1))
