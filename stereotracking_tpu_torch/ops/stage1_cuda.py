"""Fused dual stage 1 (both branches + their average): CUDA kernel + plain.

Replaces the Pallas kernel ``stereotracking_tpu/ops/stage1_pallas.py``
(``stage1_dual_pallas`` / ``_stage1_kernel``, reached through
``pallas_stage1_out``).  For the RGB and the disparity branch it runs the
stage-1 chain — 3x3 stride-2 conv C -> O, main and short 1x1 O -> O/2, ONE
Darknet bottleneck, final 1x1 O -> O — with one bf16 rounding per ConvBNAct
(the rounding points of ``_act``, ``stage1_pallas.py:199``), then writes
``bf16((rgb + disp) / 2)``.  Only ``num_blocks == 1`` is supported, as in
the Pallas kernel.

Input: the two stems' (S, H, W, C) bf16 NHWC activations; output
(S, H/2, W/2, O) bf16 NHWC, one launch for the S streams.

``VARIANTS`` are the kernel's six template instantiations, region height
x width and GEMM inner loop: ``r16x16_wmma``, ``r8x16_wmma`` (wmma bf16
tensor cores, B fragments from device memory, ``csrc/csp_chain.cuh``),
``r16x16_fma``, ``r8x16_fma`` (scalar float32 FMAs of the same operands),
``r16x16_mma``, ``r8x16_mma`` (``mma.sync`` from swizzled shared memory,
weights through a ``cp.async`` ring, ``csrc/mma_chain.cuh``; built for C in
``MMA_WIDTHS``: 16, 24 and 32, YOLOX-nano's, -tiny's and the flagship's
YOLOX-s's).  ``PRODUCTION`` is the one the main path runs:
``r8x16_mma``, the fastest on an H100 80GB HBM3 at 700 W at 8 streams of
1080p (``chip_smoke.py``'s probe: 1.80 ms against 2.03 for ``r16x16_mma``,
8.36 and 10.68 for the two wmma regions, 42-44 for the FMA ones); its
two blocks per SM hide each other's per-slice barriers and weight copies,
which outweighs its larger halo recompute (1.52x against 1.31x).
``stage1_dual_variant`` launches any of them (the probe,
``tools/probe_stage1_variants.py``) and counts under ``stage1_variants``.
"""
from __future__ import annotations

import torch

from .. import _kernels
from typing import Optional

from .stage2_cuda import (StageKernel, chain_dims_problem, check_aligned,
                          check_chain_dims, check_stage_input,
                          flat_dims_problem, kernel_dims_problem, nhwc_plain)

VARIANTS = ('r16x16_wmma', 'r8x16_wmma', 'r16x16_fma', 'r8x16_fma',
            'r16x16_mma', 'r8x16_mma')
PRODUCTION = 'r8x16_mma'
MMA_WIDTHS = (16, 24, 32)   # C the mma.sync variants are built for
NUM_BLOCKS = 1          # bottlenecks the kernel runs, as the Pallas kernel


def blocks_problem(dims) -> Optional[str]:
    if dims[3] != NUM_BLOCKS:
        return (f'the stage-1 kernel supports num_blocks == {NUM_BLOCKS} '
                f'(deepen_factor <= 0.33), got {tuple(dims)}')
    return None


def dims_problem(dims) -> Optional[str]:
    """Why ``stage1_dual``'s kernel (``PRODUCTION``) cannot run a stage 1
    of dims (C_in, C_out, mid, num_blocks), or None."""
    return (blocks_problem(dims) or kernel_dims_problem(dims)
            or chain_dims_problem(dims, MMA_WIDTHS))


def _check(rgb, dsp, k_rgb: StageKernel, k_dsp: StageKernel):
    if k_rgb.dims != k_dsp.dims:
        raise ValueError(f'branch widths differ: {k_rgb.dims} vs '
                         f'{k_dsp.dims}')
    problem = blocks_problem(k_rgb.dims)
    if problem:
        raise ValueError(problem)
    check_stage_input('stage1_dual', rgb, k_rgb)
    if dsp.shape != rgb.shape or dsp.dtype != rgb.dtype:
        raise ValueError('both branch inputs must have one shape and dtype')


def stage1_dual_plain(rgb: torch.Tensor, dsp: torch.Tensor,
                      k_rgb: StageKernel, k_dsp: StageKernel
                      ) -> torch.Tensor:
    """Plain PyTorch version of the kernel (same bf16 rounding points)."""
    y = (nhwc_plain(rgb, k_rgb.wts) + nhwc_plain(dsp, k_dsp.wts)) * 0.5
    return y.to(torch.bfloat16).contiguous()


def _launch(rgb, dsp, k_rgb: StageKernel, k_dsp: StageKernel, variant: str,
            counter: str) -> torch.Tensor:
    cin, cout, mid, nb = k_rgb.dims
    k_rgb.check_kernel_dims(counter)
    if variant.endswith('_mma'):     # the packed slices of pack_slices
        check_chain_dims(f'{counter} {variant}', k_rgb, MMA_WIDTHS)
        check_aligned(f'{counter} {variant}', rgb, dsp)
        w_rgb, w_dsp = k_rgb.ws, k_dsp.ws
    else:                            # the flat layout of weight_ptrs
        problem = flat_dims_problem(k_rgb.dims)
        if problem:
            raise ValueError(f'{counter} {variant}: {problem}')
        w_rgb, w_dsp = k_rgb.w, k_dsp.w
    _kernels.require_cuda(counter, rgb, dsp, w_rgb, k_rgb.sb, w_dsp,
                          k_dsp.sb)
    n, h, w = rgb.shape[:3]
    out = torch.empty((n, h // 2, w // 2, cout), dtype=torch.bfloat16,
                      device=rgb.device)
    status = _kernels.library().st_stage1_dual(
        rgb.data_ptr(), dsp.data_ptr(), n, h, w, cin, cout, mid, nb,
        w_rgb.data_ptr(), k_rgb.sb.data_ptr(), w_dsp.data_ptr(),
        k_dsp.sb.data_ptr(), out.data_ptr(), VARIANTS.index(variant),
        _kernels.stream_ptr(rgb))
    _kernels.check(status, f'{counter} {variant}')
    _kernels.count_launch(counter)
    return out


def stage1_dual(rgb: torch.Tensor, dsp: torch.Tensor,
                k_rgb: StageKernel, k_dsp: StageKernel) -> torch.Tensor:
    """Fused dual stage 1: two (S, H, W, C) bf16 stems -> (S, H/2, W/2, O)
    bf16.

    CPU tensors run ``stage1_dual_plain``; CUDA tensors launch the kernel."""
    _check(rgb, dsp, k_rgb, k_dsp)
    if rgb.device.type == 'cpu':
        return stage1_dual_plain(rgb, dsp, k_rgb, k_dsp)
    return _launch(rgb, dsp, k_rgb, k_dsp, PRODUCTION, 'stage1')


def stage1_dual_variant(rgb: torch.Tensor, dsp: torch.Tensor,
                        k_rgb: StageKernel, k_dsp: StageKernel,
                        variant: str) -> torch.Tensor:
    """``stage1_dual`` through the kernel variant ``variant`` (one of
    ``VARIANTS``), on CUDA tensors only: the variants differ in how the
    card computes, so a CPU tensor has nothing to run."""
    if variant not in VARIANTS:
        raise ValueError(f'unknown variant {variant!r}; one of {VARIANTS}')
    _check(rgb, dsp, k_rgb, k_dsp)
    return _launch(rgb, dsp, k_rgb, k_dsp, variant, 'stage1_variants')
