"""Fused dual stage 1 (both branches + their average): CUDA kernel + plain.

Replaces the Pallas kernel ``stereotracking_tpu/ops/stage1_pallas.py``
(``stage1_dual_pallas`` / ``_stage1_kernel``, reached through
``pallas_stage1_out``).  For the RGB and the disparity branch it runs the
stage-1 chain — 3x3 stride-2 conv C -> O, main and short 1x1 O -> O/2, ONE
Darknet bottleneck, final 1x1 O -> O — with one bf16 rounding per ConvBNAct
(the rounding points of ``_act``, ``stage1_pallas.py:199``), then writes
``bf16((rgb + disp) / 2)``.  Only ``num_blocks == 1`` is supported, as in
the Pallas kernel.

Input: the two stems' (H, W, C) bf16 NHWC activations; output
(H/2, W/2, O) bf16 NHWC.
"""
from __future__ import annotations

import torch

from .. import _kernels
from .stage2_cuda import StageWeights, check_stage_input, csp_chain_plain


def _check(rgb, dsp, w_rgb: StageWeights, w_dsp: StageWeights):
    if w_rgb.dims != w_dsp.dims:
        raise ValueError(f'branch widths differ: {w_rgb.dims} vs '
                         f'{w_dsp.dims}')
    if w_rgb.dims[3] != 1:
        raise ValueError('the stage-1 kernel supports num_blocks == 1 '
                         '(deepen_factor <= 0.33)')
    check_stage_input('stage1_dual', rgb, w_rgb)
    if dsp.shape != rgb.shape or dsp.dtype != rgb.dtype:
        raise ValueError('both branch inputs must have one shape and dtype')


def stage1_dual_plain(rgb: torch.Tensor, dsp: torch.Tensor,
                      w_rgb: StageWeights, w_dsp: StageWeights
                      ) -> torch.Tensor:
    """Plain PyTorch version of the kernel (same bf16 rounding points)."""
    fr = csp_chain_plain(rgb.float().permute(2, 0, 1)[None], w_rgb)
    fd = csp_chain_plain(dsp.float().permute(2, 0, 1)[None], w_dsp)
    y = ((fr + fd) * 0.5).to(torch.bfloat16)
    return y[0].permute(1, 2, 0).contiguous()


def stage1_dual(rgb: torch.Tensor, dsp: torch.Tensor,
                w_rgb: StageWeights, w_dsp: StageWeights) -> torch.Tensor:
    """Fused dual stage 1: two (H, W, C) bf16 stems -> (H/2, W/2, O) bf16.

    CPU tensors run ``stage1_dual_plain``; CUDA tensors launch the kernel."""
    _check(rgb, dsp, w_rgb, w_dsp)
    if rgb.device.type == 'cpu':
        return stage1_dual_plain(rgb, dsp, w_rgb, w_dsp)
    cin, cout, mid, nb = w_rgb.dims
    w_rgb.check_kernel_dims('stage1_dual')
    (wr, sr), (wd, sd) = w_rgb.kernel_buffers(), w_dsp.kernel_buffers()
    _kernels.require_cuda('stage1_dual', rgb, dsp, wr, sr, wd, sd)
    h, w = rgb.shape[:2]
    out = torch.empty((h // 2, w // 2, cout), dtype=torch.bfloat16,
                      device=rgb.device)
    status = _kernels.library().st_stage1_dual(
        rgb.data_ptr(), dsp.data_ptr(), h, w, cin, cout, mid, nb,
        wr.data_ptr(), sr.data_ptr(), wd.data_ptr(), sd.data_ptr(),
        out.data_ptr(), _kernels.stream_ptr(rgb))
    _kernels.check(status, 'stage1_dual')
    _kernels.count_launch('stage1')
    return out
