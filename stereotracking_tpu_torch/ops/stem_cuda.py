"""Focus stem with the frame preprocess fused in: CUDA kernel + plain version.

Replaces the Pallas kernel ``stereotracking_tpu/ops/stem_pallas.py``
(``focus_stem_pallas`` / ``_stem_kernel``, reached through
``pallas_stem_outputs``).  It computes the Focus stem as one 6x6 stride-2
convolution on the padded frame (padding 2 before, 3 after;
``layers.focus_kernel_to_strided``), then folded BatchNorm and SiLU in
float32 and one bfloat16 rounding.

The kernel reads S RAW frames in one launch: uint8 BGR (S, H, W, 3), or
uint16 fixed-point disparity (S, H, W) with 65535 = invalid.  The
preprocess is fused into its load: cast, 65535 -> 0, /16, zero padding to
the padded size and to the convolution's border.  The disparity value ``disp/16`` is rounded to
bfloat16 before the product, as both JAX paths do, and the disparity branch
runs the kernel summed over its three (identical) input channels.

The kernel multiplies on bf16 tensor cores: its weights are the
``stem_matrix`` (K, O) bf16, K = the 36 C taps in (uy, ux, c) order padded
to a multiple of 16, packed once per weight version
(``CSPDarknetDual.kernel_weights``).

Output: (S, out_h/2, out_w/2, O) bfloat16, NHWC.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from .. import _kernels
from ..models.layers import Focus, fold_bn

STEM_WIDTHS = (8, 16, 32, 64)    # output channels the kernel is built for


def dims_problem(o: int) -> Optional[str]:
    """Why the kernel cannot run a stem of ``o`` output channels, or
    None."""
    if o not in STEM_WIDTHS:
        return f'the kernel is built for O in {STEM_WIDTHS}, got O = {o}'
    return None


def stem_k(c: int) -> int:
    """Rows of the kernel's weight matrix for C input channels: 36 C
    zero-padded to a multiple of 16 (108 -> 112, 36 -> 48)."""
    return (36 * c + 15) // 16 * 16


def stem_matrix(w6: torch.Tensor) -> torch.Tensor:
    """(6, 6, C, O) bf16-valued kernel -> the (K, O) bf16 matrix the kernel
    multiplies, K in (uy, ux, c) order, rows past 36 C zero."""
    c, o = w6.shape[2:]
    wk = w6.reshape(36 * c, o).to(torch.bfloat16)
    return F.pad(wk, (0, 0, 0, stem_k(c) - 36 * c)).contiguous()


def stem_hwio(wk: torch.Tensor, c: int) -> torch.Tensor:
    """The (6, 6, C, O) float32 kernel of a ``stem_matrix``."""
    return wk[:36 * c].float().reshape(6, 6, c, wk.shape[1])


def stem_weights(stem: Focus, sum_channels: bool
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The (K, O) bf16 ``stem_matrix`` and (2, O) float32 [scale; bias].

    ``sum_channels``: the disparity branch's kernel summed over its three
    input channels (float32 sum, then the bf16 rounding)."""
    w6 = stem.strided_kernel().float()
    if sum_channels:
        w6 = w6.sum(dim=2, keepdim=True)
    scale, bias = fold_bn(stem.conv.bn)
    return stem_matrix(w6), torch.stack([scale, bias]).float().contiguous()


def stem_input(frame: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Preprocessed (S, C, out_h, out_w) float32 stem input, the disparity
    rounded to bf16 after /16."""
    h, w = frame.shape[1:3]
    if frame.dtype == torch.uint8:
        x = frame.to(torch.float32).permute(0, 3, 1, 2)
    else:
        d = frame.to(torch.int32)
        d = torch.where(d == 65535, 0, d).to(torch.float32) / 16.0
        x = d.to(torch.bfloat16).to(torch.float32)[:, None]
    return F.pad(x, (0, out_w - w, 0, out_h - h))


def focus_stem_plain(frame: torch.Tensor, wk: torch.Tensor,
                     sb: torch.Tensor, out_h: int, out_w: int
                     ) -> torch.Tensor:
    """Plain PyTorch version of the kernel (same bf16 rounding points)."""
    x = F.pad(stem_input(frame, out_h, out_w), (2, 3, 2, 3))
    w6 = stem_hwio(wk, x.shape[1])
    acc = F.conv2d(x, w6.permute(3, 2, 0, 1), stride=2)
    y = acc * sb[0][:, None, None] + sb[1][:, None, None]
    y = y * torch.sigmoid(y)
    return y.to(torch.bfloat16).permute(0, 2, 3, 1).contiguous()


def focus_stem(frame: torch.Tensor, wk: torch.Tensor, sb: torch.Tensor,
               out_h: int, out_w: int) -> torch.Tensor:
    """Stem activations (S, out_h/2, out_w/2, O) bf16 from S raw frames;
    ``wk``, ``sb`` as ``stem_weights`` makes them.

    CPU tensors run ``focus_stem_plain``; CUDA tensors launch the kernel."""
    is_disp = frame.dtype != torch.uint8
    c = 1 if is_disp else 3
    if is_disp and (frame.dtype != torch.uint16 or frame.dim() != 3):
        raise ValueError(f'disparity must be (S, H, W) uint16, got '
                         f'{tuple(frame.shape)} {frame.dtype}')
    if not is_disp and (frame.dim() != 4 or frame.shape[3] != 3):
        raise ValueError(f'image must be (S, H, W, 3) uint8, got '
                         f'{tuple(frame.shape)}')
    n, h, w = frame.shape[:3]
    o = wk.shape[-1]
    if (wk.dim() != 2 or wk.shape[0] != stem_k(c)
            or wk.dtype != torch.bfloat16):
        raise ValueError(f'stem weights must be ({stem_k(c)}, O) bfloat16, '
                         f'got {tuple(wk.shape)} {wk.dtype}')
    if tuple(sb.shape) != (2, o) or sb.dtype != torch.float32:
        raise ValueError(f'stem scale/bias must be (2, {o}) float32')
    if out_h % 2 or out_w % 2 or out_h < h or out_w < w:
        raise ValueError(f'bad padded shape {(out_h, out_w)} for {(h, w)}')
    if frame.device.type == 'cpu':
        return focus_stem_plain(frame, wk, sb, out_h, out_w)
    problem = dims_problem(o)
    if problem:
        raise ValueError(f'focus_stem: {problem}')
    _kernels.require_cuda('focus_stem', frame, wk, sb)
    out = torch.empty((n, out_h // 2, out_w // 2, o),
                      dtype=torch.bfloat16, device=frame.device)
    lib = _kernels.library()
    status = lib.st_focus_stem(frame.data_ptr(), int(is_disp), n, h, w,
                               out_h, out_w, o, wk.data_ptr(), sb.data_ptr(),
                               out.data_ptr(), _kernels.stream_ptr(frame))
    _kernels.check(status, 'focus_stem')
    _kernels.count_launch('stem')
    return out
