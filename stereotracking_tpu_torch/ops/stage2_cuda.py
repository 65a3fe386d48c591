"""Fused backbone stage (entry conv + CSP chain): CUDA kernel + plain version.

Replaces the Pallas kernel ``stereotracking_tpu/ops/stage2_pallas.py``
(``stage2_fold_pallas`` / ``_stage2_kernel``, reached through
``pallas_stage2_out``).  It computes one CSPDarknet stage: a 3x3 stride-2
entry conv C_in -> C_out; main and short 1x1 convs C_out -> C_out/2;
``num_blocks`` Darknet bottlenecks (1x1 and 3x3, plus the residual); the
final 1x1 on [blocks | short].  Each ConvBNAct accumulates in float32,
applies folded BatchNorm and SiLU in float32 and rounds to bfloat16 once;
the residual sum rounds to bfloat16 as well.

The stage-2 kernel (``csrc/stage2.cu``) is built for YOLOX's stage-2
shape, C_in = mid = C_out / 2, at C_in 32 or 64 (the flagship's stage 2 is
(64, 128, 3 blocks)); it reads the weights as 64 x 64 slices in its run
order (``pack_slices``).  Stage 1 and stage 3 (128, 256, 3) run their own
kernels (``ops/stage1_cuda.py``, ``ops/stage3_cuda.py``) on the same
slices (``slice_offsets`` says where each GEMM starts); the stage-1
probe's wmma and FMA variants read the flat layout of ``pack_stage``.
Input and output are canonical NHWC bf16 with a leading stream axis, one
launch for all S streams: (S, H, W, C_in) -> (S, H/2, W/2, C_out).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn

from .. import _kernels
from ..models.layers import ConvBNAct, CSPLayer, fold_bn


class StageWeights(NamedTuple):
    """One stage's weights for the fused kernel: conv kernels in HWIO /
    (in, out) layout holding bf16 values, folded BN as [scale; bias] f32."""
    entry_w: torch.Tensor    # (3, 3, C_in, C_out)
    entry_sb: torch.Tensor   # (2, C_out)
    ms_w: torch.Tensor       # (C_out, 2m)     [main | short]
    ms_sb: torch.Tensor      # (2, 2m)
    c1_w: torch.Tensor       # (nb, m, m)
    c1_sb: torch.Tensor      # (nb, 2, m)
    c2_w: torch.Tensor       # (nb, 3, 3, m, m)
    c2_sb: torch.Tensor      # (nb, 2, m)
    fin_w: torch.Tensor      # (2m, C_out)     rows [blocks | short]
    fin_sb: torch.Tensor     # (2, C_out)

    @property
    def dims(self):
        """(C_in, C_out, mid, num_blocks)."""
        return (self.entry_w.shape[2], self.entry_w.shape[3],
                self.c1_w.shape[1], self.c1_w.shape[0])


class StageKernel(NamedTuple):
    """A stage's weights as both versions take them: ``wts`` for the plain
    version, and the same values packed once into the buffers the CUDA
    kernels read (``CSPDarknetDual.kernel_weights`` rebuilds them only when
    a parameter changes)."""
    wts: StageWeights
    w: torch.Tensor          # bf16, the fields in weight_ptrs order
    sb: torch.Tensor         # float32 [scale; bias] blocks, same order
    ws: torch.Tensor         # bf16 slices in the stage-2 kernel's order

    @property
    def dims(self):
        return self.wts.dims

    def check_kernel_dims(self, name: str):
        problem = kernel_dims_problem(self.dims)
        if problem:
            raise ValueError(f'{name}: {problem}')


SLICE = 64   # a weight slice of the stage-2 kernel: SLICE k x SLICE n
STAGE_CSP_WIDTHS = (32, 64)   # C_in the stage-2 kernel is built for
MAX_BLOCKS = 7                # bottlenecks a stage kernel runs


def kernel_dims_problem(dims) -> Optional[str]:
    """What the stage kernels need that stage dims (C_in, C_out, mid,
    num_blocks) lack, or None: channel counts that are multiples of 16 and
    1 to MAX_BLOCKS blocks."""
    if any(c % 16 for c in dims[:3]) or not 1 <= dims[3] <= MAX_BLOCKS:
        return (f'the kernel needs channel counts that are multiples of 16 '
                f'and 1-{MAX_BLOCKS} blocks, got {tuple(dims)}')
    return None


def chain_dims_problem(dims, widths) -> Optional[str]:
    """What the mma_chain.cuh kernels built for C_in in ``widths`` need
    that stage dims lack, or None: C_in = mid = C_out / 2 in ``widths``."""
    cin, cout, mid, _ = dims
    if cin not in widths or mid != cin or cout != 2 * cin:
        return (f'the kernel is built for C_in = mid = C_out / 2 in '
                f'{tuple(widths)}, got {tuple(dims)}')
    return None


def stage_csp_dims_problem(dims) -> Optional[str]:
    """Why ``stage_csp``'s kernel cannot run a stage of ``dims``, or
    None."""
    return (kernel_dims_problem(dims)
            or chain_dims_problem(dims, STAGE_CSP_WIDTHS))


def gemm_shapes(dims):
    """(K, N) of the chain's GEMMs for stage dims (C_in, C_out, mid,
    num_blocks), in the order the kernels run them: entry, main|short, per
    block conv1 then conv2, final."""
    cin, cout, mid, nb = dims
    return ([(9 * cin, cout), (cout, 2 * mid)]
            + [(mid, mid), (9 * mid, mid)] * nb + [(2 * mid, cout)])


def _gemm_mats(wts: StageWeights):
    """The chain's GEMM weights as (K, N) matrices, in ``gemm_shapes``
    order."""
    cin, cout, mid, nb = wts.dims
    mats = [wts.entry_w.reshape(9 * cin, cout), wts.ms_w]
    for b in range(nb):
        mats += [wts.c1_w[b], wts.c2_w[b].reshape(9 * mid, mid)]
    return mats + [wts.fin_w]


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def slice_offsets(dims) -> list:
    """Index of each GEMM's first slice in the ``pack_slices`` stream, in
    ``gemm_shapes`` order, then the stream's length: the counts of
    ``entry_slices`` and ``chain_slices`` in csrc/mma_chain.cuh.  Entry
    ``CHAIN_GEMM`` (the first bottleneck's conv1) is where the chain part,
    stage 3's second launch, starts."""
    offs = [0]
    for k, n in gemm_shapes(dims):
        offs.append(offs[-1] + _cdiv(k, SLICE) * _cdiv(n, SLICE))
    return offs


CHAIN_GEMM = 2      # gemm_shapes index of the chain part's first GEMM


def pack_slices(wts: StageWeights) -> torch.Tensor:
    """(slices, SLICE, SLICE) bf16: each GEMM's (K, N) matrix zero-padded
    to multiples of SLICE and cut into tiles, N passes outer, K slices
    inner, GEMMs in run order: the stream the stage-2 kernel copies into
    its shared-memory ring (csrc/mma_chain.cuh)."""
    tiles = []
    for m in _gemm_mats(wts):
        k, n = m.shape
        kp, np_ = _cdiv(k, SLICE), _cdiv(n, SLICE)
        m = F.pad(m, (0, np_ * SLICE - n, 0, kp * SLICE - k))
        tiles.append(m.reshape(kp, SLICE, np_, SLICE).permute(2, 0, 1, 3)
                     .reshape(-1, SLICE, SLICE))
    return torch.cat(tiles).to(torch.bfloat16).contiguous()


def pack_stage(wts: StageWeights) -> StageKernel:
    """The fields in the order the kernels' ``weight_ptrs``
    (csrc/csp_chain.cuh) reads them: bf16 weights, float32 scale/bias; and
    the weights once more as the stage-2 kernel's slices."""
    w = torch.cat([t.reshape(-1) for t in (
        wts.entry_w, wts.ms_w, wts.c1_w, wts.c2_w, wts.fin_w)])
    sb = torch.cat([t.reshape(-1) for t in (
        wts.entry_sb, wts.ms_sb, wts.c1_sb, wts.c2_sb, wts.fin_sb)])
    return StageKernel(wts, w.to(torch.bfloat16).contiguous(),
                       sb.contiguous(), pack_slices(wts))


def _bf16(w: torch.Tensor) -> torch.Tensor:
    return w.float().to(torch.bfloat16).float()


def _sb(m: ConvBNAct) -> torch.Tensor:
    return torch.stack(fold_bn(m.bn)).float()


def _w1x1(m: ConvBNAct) -> torch.Tensor:
    return _bf16(m.conv.weight[:, :, 0, 0].t())      # (in, out)


def stage_weights(stage: nn.Sequential) -> StageKernel:
    """Kernel weights of a stage ``Sequential(ConvBNAct, CSPLayer)``."""
    conv, csp = stage[0], stage[-1]
    if not (isinstance(conv, ConvBNAct) and isinstance(csp, CSPLayer)
            and len(stage) == 2):
        raise ValueError('the fused stage kernel takes conv + CSP stages '
                         '(no SPP)')
    blocks = list(csp.blocks)
    if not blocks or not all(b.add_identity for b in blocks):
        raise ValueError('the fused stage kernel needs >= 1 residual block')
    return pack_stage(StageWeights(
        entry_w=_bf16(conv.hwio()), entry_sb=_sb(conv),
        ms_w=torch.cat([_w1x1(csp.main_conv), _w1x1(csp.short_conv)], 1),
        ms_sb=torch.cat([_sb(csp.main_conv), _sb(csp.short_conv)], 1),
        c1_w=torch.stack([_w1x1(b.conv1) for b in blocks]),
        c1_sb=torch.stack([_sb(b.conv1) for b in blocks]),
        c2_w=torch.stack([_bf16(b.conv2.hwio()) for b in blocks]),
        c2_sb=torch.stack([_sb(b.conv2) for b in blocks]),
        fin_w=_w1x1(csp.final_conv), fin_sb=_sb(csp.final_conv)))


def _act(acc: torch.Tensor, sb: torch.Tensor) -> torch.Tensor:
    """ConvBNAct tail on NCHW f32: folded BN, SiLU, one bf16 rounding."""
    y = acc * sb[0][:, None, None] + sb[1][:, None, None]
    return (y * torch.sigmoid(y)).to(torch.bfloat16).float()


def _conv(x, w_hwio, stride=1):
    k = w_hwio.shape[0]
    return F.conv2d(x, w_hwio.permute(3, 2, 0, 1), stride=stride,
                    padding=k // 2)


def csp_chain_plain(x: torch.Tensor, wts: StageWeights) -> torch.Tensor:
    """Plain PyTorch version of the stage on (S, C_in, H, W) bf16-valued
    float32 -> (S, C_out, H/2, W/2) bf16-valued float32."""
    mid = wts.dims[2]
    z = _act(_conv(x, wts.entry_w, 2), wts.entry_sb)
    ms = _act(_conv(z, wts.ms_w[None, None]), wts.ms_sb)
    m, short = ms[:, :mid], ms[:, mid:]
    for i in range(wts.c1_w.shape[0]):
        c1 = _act(_conv(m, wts.c1_w[i][None, None]), wts.c1_sb[i])
        c2 = _act(_conv(c1, wts.c2_w[i]), wts.c2_sb[i])
        m = (c2 + m).to(torch.bfloat16).float()
    return _act(_conv(torch.cat([m, short], 1), wts.fin_w[None, None]),
                wts.fin_sb)


def check_stage_input(name: str, x: torch.Tensor, k: StageKernel):
    cin = k.dims[0]
    if x.dim() != 4 or x.shape[3] != cin or x.dtype != torch.bfloat16:
        raise ValueError(f'{name}: input must be (S, H, W, {cin}) bfloat16, '
                         f'got {tuple(x.shape)} {x.dtype}')
    if x.shape[1] % 2 or x.shape[2] % 2:
        raise ValueError(f'{name}: input H and W must be even, got '
                         f'{tuple(x.shape)}')


def nhwc_plain(x: torch.Tensor, wts: StageWeights) -> torch.Tensor:
    """``csp_chain_plain`` on (S, H, W, C) bf16 -> (S, H/2, W/2, C_out)
    bf16-valued float32."""
    return csp_chain_plain(x.float().permute(0, 3, 1, 2), wts).permute(
        0, 2, 3, 1)


def stage_csp_plain(x: torch.Tensor, k: StageKernel) -> torch.Tensor:
    return nhwc_plain(x, k.wts).to(torch.bfloat16).contiguous()


def check_chain_dims(name: str, k: StageKernel, widths) -> None:
    """Raise unless the stage is C_in = mid = C_out / 2 with C_in in
    ``widths``, the shape the mma_chain.cuh kernels are built for."""
    problem = chain_dims_problem(k.dims, widths)
    if problem:
        raise ValueError(f'{name}: {problem}')


def check_aligned(name: str, *xs: torch.Tensor) -> None:
    for x in xs:
        if x.data_ptr() % 16:
            raise ValueError(f'{name}: inputs must start on a 16-byte '
                             f'boundary (the kernel copies 16-byte chunks)')


def launch_stage(entry: str, counter: str, x: torch.Tensor, k: StageKernel,
                 *scratch: torch.Tensor, ints=()) -> torch.Tensor:
    """Launch the stage kernel ``entry`` of the library on (S, H, W, C_in)
    CUDA ``x``, its weights the packed slices ``k.ws`` (``ints``: integer
    arguments it takes after the scale/bias buffer; ``scratch``: extra
    device buffers it takes before the output), and add one to the launch
    count ``counter``."""
    cin, cout, mid, nb = k.dims
    k.check_kernel_dims(counter)
    _kernels.require_cuda(counter, x, k.ws, k.sb, *scratch)
    n, h, wd = x.shape[:3]
    out = torch.empty((n, h // 2, wd // 2, cout), dtype=torch.bfloat16,
                      device=x.device)
    status = getattr(_kernels.library(), entry)(
        x.data_ptr(), n, h, wd, cin, cout, mid, nb, k.ws.data_ptr(),
        k.sb.data_ptr(), *ints, *(t.data_ptr() for t in scratch),
        out.data_ptr(), _kernels.stream_ptr(x))
    _kernels.check(status, counter)
    _kernels.count_launch(counter)
    return out


def stage_csp(x: torch.Tensor, k: StageKernel) -> torch.Tensor:
    """(S, H, W, C_in) bf16 -> (S, H/2, W/2, C_out) bf16 through the fused
    stage, one launch for the S streams.

    CPU tensors run ``stage_csp_plain``; CUDA tensors launch the kernel."""
    check_stage_input('stage_csp', x, k)
    if x.device.type == 'cpu':
        return stage_csp_plain(x, k)
    check_chain_dims('stage_csp', k, STAGE_CSP_WIDTHS)
    check_aligned('stage_csp', x)
    return launch_stage('st_stage_csp', 'stage2', x, k)
