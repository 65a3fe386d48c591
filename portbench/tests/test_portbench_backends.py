"""The stage backends that the port resolves on a card decide which bounds
the stage roofline sums and in which precision the control computes each
layer; the trace files only the port's own stage kernels as stage
kernels."""
from __future__ import annotations

import copy
import json
import re

import pytest
import torch

from conftest import REPO
from portbench import flops, harness, tracelib
from portbench.reference import lower
from portbench.reference import model as md

BENCH = REPO / 'BENCHMARK.json'
BF16_CELLS = ('airdrone_s.16x720p.bf16', 'kitti_s.8x386x1280.bf16')
F32_CELL = 'airdrone_s.8x720p.f32'
STAGES = ('stem', 'stage1', 'stage2', 'stage3')


def _model(workload: str) -> dict:
    return harness.load_cell(BENCH, workload).config['model']


def yolox_x_dual() -> dict:
    """The flagship's model dict at YOLOX-X's published widths (widen
    1.25, deepen 1.33) with the config's own 'auto' backends."""
    m = copy.deepcopy(_model(BF16_CELLS[0]))
    det = m['detector']
    for part in (det['backbone'], det['neck']):
        part.update(widen_factor=1.25, deepen_factor=1.33)
    det['bbox_head']['head_module']['widen_factor'] = 1.25
    m.update({f'{s}_backend': 'auto' for s in STAGES})
    return m


@pytest.mark.parametrize('workload', BF16_CELLS)
def test_stage_bound_unchanged_where_every_stage_is_a_kernel(workload):
    cell = harness.load_cell(BENCH, workload)
    backends = harness.stage_backends(cell.config['model'])
    assert backends == dict.fromkeys(STAGES, 'cuda')
    det = md.detector_config(cell.config['model'])._asdict()
    h, w, oh, ow, _ = harness.shapes(cell)
    n = int(cell.traffic['streams'])
    every = n * sum(flops.bound_s(*x) for x in flops.stage_kernel_work(
        det, h, w, oh, ow).values())
    assert n * harness.kernel_bound_s(det, h, w, oh, ow, backends) == every


def test_yolox_x_bounds_its_two_stems_alone():
    m = yolox_x_dual()
    with pytest.warns(UserWarning, match='float32 modules'):
        backends = harness.stage_backends(m)
    assert backends == dict(stem='cuda', stage1='torch', stage2='torch',
                            stage3='torch')
    det = md.detector_config(m)._asdict()
    work = flops.stage_kernel_work(det, 720, 1280, 736, 1280)
    stems = flops.bound_s(*work['stem']) + flops.bound_s(*work['disp_stem'])
    got = harness.kernel_bound_s(det, 720, 1280, 736, 1280, backends)
    assert got == stems
    # the stages on the modules would have made it ~10x too large
    assert sum(flops.bound_s(*x) for x in work.values()) > 9 * got


def test_f32_cell_runs_stem_and_stages_1_2_as_kernels():
    assert harness.stage_backends(_model(F32_CELL)) == dict(
        stem='cuda', stage1='cuda', stage2='cuda', stage3='torch')


def _fp8_like(t: torch.Tensor) -> bool:
    return t.unique().numel() <= 256


def _tf32_like(t: torch.Tensor) -> bool:
    return bool(((t.float().contiguous().view(torch.int32) & 0x1FFF)
                 == 0).all())


def test_f32_control_lowers_kernel_layers_to_fp8_and_the_rest_to_tf32():
    m = _model(F32_CELL)
    backends = harness.stage_backends(m)
    torch.manual_seed(0)
    det = md.YOLOXDetector(md.detector_config(m))
    lower.lower_detector(det, 'float32', backends)
    kernel = ('backbone.stem.', 'backbone.disp_stem.', 'backbone.stage1.',
              'backbone.disp_stage1.', 'backbone.stage2.')
    seen = {True: 0, False: 0}
    x = torch.randn(1, 64, 9, 9)
    for name, mod in det.named_modules():
        inside = name.startswith(kernel)
        if isinstance(mod, torch.nn.Conv2d):
            seen[inside] += 1
            pre = next(iter(mod._forward_pre_hooks.values()))
            xin = pre(mod, (x[:, :mod.in_channels],))[0]
            if inside:
                assert _fp8_like(mod.weight) and _fp8_like(xin), name
                assert mod._forward_hooks, name
            else:
                assert _tf32_like(mod.weight) and _tf32_like(xin), name
                assert not _fp8_like(xin), name
        if isinstance(mod, (torch.nn.Conv2d, md.ConvBNAct)):
            assert bool(mod._forward_hooks) == inside, name
    assert seen[True] and seen[False]


def _bf16_like(t: torch.Tensor) -> bool:
    return bool(((t.float().contiguous().view(torch.int32) & 0xFFFF)
                 == 0).all())


def test_tf32_control_keeps_kernel_layers_in_bf16_and_the_rest_tf32():
    m = _model(F32_CELL)
    torch.manual_seed(0)
    det = md.YOLOXDetector(md.detector_config(m))
    lower.lower_detector(det, 'float32', harness.stage_backends(m),
                         kernels_as_run=True)
    kernel = ('backbone.stem.', 'backbone.disp_stem.', 'backbone.stage1.',
              'backbone.disp_stage1.', 'backbone.stage2.')
    seen = {True: 0, False: 0}
    x = torch.randn(1, 64, 9, 9)
    for name, mod in det.named_modules():
        inside = name.startswith(kernel)
        if isinstance(mod, torch.nn.Conv2d):
            seen[inside] += 1
            pre = next(iter(mod._forward_pre_hooks.values()))
            xin = pre(mod, (x[:, :mod.in_channels],))[0]
            if inside:
                assert _bf16_like(mod.weight) and _bf16_like(xin), name
            else:
                assert _tf32_like(mod.weight) and _tf32_like(xin), name
                assert not _bf16_like(xin), name
        if isinstance(mod, (torch.nn.Conv2d, md.ConvBNAct)):
            assert bool(mod._forward_hooks) == inside, name
    assert seen[True] and seen[False]


def test_tf32_control_is_not_correct(tiny_bench):
    r = harness.run_cell(tiny_bench, F32_CELL, 11, 0.1, False, 'cpu',
                         system='control_tf32')
    assert not r['correct'], r['checks']


class _SwitchesTF32:
    """The program, switching cuDNN's TF32 on at its first step."""

    def __init__(self, system):
        self.system = system

    @property
    def states(self):
        return self.system.states

    @property
    def captures(self):
        return self.system.captures

    def reset(self):
        self.system.reset()

    def submit(self, *args):
        torch.backends.cudnn.allow_tf32 = True
        return self.system.submit(*args)


def test_tf32_switched_inside_a_run_is_not_correct(tiny_bench):
    r = harness.run_cell(tiny_bench, F32_CELL, 11, 0.1, False, 'cpu',
                         wrap=_SwitchesTF32)
    assert not r['correct']
    assert r['checks']['tf32_switched'] == {'value': 1.0, 'limit': 0}
    assert not torch.backends.cudnn.allow_tf32


def test_sound_run_reads_no_tf32(tiny_bench):
    r = harness.run_cell(tiny_bench, F32_CELL, 11, 0.1, False, 'cpu')
    assert r['correct'], r['checks']
    assert r['checks']['tf32_switched'] == {'value': 0.0, 'limit': 0}


# the TF32 kernels that cuDNN and cuBLAS ran for the f32 cell with TF32
# switched on, as the card's trace names them
TF32_NAMES = [
    'sm90_xmma_fprop_implicit_gemm_f32f32_tf32f32_f32_nhwckrsc_nhwc_tilesize'
    '128x128x32_warpgroupsize1x1x1_g1_execute_segment_k_off_kernel__5x_cudnn',
    'sm90_xmma_gemm_f32f32_tf32f32_f32_tn_n_tilesize128x128x32_warpgroupsize'
    '1x1x1_execute_segment_k_off_kernel__5x_cublas',
    'void cutlass::Kernel2<cutlass_80_tensorop_s1688gemm_64x128_32x3_tn_'
    'align4>(cutlass_80_tensorop_s1688gemm_64x128_32x3_tn_align4::Params)',
]


def test_tf32_kernels_are_counted():
    fp32 = LIBRARY_NAMES + STAGE_NAMES + [
        'void DSE::vector_fft<0, 1, 256, 16, 16, 1, float, float, float2>'
        '(float2*, float2*, int, int3, int3)',
        'sm80_xmma_fprop_implicit_gemm_f32f32_f32f32_f32_nchwkcrs_nchw_'
        'tilesize256x64x8_stage3_warpsize2x2x1_g1_ffma_aligna4_alignc4_'
        'execute_kernel__5x_cudnn',
        'void cutlass::Kernel2<cutlass_80_simt_sgemm_32x128_8x5_tn_align1>'
        '(cutlass_80_simt_sgemm_32x128_8x5_tn_align1::Params)']
    tr = tracelib.Trace(1, 0.0, 1.0, [_kernel(n) for n in fp32], [])
    assert tracelib.tf32_kernels(tr) == 0
    tr = tracelib.Trace(1, 0.0, 1.0,
                        [_kernel(n) for n in fp32 + TF32_NAMES * 2], [])
    assert tracelib.tf32_kernels(tr) == 2 * len(TF32_NAMES)


@pytest.mark.parametrize('workload', BF16_CELLS)
def test_bf16_control_is_the_whole_detector_step_down(workload):
    m = _model(workload)
    cfg = md.detector_config(m)
    torch.manual_seed(1)
    a = md.YOLOXDetector(cfg)
    b = md.YOLOXDetector(cfg)
    b.load_state_dict(a.state_dict())
    lower.lower_detector(a, 'bfloat16', harness.stage_backends(m))
    # the whole detector one step below bfloat16, as before the backends
    lower.lower_detector(b, 'bfloat16', dict.fromkeys(STAGES, 'torch'))
    g = torch.Generator().manual_seed(2)
    inputs = {'img': torch.rand(1, 64, 96, 3, generator=g) * 255,
              'disp_postp': torch.rand(1, 64, 96, 3, generator=g) * 64}
    with torch.no_grad():
        for x, y in zip(a(inputs), b(inputs)):
            for u, v in zip(x, y):
                assert torch.equal(u, v)


GLOBAL = re.compile(r'__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?'
                    r'(\w+)\s*\(')


def test_stage_kernels_are_the_sources_own():
    src = REPO / 'stereotracking_tpu_torch' / 'csrc'
    names = set()
    for f in ('stem.cu', 'stage1.cu', 'stage2.cu', 'stage3.cu'):
        names |= set(GLOBAL.findall((src / f).read_text()))
    assert names == tracelib.STAGE_KERNELS


def _kernel(name):
    return tracelib.Event('kernel', name, 0.0, 1e-6)


# as the card's trace names them; stage1_dual_kernel and stage3_fused_kernel
# (other widths) in the same form
STAGE_NAMES = [
    'void (anonymous namespace)::focus_stem_kernel<unsigned char, 3, 32>'
    '(unsigned char const*, int, int, int, int, __nv_bfloat16 const*, '
    'float const*, __nv_bfloat16*)',
    'void (anonymous namespace)::focus_stem_kernel<unsigned short, 1, 32>'
    '(unsigned short const*, int, int, int, int, __nv_bfloat16 const*, '
    'float const*, __nv_bfloat16*)',
    'void (anonymous namespace)::stage1_mma_kernel<8, 32>(__nv_bfloat16 '
    'const*, __nv_bfloat16 const*, int, int, __nv_bfloat16 const*, float '
    'const*, __nv_bfloat16 const*, float const*, __nv_bfloat16*)',
    'void (anonymous namespace)::stage1_dual_kernel<8, 4>(__nv_bfloat16 '
    'const*, __nv_bfloat16 const*, int, int, __nv_bfloat16 const*, float '
    'const*, __nv_bfloat16 const*, float const*, __nv_bfloat16*)',
    'void (anonymous namespace)::stage_csp_kernel<64>(__nv_bfloat16 const*, '
    'int, int, st_chain::StageDims, __nv_bfloat16 const*, float const*, '
    '__nv_bfloat16*)',
    'void (anonymous namespace)::stage3_fused_kernel<64>(__nv_bfloat16 '
    'const*, int, int, st_chain::StageDims, __nv_bfloat16 const*, float '
    'const*, __nv_bfloat16*)',
    'void (anonymous namespace)::stage3_entry_kernel<128>(__nv_bfloat16 '
    'const*, int, int, st_chain::StageDims, __nv_bfloat16 const*, float '
    'const*, __nv_bfloat16*)',
    'void (anonymous namespace)::stage3_chain_kernel<128>(__nv_bfloat16 '
    'const*, int, int, st_chain::StageDims, __nv_bfloat16 const*, int, '
    'float const*, __nv_bfloat16*)',
]
# cuBLAS's and cuDNN's names carry their pipeline depth (kalman.predict's
# float32 gemms; a float32 convolution), and cuDNN's float32 FFT
# convolutions, as the card's trace names them
LIBRARY_NAMES = [
    'sm80_xmma_gemm_f32f32_f32f32_f32_tn_n_tilesize32x32x8_stage3_warpsize'
    '1x2x1_ffma_aligna4_alignc4_execute_kernel__5x_cublas',
    'sm80_xmma_gemm_f32f32_f32f32_f32_nn_n_tilesize64x32x8_stage3_warpsize'
    '1x2x1_ffma_aligna4_alignc4_execute_kernel__5x_cublas',
    'sm80_xmma_gemm_f32f32_f32f32_f32_tn_n_tilesize32x32x8_stage3_warpsize'
    '1x2x1_ffma_aligna4_alignc4_execute_split_k_kernel__5x_cublas',
    'sm80_xmma_fprop_implicit_gemm_f32f32_f32f32_f32_nchwkcrs_nchw_tilesize'
    '256x64x8_stage3_warpsize2x2x1_g1_ffma_aligna4_alignc4_execute_kernel__'
    '5x_cudnn',
    'void DSE::regular_fft_pad<0, 1, 256, 16, 16, 1, float, float, float2>'
    '(float2*, float*, int, int3, int3, int, int3, int3, int, int, int, int, '
    'int, bool)',
    'void DSE::vector_fft<0, 1, 256, 16, 16, 1, float, float, float2>'
    '(float2*, float2*, int, int3, int3)',
    'void pointwise_mult_and_sum_complex<float2, 8, 4>(float2*, float2*, '
    'float2*, int, int, int, int, int, float2)',
]


@pytest.mark.parametrize('name', STAGE_NAMES)
def test_stage_kernel_is_stage(name):
    assert tracelib.kind(_kernel(name)) == 'stage'


@pytest.mark.parametrize('name', LIBRARY_NAMES)
def test_library_kernel_is_library(name):
    assert tracelib.kind(_kernel(name)) == 'library'


def test_track_and_torch_kernels_keep_their_kind():
    assert tracelib.kind(_kernel(
        'void (anonymous namespace)::nms_kernel(float4 const*, int)')) == \
        'track'
    assert tracelib.kind(_kernel(
        'void at::native::vectorized_elementwise_kernel<4, at::native::'
        'FillFunctor<float>, at::detail::Array<char*, 1> >(int, at::native::'
        'FillFunctor<float>, at::detail::Array<char*, 1>)')) == 'torch'


def test_run_records_the_backends(tiny_bench):
    r = harness.run_cell(tiny_bench, F32_CELL, 7, 0.1, False, 'cpu')
    assert r['device']['stage_backends'] == dict(
        stem='cuda', stage1='cuda', stage2='cuda', stage3='torch')
    json.loads(json.dumps(r))
