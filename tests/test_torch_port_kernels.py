"""Plain PyTorch versions of the port's kernels against the Pallas kernels.

The JAX package runs its Pallas kernels in interpret mode here (its own
tests do the same off-TPU); the port's wrappers, given CPU tensors, run
their plain versions, which round to bf16 at the kernels' points.  Canonical
NHWC on the port's side; the JAX kernels' layouts are undone with
``depth_to_space(2)`` (stem) and ``unfold_w`` (stages).
"""
import numpy as np
import pytest

import jax.numpy as jnp
import torch

from stereotracking_tpu.models.detector import DetectorConfig as JCfg
from stereotracking_tpu.models.detector import YOLOXDetector as JDet
from stereotracking_tpu.ops.stage1_pallas import pallas_stage1_out
from stereotracking_tpu.ops.stage2_pallas import pallas_stage2_out, unfold_w
from stereotracking_tpu.ops.stem_pallas import (pallas_stem_outputs,
                                                stem_pack_device,
                                                stem_pack_disp_device)
from stereotracking_tpu_torch.models.csp_darknet import StageBackends
from stereotracking_tpu_torch.ops import stage1_cuda, stage2_cuda, stem_cuda
from test_torch_port_bridge import (H, W, WIDEN, port_detector,
                                    random_frame, random_variables)

ULP = 2.0 ** -7        # one bf16 ulp, relative


@pytest.fixture(autouse=True, scope='module')
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _d2s(x):
    """s2d(2) layout (H, W, 4C) -> canonical (2H, 2W, C)."""
    x = np.asarray(x, np.float32)
    h, w, c4 = x.shape
    c = c4 // 4
    return x.reshape(h, w, 2, 2, c).transpose(0, 2, 1, 3, 4).reshape(
        2 * h, 2 * w, c)


@pytest.fixture(scope='module')
def world():
    """Weights, one frame, the Pallas outputs and the port's kernel
    weights, computed once for the module."""
    v = random_variables(seed=3)
    img, disp = random_frame(5)
    bp, bs = v['params']['backbone'], v['batch_stats']['backbone']
    so, dso = pallas_stem_outputs(
        bp, bs, stem_pack_device(jnp.asarray(img), H, W),
        stem_pack_disp_device(jnp.asarray(disp), H, W), W // 4,
        interpret=True)
    y1 = pallas_stage1_out(bp, bs, so, dso, interpret=True)
    y2 = pallas_stage2_out(bp, bs, y1, interpret=True)
    det = port_detector(v)
    return dict(v=v, img=img, disp=disp, so=so, dso=dso, y1=y1, y2=y2,
                det=det, kw=det.backbone.kernel_weights())


def _beyond_ulp(out, ref):
    return np.abs(out - ref) > ULP * np.abs(ref) + 1e-6


def test_stem_plain_matches_pallas_within_one_ulp(world):
    """One bf16 rounding after BN + SiLU in float32, as the Pallas kernel
    rounds: every element within one bf16 ulp (both branches)."""
    kw = world['kw']
    rgb = stem_cuda.focus_stem(torch.from_numpy(world['img'])[None],
                               *kw['stem'], H, W)[0]
    dsp = stem_cuda.focus_stem(torch.from_numpy(world['disp'])[None],
                               *kw['disp_stem'], H, W)[0]
    for out, ref in ((rgb, world['so']), (dsp, world['dso'])):
        assert out.dtype == torch.bfloat16
        ref = _d2s(ref)
        assert out.shape == ref.shape
        assert not _beyond_ulp(out.float().numpy(), ref).any()


def test_stem_rounds_disparity_input_to_bf16(world):
    """x = bf16(raw / 16) before the product, as both JAX paths do.  With
    inputs off the bf16 grid (257 -> 256, 385 -> 384) the plain version
    equals the Pallas output in nearly every element; the same stem on the
    unrounded float32 input does not."""
    disp = np.full((H, W), 16 * 257, np.uint16)
    disp[::3] = 16 * 385
    wk, sb = world['kw']['disp_stem']
    w6 = stem_cuda.stem_hwio(wk, 1)
    v = world['v']
    _, dso = pallas_stem_outputs(
        v['params']['backbone'], v['batch_stats']['backbone'],
        stem_pack_device(jnp.asarray(world['img']), H, W),
        stem_pack_disp_device(jnp.asarray(disp), H, W), W // 4,
        interpret=True)
    ref = _d2s(dso)
    out = stem_cuda.focus_stem(torch.from_numpy(disp)[None], wk, sb, H, W)
    out = out[0].float().numpy()
    assert not _beyond_ulp(out, ref).any()
    x = torch.nn.functional.pad(
        torch.from_numpy(disp.astype(np.float32) / 16.0)[None, None],
        (2, 3, 2, 3))
    acc = torch.nn.functional.conv2d(x, w6.permute(3, 2, 0, 1), stride=2)[0]
    y = acc * sb[0][:, None, None] + sb[1][:, None, None]
    raw = (y * torch.sigmoid(y)).to(torch.bfloat16).float().permute(1, 2, 0)
    same_rounded = (out == ref).mean()
    same_unrounded = (raw.numpy() == ref).mean()
    assert same_rounded >= 0.95 and same_unrounded < 0.8, \
        (same_rounded, same_unrounded)


def _check_stage(out, ref):
    """bf16 chains: roundings may flip by one ulp and carry on; held to
    2e-2 of the largest magnitude (the JAX package's own stage tolerance)
    with at most 3% of elements more than one ulp off."""
    out = out.float().numpy()
    assert out.shape == ref.shape
    scale = np.abs(ref).max()
    assert np.abs(out - ref).max() <= 2e-2 * scale + 1e-3
    assert _beyond_ulp(out, ref).mean() <= 0.03


def test_stage1_plain_matches_pallas(world):
    kw = world['kw']
    rgb = torch.from_numpy(_d2s(world['so'])).to(torch.bfloat16)[None]
    dsp = torch.from_numpy(_d2s(world['dso'])).to(torch.bfloat16)[None]
    out = stage1_cuda.stage1_dual(rgb, dsp, kw['stage1'], kw['disp_stage1'])
    assert out.dtype == torch.bfloat16
    _check_stage(out[0], np.asarray(unfold_w(world['y1']), np.float32))


def test_stage2_plain_matches_pallas(world):
    x = torch.from_numpy(np.asarray(unfold_w(world['y1']), np.float32)).to(
        torch.bfloat16)[None]
    out = stage2_cuda.stage_csp(x, world['kw']['stage2'])
    _check_stage(out[0], np.asarray(unfold_w(world['y2']), np.float32))


def test_kernel_path_detector_matches_jax_kernel_path(world):
    """The detector with the kernel backend (their plain versions on
    CPU) against the JAX detector resumed from the Pallas stage-2 output:
    head maps within 3e-2 of their largest magnitude (bf16 stems and
    stages 1-2 rounded at the same points, summed in other orders)."""
    v, det = world['v'], world['det']
    img, disp = world['img'], world['disp']
    dispf = np.where(disp == 65535, 0, disp).astype(np.float32) / 16.0
    jin = {'img': jnp.zeros((1, H, W, 3)),
           'disp_postp': jnp.zeros((1, H, W, 3)),
           'stage2_out': world['y2']}
    jd = JDet(JCfg(widen_factor=WIDEN, deepen_factor=0.33))
    ref = jd.apply(v, jin, train=False)
    inputs = {'img': torch.from_numpy(img.astype(np.float32))[None],
              'disp_postp': torch.from_numpy(dispf)[None, :, :, None].expand(
                  1, H, W, 3),
              'img_u8': torch.from_numpy(img)[None],
              'disp_u16': torch.from_numpy(disp)[None]}
    with torch.no_grad():
        out = det(inputs, StageBackends('cuda', 'cuda', 'cuda'))
    for rl, ol in zip(ref, out):
        for r, o in zip(rl, ol):
            r = np.asarray(r)
            assert np.abs(o.numpy() - r).max() <= 3e-2 * np.abs(r).max()


def test_wrappers_reject_bad_inputs(world):
    kw = world['kw']
    x = torch.zeros((1, 16, 24, 64), dtype=torch.float32)
    with pytest.raises(ValueError):
        stage2_cuda.stage_csp(x, kw['stage2'])           # not bf16
    with pytest.raises(ValueError):                      # no stream axis
        stage2_cuda.stage_csp(x[0].to(torch.bfloat16), kw['stage2'])
    w1 = kw['stage1'].wts
    bad = stage2_cuda.pack_stage(w1._replace(
        c1_w=w1.c1_w.repeat(2, 1, 1), c1_sb=w1.c1_sb.repeat(2, 1, 1),
        c2_w=w1.c2_w.repeat(2, 1, 1, 1, 1), c2_sb=w1.c2_sb.repeat(2, 1, 1)))
    xs = torch.zeros((1, 32, 48, w1.dims[0]), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match='num_blocks'):
        stage1_cuda.stage1_dual(xs, xs, bad, bad)        # two blocks
    with pytest.raises(ValueError):
        stem_cuda.focus_stem(torch.zeros((1, H, W), dtype=torch.uint8),
                             *kw['stem'], H, W)          # 2-D image
