"""Stage 3 of the PyTorch port against the JAX package's fused stage 3.

The port's stage-3 kernel (``ops/stage3_cuda.stage3_csp``) runs its plain
version here: the stage chain on the stage-3 weights, bf16 rounded at the
kernel's points.  It is held against ``pallas_stage3_out`` (the generic
Pallas stage kernel on the ``stage3`` subtree, interpret mode) within
2e-2 of the output's largest magnitude plus 1e-3 (the JAX package's own
stage tolerance, tests/test_stage3_pallas.py); the detector with stage 3
on the kernel path against the JAX detector resumed from the Pallas stage-2
and stage-3 outputs within 5e-2 relative (tests/test_stage3_pallas.py);
the builder's ``stage3_backend`` key as the JAX builder resolves it.
Weights come over through ``flax_to_state_dict``.
"""
import numpy as np
import pytest

import jax.numpy as jnp
import torch

from stereotracking_tpu.apis.builder import build_mot_config as j_build
from stereotracking_tpu.models.detector import DetectorConfig as JCfg
from stereotracking_tpu.models.detector import YOLOXDetector as JDet
from stereotracking_tpu.models.layers import widen
from stereotracking_tpu.ops.stage1_pallas import pallas_stage1_out
from stereotracking_tpu.ops.stage2_pallas import (pallas_stage2_out,
                                                  pallas_stage3_out,
                                                  unfold_w)
from stereotracking_tpu.ops.stem_pallas import (pallas_stem_outputs,
                                                stem_pack_device,
                                                stem_pack_disp_device)
from stereotracking_tpu_torch.apis.builder import build_mot_config
from stereotracking_tpu_torch.models.csp_darknet import StageBackends
from stereotracking_tpu_torch.ops import stage3_cuda
from test_torch_port_bridge import (H, W, WIDEN, port_detector,
                                    random_frame, random_variables)


@pytest.fixture(autouse=True, scope='module')
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize('wf,h8,w4', [(0.25, 24, 16), (0.5, 16, 16)])
def test_stage3_plain_matches_pallas(wf, h8, w4):
    """(wf, h8, w4): the widths and the W-folded stage-2 map of
    tests/test_stage3_pallas.py; 0.5 is the flagship's 128 -> 256."""
    v = random_variables(widen=wf, seed=4)
    bp, bs = v['params']['backbone'], v['batch_stats']['backbone']
    rng = np.random.RandomState(4)
    c2 = 2 * widen(256, wf)                       # folded stage-2 channels
    y2 = jnp.asarray(rng.randn(h8, w4, c2).astype(np.float32) * 0.8,
                     jnp.bfloat16)
    ref = np.asarray(unfold_w(pallas_stage3_out(bp, bs, y2, interpret=True)),
                     np.float32)
    k = port_detector(v, widen=wf).backbone.kernel_weights()['stage3']
    assert k.dims == (widen(256, wf), widen(512, wf), widen(256, wf), 3)
    x = torch.from_numpy(np.asarray(unfold_w(y2), np.float32)).to(
        torch.bfloat16)[None]
    out = stage3_cuda.stage3_csp(x, k)
    assert out.dtype == torch.bfloat16
    out = out[0].float().numpy()
    assert out.shape == ref.shape == (h8 // 2, w4, widen(512, wf))
    scale = np.abs(ref).max()
    assert np.abs(out - ref).max() <= 2e-2 * scale + 1e-3


def test_detector_with_stage3_kernel_matches_jax():
    """All four stage kernels on both sides (the port's plain versions
    here): head maps within 5e-2 of their largest magnitude."""
    v = random_variables(seed=3)
    img, disp = random_frame(5)
    bp, bs = v['params']['backbone'], v['batch_stats']['backbone']
    so, dso = pallas_stem_outputs(
        bp, bs, stem_pack_device(jnp.asarray(img), H, W),
        stem_pack_disp_device(jnp.asarray(disp), H, W), W // 4,
        interpret=True)
    y1 = pallas_stage1_out(bp, bs, so, dso, interpret=True)
    y2 = pallas_stage2_out(bp, bs, y1, interpret=True)
    y3 = pallas_stage3_out(bp, bs, y2, interpret=True)
    jin = {'img': jnp.zeros((1, H, W, 3)),
           'disp_postp': jnp.zeros((1, H, W, 3)),
           'stage2_out': y2, 'stage3_out': y3}
    ref = JDet(JCfg(widen_factor=WIDEN, deepen_factor=0.33)).apply(
        v, jin, train=False)
    dispf = np.where(disp == 65535, 0, disp).astype(np.float32) / 16.0
    inputs = {'img': torch.from_numpy(img.astype(np.float32))[None],
              'disp_postp': torch.from_numpy(dispf)[None, :, :, None].expand(
                  1, H, W, 3),
              'img_u8': torch.from_numpy(img)[None],
              'disp_u16': torch.from_numpy(disp)[None]}
    with torch.no_grad():
        out = port_detector(v)(inputs, StageBackends(*['cuda'] * 4))
    for rl, ol in zip(ref, out):
        for r, o in zip(rl, ol):
            r = np.asarray(r, np.float32)
            assert o.shape == r.shape
            assert np.abs(o.numpy() - r).max() <= 5e-2 * np.abs(r).max()


def test_builder_stage3_backend_key():
    """The JAX builder's cases (tests/test_stage3_pallas.py) on both
    packages: all four kernels on -> the stage-3 kernel; no key or 'auto'
    -> the float32 modules; the stage-3 kernel without the stage-2 kernel
    is a config error."""
    every = {'type': 'OCSORT_Disparity', 'stem_backend': 'pallas',
             'stage1_backend': 'pallas', 'stage2_backend': 'pallas',
             'stage3_backend': 'pallas'}
    assert j_build(every).stage3_backend == 'pallas'
    assert build_mot_config(every, device='cpu').backends.stage3 == 'cuda'
    cuda = {k: 'cuda' if k.endswith('backend') else v
            for k, v in every.items()}
    assert build_mot_config(cuda, device='cpu').backends.stage3 == 'cuda'
    for cfg in ({'type': 'OCSORT_Disparity'},
                {'type': 'OCSORT_Disparity', 'stage3_backend': 'auto'},
                {**every, 'stage3_backend': 'auto'}):
        assert j_build(cfg).stage3_backend == 'xla'
        assert build_mot_config(cfg, device='cpu').backends.stage3 == 'torch'
    for key in ('pallas', 'cuda'):
        lone = {'type': 'OCSORT_Disparity', 'stage3_backend': key}
        with pytest.raises(ValueError, match="requires stage2_backend='cuda'"):
            build_mot_config(lone, device='cpu')
    with pytest.raises(ValueError):
        j_build({'type': 'OCSORT_Disparity', 'stage3_backend': 'pallas'})
    with pytest.raises(ValueError, match='unknown'):
        build_mot_config({'stage3_backend': 'tpu'}, device='cpu')
