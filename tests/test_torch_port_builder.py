"""The port's per-stage backend resolution against the JAX builder.

``resolve_stage_backends`` is a pure function of (model config, device
type), so the CUDA-device cases run here without a card.
Kernel support per width and depth is stated below from the kernels'
documented limits (stem O in {8, 16, 24, 32, 48, 64, 80}; stage 1 C_in = mid =
C_out / 2 in {16, 24, 32} with one block; stage 2 C_in in {32, 48, 64};
stage 3 C_in in {64, 96, 128}; stages 2 and 3 with 1-7 blocks) and held
against what the resolver reads from the wrappers.  One
mix the JAX builder accepts (stem and stage-1 kernels, stage 2 on the
float32 modules) also runs end to end: its head maps within 3e-2 of their
largest magnitude of the JAX detector resumed from the Pallas stage-1
output (bf16 stems and stage 1 rounded at the same points, summed in
other orders), and ``predict_frame_raw`` on the same mix gives the same
detections as the detector alone.
"""
import itertools
import warnings

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from stereotracking_tpu.apis.builder import _resolve_stage_backends
from stereotracking_tpu.models.detector import DetectorConfig as JCfg
from stereotracking_tpu.models.detector import YOLOXDetector as JDet
from stereotracking_tpu.ops.stage1_pallas import pallas_stage1_out
from stereotracking_tpu.ops.stem_pallas import (pallas_stem_outputs,
                                                stem_pack_device,
                                                stem_pack_disp_device)
from stereotracking_tpu_torch.apis import builder
from stereotracking_tpu_torch.apis.builder import (build_mot_config,
                                                   resolve_stage_backends)
from stereotracking_tpu_torch.models import tracker as trk
from stereotracking_tpu_torch.models.csp_darknet import StageBackends
from stereotracking_tpu_torch.models.detector import detector_predict
from stereotracking_tpu_torch.models.mot import (predict_frame_raw,
                                                 preprocess_raw)
from test_torch_port_bridge import (H, W, WIDEN, port_detector,
                                    random_frame, random_variables)

KEYS = tuple(f'{s}_backend' for s in StageBackends._fields)
# (widen, deepen) -> does the kernel take (stem, stage 1, stage 2, stage 3)
SUPPORT = {
    (0.25, 0.33): (True, True, True, True),      # O 16; C 16, 32, 64
    (0.25, 0.67): (True, False, True, True),     # stage 1 has 2 blocks
    (0.375, 0.33): (True, True, True, True),     # O 24; C 24, 48, 96
    (0.375, 0.67): (True, False, True, True),
    (0.5, 0.33): (True, True, True, True),       # the flagship
    (0.5, 0.67): (True, False, True, True),      # 6 blocks in stages 2-3
    (0.75, 0.33): (True, False, False, False),   # O 48, C 96, 192, 384
    (0.75, 0.67): (True, False, False, False),
    (1.25, 1.33): (True, False, False, False),   # YOLOX-x: O 80, C 160
}
MIXES = list(itertools.product(('auto', 'cuda', 'torch'), repeat=4))


@pytest.fixture(autouse=True, scope='module')
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _expected(mix, support, on_card):
    """The resolution rule, stated independently: None where it raises."""
    out = []
    for i, (val, ok) in enumerate(zip(mix, support)):
        ok = ok or not on_card
        if val == 'cuda' and not ok:
            return None
        if val == 'auto':
            val = 'cuda' if on_card and ok and i < 3 else 'torch'
        if val == 'cuda' and i and out[-1] != 'cuda':
            if mix[i] != 'auto':
                return None
            val = 'torch'
        out.append(val)
    return StageBackends(*out)


@pytest.mark.parametrize('wf_df', sorted(SUPPORT))
def test_resolution_table_on_a_cuda_device(wf_df):
    """Every request mix at each width and depth, device type 'cuda'."""
    det = {'backbone': {'widen_factor': wf_df[0],
                        'deepen_factor': wf_df[1]}}
    for mix in MIXES:
        cfg = {'detector': det, **dict(zip(KEYS, mix))}
        # on the CPU 'cuda' is the plain versions, which take any width
        for device_type in ('cuda', 'cpu'):
            want = _expected(mix, SUPPORT[wf_df], device_type == 'cuda')
            with warnings.catch_warnings():
                warnings.simplefilter('ignore')     # 'auto' moved: reported
                if want is None:
                    with pytest.raises(ValueError):
                        resolve_stage_backends(cfg, device_type)
                else:
                    got = resolve_stage_backends(cfg, device_type)
                    assert got == want, mix


@pytest.mark.parametrize('wf_df', [(0.25, 0.67), (0.75, 0.33),
                                   (0.5, 0.67)])
def test_explicit_kernel_at_unsupported_dims_raises_at_build(monkeypatch,
                                                            wf_df):
    """``build_mot_config`` on a CUDA device (the card check stubbed: the
    config holds no tensor) names the stage, its dims and the kernel's."""
    monkeypatch.setattr(builder, 'checked_device', torch.device)
    det = {'backbone': {'widen_factor': wf_df[0],
                        'deepen_factor': wf_df[1]}}
    support = SUPPORT[wf_df]
    first_bad = KEYS[support.index(False)]
    cfg = {'type': 'OCSORT_Disparity', 'detector': det,
           **{k: 'cuda' for k in KEYS}}
    with pytest.raises(ValueError, match=f"{first_bad}='cuda': .*got"):
        build_mot_config(cfg, device='cuda')
    with pytest.warns(UserWarning, match=f"{first_bad}='auto' runs on the "
                      f"float32 modules: .*got"):
        auto = build_mot_config({**cfg, **{k: 'auto' for k in KEYS}},
                                device='cuda')
    assert auto.backends == _expected(('auto',) * 4, support, True)


@pytest.mark.parametrize('widen', [0.375, 0.75, 1.25])
def test_stem_kernel_runs_every_yolox_width(widen):
    """YOLOX-tiny, -m and -x (stem O = 24, 48, 80): the stem kernel takes
    their width.  With every stage 'auto' on a CUDA device, YOLOX-tiny's
    stages 1 and 2 run their kernels too (stage 3 'auto' stays on the
    modules, as the JAX builder decides) with no warning; at -m's and -x's
    widths stage 1's kernel is not built (C = 48, 80), so stage 1 moves to
    the float32 modules with the builder's warning, naming the roadmap
    item (one more for each later stage whose own dims would move it),
    and every stage after it follows."""
    from stereotracking_tpu_torch.ops import stem_cuda
    o = int(64 * widen)
    assert o in stem_cuda.STEM_WIDTHS and stem_cuda.dims_problem(o) is None
    assert 'got O = 40' in stem_cuda.dims_problem(40)
    assert 'got O = 88' in stem_cuda.dims_problem(88)
    cfg = {'detector': {'backbone': {'widen_factor': widen,
                                     'deepen_factor': 0.33}},
           **{k: 'auto' for k in KEYS}}
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter('always')
        got = resolve_stage_backends(cfg, 'cuda')
    said = [str(w.message) for w in caught]
    if widen == 0.375:
        assert got == StageBackends('cuda', 'cuda', 'cuda', 'torch')
        assert not said, said
        assert resolve_stage_backends({**cfg, 'stage3_backend': 'cuda'},
                                      'cuda') == StageBackends(*['cuda'] * 4)
    else:
        assert got == StageBackends('cuda', 'torch', 'torch', 'torch')
        assert said[0].startswith("stage1_backend='auto' runs on the "
                                  'float32 modules'), said
        assert all('Queue 3 item 1' in m for m in said), said
    assert not any(m.startswith('stem_backend') for m in said), said
    assert resolve_stage_backends({**cfg, 'stem_backend': 'cuda',
                                   'stage1_backend': 'torch'},
                                  'cuda').stem == 'cuda'


@pytest.mark.parametrize('mix', MIXES, ids='-'.join)
def test_mixes_resolve_as_the_jax_builder(mix):
    """Each mix of 'auto' / kernel / modules on the JAX builder
    ('pallas' / 'xla') and the port ('cuda' / 'torch') on the CPU: both
    accept it and resolve alike, or both raise."""
    jval = {'auto': 'auto', 'cuda': 'pallas', 'torch': 'xla'}
    jcfg = {k: jval[v] for k, v in zip(KEYS, mix)}
    try:
        want = _resolve_stage_backends(jcfg)
    except ValueError:
        want = None
    cfg = dict(zip(KEYS, mix))
    if want is None:
        with pytest.raises(ValueError, match='requires'):
            build_mot_config(cfg, device='cpu')
        return
    got = build_mot_config(cfg, device='cpu')
    tval = {'pallas': 'cuda', 'xla': 'torch'}
    assert got.backends == StageBackends(*(tval[want[k]] for k in KEYS))
    # the JAX names are accepted too
    assert build_mot_config(jcfg, device='cpu').backends == got.backends


def test_unported_depth_mode_raises_at_build():
    for mode in ('truncated_mean', 'mean', 'median', 'center'):
        with pytest.raises(NotImplementedError, match='Queue 1 item 4'):
            build_mot_config({'depth_mode': mode}, device='cpu')
    assert build_mot_config({'depth_mode': 'corner_guided'},
                            device='cpu').depth_mode == 'corner_guided'


def test_stage_backends_check():
    StageBackends('cuda', 'cuda', 'torch', 'torch').check()
    with pytest.raises(ValueError,
                       match="stage2_backend='cuda' requires stage1_backend"):
        StageBackends('cuda', 'torch', 'cuda').check()
    with pytest.raises(ValueError, match='must be in'):
        StageBackends('pallas').check()


def test_stem_and_stage1_kernels_with_stage2_modules_match_jax():
    """The mix stem + stage 1 kernels (their plain versions here), stage 2
    on the float32 modules, against the JAX detector with the same
    switches (Pallas stem and stage 1 in interpret mode, stage 2 on XLA)."""
    v = random_variables(seed=4, head_bias=3.0)
    img, disp = random_frame(6)
    bp, bs = v['params']['backbone'], v['batch_stats']['backbone']
    so, dso = pallas_stem_outputs(
        bp, bs, stem_pack_device(jnp.asarray(img), H, W),
        stem_pack_disp_device(jnp.asarray(disp), H, W), W // 4,
        interpret=True)
    y1 = pallas_stage1_out(bp, bs, so, dso, interpret=True)
    jin = {'img': jnp.zeros((1, H, W, 3)),
           'disp_postp': jnp.zeros((1, H, W, 3)), 'stage1_out': y1}
    ref = JDet(JCfg(widen_factor=WIDEN, deepen_factor=0.33)).apply(
        v, jin, train=False)

    model_cfg = {'type': 'OCSORT_Disparity',
                 'detector': {'backbone': {'widen_factor': WIDEN}},
                 'stem_backend': 'pallas', 'stage1_backend': 'pallas',
                 'stage2_backend': 'auto', 'stage3_backend': 'auto'}
    cfg = build_mot_config(model_cfg, device='cpu')
    assert cfg.backends == StageBackends('cuda', 'cuda', 'torch', 'torch')
    det = port_detector(v)
    inputs = preprocess_raw(torch.from_numpy(img)[None],
                            torch.from_numpy(disp)[None], H, W)
    with torch.no_grad():
        out = det(inputs, cfg.backends)
    for rl, ol in zip(ref, out):
        for r, o in zip(rl, ol):
            r = np.asarray(r, np.float32)
            assert o.shape == r.shape
            assert np.abs(o.numpy() - r).max() <= 3e-2 * np.abs(r).max()

    state = trk.init_state(cfg.tracker, torch.device('cpu'))
    _, res = predict_frame_raw(det, state, torch.from_numpy(img),
                               torch.from_numpy(disp), 0, cfg, H, W)
    alone = detector_predict(det, inputs, backends=cfg.backends)
    assert torch.equal(res.det_bboxes, alone.boxes[0])
    assert torch.equal(res.det_scores, alone.scores[0])
    assert int(res.det_valid.sum()) > 0
    assert torch.isfinite(res.track_depths).all()
