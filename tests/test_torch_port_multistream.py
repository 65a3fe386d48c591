"""Multi-stream batched tracking of the PyTorch port.

``parallel.multistream.MultiStreamTracker`` against the JAX one with the
``SMALL`` config of tests/test_multistream.py (2 streams, 3 frames, float32,
weights through ``flax_to_state_dict``): track ids and validity exact,
boxes within 1e-2 px.  Then the port against itself: the batched run
against per-stream ``OCSORTDisparity`` runs, ``track_raw_chunk`` against
per-frame ``track_raw``, streams at different frame ids (one restarting at
frame 0), and the batched tracker step and assignment against the
single-stream ones over 12 frames.  Also: the entry points run on the card
unless asked for the CPU, and the stage-1 variant probe needs the card.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from stereotracking_tpu.models.mot import MOTConfig as JMOT
from stereotracking_tpu.models.preprocessor import preprocess_frame
from stereotracking_tpu.parallel.multistream import \
    MultiStreamTracker as JMulti
from stereotracking_tpu_torch.models import tracker as tt
from stereotracking_tpu_torch.models.detector import DetectorConfig
from stereotracking_tpu_torch.models.mot import MOTConfig, OCSORTDisparity
from stereotracking_tpu_torch.models.preprocessor import padded_shape
from stereotracking_tpu_torch.ops.assignment import \
    linear_assignment_with_limit
from stereotracking_tpu_torch.parallel.multistream import MultiStreamTracker
from synthetic import SyntheticSequence
from test_torch_port_bridge import WIDEN, port_detector, random_variables
from test_torch_port_tracker import _frames

H, W = 64, 96
CPU = 'cpu'


@pytest.fixture(autouse=True, scope='module')
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def small_configs():
    """tests/test_multistream.py's SMALL, at widen 0.25, in both
    packages."""
    from stereotracking_tpu.models import tracker as jt
    from stereotracking_tpu.models.detector import DetectorConfig as JCfg
    jcfg = JMOT(detector=JCfg(widen_factor=WIDEN, pre_nms_top_k=128,
                              max_per_img=32),
                tracker=jt.TrackerConfig(num_slots=8, num_dets=8))
    tcfg = MOTConfig(
        detector=DetectorConfig(widen_factor=WIDEN, pre_nms_top_k=128,
                                max_per_img=32),
        tracker=tt.TrackerConfig(**jcfg.tracker._asdict()),
        baseline=jcfg.baseline, focal_length=jcfg.focal_length,
        depth_crop=jcfg.depth_crop, reuse_det_depth=jcfg.reuse_det_depth)
    return jcfg, tcfg


@pytest.fixture(scope='module')
def world():
    v = random_variables(seed=6, head_bias=2.0)
    jcfg, tcfg = small_configs()
    return dict(v=v, jcfg=jcfg, tcfg=tcfg)


def _synthetic(n_streams, n_frames):
    """(T, S, H, W, 3) uint8 and (T, S, H, W) uint16 of moving objects."""
    seqs = [SyntheticSequence(seed=i, h=H, w=W) for i in range(n_streams)]
    frames = [[s.frame(t)[:2] for s in seqs] for t in range(n_frames)]
    return (np.stack([[f[0] for f in ft] for ft in frames]),
            np.stack([[f[1] for f in ft] for ft in frames]))


def _same(a, b, s=None, atol=1e-2):
    """FrameResult ``a`` (stream ``s`` of it if given) against ``b``: ids
    and validity exact, tracked boxes within ``atol`` px."""
    pick = (lambda x: np.asarray(x)) if s is None else \
        (lambda x: np.asarray(x)[s])
    np.testing.assert_array_equal(pick(a.track_ids), np.asarray(b.track_ids))
    np.testing.assert_array_equal(pick(a.track_valid),
                                  np.asarray(b.track_valid))
    np.testing.assert_allclose(pick(a.track_bboxes),
                               np.asarray(b.track_bboxes), atol=atol)


def test_multistream_matches_jax(world):
    jcfg, tcfg, v = world['jcfg'], world['tcfg'], world['v']
    oh, ow = padded_shape(H, W)
    imgs, disps = _synthetic(2, 3)
    jm = JMulti(jcfg, n_streams=2, variables=v, input_shape=(oh, ow))
    tm = MultiStreamTracker(tcfg, 2, module=port_detector(v), device=CPU)
    n_valid = 0
    for t in range(3):
        ins = [preprocess_frame(jnp.asarray(i), jnp.asarray(d), oh, ow)
               for i, d in zip(imgs[t], disps[t])]
        jin = jax.tree.map(lambda *xs: jnp.stack(xs), *ins)
        rj = jm.track(jin, [t, t])
        rt = tm.track({k: np.array(x) for k, x in jin.items()}, [t, t])
        _same(rt, rj)
        n_valid += int(np.asarray(rj.track_valid).sum())
    assert n_valid > 0


@pytest.fixture(scope='module')
def port_world(world):
    """One port detector (float32 modules) and the synthetic clips."""
    return dict(det=port_detector(world['v']), cfg=world['tcfg'],
                clip=_synthetic(3, 4))


def test_batched_equals_per_stream(port_world):
    det, cfg, (imgs, disps) = (port_world['det'], port_world['cfg'],
                               port_world['clip'])
    s_count = imgs.shape[1]
    ms = MultiStreamTracker(cfg, s_count, module=det, device=CPU)
    singles = [OCSORTDisparity(cfg, module=det, device=CPU)
               for _ in range(s_count)]
    for t in range(imgs.shape[0]):
        rb = ms.track_raw(imgs[t], disps[t], [t] * s_count)
        assert rb.track_ids.shape == (s_count, cfg.tracker.num_dets)
        for s, one in enumerate(singles):
            _same(rb, one.track_raw(imgs[t, s], disps[t, s], t), s)


def test_chunk_equals_per_frame(port_world):
    """track_raw_chunk carries the states as T track_raw calls do."""
    det, cfg, (imgs, disps) = (port_world['det'], port_world['cfg'],
                               port_world['clip'])
    t_count, s_count = imgs.shape[:2]
    fids = np.repeat(np.arange(t_count)[:, None], s_count, 1)
    a = MultiStreamTracker(cfg, s_count, module=det, device=CPU)
    b = MultiStreamTracker(cfg, s_count, module=det, device=CPU)
    per_frame = [a.track_raw(imgs[t], disps[t], fids[t])
                 for t in range(t_count)]
    chunk = b.track_raw_chunk(imgs, disps, fids)
    for t in range(t_count):
        for x, y in zip(chunk, per_frame[t]):
            assert torch.equal(x[t], y)
    for x, y in zip(a.states, b.states):
        assert torch.equal(x, y)
    b.reset()
    assert not b.states.active.any() and (b.states.num_tracks == 0).all()


def test_streams_at_different_frame_ids(port_world):
    """Stream 0 restarts at frame 0 mid-run; stream 1 runs on; stream 2
    starts late.  Each stream equals its own single-stream run."""
    det, cfg, (imgs, disps) = (port_world['det'], port_world['cfg'],
                               port_world['clip'])
    fids = [[0, 5, 9], [1, 6, 10], [0, 7, 11], [1, 8, 12]]
    ms = MultiStreamTracker(cfg, 3, module=det, device=CPU)
    singles = [OCSORTDisparity(cfg, module=det, device=CPU)
               for _ in range(3)]
    for t, f in enumerate(fids):
        rb = ms.track_raw(imgs[t], disps[t], f)
        for s, one in enumerate(singles):
            _same(rb, one.track_raw(imgs[t, s], disps[t, s], f[s]), s)


def test_batched_tracker_and_assignment_match_single():
    """The tracker step over 3 streams of synthetic detections against 3
    single-stream steps, 12 frames: ids, validity and every integer field
    exact, float fields within 1e-4; the batched assignment against the
    single-stream one on random costs: exact."""
    cfg = tt.TrackerConfig(num_slots=16, num_dets=16, match_iou_thr=0.1)
    streams = [_frames(seed=s) for s in range(3)]
    batched = tt.init_state(cfg, n_streams=3)
    singles = [tt.init_state(cfg) for _ in range(3)]
    for f in range(12):
        dets = [tt.Detections(**{k: torch.from_numpy(v)
                                 for k, v in st[f].items()})
                for st in streams]
        stacked = tt.Detections(*(torch.stack(x) for x in zip(*dets)))
        batched, out = tt.step(batched, stacked, [f] * 3, cfg)
        for s in range(3):
            singles[s], o1 = tt.step(singles[s], dets[s], f, cfg)
            assert torch.equal(out.ids[s], o1.ids)
            assert torch.equal(out.valid[s], o1.valid)
            for a, b in zip(batched, singles[s]):
                if a.dtype in (torch.bool, torch.int32):
                    assert torch.equal(a[s], b)
                else:
                    torch.testing.assert_close(a[s], b, atol=1e-4,
                                               rtol=1e-4, equal_nan=True)
    assert int(batched.num_tracks.min()) >= 9
    rng = np.random.RandomState(0)
    cost = torch.from_numpy(rng.uniform(0, 1.2, (4, 12, 9)).astype(
        np.float32))
    rm = torch.from_numpy(rng.rand(4, 12) > 0.2)
    cm = torch.from_numpy(rng.rand(4, 9) > 0.2)
    rows, cols = linear_assignment_with_limit(cost, rm, cm, 0.9)
    for s in range(4):
        r1, c1 = linear_assignment_with_limit(cost[s], rm[s], cm[s], 0.9)
        assert torch.equal(rows[s], r1) and torch.equal(cols[s], c1)


def test_entry_points_run_on_the_card():
    """No device given: the card.  Without one they raise; they never fall
    back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip('a card is present: the default device is usable')
    from stereotracking_tpu_torch.apis.builder import (build_model,
                                                       build_mot_config)
    from stereotracking_tpu_torch.config import load_config
    cfg = load_config(
        'configs/stereo_tracking/ocsort/yolox_s_airdrone_disp.py')
    _, tcfg = small_configs()
    for make in (lambda: build_model(cfg),
                 lambda: build_mot_config(cfg['model']),
                 lambda: OCSORTDisparity(tcfg),
                 lambda: MultiStreamTracker(tcfg, 2)):
        with pytest.raises(RuntimeError, match='no CUDA device'):
            make()


def test_probe_needs_the_card(world):
    """The stage-1 variant probe times CUDA kernels: it refuses to run on
    the CPU, and its variants hold the production kernel."""
    from stereotracking_tpu_torch.ops import stage1_cuda
    from stereotracking_tpu_torch.tools import probe_stage1_variants as probe
    assert stage1_cuda.PRODUCTION in stage1_cuda.VARIANTS
    assert len(set(stage1_cuda.VARIANTS)) == 6
    with pytest.raises(RuntimeError, match='NVIDIA GPU'):
        probe.run_probe(device='cpu')
    k = port_detector(world['v']).backbone.kernel_weights()
    x = torch.zeros((1, 16, 24, k['stage1'].dims[0]), dtype=torch.bfloat16)
    with pytest.raises(ValueError):        # a variant is a CUDA kernel
        stage1_cuda.stage1_dual_variant(x, x, k['stage1'],
                                        k['disp_stage1'], 'r8x16_wmma')
    with pytest.raises(ValueError, match='unknown variant'):
        stage1_cuda.stage1_dual_variant(x, x, k['stage1'],
                                        k['disp_stage1'], 'r4x4')


def test_ablation_edits_match_the_kernel_sources():
    """Each source edit of the ablation tool finds its text, once switched
    on changes its file, and names a kernel group the tool builds: the tool
    raises on the card when a refactor leaves a pattern behind."""
    from stereotracking_tpu_torch import _kernels
    from stereotracking_tpu_torch.tools import ablate_kernels as ab
    assert set(ab.ABLATIONS) == set(ab._SOURCES)
    for group, ablations in ab.ABLATIONS.items():
        for name, edits in ablations.items():
            for fname, old, new in edits:
                text = (_kernels.CSRC / fname).read_text()
                assert old in text, (group, name, fname)
                assert text.replace(old, new, 1) != text, (group, name)
