"""Camera-motion compensation of the PyTorch port against the JAX package,
on the CPU.

From seeded numpy inputs, with each tolerance stated beside its check:

- ``to_small_gray``: equal, except pixels whose pooled mean lies within
  2^-10 of an integer: there the floor before the equalization may differ
  with the order in which the block's float32 sum is taken (torch and XLA
  reduce in different orders); the count is printed;
- ``mesh_block_flow``: the SSD of every cell and offset and its argmin
  exact (integer terms, sums below 2^24, so exact in any order; held
  against an int64 numpy SSD), the flow within 1e-5 of JAX's;
- ``ransac_pairs`` equal to ``jax.random.randint(PRNGKey(fid), (128, 2), 0,
  n)`` for several frame ids and n in {256, 100}: pinned to the installed
  JAX, 0.9.0, whose ``jax_threefry_partitionable`` is True;
- ``ransac_similarity`` on those draws: the same hypothesis and inlier
  ratio (exact), the warp's linear part within 1e-5 and its translation
  within 4 float32 ulps of the points' largest coordinate (it is the
  difference of two weighted means of magnitude ~1e3, each summed in
  another order: 2.4e-4 px at 1000 px; measured 1-3 ulps);
- ``estimate_camera_motion`` (warp as above, ratio exact) and
  ``apply_warp_to_tracks`` (means and covariances within 1e-5 relative:
  JAX takes the determinant from LU and the products through dots);
- ``tracker.step`` with a warp: ids and integer state exact, Kalman states
  within the tracker test's tolerances (atol 1e-3, rtol 1e-4); with the
  warp off, bit for bit the step without one;
- the moving-camera config, in its single-backbone form at a small size,
  through ``OCSORTDisparity.track_raw`` over frames of a panning camera:
  ids exact against the JAX ``track_raw`` (the tolerances of
  ``tests/test_torch_port_configs.py`` for the rest), the device warp
  applied; the same through ``track`` and with ``backend='opencv'`` (both
  packages call the same OpenCV chain); the CMC step reads nothing back
  to the host; ``MultiStreamTracker`` refuses a CMC config.
"""
import functools
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereotracking_tpu.apis.builder import build_model as j_build_model
from stereotracking_tpu.models import tracker as jt
from stereotracking_tpu.ops import gmc as J
from stereotracking_tpu_torch.apis.builder import (build_model,
                                                   build_mot_config)
from stereotracking_tpu_torch.models import tracker as tt
from stereotracking_tpu_torch.ops import gmc as T
from stereotracking_tpu_torch.utils.convert import flax_to_state_dict
from test_torch_port_configs import (HEAD_BIAS, assert_results_equal,
                                     random_variables, small_cfg)
from test_torch_port_tracker import CFG, TCFG, _frames

REPO = Path(__file__).parent.parent
CMC = REPO / 'configs/mot/ocsort/yolox_s_ocsort_monocular_cmc.py'
FIDS = (0, 1, 2, 17, 1000, 2 ** 31 - 1)


@pytest.fixture(autouse=True, scope='module')
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def textured(rng, h, w, block=4):
    """A blocky random texture (matchable), (h, w) float in 0-255."""
    base = rng.randint(0, 256, (h // block + 1, w // block + 1))
    return np.kron(base, np.ones((block, block)))[:h, :w].astype(np.float32)


def pan(rng, n, h, w, step=(3, -2)):
    """n uint8 BGR frames of a camera panning over a textured canvas by
    ``step`` (dy, dx) pixels a frame."""
    canvas = np.stack([textured(rng, h + 64, w + 64, 8)] * 3, -1)
    canvas[..., 1] = np.roll(canvas[..., 1], 5, 0)
    out = []
    for f in range(n):
        y, x = 32 + step[0] * f, 32 + step[1] * f
        out.append(canvas[y:y + h, x:x + w].astype(np.uint8))
    return out


# ----------------------------------------------------------------- gray ----

def test_to_small_gray_equals_jax():
    rng = np.random.RandomState(0)
    img = rng.randint(0, 256, (3, 300, 530, 3)).astype(np.uint8)
    img[2] = img[2] // 4           # a dark frame: equalization stretches
    got = T.to_small_gray(torch.from_numpy(img), 64).numpy()
    assert got.shape == (3, 64, 64) and got.dtype == np.float32
    # the pooled means, to find the pixels near an integer
    x = img.astype(np.float64)
    gray = 0.114 * x[..., 0] + 0.587 * x[..., 1] + 0.299 * x[..., 2]
    gray = np.pad(gray, ((0, 0), (0, 320 - 300), (0, 576 - 530)), 'edge')
    pooled = gray.reshape(3, 64, 5, 64, 9).mean((2, 4))
    near = np.abs(pooled - np.round(pooled)) < 2 ** -10
    n_diff = 0
    for s in range(3):
        want = np.asarray(J.to_small_gray(jnp.asarray(img[s], jnp.float32),
                                          64))
        np.testing.assert_array_equal(got[s][~near[s]], want[~near[s]])
        n_diff += int((got[s] != want).sum())
    print(f'to_small_gray: {n_diff} of {got.size} pixels differ, '
          f'{int(near.sum())} pooled means within 2^-10 of an integer')
    assert (got == np.round(got)).all() and got.min() >= 0 \
        and got.max() <= 255


# ----------------------------------------------------------------- flow ----

def test_mesh_block_flow_equals_jax():
    rng = np.random.RandomState(1)
    prev = np.stack([textured(rng, 128, 128) for _ in range(2)])
    curr = np.stack([np.roll(prev[0], (3, -5), (0, 1)),
                     rng.randint(0, 256, (128, 128)).astype(np.float32)])
    step, search = 16, 8
    ssd = T.block_ssd(torch.from_numpy(prev), torch.from_numpy(curr), step,
                      search).numpy()
    # int64 reference: every offset, edge padding
    g, n_off = 128 // step, 2 * search + 1
    want = np.zeros((2, n_off, n_off, g, g), np.int64)
    for s in range(2):
        pad = np.pad(curr[s].astype(np.int64), search, 'edge')
        cells = prev[s].astype(np.int64).reshape(g, step, g, step)
        for dy in range(n_off):
            for dx in range(n_off):
                sh = pad[dy:dy + 128, dx:dx + 128].reshape(g, step, g, step)
                want[s, dy, dx] = ((cells - sh) ** 2).sum((1, 3))
    np.testing.assert_array_equal(ssd, want.astype(np.float32))
    assert want.max() < 2 ** 24
    src, flow = T.mesh_block_flow(torch.from_numpy(prev),
                                  torch.from_numpy(curr), step, search)
    best = want.reshape(2, n_off * n_off, g, g).argmin(1)   # first index
    for s in range(2):
        js, jf = J.mesh_block_flow(jnp.asarray(prev[s]),
                                   jnp.asarray(curr[s]), step, search)
        np.testing.assert_array_equal(src.numpy(), np.asarray(js))
        np.testing.assert_allclose(flow[s].numpy(), np.asarray(jf),
                                   atol=1e-5, rtol=0)
        # the flow's integer part is the exact argmin (clamped rows aside)
        by, bx = best[s] // n_off, best[s] % n_off
        inner = (by > 0) & (by < n_off - 1) & (bx > 0) & (bx < n_off - 1)
        fx = flow[s].numpy()[:, 0].reshape(g, g) + search
        fy = flow[s].numpy()[:, 1].reshape(g, g) + search
        assert (np.abs(fx - bx)[inner] <= 0.5).all()
        assert (np.abs(fy - by)[inner] <= 0.5).all()
    # the shifted stream recovers the shift (the sub-pixel refinement of a
    # blocky texture moves each cell's flow by up to ~0.2 px)
    assert abs(np.median(flow[0, :, 0].numpy()) + 5) < 0.2
    assert abs(np.median(flow[0, :, 1].numpy()) - 3) < 0.2


# ---------------------------------------------------------------- draws ----

@pytest.mark.parametrize('n', [256, 100])
def test_ransac_pairs_equal_jax_randint(n):
    assert jax.__version__ == '0.9.0'
    assert jax.config.jax_threefry_partitionable
    got = T.ransac_pairs(torch.tensor(FIDS, dtype=torch.int32), 128, n)
    assert got.shape == (len(FIDS), 128, 2) and got.dtype == torch.int64
    for k, fid in enumerate(FIDS):
        want = np.asarray(jax.random.randint(jax.random.PRNGKey(fid),
                                             (128, 2), 0, n))
        np.testing.assert_array_equal(got[k].numpy(), want)


def assert_warp_close(got, want, pts):
    """Linear part within 1e-5; translation within 4 float32 ulps of the
    largest coordinate of ``pts`` (see the module docstring)."""
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got[:, :2], want[:, :2], atol=1e-5, rtol=0)
    ulp = np.spacing(np.float32(np.abs(pts).max()))
    np.testing.assert_allclose(got[:, 2], want[:, 2], atol=4 * ulp, rtol=0)


def _points(seed, n=256, outliers=5):
    rng = np.random.RandomState(seed)
    src = rng.uniform(0, 1900, (n, 2)).astype(np.float32)
    theta, sc, t = 0.03 * (seed - 2), 1.0 + 0.01 * seed, [9.0, -4.5]
    R = sc * np.array([[np.cos(theta), -np.sin(theta)],
                       [np.sin(theta), np.cos(theta)]])
    dst = (src @ R.T + t + rng.normal(0, 0.5, (n, 2))).astype(np.float32)
    dst[::outliers] += rng.uniform(30, 90, dst[::outliers].shape)
    return src, dst


def test_ransac_similarity_equals_jax():
    fids = (3, 4, 9)
    pts = [_points(s) for s in range(len(fids))]
    src = torch.from_numpy(np.stack([p[0] for p in pts]))
    dst = torch.from_numpy(np.stack([p[1] for p in pts]))
    pairs = T.ransac_pairs(torch.tensor(fids), 128, 256)
    H, ratio = T.ransac_similarity(src, dst, pairs, 5.0)
    for k, fid in enumerate(fids):
        jh, jr = J.ransac_similarity(jnp.asarray(pts[k][0]),
                                     jnp.asarray(pts[k][1]),
                                     jax.random.PRNGKey(fid), 128, 5.0)
        assert_warp_close(H[k], jh, pts[k])
        assert float(ratio[k]) == float(jr)
        assert 0.7 < float(jr) < 0.85          # the 20% outliers left out


def test_estimate_camera_motion_equals_jax():
    rng = np.random.RandomState(5)
    a = T.to_small_gray(torch.from_numpy(np.stack(pan(rng, 2, 540, 960))),
                        256)
    prev, curr = a[:1].expand(2, -1, -1), a[1:].expand(2, -1, -1)
    curr = torch.stack([curr[0], a[0]])        # stream 1: no motion
    fids = torch.tensor([1, 7])
    H, ratio = T.estimate_camera_motion(prev.contiguous(), curr, 540, 960,
                                        fids, T.GMCConfig())
    for s in range(2):
        jh, jr = J.estimate_camera_motion(
            jnp.asarray(prev[s].numpy()), jnp.asarray(curr[s].numpy()), 540,
            960, jax.random.PRNGKey(int(fids[s])), J.GMCConfig())
        assert_warp_close(H[s], jh, [540, 960])
        assert float(ratio[s]) == float(jr) and float(jr) > 0.5
    # the pan is (dy, dx) = (3, -2) px a frame: content moves by (-3, +2);
    # recovered within the JAX test's bound, 2.5 px (tests/test_gmc.py)
    np.testing.assert_allclose(H[0, :, 2].numpy(), [2.0, -3.0], atol=2.5)
    # no motion: the identity within the JAX test's bounds (linear part
    # 0.05, translation 2.5 px)
    np.testing.assert_allclose(H[:, :, :2].numpy(), np.stack([np.eye(2)] * 2),
                               atol=0.05)
    np.testing.assert_allclose(H[1, :, 2].numpy(), [0.0, 0.0], atol=2.5)


def test_apply_warp_to_tracks_equals_jax():
    rng = np.random.RandomState(3)
    mean = (rng.rand(2, 6, 8) * 100).astype(np.float32)
    a = rng.randn(2, 6, 8, 8).astype(np.float32)
    cov = a @ a.transpose(0, 1, 3, 2) + np.eye(8, dtype=np.float32)
    warps = []
    for theta, sc, t in ((0.1, 1.1, (3.0, 4.0)), (-0.05, 0.97, (-8, 1))):
        R = sc * np.array([[np.cos(theta), -np.sin(theta)],
                           [np.sin(theta), np.cos(theta)]])
        warps.append(np.concatenate([R, np.array(t)[:, None]], 1))
    warps = np.stack(warps).astype(np.float32)
    mask = rng.rand(2, 6) < 0.6
    nm, nc = T.apply_warp_to_tracks(*(torch.from_numpy(x) for x in
                                      (mean, cov, warps, mask)))
    for s in range(2):
        jm, jc = J.apply_warp_to_tracks(*(jnp.asarray(x[s]) for x in
                                          (mean, cov, warps, mask)))
        np.testing.assert_allclose(nm[s].numpy(), np.asarray(jm), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(nc[s].numpy(), np.asarray(jc), rtol=1e-5,
                                   atol=1e-4)
        off = ~mask[s]
        assert np.array_equal(nm[s].numpy()[off], mean[s][off])
        assert np.array_equal(nc[s].numpy()[off], cov[s][off])


# -------------------------------------------------------------- tracker ----

def test_tracker_step_with_warp_equals_jax():
    """A panning warp every frame from frame 1: ids and integer state
    exact, Kalman states within the tracker test's tolerances; the warp's
    mask off gives the step without a warp, bit for bit."""
    j_step = jax.jit(functools.partial(jt.step, cfg=CFG))
    js = jt.init_state(CFG)
    ts = tt.init_state(TCFG)
    bare = tt.init_state(TCFG)
    for f, d in enumerate(_frames()):
        jdet = jt.Detections(**{k: jnp.asarray(v) for k, v in d.items()})
        tdet = tt.Detections(**{k: torch.from_numpy(v) for k, v in d.items()})
        th = 0.01 * f
        warp = np.array([[np.cos(th), -np.sin(th), 2.0 + f],
                         [np.sin(th), np.cos(th), -1.0]], np.float32)
        js, jo = j_step(js, jdet, jnp.int32(f), warp=jnp.asarray(warp))
        ts, to = tt.step(ts, tdet, f, TCFG, torch.from_numpy(warp),
                         torch.tensor(True))
        np.testing.assert_array_equal(to.ids.numpy(), np.asarray(jo.ids))
        np.testing.assert_array_equal(to.valid.numpy(), np.asarray(jo.valid))
        live = np.asarray(js.active)
        for name in jt.TrackState._fields:
            a, b = np.asarray(getattr(js, name)), getattr(ts, name).numpy()
            if a.dtype.kind in 'biu':
                np.testing.assert_array_equal(b, a, err_msg=f'{f} {name}')
            else:
                np.testing.assert_allclose(b[live], a[live], atol=1e-3,
                                           rtol=1e-4, err_msg=f'{f} {name}')
        # the warp off: the same step as without one
        off, off_out = tt.step(bare, tdet, f, TCFG, torch.from_numpy(warp),
                               torch.tensor(False))
        bare, bare_out = tt.step(bare, tdet, f, TCFG)
        for x, y in zip((*off, *off_out), (*bare, *bare_out)):
            assert torch.equal(x, y) or (x.isnan() == y.isnan()).all() and \
                torch.equal(x.nan_to_num(), y.nan_to_num())


# ---------------------------------------------------------------- model ----

H, W = 128, 128
N_FRAMES = 4
SMALL = 64        # the gray's side at this size (the config's 256 / 4)


@pytest.fixture(scope='module')
def single_variables():
    return random_variables('single', seed=1, head_bias=HEAD_BIAS)


def _cmc_cfg(backend='device', size=SMALL):
    cfg = small_cfg(CMC)
    cfg['model']['cmc'].update(backend=backend, size=size)
    return cfg


def _camera_frames():
    rng = np.random.RandomState(7)
    imgs = pan(rng, N_FRAMES, H, W, step=(2, -3))
    disp = rng.randint(16, 1600, (H, W)).astype(np.uint16)
    return [(img, disp) for img in imgs]


def test_cmc_config_builds():
    mot = build_mot_config(small_cfg(CMC)['model'], 'cpu')
    assert mot.cmc == T.GMCConfig(backend='device', step=16, search=8,
                                  ransac_iters=128, ransac_thr=5.0,
                                  min_inlier_ratio=0.3)
    assert mot.detector.backbone == 'single'
    with pytest.raises(NotImplementedError, match='camera-motion'):
        from stereotracking_tpu_torch.parallel.multistream import \
            MultiStreamTracker
        MultiStreamTracker(mot, 2, device='cpu')


@pytest.mark.parametrize('entry', ['track_raw', 'track'])
def test_cmc_config_tracks_as_jax(single_variables, entry):
    """The moving-camera config over 4 frames of a panning camera, then 2
    more from frame 0: every
    frame's result as JAX's (ids exact), the warp applied from frame 1 on
    (recovered within the JAX test's 2.5 px of the pan), the state reset
    by frame 0."""
    v = single_variables
    cfg = _cmc_cfg()
    jm = j_build_model(cfg, variables=v, input_shape=(H, W))
    assert jm.cfg.cmc is not None
    tm = build_model(cfg, device='cpu')
    tm.module.load_state_dict(flax_to_state_dict(v))
    from stereotracking_tpu.models.preprocessor import \
        preprocess_frame as j_pre
    from stereotracking_tpu_torch.models.preprocessor import \
        preprocess_frame_pure as t_pre
    frames = _camera_frames()
    ids = set()
    for rep, run in enumerate((frames, frames[:2])):   # restart at 0
        for f, (img, disp) in enumerate(run):
            if entry == 'track_raw':
                rt = tm.track_raw(img, disp, f)
                rj = jm.track_raw(img, disp, f)
            else:
                jin = j_pre(jnp.asarray(img), jnp.asarray(disp), H, W)
                rj = jm.track(jin, f)
                tin = t_pre(torch.from_numpy(img)[None],
                            torch.from_numpy(disp)[None], H, W)
                rt = tm.track(tin, f)
            assert_results_equal(rt, rj, f'{entry} {rep} frame {f}')
            ids |= set(rt.track_ids.numpy()[rt.track_valid.numpy()].tolist())
            assert bool(tm.cmc.has_prev[0])
    assert len(ids - {-1}) >= 1
    # the last frame's warp, recomputed: the pan (dy, dx) = (2, -3)
    prev = T.to_small_gray(torch.from_numpy(frames[-2][0])[None], SMALL)
    curr = T.to_small_gray(torch.from_numpy(frames[-1][0])[None], SMALL)
    Hw, ratio = T.estimate_camera_motion(prev, curr, H, W,
                                         torch.tensor([N_FRAMES - 1]),
                                         tm.cfg.cmc)
    assert float(ratio[0]) >= 0.3
    np.testing.assert_allclose(Hw[0, :, 2].numpy(), [3.0, -2.0], atol=2.5)


def test_cmc_opencv_backend_tracks_as_jax(single_variables):
    pytest.importorskip('cv2')
    v = single_variables
    cfg = _cmc_cfg('opencv')
    jm = j_build_model(cfg, variables=v, input_shape=(H, W))
    tm = build_model(cfg, device='cpu')
    tm.module.load_state_dict(flax_to_state_dict(v))
    assert tm.cmc is None
    for f, (img, disp) in enumerate(_camera_frames()[:3]):
        assert_results_equal(tm.track_raw(img, disp, f),
                             jm.track_raw(img, disp, f), f'opencv {f}')
    with pytest.raises(ValueError, match='host frame ids'):
        tm.track_raw(img, disp, torch.tensor(3))


def test_cmc_step_reads_nothing_back(monkeypatch):
    """The camera-motion chain inside the raw-frame step (gray,
    histogram, block matching, the draws, RANSAC, the warp of the states)
    with tensor frame ids: no tensor value read back to the host."""
    from test_torch_port_device_step import _HostReads
    from stereotracking_tpu_torch.ops import (assignment_cuda, depth_cuda,
                                              nms_cuda)
    model = build_model(_cmc_cfg(), device='cpu', seed=2)
    frames = _camera_frames()[:3]
    guard = _HostReads(monkeypatch)
    guard.allow(monkeypatch, assignment_cuda, 'jv_assign_plain')
    guard.allow(monkeypatch, nms_cuda, 'nms_keep_plain')
    guard.allow(monkeypatch, depth_cuda, 'box_depths_plain')
    fid0 = torch.zeros((), dtype=torch.int32)
    for f, (img, disp) in enumerate(frames):
        model.track_raw(torch.from_numpy(img), torch.from_numpy(disp),
                        fid0 + f)
    with pytest.raises(AssertionError, match='host read'):
        bool(model.cmc.has_prev[0])
