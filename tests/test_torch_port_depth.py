"""Per-box depth of the PyTorch port against the JAX package.

The port's depth runs through ``depth_cuda.box_depths``, whose plain
version runs here.  It is held against the JAX XLA path
``extract_box_depths_disp`` on many boxes (integer decisions exact, so the
-1 pattern must match; depths within float32 reassociation: rtol 2e-6,
atol 1e-5, as tests/test_depth_pallas.py holds the Pallas kernel), and its
raw statistics row against the Pallas kernel (interpret mode) on one small
case: every integer exact.  The plain composite that the CUDA kernel is
held to on the card (``box_depths_plain``: box scalars, statistics, corner
vote with its fixed order of the four corner additions) is held against
the Pallas path ``extract_box_depths_disp_pallas`` on the edge cases.
"""
import numpy as np
import pytest

import jax.numpy as jnp
import torch

from stereotracking_tpu.ops import depth_pallas as jdp
from stereotracking_tpu.ops.depth import disp_to_depth as j_d2d
from stereotracking_tpu.ops.depth import extract_box_depths as j_float
from stereotracking_tpu.ops.depth import extract_box_depths_disp as j_disp
from stereotracking_tpu_torch.ops import depth_cuda
from stereotracking_tpu_torch.ops.depth import (disp_to_depth,
                                                extract_box_depths,
                                                extract_box_depths_disp)

BASELINE, FOCAL = 0.25, 640.0


@pytest.fixture(autouse=True, scope='module')
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _world(seed, h, w, n, max_size=120):
    rng = np.random.RandomState(seed)
    disp = rng.randint(0, 1600, (h, w)).astype(np.float32) / 16.0
    disp[rng.rand(h, w) < 0.1] = 0.0
    boxes = rng.uniform(-20, max(h, w) + 20, (n, 4)).astype(np.float32)
    sizes = rng.uniform(1, max_size, (n, 2)).astype(np.float32)
    boxes[:, 2:] = boxes[:, :2] + sizes
    return disp, boxes, rng.rand(n) > 0.15


EDGE_BOXES = np.array([
    [-30, -30, -5, -5], [-10, -10, 40, 40], [250, 150, 300, 220],
    [279, 199, 400, 400], [50, 50, 50, 80], [50, 50, 900, 120],
    [10, 10, 12, 12], [0, 0, 280, 200], [30, 30, 31, 31]], np.float32)


def _worlds():
    yield _world(0, 240, 320, 64, 60) + (64,)
    yield _world(1, 400, 512, 64, 500) + (32,)       # pyramid levels 0-3
    yield _world(2, 200, 280, 64, 300) + (96,)
    d, _, _ = _world(3, 200, 280, 1)
    yield d, EDGE_BOXES, np.ones(len(EDGE_BOXES), bool), 32


def _close(t, j):
    t, j = t.numpy(), np.asarray(j)
    np.testing.assert_array_equal(t == -1.0, j == -1.0)
    np.testing.assert_allclose(t, j, rtol=2e-6, atol=1e-5)


@pytest.mark.parametrize('case', range(4))
def test_disp_depth_matches_jax_xla(case):
    disp, boxes, valid, crop = list(_worlds())[case]
    jd, js = j_disp(jnp.asarray(disp), jnp.asarray(boxes),
                    jnp.asarray(valid), BASELINE, FOCAL, crop)
    td, ts = extract_box_depths_disp(
        torch.from_numpy(disp), torch.from_numpy(boxes),
        torch.from_numpy(valid), BASELINE, FOCAL, crop)
    _close(td, jd)
    _close(ts, js)


@pytest.mark.parametrize('case', range(4))
def test_float_depth_matches_jax_xla(case):
    """The float path (GT-depth column) on the metric depth map."""
    disp, boxes, valid, crop = list(_worlds())[case]
    dm = disp_to_depth(torch.from_numpy(disp), BASELINE, FOCAL)
    np.testing.assert_array_equal(
        dm.numpy(), np.asarray(j_d2d(jnp.asarray(disp), BASELINE, FOCAL)))
    jd, js = j_float(jnp.asarray(dm.numpy()), jnp.asarray(boxes),
                     jnp.asarray(valid), crop)
    td, ts = extract_box_depths(dm, torch.from_numpy(boxes),
                                torch.from_numpy(valid), crop)
    _close(td, jd)
    _close(ts, js)


def test_all_invalid_window():
    disp = torch.zeros((160, 240))
    d, s = extract_box_depths_disp(disp, torch.tensor([[20., 20., 60., 60.]]),
                                   torch.ones(1, dtype=torch.bool), BASELINE,
                                   FOCAL, 32)
    assert float(d[0]) == -1.0 and float(s[0]) == 1.0


def test_stats_row_matches_pallas_kernel():
    """The 24-float statistics row against the Pallas kernel: n, the eight
    rank values and the seven counts exact; the float32 sums within
    rtol 1e-6 (reassociation)."""
    h, w, crop = 64, 96, 32
    disp, boxes, _ = _world(7, h, w, 8, 60)
    boxes[0] = [2, 3, 90, 60]                   # a level-2 window
    bf = BASELINE * FOCAL
    rmin = depth_cuda.depth_rmin(bf)
    scal_j = jdp._prep_scalars(jnp.asarray(boxes), h, w, crop,
                               jnp.int32(rmin))
    scal_j = jnp.concatenate(
        [jnp.zeros((len(boxes), 1), jnp.int32), scal_j], 1)
    ref = np.asarray(jdp._stats_pallas(jnp.asarray(disp)[None], scal_j,
                                       bf=bf, crop=crop, interpret=True))
    scal = depth_cuda.box_scalars(torch.from_numpy(boxes)[None], crop, rmin,
                                  h, w)
    np.testing.assert_array_equal(scal[:, 0].numpy(), np.asarray(scal_j[:, 1]))
    out = depth_cuda.box_depth_stats_plain(torch.from_numpy(disp)[None],
                                           scal, crop, bf).numpy()
    assert out.shape == (len(boxes), 24)
    np.testing.assert_array_equal(out[:, :16], ref[:, :16])
    np.testing.assert_allclose(out[:, 16:23], ref[:, 16:23], rtol=1e-6,
                               atol=1e-3)
    assert (out[:, 0] > 0).sum() >= 4


def _edge_case_world():
    """A 96 x 160 map with a zero (n = 0) and an all-equal region, and
    boxes at every pyramid level of crops 32 and 96, with n = 0, 1 and 2, on the
    equal region, leaving the frame, wider than 800 px, and NaN ones
    flagged invalid (empty tracker slots)."""
    rng = np.random.RandomState(21)
    disp = rng.randint(16, 1600, (96, 160)).astype(np.float32) / 16.0
    disp[::4] = 0.0
    disp[60:80, 100:130] = 0.0
    disp[20:40, 60:100] = 25.0
    nan = np.nan
    boxes = np.array([
        [3, 4, 40, 30], [10, 10, 150, 90], [5, 5, 20, 20], [20, 20, 90, 70],
        [-5, 0, 9, 9], [100, 50, 100, 70], [140, 80, 300, 200],
        [0, 0, 160, 96], [102, 62, 125, 78], [50, 50, 51, 51],
        [50, 50, 52, 51], [64, 22, 96, 38], [10, 10, 850, 40],
        [nan, nan, nan, nan], [nan, 10, nan, 40], [7.6, 9.2, 61.9, 44.5],
        [2, 3, 250, 90]],
        np.float32)
    return disp, boxes, np.isfinite(boxes).all(1)


@pytest.mark.parametrize('crop', [32, 96])
def test_plain_composite_matches_pallas(crop):
    """``box_depths_plain`` against the Pallas path (interpret mode):
    statistics rows against ``_stats_pallas`` with every integer exact and
    the sums within rtol 1e-6; depths and scales within rtol 2e-6, atol
    1e-5 of ``extract_box_depths_disp_pallas``, the -1 pattern exact."""
    disp, boxes, valid = _edge_case_world()
    h, w = disp.shape
    bf = BASELINE * FOCAL
    jd, js = jdp.extract_box_depths_disp_pallas(
        jnp.asarray(disp), jnp.asarray(boxes), jnp.asarray(valid), BASELINE,
        FOCAL, crop, interpret=True)
    td, ts, stats = depth_cuda.box_depths_plain(
        torch.from_numpy(disp)[None], torch.from_numpy(boxes)[None],
        torch.from_numpy(valid)[None], crop, bf)
    _close(td[0], jd)
    _close(ts[0], js)
    rmin = depth_cuda.depth_rmin(bf)
    scal_j = jdp._prep_scalars(jnp.asarray(boxes), h, w, crop,
                               jnp.int32(rmin))
    scal_j = jnp.concatenate(
        [jnp.zeros((len(boxes), 1), jnp.int32), scal_j], 1)
    ref = np.asarray(jdp._stats_pallas(jnp.asarray(disp)[None], scal_j,
                                       bf=bf, crop=crop, interpret=True))
    out = stats.numpy()
    np.testing.assert_array_equal(out[:, :16], ref[:, :16])
    np.testing.assert_allclose(out[:, 16:23], ref[:, 16:23], rtol=1e-6,
                               atol=1e-3)
    assert {0, 1, 2} <= set(out[:, 0].astype(int).tolist())
    levels = depth_cuda.box_scalars(torch.from_numpy(boxes)[None], crop,
                                    rmin, h, w)[:, 0]
    assert set(levels.tolist()) == {0, 1, 2, 3}
    assert (td > 0).sum() >= 6
