"""Building blocks of the PyTorch port against the JAX package.

bbox geometry, the raw-frame preprocess, the Kalman filter, the
cost-limited assignment, NMS and the depth threshold: the same numpy inputs
through both packages.  Integer and boolean outputs must match exactly.
Also: importing the port never imports jax or flax.
"""
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from stereotracking_tpu.models import kalman as jk
from stereotracking_tpu.models.preprocessor import \
    preprocess_frame_pure as j_prep
from stereotracking_tpu.ops.assignment import \
    linear_assignment_with_limit as j_lap
from stereotracking_tpu.ops.depth import MAX_DEPTH
from stereotracking_tpu.ops.nms import batched_nms as j_nms
from stereotracking_tpu.structures import bbox as jb
from stereotracking_tpu_torch.models import kalman as tk
from stereotracking_tpu_torch.models.preprocessor import (
    padded_shape, preprocess_frame_pure)
from stereotracking_tpu_torch.ops.assignment import (
    linear_assignment_with_limit, solve_square_lap)
from stereotracking_tpu_torch.ops.depth_cuda import depth_rmin, f_depth
from stereotracking_tpu_torch.ops.nms import batched_nms
from stereotracking_tpu_torch.structures import bbox as tb

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True, scope='module')
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _boxes(rng, n):
    xy = rng.uniform(0, 200, (n, 2)).astype(np.float32)
    wh = rng.uniform(1, 60, (n, 2)).astype(np.float32)
    return np.concatenate([xy, xy + wh], 1)


def test_bbox_geometry_matches_jax():
    """Same float32 operations in the same order: rtol 1e-6."""
    rng = np.random.RandomState(0)
    a, b = _boxes(rng, 17), _boxes(rng, 11)
    s = rng.uniform(0.5, 2, 17).astype(np.float32)
    pairs = [
        (jb.bbox_xyxy_to_cxcyah(a),
         tb.bbox_xyxy_to_cxcyah(torch.from_numpy(a))),
        (jb.bbox_cxcyah_to_xyxy(a),
         tb.bbox_cxcyah_to_xyxy(torch.from_numpy(a))),
        (jb.scale_bbox(a, s), tb.scale_bbox(torch.from_numpy(a),
                                            torch.from_numpy(s))),
        (jb.bbox_area(a), tb.bbox_area(torch.from_numpy(a))),
        (jb.bbox_iou_matrix(a, b), tb.bbox_iou_matrix(torch.from_numpy(a),
                                                      torch.from_numpy(b))),
    ]
    for j, t in pairs:
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-6,
                                   atol=1e-6)


def test_zero_height_box_gives_inf_aspect_like_jax():
    box = np.array([[10, 10, 20, 10]], np.float32)
    j = np.asarray(jb.bbox_xyxy_to_cxcyah(box))
    t = tb.bbox_xyxy_to_cxcyah(torch.from_numpy(box)).numpy()
    np.testing.assert_array_equal(t, j)


def test_preprocess_matches_jax_exactly():
    rng = np.random.RandomState(1)
    img = rng.randint(0, 256, (50, 70, 3)).astype(np.uint8)
    disp = rng.randint(0, 65536, (50, 70)).astype(np.uint16)
    disp[::7] = 65535
    depth = rng.uniform(0, 100, (50, 70)).astype(np.float32)
    oh, ow = padded_shape(50, 70)
    assert (oh, ow) == (64, 96)
    j = j_prep(jnp.asarray(img), jnp.asarray(disp), oh, ow,
               jnp.asarray(depth))
    t = preprocess_frame_pure(torch.from_numpy(img), torch.from_numpy(disp),
                              oh, ow, torch.from_numpy(depth))
    assert set(j) == set(t)
    for k in j:
        np.testing.assert_array_equal(t[k].numpy(), np.asarray(j[k]),
                                      err_msg=k)


def test_kalman_matches_jax():
    """float32 filter; the Cholesky solve differs in LAPACK vs XLA, so
    rtol 1e-4 / atol 1e-4 (relative to covariances of order 1-100)."""
    rng = np.random.RandomState(2)
    meas = np.concatenate([rng.uniform(0, 500, (8, 2)),
                           rng.uniform(0.3, 3, (8, 1)),
                           rng.uniform(5, 80, (8, 1))], 1).astype(np.float32)
    jm, jc = jk.initiate(jnp.asarray(meas))
    tm, tc = tk.initiate(torch.from_numpy(meas))
    for _ in range(3):
        jm, jc = jk.predict(jm, jc)
        tm, tc = tk.predict(tm, tc)
    z = meas + rng.normal(0, 2, meas.shape).astype(np.float32)
    jm, jc = jk.update(jm, jc, jnp.asarray(z))
    tm, tc = tk.update(tm, tc, torch.from_numpy(z))
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-4,
                               atol=1e-4)
    gj = jk.gating_distance(jm[0], jc[0], jnp.asarray(z))
    gt = tk.gating_distance(tm[0], tc[0], torch.from_numpy(z))
    np.testing.assert_allclose(gt.numpy(), np.asarray(gj), rtol=1e-3)
    for _ in range(50):                      # 50 predicts stay finite
        tm, tc = tk.predict(tm, tc)
    assert torch.isfinite(tm).all() and torch.isfinite(tc).all()


@pytest.mark.parametrize('seed', range(6))
def test_assignment_matches_jax_exactly(seed):
    """Continuous random costs (no ties): row and column matches equal."""
    rng = np.random.RandomState(seed)
    k, n = 12, 9
    cost = rng.uniform(0, 1.2, (k, n)).astype(np.float32)
    # clustered near-identical rows force the JV path, not the fast paths
    cost[:4] = cost[0] + rng.uniform(0, 0.05, (4, n)).astype(np.float32)
    rm = rng.rand(k) > 0.2
    cm = rng.rand(n) > 0.2
    jr, jc = j_lap(jnp.asarray(cost), jnp.asarray(rm), jnp.asarray(cm), 0.9)
    tr, tc = linear_assignment_with_limit(
        torch.from_numpy(cost), torch.from_numpy(rm), torch.from_numpy(cm),
        0.9)
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))


def test_assignment_probes():
    """All rows masked (an empty tracker) and every cost above the limit:
    nothing matches."""
    cost = torch.rand(6, 5)
    r, c = linear_assignment_with_limit(cost, torch.zeros(6, dtype=bool),
                                        torch.ones(5, dtype=bool), 0.9)
    assert (r == -1).all() and (c == -1).all()
    r, c = linear_assignment_with_limit(cost + 1.0, torch.ones(6, dtype=bool),
                                        torch.ones(5, dtype=bool), 0.9)
    assert (r == -1).all() and (c == -1).all()


def test_square_lap_is_optimal():
    scipy_opt = pytest.importorskip('scipy.optimize')
    rng = np.random.RandomState(3)
    cost = rng.uniform(0, 10, (20, 20)).astype(np.float32)
    r2c, c2r = solve_square_lap(cost)
    ri, ci = scipy_opt.linear_sum_assignment(cost)
    assert np.isclose(cost[np.arange(20), r2c].sum(), cost[ri, ci].sum(),
                      rtol=1e-6)
    np.testing.assert_array_equal(c2r[r2c], np.arange(20))


def test_nms_keeps_jax_order_on_tied_scores():
    """Tied scores: a stable descending sort keeps index order, as
    jax.lax.top_k does; the kept set, slots and boxes must be identical."""
    rng = np.random.RandomState(4)
    n = 120
    boxes = _boxes(rng, n)
    boxes[1::2] = boxes[0::2] + 1.0           # overlapping pairs
    scores = np.round(rng.uniform(0, 1, n), 1).astype(np.float32)
    scores[1::2] = scores[0::2]                # each pair tied
    labels = rng.randint(0, 2, n).astype(np.int32)
    j = j_nms(jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(labels),
              0.5, 0.05, 64, 40)
    t = batched_nms(torch.from_numpy(boxes), torch.from_numpy(scores),
                    torch.from_numpy(labels), 0.5, 0.05, 64, 40)
    for a, b in zip(j, t):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


def test_depth_threshold_uses_exact_division():
    """rmin is the first raw disparity with 0 < depth < 150 under IEEE
    float32 division — the JAX path's own formula evaluated by XLA — and
    the depth formula on tensors divides, never multiplies by a
    reciprocal."""
    for bf in (160.0, 0.25 * 640, 0.12 * 721.5, 54.3):
        rr = jnp.arange(65536, dtype=jnp.float32)
        dd = np.asarray(jnp.float32(bf) / (rr / 16.0 + 1e-6))
        vr = (dd > 0.0) & (dd < MAX_DEPTH)
        assert depth_rmin(bf) == int(np.argmax(vr))
        t = f_depth(torch.arange(65536, dtype=torch.int32), bf).numpy()
        np.testing.assert_array_equal(t, dd)


def test_port_imports_no_jax():
    code = (
        'import sys, pkgutil, importlib\n'
        'import stereotracking_tpu_torch as p\n'
        'for m in pkgutil.walk_packages(p.__path__, p.__name__ + "."):\n'
        '    importlib.import_module(m.name)\n'
        'import stereotracking_tpu_torch.apis.builder\n'
        'import stereotracking_tpu_torch.models.mot\n'
        'bad = sorted(k for k in sys.modules\n'
        '             if k.split(".")[0] in ("jax", "flax", "jaxlib",\n'
        '                                    "stereotracking_tpu"))\n'
        'print(bad)\n'
        'assert not bad, bad\n')
    r = subprocess.run([sys.executable, '-c', code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
