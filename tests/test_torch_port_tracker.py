"""OC-SORT tracker step of the PyTorch port against the JAX package.

Synthetic detections over a dozen frames (objects moving, dropping out for
a few frames and coming back, new objects appearing, low-score ones) go
through JAX ``tracker.step`` and the port's ``step``.  Track ids, validity
and every integer or boolean field of the state must match exactly; boxes
and Kalman states within float32 tolerance (atol 1e-3 px on coordinates
of order 100, the Cholesky solves differing between LAPACK and XLA).
"""
from functools import partial

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from stereotracking_tpu.apis.builder import build_mot_config as j_build_cfg
from stereotracking_tpu.config import load_config
from stereotracking_tpu.models import tracker as jt
from stereotracking_tpu_torch.apis.builder import build_mot_config
from stereotracking_tpu_torch.models import tracker as tt

CFG = jt.TrackerConfig(num_slots=16, num_dets=16,
                       weight_iou_with_det_scores=False, match_iou_thr=0.1,
                       num_frames_retain=30)
TCFG = tt.TrackerConfig(**CFG._asdict())


@pytest.fixture(autouse=True, scope='module')
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _frames(n_frames=12, nd=16, seed=0):
    rng = np.random.RandomState(seed)
    n_obj = 9
    pos = rng.uniform(50, 400, (n_obj, 2))
    vel = rng.uniform(-6, 6, (n_obj, 2))
    size = rng.uniform(15, 40, (n_obj, 2))
    score = rng.uniform(0.75, 0.95, n_obj)
    score[7] = 0.5                    # tracked only once matched
    out = []
    for f in range(n_frames):
        boxes = np.zeros((nd, 4), np.float32)
        valid = np.zeros(nd, bool)
        scores = np.zeros(nd, np.float32)
        k = 0
        for o in range(n_obj):
            if o == 3 and 4 <= f < 7:        # drops out, comes back
                continue
            if o == 8 and f < 5:             # appears later
                continue
            c = pos[o] + vel[o] * f + rng.normal(0, 0.7, 2)
            boxes[k] = [c[0], c[1], c[0] + size[o, 0], c[1] + size[o, 1]]
            scores[k] = score[o]
            valid[k] = True
            k += 1
        depths = rng.uniform(5, 60, nd).astype(np.float32)
        scales = np.clip(depths / 40.0, 1.0, 3.0).astype(np.float32)
        out.append(dict(bboxes=boxes, scores=scores,
                        labels=np.zeros(nd, np.int32), scales=scales,
                        depths=depths, valid=valid))
    return out


def test_tracker_steps_match_jax():
    j_step = jax.jit(partial(jt.step, cfg=CFG))
    js = jt.init_state(CFG)
    ts = tt.init_state(TCFG)
    n_ids = 0
    for f, d in enumerate(_frames()):
        jdet = jt.Detections(**{k: jnp.asarray(v) for k, v in d.items()})
        tdet = tt.Detections(**{k: torch.from_numpy(v) for k, v in d.items()})
        js, jo = j_step(js, jdet, jnp.int32(f))
        ts, to = tt.step(ts, tdet, f, TCFG)
        np.testing.assert_array_equal(to.ids.numpy(), np.asarray(jo.ids))
        np.testing.assert_array_equal(to.valid.numpy(), np.asarray(jo.valid))
        for name in jt.TrackState._fields:
            a, b = np.asarray(getattr(js, name)), getattr(ts, name).numpy()
            if a.dtype.kind in 'biu':
                np.testing.assert_array_equal(b, a, err_msg=f'{f} {name}')
            else:
                live = np.asarray(js.active)
                np.testing.assert_allclose(b[live], a[live], atol=1e-3,
                                           rtol=1e-4, err_msg=f'{f} {name}')
        n_ids = max(n_ids, int(np.asarray(jo.ids).max()) + 1)
    assert n_ids >= 9                # every object got an id


def test_reuse_det_depth_is_set_explicitly():
    """Its default is True in both packages' MOTConfig, but the flagship
    config sets False; the builders of both packages must carry the config
    file's value, and the port's parity tests set it on both sides."""
    from stereotracking_tpu.models.mot import MOTConfig as JMOT
    from stereotracking_tpu_torch.models.mot import MOTConfig
    assert JMOT().reuse_det_depth is True and MOTConfig().reuse_det_depth
    cfg = load_config(
        'configs/stereo_tracking/ocsort/yolox_s_airdrone_disp.py')
    assert cfg['model']['reuse_det_depth'] is False
    assert build_mot_config(cfg['model'],
                            device='cpu').reuse_det_depth is False
    assert j_build_cfg(cfg['model']).reuse_det_depth is False
    cfg['model']['reuse_det_depth'] = True
    assert build_mot_config(cfg['model'],
                            device='cpu').reuse_det_depth is True
