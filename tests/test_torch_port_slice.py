"""The whole flagship slice: JAX ``OCSORTDisparity.track_raw`` against the
PyTorch port's ``build_model(...).track_raw``.

Both packages build the flagship config (cut to widen_factor 0.25 and
64x96 frames), both in float32 with their float32 backbone paths (JAX
'xla', the port 'torch': what 'auto' resolves to off the accelerator), the
port's weights carried over by the bridge.  The head's cls and obj biases
are raised on both sides so detections pass the tracker's gates.
``reuse_det_depth`` is set explicitly (the flagship's False), since its
default is True in both packages.  Four frames of a drifting scene:
track ids and validity exact; boxes within 1e-3 px, scores 1e-5, depths
rtol 1e-4 (float32 reassociation through the detector).
"""
import numpy as np
import pytest

import torch

from stereotracking_tpu.apis.builder import build_model as j_build_model
from stereotracking_tpu.config import load_config
from stereotracking_tpu_torch.apis.builder import build_model
from stereotracking_tpu_torch.models.csp_darknet import StageBackends
from test_torch_port_bridge import H, W, WIDEN, random_frame, random_variables

CONFIG = 'configs/stereo_tracking/ocsort/yolox_s_airdrone_disp.py'


@pytest.fixture(autouse=True, scope='module')
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg():
    cfg = load_config(CONFIG)
    cfg['model']['detector']['backbone']['widen_factor'] = WIDEN
    cfg['model']['reuse_det_depth'] = False
    return cfg


def test_track_raw_matches_jax_over_frames():
    variables = random_variables(seed=1, head_bias=3.0)
    jm = j_build_model(_cfg(), variables=variables, input_shape=(H, W))
    assert jm.cfg.reuse_det_depth is False and jm.cfg.stem_backend == 'xla'
    tm = build_model(_cfg(), device='cpu')
    assert tm.cfg.reuse_det_depth is False
    assert tm.cfg.backends == StageBackends()
    from stereotracking_tpu_torch.utils.convert import flax_to_state_dict
    tm.module.load_state_dict(flax_to_state_dict(variables))
    img0, disp0 = random_frame(11)
    ids_seen = set()
    for f in range(4):
        img, disp = np.roll(img0, 2 * f, axis=1), np.roll(disp0, 2 * f, 1)
        rj = jm.track_raw(img, disp, f)
        rt = tm.track_raw(img, disp, f)
        for name in ('det_valid', 'det_labels', 'track_ids', 'track_valid',
                     'track_labels'):
            np.testing.assert_array_equal(
                getattr(rt, name).numpy(), np.asarray(getattr(rj, name)),
                err_msg=f'frame {f} {name}')
        for name, tol in (('det_bboxes', 1e-3), ('track_bboxes', 1e-3),
                          ('det_scores', 1e-5), ('track_scores', 1e-5)):
            np.testing.assert_allclose(
                getattr(rt, name).numpy(), np.asarray(getattr(rj, name)),
                atol=tol, rtol=0, err_msg=f'frame {f} {name}')
        for name in ('track_depths', 'track_scales', 'track_gt_depths'):
            np.testing.assert_allclose(
                getattr(rt, name).numpy(), np.asarray(getattr(rj, name)),
                rtol=1e-4, atol=1e-4, err_msg=f'frame {f} {name}')
        valid = rt.track_valid.numpy()
        ids_seen |= set(rt.track_ids.numpy()[valid].tolist())
        assert np.isfinite(rt.track_depths.numpy()).all()
    assert len(ids_seen - {-1}) >= 1


def test_track_equals_track_raw():
    """``track`` on preprocessed inputs and ``track_raw`` on the raw frames
    are one path: identical results."""
    from stereotracking_tpu_torch.models.preprocessor import (
        padded_shape, preprocess_frame_pure)
    a, b = (build_model(_cfg(), device='cpu'),
            build_model(_cfg(), device='cpu'))
    img, disp = random_frame(12, 60, 90)
    oh, ow = padded_shape(60, 90)
    for f in range(2):
        ra = a.track_raw(img, disp, f)
        inputs = preprocess_frame_pure(torch.from_numpy(img),
                                       torch.from_numpy(disp), oh, ow)
        rb = b.track(inputs, f)
        for x, y in zip(ra, rb):
            assert torch.equal(x, y)
