"""The bf16 compute dtype: the PyTorch port against the JAX package.

Both packages keep their parameters in float32 and compute in bfloat16
(JAX ``dtype=jnp.bfloat16``, the port ``dtype=torch.bfloat16``); every
stage runs on the modules on both sides (JAX 'xla', the port 'torch').
Weights: random Flax variables (random BatchNorm statistics) bridged by
``flax_to_state_dict``, at widen 0.25 on 64x96 frames.

Head-map tolerance, in bf16 ulps of each map's largest magnitude ``m``
(one ulp = 2^(floor(log2 m) - 7)).  The two packages round at the same
points of each ConvBNAct but for the SiLU: Flax evaluates
``x * (1 / (1 + exp(-x)))`` with a bf16 rounding after every operation,
torch's SiLU rounds once, so at one layer the two differ by up to 2 ulps
(and exp's implementations differ too).  Those differences carry through
the remaining layers as bf16 rounding noise does, so the two bf16 results
stand apart as far as each stands from the float32 result, which the JAX
package's own bf16 maps do by up to 4 ulps here: by the triangle
inequality the maps must agree within 2 x 4 = 8 ulps.

``track_raw`` over 4 frames: a head of random weights gives ~120 candidate
boxes of nearly tied scores, which any bf16 difference reorders in NMS.  So
the cls and obj convs keep only their raised biases (every score equal:
NMS and the tracker break the ties by index, as both packages do) and the
reg conv's weights are scaled by 0.05 (boxes about one stride wide at their
anchors); the boxes still come through the whole bf16 network.  Ids and
validity exact; boxes within 1 px: each box coordinate moves by at most
stride x (dxy + dwh x exp(wh) / 2) with |reg| < 0.5, d <= 8 ulps of 0.5 =
2^-6, stride 32: 32 x 2^-6 x 1.83 < 1 px.
"""
import numpy as np
import pytest

import jax.numpy as jnp
import torch

from stereotracking_tpu.apis.builder import build_model as j_build_model
from stereotracking_tpu_torch.apis.builder import build_model
from stereotracking_tpu_torch.models.csp_darknet import StageBackends
from stereotracking_tpu_torch.models.detector import (DetectorConfig,
                                                      YOLOXDetector)
from stereotracking_tpu_torch.parallel.multistream import MultiStreamTracker
from stereotracking_tpu_torch.utils.convert import flax_to_state_dict
from test_torch_port_bridge import (WIDEN, JCfg, JDet, random_frame,
                                    random_variables)
from test_torch_port_slice import _cfg

BF16 = torch.bfloat16
ULPS = 8
BOX_TOL = 1.0


@pytest.fixture(autouse=True, scope='module')
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ulp(m):
    return 2.0 ** (np.floor(np.log2(m)) - 7)


def _detector_inputs(seed):
    img, disp = random_frame(seed)
    img_f = img.astype(np.float32)[None]
    disp_f = np.where(disp == 65535, 0, disp).astype(np.float32) / 16.0
    return img_f, np.repeat(disp_f[None, :, :, None], 3, -1)


def test_head_maps_match_jax_bf16():
    v = random_variables()
    img_f, disp_f = _detector_inputs(1)
    jin = {'img': jnp.asarray(img_f), 'disp_postp': jnp.asarray(disp_f)}
    ref = JDet(JCfg(widen_factor=WIDEN, deepen_factor=0.33),
               dtype=jnp.bfloat16).apply(v, jin, train=False)
    ref32 = JDet(JCfg(widen_factor=WIDEN, deepen_factor=0.33)).apply(
        v, jin, train=False)
    det = YOLOXDetector(DetectorConfig(widen_factor=WIDEN,
                                       deepen_factor=0.33), dtype=BF16)
    det.load_state_dict(flax_to_state_dict(v))
    det.eval()
    for p in det.parameters():
        assert p.dtype == torch.float32           # parameters stay float32
    with torch.no_grad():
        out = det({'img': torch.from_numpy(img_f),
                   'disp_postp': torch.from_numpy(disp_f)}, StageBackends())
    for rl, ol, fl in zip(ref, out, ref32):
        for r, o, f in zip(rl, ol, fl):
            assert o.dtype == BF16 and r.dtype == jnp.bfloat16
            r = np.asarray(r.astype(jnp.float32))
            assert o.shape == r.shape
            ulp = _ulp(np.abs(r).max())
            # the premise of the tolerance: JAX's bf16 within 4 ulps of f32
            assert np.abs(np.asarray(f) - r).max() <= 4 * ulp
            assert np.abs(o.float().numpy() - r).max() <= ULPS * ulp


def _tied_head_variables():
    """Random variables whose cls / obj convs give their bias (3.0) alone
    and whose reg conv weights are scaled by 0.05 (see the module doc)."""
    v = random_variables(seed=1, head_bias=3.0)
    head = v['params']['bbox_head']
    for lvl in range(3):
        head[f'conv_cls_{lvl}']['kernel'][...] = 0.0
        head[f'conv_obj_{lvl}']['kernel'][...] = 0.0
        head[f'conv_reg_{lvl}']['kernel'][...] *= 0.05
    return v


def _scene(n=4):
    img0, disp0 = random_frame(11)
    return [(np.roll(img0, 2 * f, 1), np.roll(disp0, 2 * f, 1))
            for f in range(n)]


def _port_bf16_model(v):
    tm = build_model(_cfg(), device='cpu', dtype=BF16)
    assert tm.module.dtype == BF16 and tm.cfg.backends == StageBackends()
    tm.module.load_state_dict(flax_to_state_dict(v))
    return tm


def test_track_raw_bf16_matches_jax():
    from test_torch_port_bridge import H, W
    v = _tied_head_variables()
    jm = j_build_model(_cfg(), variables=v, input_shape=(H, W),
                       dtype=jnp.bfloat16)
    tm = _port_bf16_model(v)
    n_tracks = 0
    for f, (img, disp) in enumerate(_scene()):
        rj = jm.track_raw(img, disp, f)
        rt = tm.track_raw(img, disp, f)
        for name in ('det_valid', 'track_ids', 'track_valid'):
            np.testing.assert_array_equal(
                getattr(rt, name).numpy(), np.asarray(getattr(rj, name)),
                err_msg=f'frame {f} {name}')
        tv = rt.track_valid.numpy()
        dv = rt.det_valid.numpy()
        np.testing.assert_allclose(rt.track_bboxes.numpy()[tv],
                                   np.asarray(rj.track_bboxes)[tv],
                                   atol=BOX_TOL, rtol=0)
        np.testing.assert_allclose(rt.det_bboxes.numpy()[dv],
                                   np.asarray(rj.det_bboxes)[dv],
                                   atol=BOX_TOL, rtol=0)
        n_tracks += int(tv.sum())
    assert n_tracks > 0


def test_multistream_bf16_stream0_equals_one_stream():
    v = _tied_head_variables()
    one = _port_bf16_model(v)
    ms = MultiStreamTracker(one.cfg, 2, module=one.module, device='cpu',
                            dtype=BF16)
    other = _scene()[::-1]
    for f, ((img, disp), (img2, disp2)) in enumerate(zip(_scene(), other)):
        rb = ms.track_raw(np.stack([img, img2]), np.stack([disp, disp2]),
                          [f, f])
        r1 = one.track_raw(img, disp, f)
        for name in ('det_valid', 'track_ids', 'track_valid'):
            assert torch.equal(getattr(rb, name)[0], getattr(r1, name)), name
        tv = r1.track_valid
        err = (rb.track_bboxes[0][tv] - r1.track_bboxes[tv]).abs().max()
        assert float(err) <= BOX_TOL
    with pytest.raises(ValueError, match='dtype'):
        MultiStreamTracker(one.cfg, 2, module=one.module, device='cpu',
                           dtype=torch.float32)
