"""Weight bridge and detector forward: the PyTorch port against the JAX one.

Random Flax variables (random BatchNorm statistics, so no layer is an
identity; the RGB and disparity branches get different weights) go through
``stereotracking_tpu_torch.utils.convert.flax_to_state_dict`` into the
port's detector; both packages then see the same numpy inputs.  The
helpers here are shared by the other ``test_torch_port_*`` files.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from stereotracking_tpu.models.detector import DetectorConfig as JCfg
from stereotracking_tpu.models.detector import YOLOXDetector as JDet
from stereotracking_tpu.utils.torch_convert import convert_yolox_state_dict
from stereotracking_tpu_torch.models.detector import DetectorConfig
from stereotracking_tpu_torch.models.detector import YOLOXDetector
from stereotracking_tpu_torch.utils.convert import flax_to_state_dict

H, W = 64, 96          # stage 2's band needs H/8 divisible by a band >= 4
WIDEN = 0.25


@pytest.fixture(autouse=True, scope='module')
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def random_variables(widen=WIDEN, seed=0, head_bias=None):
    """Flax YOLOXDetector variables as numpy: Flax init, then random BN
    scale / bias / mean / var; ``head_bias`` sets the cls and obj conv
    biases (so that detections clear the tracker's score gates)."""
    det = JDet(JCfg(widen_factor=widen, deepen_factor=0.33))
    dummy = {'img': jnp.zeros((1, H, W, 3)),
             'disp_postp': jnp.zeros((1, H, W, 3)),
             'disp_mask': jnp.zeros((1, H, W, 1))}
    v = det.init(jax.random.PRNGKey(seed), dummy, train=False)
    rng = np.random.RandomState(seed)

    def bn(x, lo, hi):
        return (rng.uniform(lo, hi, x.shape)).astype(np.float32)

    params = jax.tree.map(lambda x: np.array(x, np.float32), v['params'])
    stats = jax.tree.map(lambda x: np.array(x, np.float32), v['batch_stats'])
    for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
        name = path[-1].key
        if name == 'scale':
            leaf[...] = bn(leaf, 0.5, 1.5)
        elif name == 'bias' and path[-2].key == 'bn':
            leaf[...] = bn(leaf, -0.3, 0.3)
    for path, leaf in jax.tree_util.tree_flatten_with_path(stats)[0]:
        leaf[...] = (bn(leaf, -0.3, 0.3) if path[-1].key == 'mean'
                     else bn(leaf, 0.5, 1.5))
    if head_bias is not None:
        for l in range(3):
            params['bbox_head'][f'conv_obj_{l}']['bias'][...] = head_bias
            params['bbox_head'][f'conv_cls_{l}']['bias'][...] = head_bias
    return {'params': params, 'batch_stats': stats}


def port_detector(variables, widen=WIDEN):
    det = YOLOXDetector(DetectorConfig(widen_factor=widen,
                                       deepen_factor=0.33))
    det.load_state_dict(flax_to_state_dict(variables), strict=True)
    return det.eval()


def random_frame(seed=0, h=H, w=W):
    rng = np.random.RandomState(seed)
    img = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
    disp = rng.randint(16, 1600, (h, w)).astype(np.uint16)
    disp[rng.rand(h, w) < 0.1] = 65535
    return img, disp


@pytest.fixture(scope='module')
def variables():
    return random_variables()


def test_bridge_keys_follow_mm_names(variables):
    sd = flax_to_state_dict(variables)
    for key in ('backbone.stem.conv.conv.weight',
                'backbone.disp_stem.conv.bn.running_var',
                'backbone.stage1.0.conv.weight',
                'backbone.stage1.1.blocks.0.conv2.bn.weight',
                'backbone.disp_stage1.1.final_conv.conv.weight',
                'backbone.stage4.1.conv1.conv.weight',
                'backbone.stage4.2.main_conv.bn.running_mean',
                'neck.reduce_layers.0.conv.weight',
                'neck.top_down_blocks.1.short_conv.conv.weight',
                'neck.downsamples.0.bn.bias',
                'neck.bottom_up_blocks.1.blocks.0.conv1.conv.weight',
                'neck.out_convs.2.conv.weight',
                'bbox_head.head_module.multi_level_cls_convs.2.1.conv.weight',
                'bbox_head.head_module.multi_level_conv_obj.0.bias'):
        assert key in sd, key
    # the branches keep their own weights (no RGB -> disparity copy)
    assert not torch.equal(sd['backbone.stem.conv.conv.weight'],
                           sd['backbone.disp_stem.conv.conv.weight'])
    # OIHW from HWIO
    k = variables['params']['backbone']['stage1']['conv']['conv']['kernel']
    np.testing.assert_array_equal(
        sd['backbone.stage1.0.conv.weight'].numpy(), k.transpose(3, 2, 0, 1))


def test_bridge_inverts_the_reference_converter(variables):
    """The port's state dict read back by the JAX package's torch->Flax
    converter (the mm key mapping) returns the original leaves."""
    sd = {f'detector.{k}': v.numpy()
          for k, v in flax_to_state_dict(variables).items()}
    params, stats = convert_yolox_state_dict(sd, dual_branch=False)
    for coll, tree in (('params', params), ('batch_stats', stats)):
        flat_back = dict(jax.tree_util.tree_flatten_with_path(tree)[0])
        flat_orig = jax.tree_util.tree_flatten_with_path(
            variables[coll])[0]
        for path, leaf in flat_orig:
            if path[1].key in ('disp_stem', 'disp_stage1'):
                continue                    # the converter duplicates RGB
            np.testing.assert_array_equal(flat_back[path], leaf,
                                          err_msg=str(path))


def test_detector_head_matches_jax_f32(variables):
    """cls / reg / obj maps in float32.  Tolerance 1e-5 of each map's
    largest magnitude: the same float32 convolutions summed in another
    order through ~70 layers."""
    img, disp = random_frame(1)
    img_f = img.astype(np.float32)[None]
    disp_f = np.where(disp == 65535, 0, disp).astype(np.float32) / 16.0
    disp_f = np.repeat(disp_f[None, :, :, None], 3, -1)
    jd = JDet(JCfg(widen_factor=WIDEN, deepen_factor=0.33))
    ref = jd.apply(variables, {'img': jnp.asarray(img_f),
                               'disp_postp': jnp.asarray(disp_f)},
                   train=False)
    det = port_detector(variables)
    with torch.no_grad():
        out = det({'img': torch.from_numpy(img_f),
                   'disp_postp': torch.from_numpy(disp_f)})
    for rl, ol in zip(ref, out):
        for r, o in zip(rl, ol):
            r = np.asarray(r)
            assert o.shape == r.shape
            scale = np.abs(r).max()
            assert np.abs(o.numpy() - r).max() <= 1e-5 * scale + 1e-5


def test_detector_predict_matches_jax_with_rescale():
    """Decode, score filter, NMS and the ``scale_factor`` rescale: kept
    slots, labels and validity exact; boxes within 1e-3 px, scores 1e-5."""
    from stereotracking_tpu.models.detector import \
        detector_predict as j_predict
    from stereotracking_tpu_torch.models.detector import detector_predict
    v = random_variables(seed=2, head_bias=0.5)
    img, disp = random_frame(2)
    img_f = img.astype(np.float32)[None]
    disp_f = np.where(disp == 65535, 0, disp).astype(np.float32) / 16.0
    disp_f = np.repeat(disp_f[None, :, :, None], 3, -1)
    jd = JDet(JCfg(widen_factor=WIDEN, deepen_factor=0.33))
    sf = (2.0, 1.5)
    ref = j_predict(v, jd, {'img': jnp.asarray(img_f),
                            'disp_postp': jnp.asarray(disp_f)}, sf)
    out = detector_predict(port_detector(v),
                           {'img': torch.from_numpy(img_f),
                            'disp_postp': torch.from_numpy(disp_f)}, sf)
    out = type(out)(*(x[0] for x in out))        # the one stream
    assert int(np.asarray(ref.valid).sum()) > 10
    np.testing.assert_array_equal(out.valid.numpy(), np.asarray(ref.valid))
    np.testing.assert_array_equal(out.labels.numpy(), np.asarray(ref.labels))
    np.testing.assert_allclose(out.boxes.numpy(), np.asarray(ref.boxes),
                               atol=1e-3, rtol=0)
    np.testing.assert_allclose(out.scores.numpy(), np.asarray(ref.scores),
                               atol=1e-5, rtol=0)
