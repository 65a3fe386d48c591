"""The single-branch and concatenated backbones and the monocular config:
the PyTorch port against the JAX package, on the CPU.

The monocular config's eval CLI is held to JAX's in
``tests/test_torch_port_kitti.py``, beside the KITTI config's.

At a small size (deepen 0.1, widen 0.125, 64x96 frames), from seeded
numpy inputs and Flax weights carried across by ``utils/convert``:

- the head maps of ``CSPDarknet`` ('single') and ``CSPDarknetConcat``
  ('concat') detectors in float32 within 1e-4 of each map's largest
  magnitude (JAX evaluates the single branch in its space-to-depth form on
  the CPU, the port in the canonical one: the same products summed in
  another order; measured ~5e-6);
- the builder: for both backbones every stage resolves to the modules,
  'auto' with one warning, and an explicit 'cuda' stage raises in
  ``build_mot_config`` on either device;
- ``track_raw`` of the monocular config over 4 frames: ids and validity
  exact, boxes within 1e-3 px, scores 1e-5, depths and scales rtol 1e-4;
  ``MultiStreamTracker`` with either backbone equal to its streams'
  single-stream runs;
- a reference single-branch 80-class ``.pth`` through ``init_model``: the
  weights of the JAX converter's ``'mot'`` route;
- one ``train_step`` of the single backbone from a carried JAX
  ``TrainState``, with the tolerances of ``tests/test_torch_port_train.py``;
  and ``tools/train.py`` on the monocular config, its export loaded by
  ``init_model``;
- the eval CLI's batch-invariant choice: cuDNN off around both loops for
  bf16 on a CUDA device, the default for float32 and on the CPU.
"""
import functools
import warnings
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereotracking_tpu.apis.builder import build_model as j_build_model
from stereotracking_tpu.config import load_config
from stereotracking_tpu.models.detector import DetectorConfig as JCfg
from stereotracking_tpu.models.detector import YOLOXDetector as JDet
from stereotracking_tpu.train import losses as JL
from stereotracking_tpu.train import schedules as JS
from stereotracking_tpu.train import train_state as JTS
from stereotracking_tpu_torch.apis.builder import (build_model,
                                                   build_mot_config,
                                                   resolve_stage_backends)
from stereotracking_tpu_torch.models.csp_darknet import StageBackends
from stereotracking_tpu_torch.models.detector import (DetectorConfig,
                                                      YOLOXDetector)
from stereotracking_tpu_torch.models.mot import init_weights
from stereotracking_tpu_torch.train import losses as TL
from stereotracking_tpu_torch.train import train_state as TS
from stereotracking_tpu_torch.train.schedules import yolox_schedule
from stereotracking_tpu_torch.utils.convert import (flax_to_state_dict,
                                                    train_state_to_torch)

REPO = Path(__file__).parent.parent
MONO = REPO / 'configs/mot/ocsort/yolox_s_ocsort_monocular.py'
FLAGSHIP = REPO / 'configs/stereo_tracking/ocsort/yolox_s_airdrone_disp.py'
DEEPEN, WIDEN = 0.1, 0.125
H, W = 64, 96
HEAD_BIAS = 3.0     # detections clear init_track_thr (sigmoid(3)^2 = 0.91)
V0 = 'YOLOXCSPDarknet_Disparity_V0_MMYOLO'


@pytest.fixture(autouse=True, scope='module')
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_detector(backbone, num_classes=1):
    return JDet(JCfg(backbone=backbone, num_classes=num_classes,
                     deepen_factor=DEEPEN, widen_factor=WIDEN))


def random_variables(backbone, num_classes=1, seed=0, head_bias=None):
    """Flax YOLOXDetector variables of ``backbone`` as numpy: Flax init
    (jitted), then random BatchNorm scale / bias / mean / var; ``head_bias``
    sets the cls and obj conv biases."""
    det = jax_detector(backbone, num_classes)
    dummy = {'img': jnp.zeros((1, H, W, 3)),
             'disp_postp': jnp.zeros((1, H, W, 3))}
    v = jax.jit(functools.partial(det.init, train=False))(
        jax.random.PRNGKey(seed), dummy)
    rng = np.random.RandomState(seed)
    params = jax.tree.map(lambda x: np.array(x, np.float32), v['params'])
    stats = jax.tree.map(lambda x: np.array(x, np.float32), v['batch_stats'])
    for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
        if path[-1].key == 'scale':
            leaf[...] = rng.uniform(0.5, 1.5, leaf.shape)
        elif path[-1].key == 'bias' and path[-2].key == 'bn':
            leaf[...] = rng.uniform(-0.3, 0.3, leaf.shape)
    for path, leaf in jax.tree_util.tree_flatten_with_path(stats)[0]:
        leaf[...] = (rng.uniform(-0.3, 0.3, leaf.shape)
                     if path[-1].key == 'mean'
                     else rng.uniform(0.5, 1.5, leaf.shape))
    if head_bias is not None:
        for lvl in range(3):
            params['bbox_head'][f'conv_obj_{lvl}']['bias'][...] = head_bias
            params['bbox_head'][f'conv_cls_{lvl}']['bias'][...] = head_bias
    return {'params': params, 'batch_stats': stats}


def random_frames(n=4, h=H, w=W, seed=11):
    """n frames of a drifting scene: (H, W, 3) uint8 and (H, W) uint16
    fixed-point disparity with 10% invalid pixels."""
    rng = np.random.RandomState(seed)
    img = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
    disp = rng.randint(16, 1600, (h, w)).astype(np.uint16)
    disp[rng.rand(h, w) < 0.1] = 65535
    return [(np.roll(img, 2 * f, 1), np.roll(disp, 2 * f, 1))
            for f in range(n)]


def small_cfg(path, **backbone):
    cfg = load_config(str(path))
    bb = cfg['model']['detector']['backbone']
    bb.update(deepen_factor=DEEPEN, widen_factor=WIDEN, **backbone)
    return cfg


def assert_results_equal(rt, rj, what):
    """Port FrameResult against JAX's: ids, labels and validity exact;
    boxes within 1e-3 px, scores 1e-5; depths and scales rtol 1e-4."""
    for name in ('det_valid', 'det_labels', 'track_ids', 'track_valid',
                 'track_labels'):
        np.testing.assert_array_equal(getattr(rt, name).numpy(),
                                      np.asarray(getattr(rj, name)),
                                      err_msg=f'{what} {name}')
    for name, tol in (('det_bboxes', 1e-3), ('track_bboxes', 1e-3),
                      ('det_scores', 1e-5), ('track_scores', 1e-5)):
        np.testing.assert_allclose(getattr(rt, name).numpy(),
                                   np.asarray(getattr(rj, name)), atol=tol,
                                   rtol=0, err_msg=f'{what} {name}')
    for name in ('track_depths', 'track_scales', 'track_gt_depths'):
        np.testing.assert_allclose(getattr(rt, name).numpy(),
                                   np.asarray(getattr(rj, name)), rtol=1e-4,
                                   atol=1e-4, err_msg=f'{what} {name}')


@pytest.fixture(scope='module')
def variables():
    """Seeded Flax variables of each backbone, 1 class, raised head
    biases."""
    return {bb: random_variables(bb, seed=seed, head_bias=HEAD_BIAS)
            for bb, seed in (('single', 1), ('concat', 3))}


# ------------------------------------------------------------ backbones ----

@pytest.mark.parametrize('backbone', ['single', 'concat'])
def test_head_maps_equal_jax(variables, backbone):
    v = variables[backbone]
    rng = np.random.RandomState(4)
    img = (rng.rand(2, H, W, 3) * 255).astype(np.float32)
    disp = np.repeat((rng.rand(2, H, W, 1) * 40).astype(np.float32), 3, -1)
    ref = jax.jit(functools.partial(jax_detector(backbone).apply,
                                    train=False))(
        v, {'img': jnp.asarray(img), 'disp_postp': jnp.asarray(disp)})
    det = YOLOXDetector(DetectorConfig(backbone=backbone,
                                       deepen_factor=DEEPEN,
                                       widen_factor=WIDEN))
    det.load_state_dict(flax_to_state_dict(v), strict=True)
    inputs = {'img': torch.from_numpy(img)}
    if backbone == 'concat':
        inputs['disp_postp'] = torch.from_numpy(disp)
    with torch.no_grad():
        out = det(inputs)
    for rl, ol in zip(ref, out):
        for r, o in zip(rl, ol):
            r = np.asarray(r)
            assert o.shape == r.shape
            assert np.abs(o.numpy() - r).max() <= 1e-4 * np.abs(r).max()
    names = det.state_dict().keys()
    stem = ('backbone.trunk.stem.conv.conv.weight' if backbone == 'concat'
            else 'backbone.stem.conv.conv.weight')
    assert stem in names and not any('disp_' in k for k in names)
    assert det.state_dict()[stem].shape[1] == (24 if backbone == 'concat'
                                               else 12)


# -------------------------------------------------------------- builder ----

@pytest.mark.parametrize('backbone', ['YOLOXCSPDarknet', V0])
@pytest.mark.parametrize('stage', list(StageBackends._fields))
def test_builder_resolves_other_backbones_to_modules(backbone, stage):
    model = small_cfg(FLAGSHIP, type=backbone)['model']
    kind = 'concat' if backbone == V0 else 'single'
    for device_type in ('cuda', 'cpu'):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter('always')
            got = resolve_stage_backends(model, device_type)
        said = [str(w.message) for w in caught]
        assert got == StageBackends(), got
        assert len(said) == 1 and f"'{kind}' backbone" in said[0], said
    for val in ('cuda', 'pallas'):
        bad = dict(model, **{f'{stage}_backend': val})
        for st in StageBackends._fields:
            if st != stage:
                bad[f'{st}_backend'] = 'torch'
        with pytest.raises(ValueError, match='has no stage kernel'):
            build_mot_config(bad, 'cpu')
    quiet = dict(model, **{f'{s}_backend': 'torch'
                           for s in StageBackends._fields})
    with warnings.catch_warnings():
        warnings.simplefilter('error')
        assert build_mot_config(quiet, 'cpu').backends == StageBackends()


def test_monocular_config_builds_the_single_backbone():
    mot = build_mot_config(load_config(str(MONO))['model'], 'cpu')
    assert mot.detector.backbone == 'single'
    assert mot.detector.num_classes == 1 and mot.reuse_det_depth
    assert mot.tracker.num_frames_retain == 30
    assert mot.backends == StageBackends()


# ------------------------------------------------------------ track_raw ----

def test_monocular_track_raw_equals_jax(variables):
    v = variables['single']
    cfg = small_cfg(MONO)
    jm = j_build_model(cfg, variables=v, input_shape=(H, W))
    assert jm.cfg.detector.backbone == 'single'
    tm = build_model(cfg, device='cpu')
    tm.module.load_state_dict(flax_to_state_dict(v))
    ids = set()
    for f, (img, disp) in enumerate(random_frames()):
        rt = tm.track_raw(img, disp, f)
        assert_results_equal(rt, jm.track_raw(img, disp, f), f'frame {f}')
        ids |= set(rt.track_ids.numpy()[rt.track_valid.numpy()].tolist())
    assert len(ids - {-1}) >= 1


@pytest.mark.parametrize('config', ['mono', 'concat'])
def test_multistream_equals_single_streams(config):
    """``MultiStreamTracker`` with the single or concatenated backbone:
    each of 2 streams over 3 steps equals its own ``OCSORTDisparity`` run
    (ids and validity exact, boxes within 1e-3 px: the float32 layers sum
    in another order at batch 2)."""
    from stereotracking_tpu_torch.models.mot import OCSORTDisparity
    from stereotracking_tpu_torch.parallel.multistream import \
        MultiStreamTracker
    cfg = (small_cfg(MONO) if config == 'mono'
           else small_cfg(FLAGSHIP, type=V0))
    with warnings.catch_warnings():
        warnings.simplefilter('ignore')     # concat: 'auto' -> modules
        mot = build_mot_config(cfg['model'], 'cpu')
        model = build_model(cfg, device='cpu', seed=5)
    head = model.module.bbox_head.head_module
    with torch.no_grad():
        for conv in (*head.multi_level_conv_cls, *head.multi_level_conv_obj):
            conv.bias.fill_(HEAD_BIAS)
    ms = MultiStreamTracker(mot, 2, module=model.module, device='cpu')
    streams = [random_frames(3, seed=30), random_frames(3, seed=31)]
    singles = [OCSORTDisparity(mot, module=model.module, device='cpu')
               for _ in streams]
    for t in range(3):
        rb = ms.track_raw(np.stack([s[t][0] for s in streams]),
                          np.stack([s[t][1] for s in streams]), [t, t])
        for i, one in enumerate(singles):
            r1 = one.track_raw(*streams[i][t], t)
            for name in ('track_ids', 'track_valid', 'det_valid'):
                assert torch.equal(getattr(rb, name)[i],
                                   getattr(r1, name)), (t, i, name)
            err = float((rb.track_bboxes[i] - r1.track_bboxes).abs().max())
            assert err <= 1e-3, (t, i, err)
    assert int(rb.track_valid.sum()) > 0


# ----------------------------------------------------------- checkpoint ----

def reference_pth(path, backbone, num_classes, seed=0):
    """A reference-layout checkpoint of a detector: seeded weights and
    BatchNorm statistics, raised head biases, ``detector.`` keys, no
    disparity branch (the reference copies it from the RGB one), wrapped
    in ``{'state_dict', 'meta'}``."""
    det = YOLOXDetector(DetectorConfig(backbone=backbone,
                                       num_classes=num_classes,
                                       deepen_factor=DEEPEN,
                                       widen_factor=WIDEN))
    gen = torch.Generator().manual_seed(seed)
    init_weights(det, gen)
    with torch.no_grad():
        for m in det.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.weight.uniform_(0.5, 1.5, generator=gen)
                m.bias.uniform_(-0.3, 0.3, generator=gen)
                m.running_mean.uniform_(-0.3, 0.3, generator=gen)
                m.running_var.uniform_(0.5, 1.5, generator=gen)
        head = det.bbox_head.head_module
        for conv in (*head.multi_level_conv_cls, *head.multi_level_conv_obj):
            conv.bias.fill_(HEAD_BIAS)
    torch.save({'state_dict': {
        f'detector.{k}': v for k, v in det.state_dict().items()
        if not k.startswith(('backbone.disp_stem', 'backbone.disp_stage1'))},
        'meta': {'epoch': 1}}, path)
    return str(path)


def test_reference_single_branch_pth_through_init_model(tmp_path):
    """A reference single-branch 80-class ``.pth`` loads through
    ``init_model`` to the weights of the JAX converter's ``'mot'`` route
    (no disparity branch to copy into), and tracks a frame."""
    from stereotracking_tpu.utils.torch_convert import convert_zoo_checkpoint
    from stereotracking_tpu_torch.apis.inference import (inference_mot,
                                                         init_model)
    pth = reference_pth(tmp_path / 'coco.pth', 'single', 80)
    cfg = small_cfg(MONO)
    cfg['model']['detector']['bbox_head']['head_module']['num_classes'] = 80
    tm = init_model(cfg, pth, device='cpu')
    got = tm.module.state_dict()
    want = flax_to_state_dict(convert_zoo_checkpoint(pth, 'mot'))
    assert not any('disp_' in k for k in got)
    for k, v in got.items():
        assert torch.equal(v, want[k]), k
    assert got['bbox_head.head_module.multi_level_conv_cls.0.bias'].shape \
        == (80,)
    img, disp = random_frames(1)[0]
    out = inference_mot(tm, img, disp, 0)['det_instances']
    assert len(out['labels']) > 0 and out['labels'].max() < 80


# ---------------------------------------------------------------- train ----

def test_single_backbone_train_step_equals_jax():
    """One step (L1 on) of the single backbone from a carried JAX state:
    num_pos exact, losses rtol 1e-4; weights, EMA and momentum within
    2e-3 / 2e-3 / 2e-2 of each tensor's largest magnitude (the tolerances
    of tests/test_torch_port_train.py and their derivation)."""
    from test_torch_port_train import SCHED, _batch, _torch_batch
    module = jax_detector('single')
    opt = JTS.make_optimizer(JS.yolox_schedule(*SCHED))
    batch = _batch(1)
    state = JTS.create_train_state(module, jax.random.PRNGKey(0),
                                   batch['img'].shape[1:3], opt)
    rng = np.random.RandomState(0)

    def perturb(path, a):       # as test_torch_port_train.jax_steps does
        if path[-1].key == 'scale':
            return jnp.asarray(rng.uniform(0.5, 1.5, a.shape), jnp.float32)
        if path[-1].key == 'bias':
            return jnp.asarray(rng.uniform(-0.3, 0.3, a.shape), jnp.float32)
        return a
    params = jax.tree_util.tree_map_with_path(perturb, state.params)
    state = state._replace(params=params, opt_state=opt.init(params),
                           ema_params=jax.tree.map(lambda a: a * 0.9,
                                                   params))
    step = jax.jit(functools.partial(
        JTS.train_step, module=module, optimizer=opt,
        loss_cfg=JL.YOLOXLossConfig(use_l1=True)))
    j_after, j_losses = step(state, {k: v for k, v in batch.items()
                                     if k != 'disp_postp'})
    st = TS.create_train_state(
        YOLOXDetector(DetectorConfig(backbone='single', deepen_factor=DEEPEN,
                                     widen_factor=WIDEN)),
        yolox_schedule(*SCHED))
    st.load_state_dict(train_state_to_torch(state))
    tb = {k: v for k, v in _torch_batch(batch).items() if k != 'disp_postp'}
    got = TS.train_step(st, tb, TL.YOLOXLossConfig(use_l1=True))
    assert int(got['num_pos']) == int(j_losses['num_pos']) > 0
    for k, v in j_losses.items():
        np.testing.assert_allclose(float(got[k]), float(v), rtol=1e-4,
                                   err_msg=k)
    want, have = train_state_to_torch(j_after), st.state_dict()
    assert have['step'] == want['step'] == 1
    for part, tol in (('model', 2e-3), ('ema', 2e-3), ('momentum', 2e-2)):
        assert have[part].keys() == want[part].keys()
        for k, v in want[part].items():
            if k.endswith('num_batches_tracked'):
                continue
            err = float((have[part][k] - v).abs().max())
            assert err <= tol * float(v.abs().max()), (part, k, err)


# ------------------------------------------------------------------ CLI ----

def test_train_cli_trains_the_monocular_config(tmp_path):
    """``tools/train.py`` on the monocular config (its train dataset given
    by ``--cfg-options``, as the JAX CLI needs it too) trains the single
    backbone on the CPU, and its export loads through ``init_model``."""
    from stereotracking_tpu_torch.apis.inference import init_model
    from stereotracking_tpu_torch.tools import train as cli
    from synthetic_dataset import write_airdrone_dataset
    write_airdrone_dataset(str(tmp_path), n_videos=1, n_frames=4, h=96,
                           w=128)
    work = tmp_path / 'work'
    state = cli.main([
        str(MONO), '--work-dir', str(work), '--device', 'cpu',
        '--max-epochs', '1', '--steps-per-epoch', '2', '--batch-size', '2',
        '--max-gt', '8', '--img-scale', '96', '128', '--cfg-options',
        f'train_dataloader.dataset.data_root={tmp_path}/',
        'train_dataloader.dataset.ann_file=annotations.json',
        'train_dataloader.dataset.img_prefix=',
        f'model.detector.backbone.deepen_factor={DEEPEN}',
        f'model.detector.backbone.widen_factor={WIDEN}'])
    assert state.step == 2 and state.module.cfg.backbone == 'single'
    model = init_model(small_cfg(MONO), str(work / 'detector_final.pth'),
                       device='cpu')
    for k, v in state.ema.state_dict().items():
        assert torch.equal(model.module.state_dict()[k], v), k


@pytest.mark.parametrize('bf16,device,off', [
    (True, 'cuda', True), (False, 'cuda', False), (True, 'cpu', False),
    (False, 'cpu', False)])
@pytest.mark.parametrize('streams', [1, 2])
def test_eval_picks_batch_invariant_convs_for_bf16_on_cuda(
        monkeypatch, bf16, device, off, streams):
    """``tools/test.evaluate`` runs both loops with cuDNN off exactly for
    bf16 on a CUDA device, and restores the switch after."""
    from stereotracking_tpu_torch.tools import test as cli
    before = torch.backends.cudnn.enabled
    with cli.batch_invariant_convs(bf16, torch.device(device)) as got:
        assert got == off
        assert torch.backends.cudnn.enabled == (before and not off)
    assert torch.backends.cudnn.enabled == before
    seen = []

    def loop(*a):
        seen.append(torch.backends.cudnn.enabled)
        return 0, 1.0
    monkeypatch.setattr(cli, '_sequential_eval', loop)
    monkeypatch.setattr(cli, '_multistream_eval', loop)

    class Data:
        def video_frames(self, vid):
            return [0]

        def frame_info(self, img_id):
            return dict(height=H, width=W)

    class Model:
        pass
    Model.device = torch.device(device)

    args = cli.parse_args([str(MONO), '--streams', str(streams)]
                          + (['--bf16'] if bf16 else []))
    cli.evaluate(Model(), Data(), [0], args, (H, W), None, None)
    assert seen == [before and not off]
    assert torch.backends.cudnn.enabled == before
