"""The port's training path against the JAX package, on the CPU.

From seeded numpy inputs, at the CLI tests' small size (deepen 0.1, widen
0.125, as tests/test_tools_e2e.py cuts it):

- ``yolox_schedule`` and ``ema_momentum`` over every step of short
  schedules (rtol 1e-6: both evaluate the same float32 formula; numpy's
  and XLA's cosine may differ in the last bit);
- the optimizer's decay group is exactly the JAX ``_decay_mask`` leaves;
- ``simota_assign`` on identical inputs (random, no ground truth,
  conflicted priors): ``fg`` and ``matched_gt`` exact, ``matched_iou``
  within 1e-6;
- ``yolox_loss`` with and without L1: losses rtol 1e-5, the gradients with
  respect to cls, reg, obj and the decoded boxes within 1e-5 of each
  tensor's largest magnitude (the decoded boxes' gradient includes the
  IoU-soft class target's, which a ``.detach()`` would drop);
- BatchNorm train mode of one ``ConvBNAct`` against Flax's over two calls:
  output, running mean and variance, gradients;
- two full ``train_step``s from a carried JAX ``TrainState``: losses rtol
  1e-4, ``num_pos`` exact, and the weights, running statistics, EMA and
  momentum after the second step within the tolerance derived in
  ``test_two_train_steps_equal_jax``;
- a step resumed from a checkpoint of the state after step 1 equals the
  uninterrupted step exactly;
- train mode stays out of serving: blocks and detectors are built in eval
  mode, and an eval forward leaves the running statistics alone;
- the optimizer's in-place step invalidates ``kernel_weights``' cache, and
  ``train_step`` reads no tensor back to the host.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereotracking_tpu.models.detector import DetectorConfig as JCfg
from stereotracking_tpu.models.detector import YOLOXDetector as JDet
from stereotracking_tpu.models.layers import ConvBNAct as JConvBNAct
from stereotracking_tpu.models.yolox_head import level_priors as j_priors
from stereotracking_tpu.train import losses as JL
from stereotracking_tpu.train import schedules as JS
from stereotracking_tpu.train import train_state as JTS
from stereotracking_tpu_torch.models.detector import (DetectorConfig,
                                                      YOLOXDetector)
from stereotracking_tpu_torch.models.layers import ConvBNAct
from stereotracking_tpu_torch.ops.stem_cuda import stem_weights
from stereotracking_tpu_torch.train import losses as TL
from stereotracking_tpu_torch.train import train_state as TS
from stereotracking_tpu_torch.train.checkpoint import (load_checkpoint,
                                                       save_checkpoint)
from stereotracking_tpu_torch.train.schedules import yolox_schedule
from stereotracking_tpu_torch.utils.convert import (flax_to_state_dict,
                                                    train_state_to_torch)
from test_torch_port_device_step import _HostReads

DEEPEN, WIDEN = 0.1, 0.125
H, W, N, G = 64, 96, 2, 4
# base lr, steps per epoch, max epochs, warm-up epochs, last epochs: the
# learning rates of steps 0 and 1 are 2.5e-4 and 1e-3
SCHED = (1e-3, 2, 4, 1, 1)


@pytest.fixture(autouse=True, scope='module')
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------- schedule, EMA, mask ----

@pytest.mark.parametrize('args', [(1e-3, 7, 6, 2, 2), (0.01, 3, 12, 2, 5),
                                  (0.02, 1, 3, 0, 1)])
def test_schedule_and_ema_momentum_equal_jax(args):
    j, t = JS.yolox_schedule(*args), yolox_schedule(*args)
    steps = range(args[1] * args[2] + 3)        # past the end: the tail
    np.testing.assert_allclose([t(s) for s in steps],
                               [float(j(s)) for s in steps], rtol=1e-6)
    np.testing.assert_allclose(
        [TS.ema_momentum(s) for s in steps],
        [float(JTS.ema_momentum(jnp.int32(s))) for s in steps], rtol=1e-6)


def test_decay_groups_cover_jax_decay_mask(jax_steps):
    params = jax_steps[0][0].params
    as_arrays = jax.tree.map(
        lambda p, m: np.full(p.shape, float(m), np.float32),
        params, JTS._decay_mask(params))
    want = {k: bool(v.flatten()[0]) for k, v in flax_to_state_dict(
        {'params': as_arrays, 'batch_stats': {}}).items()}
    det = YOLOXDetector(DetectorConfig(deepen_factor=DEEPEN,
                                       widen_factor=WIDEN))
    assert TS.decay_mask(det) == want
    opt = TS.make_optimizer(det, lambda s: 0.1)
    params = dict(det.named_parameters())
    decayed, plain = opt.param_groups
    assert decayed['weight_decay'] == 5e-4 and plain['weight_decay'] == 0.0
    assert {id(p) for p in decayed['params']} == {
        id(params[k]) for k, v in want.items() if v}
    assert {id(p) for p in plain['params']} == {
        id(params[k]) for k, v in want.items() if not v}
    assert opt.defaults['nesterov'] and opt.defaults['momentum'] == 0.9


# ------------------------------------------------------------- the loss ----

def _priors():
    return np.asarray(jnp.concatenate(
        [j_priors(8, 12, 8), j_priors(4, 6, 16), j_priors(2, 3, 32)]))


def _loss_case(kind, seed=0):
    """(cls, reg, obj, decoded, gt_bboxes, gt_labels, gt_valid) for 3
    images: random boxes; 'no_gt' has none; 'conflicted' stacks nearly
    equal boxes so that priors match several ground truths."""
    rng = np.random.RandomState(seed)
    pri = _priors()
    p = len(pri)
    cls = rng.randn(3, p, 1).astype(np.float32)
    reg = (rng.randn(3, p, 4) * 0.5).astype(np.float32)
    obj = rng.randn(3, p, 1).astype(np.float32)
    xy = reg[..., :2] * pri[None, :, 2:3] + pri[None, :, :2]
    wh = np.exp(reg[..., 2:]) * pri[None, :, 2:3]
    decoded = np.concatenate([xy - wh / 2, xy + wh / 2], -1).astype(
        np.float32)
    gt = np.zeros((3, G + 2, 4), np.float32)
    valid = np.zeros((3, G + 2), bool)
    counts = [0, 0, 0] if kind == 'no_gt' else [1, 3, G + 2]
    for b, n in enumerate(counts):
        x = rng.uniform(0, 80, n)
        y = rng.uniform(0, 50, n)
        gt[b, :n] = np.stack([x, y, x + rng.uniform(5, 40, n),
                              y + rng.uniform(5, 30, n)], 1)
        valid[b, :n] = True
    if kind == 'conflicted':
        for b in range(3):
            gt[b, 1:] = gt[b, :1] + rng.uniform(-1, 1, (G + 1, 4)).astype(
                np.float32)
            valid[b] = True
    labels = np.zeros((3, G + 2), np.int32)
    return cls, reg, obj, decoded, gt, labels, valid


@pytest.mark.parametrize('kind', ['random', 'no_gt', 'conflicted'])
def test_simota_assign_equal_jax(kind):
    cls, _, obj, decoded, gt, labels, valid = _loss_case(kind)
    scores = (1 / (1 + np.exp(-cls)) * (1 / (1 + np.exp(-obj)))).astype(
        np.float32)
    pri = _priors()
    jf, jm, ji = jax.jit(jax.vmap(
        functools.partial(JL.simota_assign, num_classes=1,
                          cfg=JL.SimOTAConfig()),
        in_axes=(None, 0, 0, 0, 0, 0)))(
        jnp.asarray(pri), decoded, scores, gt, labels, valid)
    tf, tm, ti = TL.simota_assign(
        *(torch.from_numpy(a) for a in (pri, decoded, scores, gt)),
        torch.from_numpy(labels).long(), torch.from_numpy(valid), 1,
        TL.SimOTAConfig())
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    np.testing.assert_allclose(ti.detach().numpy(), np.asarray(ji),
                               rtol=0, atol=1e-6)
    if kind == 'no_gt':
        assert not tf.any()
    else:
        assert tf.sum() >= 2
    if kind == 'conflicted':
        # priors inside several ground truths' candidate sets were
        # resolved: each fg prior kept one gt, not always gt 0
        assert len(np.unique(tm.numpy()[tf.numpy()])) > 1


@pytest.mark.parametrize('use_l1', [False, True])
@pytest.mark.parametrize('kind', ['random', 'conflicted'])
def test_yolox_loss_and_gradients_equal_jax(kind, use_l1):
    cls, reg, obj, decoded, gt, labels, valid = _loss_case(kind, seed=1)
    pri = _priors()
    jcfg = JL.YOLOXLossConfig(use_l1=use_l1)

    def f(c, r, o, d):
        out = JL.yolox_loss(c, r, o, jnp.asarray(pri), d, gt, labels,
                            valid, jcfg)
        return out['loss'], out
    (_, jout), jgrads = jax.jit(jax.value_and_grad(
        f, argnums=(0, 1, 2, 3), has_aux=True))(cls, reg, obj, decoded)
    ts = [torch.tensor(a, requires_grad=True)
          for a in (cls, reg, obj, decoded)]
    tout = TL.yolox_loss(*ts[:3], torch.from_numpy(pri), ts[3],
                         torch.from_numpy(gt), torch.from_numpy(labels).long(),
                         torch.from_numpy(valid),
                         TL.YOLOXLossConfig(use_l1=use_l1))
    tout['loss'].backward()
    assert set(tout) == set(jout)
    assert int(tout['num_pos']) == int(jout['num_pos']) > 0
    for k in jout:
        np.testing.assert_allclose(float(tout[k]), float(jout[k]),
                                   rtol=1e-5, err_msg=k)
    for name, jg, t in zip(('cls', 'reg', 'obj', 'decoded'), jgrads, ts):
        jg = np.asarray(jg)
        got = t.grad.numpy() if t.grad is not None else np.zeros_like(jg)
        scale = np.abs(jg).max()
        if name == 'reg' and not use_l1:
            assert scale == 0       # reg reaches the loss through L1 only
        else:
            assert scale > 0
        np.testing.assert_allclose(got, jg, rtol=0, atol=1e-5 * scale,
                                   err_msg=name)


# --------------------------------------------------------- BatchNorm ----

def test_batch_norm_train_mode_equals_flax():
    """One ConvBNAct (3x3 stride 2, 8 -> 16 channels) in train mode over
    two batches: output, the running statistics after each call, and the
    gradients of input, kernel, scale and bias.  Measured: output and
    running statistics within 2e-6 of their largest magnitude, gradients
    within 3e-6 (float32 reductions in another order); limits 1e-5."""
    rng = np.random.RandomState(0)
    xs = [(rng.randn(4, 12, 10, 8) + 0.5).astype(np.float32)
          for _ in range(2)]
    jm = JConvBNAct(16, kernel_size=3, strides=2)
    var = jm.init(jax.random.PRNGKey(0), xs[0], train=True)
    params = jax.tree.map(np.asarray, var['params'])
    params['bn'] = dict(scale=rng.uniform(0.5, 1.5, 16).astype(np.float32),
                        bias=rng.uniform(-0.3, 0.3, 16).astype(np.float32))
    stats = dict(bn=dict(mean=rng.uniform(-0.3, 0.3, 16).astype(np.float32),
                         var=rng.uniform(0.5, 1.5, 16).astype(np.float32)))
    tm = ConvBNAct(8, 16, 3, 2)
    assert not tm.training                       # built in eval mode
    with torch.no_grad():
        tm.conv.weight.copy_(torch.from_numpy(
            params['conv']['kernel'].transpose(3, 2, 0, 1)))
        tm.bn.weight.copy_(torch.from_numpy(params['bn']['scale']))
        tm.bn.bias.copy_(torch.from_numpy(params['bn']['bias']))
        tm.bn.running_mean.copy_(torch.from_numpy(stats['bn']['mean']))
        tm.bn.running_var.copy_(torch.from_numpy(stats['bn']['var']))
    tm.train()
    for x in xs:
        cot = rng.randn(4, 6, 5, 16).astype(np.float32)

        def f(p, xx, stats=stats):
            return jm.apply({'params': p, 'batch_stats': stats}, xx,
                            train=True, mutable=['batch_stats'])
        y, vjp, new = jax.vjp(f, params, x, has_aux=True)
        gp, gx = vjp(jnp.asarray(cot))
        stats = jax.tree.map(np.asarray, new['batch_stats'])
        tx = torch.tensor(x.transpose(0, 3, 1, 2), requires_grad=True)
        ty = tm(tx)
        ty.backward(torch.from_numpy(cot.transpose(0, 3, 1, 2)))
        pairs = [
            (ty.detach().permute(0, 2, 3, 1), y),
            (tm.bn.running_mean, stats['bn']['mean']),
            (tm.bn.running_var, stats['bn']['var']),
            (tx.grad.permute(0, 2, 3, 1), gx),
            (tm.conv.weight.grad.permute(2, 3, 1, 0), gp['conv']['kernel']),
            (tm.bn.weight.grad, gp['bn']['scale']),
            (tm.bn.bias.grad, gp['bn']['bias'])]
        for i, (got, want) in enumerate(pairs):
            want = np.asarray(want)
            np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                                       atol=1e-5 * np.abs(want).max(),
                                       err_msg=str(i))
        tm.zero_grad()


def test_serving_stays_in_eval_mode():
    """Blocks and detectors are built in eval mode: a forward normalises
    with the running statistics and leaves them as they were."""
    det = YOLOXDetector(DetectorConfig(deepen_factor=DEEPEN,
                                       widen_factor=WIDEN))
    convs = [m for m in det.modules() if isinstance(m, ConvBNAct)]
    assert convs and not any(m.training for m in convs)
    before = {k: v.clone() for k, v in det.state_dict().items()}
    inputs = {k: torch.from_numpy(v) for k, v in
              _jax_inputs(_batch(0)).items()}
    with torch.no_grad():
        a = det(inputs)
        b = det(inputs)
    for k, v in det.state_dict().items():
        assert torch.equal(v, before[k]), k
    for x, y in zip(sum(a, []), sum(b, [])):
        assert torch.equal(x, y)
    state = TS.create_train_state(det, lambda s: 1e-3)
    assert all(m.training for m in convs)
    assert not any(m.training for m in state.ema.modules()
                   if isinstance(m, ConvBNAct))


# ------------------------------------------------------ the train step ----

def _batch(seed):
    r = np.random.RandomState(seed)
    gtb = np.zeros((N, G, 4), np.float32)
    gtv = np.zeros((N, G), bool)
    for b in range(N):
        n = r.randint(1, G + 1)
        x = r.uniform(0, W - 30, n)
        y = r.uniform(0, H - 20, n)
        gtb[b, :n] = np.stack([x, y, x + r.uniform(8, 30, n),
                               y + r.uniform(6, 20, n)], 1)
        gtv[b, :n] = True
    return dict(
        img=(r.rand(N, H, W, 3) * 255).astype(np.float32),
        disp_postp=np.repeat((r.rand(N, H, W, 1) * 40).astype(np.float32),
                             3, -1),
        disp_mask=np.ones((N, H, W, 1), np.float32), gt_bboxes=gtb,
        gt_labels=np.zeros((N, G), np.int32), gt_valid=gtv)


def _jax_inputs(b):
    return {k: b[k] for k in ('img', 'disp_postp')}


def _torch_batch(b):
    return {k: torch.from_numpy(v).long() if k == 'gt_labels'
            else torch.from_numpy(v) for k, v in b.items()}


@pytest.fixture(scope='module')
def jax_steps():
    """The JAX train state (BatchNorm scales, biases and the EMA perturbed
    from their init) and the states and losses of two steps with the L1
    loss on, compiled once."""
    rng = np.random.RandomState(0)
    module = JDet(JCfg(deepen_factor=DEEPEN, widen_factor=WIDEN))
    opt = JTS.make_optimizer(JS.yolox_schedule(*SCHED))
    # create_train_state's init, jitted (op by op it takes 26 s)
    variables = jax.jit(functools.partial(module.init, train=True))(
        jax.random.PRNGKey(0), _jax_inputs(_batch(0)))
    state = JTS.TrainState(
        step=jnp.int32(0), params=variables['params'],
        batch_stats=variables['batch_stats'], opt_state=None,
        ema_params=None, ema_batch_stats=variables['batch_stats'])

    def perturb(path, a):
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
    states, losses = [state], []
    for seed in (1, 2):
        state, out = step(state, _batch(seed))
        states.append(state)
        losses.append(jax.tree.map(np.asarray, out))
    return states, losses


def _torch_state(carried):
    st = TS.create_train_state(
        YOLOXDetector(DetectorConfig(deepen_factor=DEEPEN,
                                     widen_factor=WIDEN)),
        yolox_schedule(*SCHED))
    st.load_state_dict(carried)
    return st


def _torch_steps(st, seeds):
    cfg = TL.YOLOXLossConfig(use_l1=True)
    return [TS.train_step(st, _torch_batch(_batch(s)), cfg) for s in seeds]


def test_two_train_steps_equal_jax(jax_steps):
    """Two steps from the carried JAX state.  num_pos exact; the total
    loss of both steps and every loss of step 1 rtol 1e-4 (measured 2e-5).
    Flax's fast variance (E[x^2] - E[x]^2) cancels on the few values per
    channel of the deepest maps, so the float32 gradients of step 1 differ
    by up to 3.6e-4 of their largest magnitude between two orders of
    summation, and the weights after step 1 by up to 1.7e-5 of theirs.
    JAX's own step-2 losses are that sensitive too: a random 1e-6 relative
    change of its weights moves its loss_l1 by up to 3.4e-5 relative (34x),
    so at 1.7e-5 the step-2 component losses may move by 5.8e-4: they are
    held at rtol 1e-3 (measured: loss_l1 1.1e-4).  For the same reason the
    weights, running statistics, EMA and momentum after step 2 are held
    within 2e-3 / 2e-3 / 2e-3 / 2e-2 of each tensor's largest magnitude
    (JAX's own momentum moves by 3.5e-4 of its largest magnitude under the
    1e-6 change; measured: weights and EMA 5.6e-4, momentum 4.3e-3)."""
    states, jlosses = jax_steps
    st = _torch_state(train_state_to_torch(states[0]))
    got = _torch_steps(st, (1, 2))
    for t, (a, b) in enumerate(zip(got, jlosses)):
        assert int(a['num_pos']) == int(b['num_pos']), t
        for k in b:
            rtol = 1e-4 if t == 0 or k == 'loss' else 1e-3
            np.testing.assert_allclose(float(a[k]), float(b[k]), rtol=rtol,
                                       err_msg=f'step {t} {k}')
    want = train_state_to_torch(states[2])
    have = st.state_dict()
    assert have['step'] == want['step'] == 2
    for part, tol in (('model', 2e-3), ('ema', 2e-3), ('momentum', 2e-2)):
        assert have[part].keys() == want[part].keys()
        for k, v in want[part].items():
            if k.endswith('num_batches_tracked'):
                continue
            err = float((have[part][k] - v).abs().max())
            assert err <= tol * float(v.abs().max()), (part, k, err)
    # the EMA really moved, from weights 0.9x the parameters
    ema0 = train_state_to_torch(states[0])['ema']
    assert any(not torch.equal(ema0[k], have['ema'][k]) for k in ema0)


def test_resumed_step_equals_uninterrupted(jax_steps, tmp_path):
    carried = train_state_to_torch(jax_steps[0][0])
    whole = _torch_state(carried)
    _torch_steps(whole, (1, 2))
    first = _torch_state(carried)
    _torch_steps(first, (1,))
    save_checkpoint(str(tmp_path / 'epoch_1.pth'), first.state_dict())
    resumed = _torch_state(load_checkpoint(str(tmp_path / 'epoch_1.pth')))
    assert resumed.step == 1
    _torch_steps(resumed, (2,))
    a, b = whole.state_dict(), resumed.state_dict()
    for part in ('model', 'ema', 'momentum'):
        for k, v in a[part].items():
            assert torch.equal(v, b[part][k]), (part, k)


def test_step_invalidates_kernel_weights_and_reads_nothing_back(
        jax_steps, monkeypatch):
    """An in-place optimizer step changes every parameter's version, so
    ``CSPDarknetDual.kernel_weights`` repacks; ``train_step`` reads no
    tensor back to the host (``Tensor.item`` and the like raise)."""
    st = _torch_state(train_state_to_torch(jax_steps[0][0]))
    bb = st.module.backbone
    before = bb.kernel_weights()
    key = bb._kernel_cache[0]
    batch = _torch_batch(_batch(1))
    guard = _HostReads(monkeypatch)
    with pytest.raises(AssertionError, match='host read'):
        bool(batch['gt_valid'].any())
    TS.train_step(st, batch, TL.YOLOXLossConfig(use_l1=True))
    monkeypatch.undo()
    del guard
    after = bb.kernel_weights()
    assert bb._kernel_cache[0] != key and after is not before
    fresh = stem_weights(bb.stem, sum_channels=False)
    for a, b in zip(after['stem'], fresh):
        assert torch.equal(a, b)
    assert not all(torch.equal(a, b)
                   for a, b in zip(after['stem'], before['stem']))
