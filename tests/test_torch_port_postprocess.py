"""The eval CLI's tracklet post-processing in the PyTorch port against the
JAX package, on the CPU.

- ``interpolate_tracklets`` (linear gap fill, and GSI) equal to JAX's on
  seeded tracks with gaps (the same numpy and scipy arithmetic: exact);
- AFLink: the probabilities of the port's ``AFLinkModel`` within 1e-5 of
  the Flax model's with the weights carried by ``aflink_to_state_dict``;
  the linked ids equal JAX's on the JAX tests' cases
  (``tests/test_aflink_training.py``: an id switch healed, two far-apart
  objects kept apart) with JAX-trained weights;
- ``train_aflink``: from the same initial weights and batches, the first
  step's gradients within 1e-6 of JAX's, and after 3 Adam steps every
  parameter within 1e-5 of optax's where the gradient kept |g| > 1e-5 on
  all 3 steps (elsewhere Adam's update -lr g / (|g| + eps) turns a
  gradient difference of ~1e-8 at |g| ~ eps into any step up to lr, so
  those are held only to 3 lr); 70 steps at batch 64 reach the JAX test's
  held-out accuracy bar, 0.85; its checkpoint round-trips, its CLI writes
  one, and a JAX-native checkpoint is refused naming ROADMAP.md Queue 1
  item 3;
- the eval CLI with the moving-camera config, ``--interpolate`` and
  ``--aflink`` on the synthetic on-disk dataset: count metrics equal to the
  JAX CLI's (the others within 1e-6), the AFLink weights carried from a
  Flax checkpoint.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from stereotracking_tpu.evaluation import (AppearanceFreeLink as JLink,
                                           interpolate_tracklets as j_interp)
from stereotracking_tpu.evaluation.aflink import AFLinkModel as JModel
from stereotracking_tpu.train.train_aflink import synthesize_batch as j_batch
from stereotracking_tpu.train.train_aflink import train_aflink as j_train
from stereotracking_tpu_torch.evaluation import (AppearanceFreeLink,
                                                 interpolate_tracklets)
from stereotracking_tpu_torch.evaluation.aflink import (AFLinkModel,
                                                        load_aflink)
from stereotracking_tpu_torch.train.train_aflink import (aflink_loss,
                                                         save_aflink,
                                                         synthesize_batch,
                                                         train_aflink)
from stereotracking_tpu_torch.utils.convert import aflink_to_state_dict
from synthetic_dataset import write_airdrone_dataset
from test_torch_port_eval import COUNT_KEYS, DEEPEN, WIDEN
from test_torch_port_kitti import reference_pth

REPO = Path(__file__).parent.parent
CMC = REPO / 'configs/mot/ocsort/yolox_s_ocsort_monocular_cmc.py'
LR = 1e-3


@pytest.fixture(autouse=True, scope='module')
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def flax_init(seed=0):
    z = jnp.zeros((1, 30, 5))
    v = JModel().init(jax.random.PRNGKey(seed), z, z)
    return jax.tree.map(np.asarray, v)


# -------------------------------------------------------- interpolation ----

def _tracks_with_gaps(seed=0, n_frames=40, n_ids=6):
    rng = np.random.RandomState(seed)
    frames = {f: ([], []) for f in range(n_frames)}
    for tid in range(n_ids):
        start = rng.randint(0, 10)
        length = rng.randint(2, 30)            # some <= 2 rows: dropped
        gaps = set(rng.choice(np.arange(start, start + length), 5))
        x, y = rng.uniform(0, 500, 2)
        for f in range(start, min(start + length, n_frames)):
            if f in gaps:
                continue
            b = [x + 3 * f, y - f, x + 3 * f + 20, y - f + 15]
            frames[f][0].append(tid)
            frames[f][1].append(b)
    return {f: (np.array(i, int), np.array(b, float).reshape(-1, 4))
            for f, (i, b) in frames.items()}


@pytest.mark.parametrize('gsi', [False, True])
def test_interpolate_tracklets_equals_jax(gsi):
    frames = _tracks_with_gaps()
    got = interpolate_tracklets(frames, use_gsi=gsi)
    want = j_interp(frames, use_gsi=gsi)
    assert got.keys() == want.keys()
    n = 0
    for f in want:
        np.testing.assert_array_equal(got[f][0], want[f][0])
        np.testing.assert_array_equal(got[f][1], want[f][1])
        n += len(want[f][0])
    assert n > sum(len(i) for i, _ in frames.values()) - 12   # gaps filled


# --------------------------------------------------------------- AFLink ----

def test_aflink_probabilities_equal_jax():
    v = flax_init(3)
    model = AFLinkModel()
    model.load_state_dict(aflink_to_state_dict(v))
    x1, x2, _ = synthesize_batch(np.random.RandomState(4), 32)
    jx1, jx2, _ = j_batch(np.random.RandomState(4), 32)
    np.testing.assert_array_equal(x1, jx1)
    np.testing.assert_array_equal(x2, jx2)
    want = np.asarray(JModel().apply(v, jnp.asarray(x1), jnp.asarray(x2)))
    with torch.no_grad():
        got = model(torch.from_numpy(x1), torch.from_numpy(x2)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


@pytest.fixture(scope='module')
def jax_trained():
    """The JAX tests' trained linker (tests/test_aflink_training.py)."""
    v, acc = j_train(steps=70, batch=64, log_every=0)
    return jax.tree.map(np.asarray, v), acc


def _id_switch():
    frames = {}
    for f in range(40):
        if 20 <= f < 23:
            frames[f] = (np.zeros(0, int), np.zeros((0, 4)))
            continue
        x, y = 100 + 6.0 * f, 200 + 2.0 * f
        frames[f] = (np.array([0 if f < 20 else 7]),
                     np.array([[x, y, x + 40, y + 30]], float))
    return frames


def _far_apart():
    return {f: (np.array([0, 1]),
                np.array([[100 + 3 * f, 100, 140 + 3 * f, 130],
                          [1500, 800 + 2 * f, 1540, 830 + 2 * f]], float))
            for f in range(30)}


@pytest.mark.parametrize('case,ids', [('id_switch', {0}),
                                      ('far_apart', {0, 1})])
def test_aflink_links_as_jax(jax_trained, case, ids):
    frames = {'id_switch': _id_switch, 'far_apart': _far_apart}[case]()
    jl = JLink(variables=jax_trained[0])
    tl = AppearanceFreeLink(aflink_to_state_dict(jax_trained[0]),
                            device='cpu')
    want, got = jl.link(frames), tl.link(frames)
    assert got.keys() == want.keys()
    for f in want:
        np.testing.assert_array_equal(got[f][0], want[f][0])
        np.testing.assert_array_equal(got[f][1], want[f][1])
    assert {int(i) for f in got for i in got[f][0]} == ids


# -------------------------------------------------------------- trainer ----

def _jax_adam_steps(v, steps, seed=0, batch=64):
    """The JAX trainer's loop (optax.adam, the clipped-log loss) on the
    first ``steps`` batches of ``seed``: final params and, per parameter,
    the smallest |gradient| over the steps."""
    model = JModel()
    tx = optax.adam(LR)
    params = v['params']
    opt = tx.init(params)

    def loss_fn(p, x1, x2, y):
        probs = model.apply({'params': p}, x1, x2)
        logp = jnp.log(jnp.clip(probs, 1e-8))
        return -jnp.take_along_axis(logp, y[:, None], axis=1)[:, 0].mean()

    grad = jax.jit(jax.grad(loss_fn))
    rng = np.random.RandomState(seed)
    least, first = None, None
    for _ in range(steps):
        x1, x2, y = j_batch(rng, batch)
        g = grad(params, x1, x2, y)
        gabs = jax.tree.map(lambda a: np.abs(np.asarray(a)), g)
        if first is None:
            first = g
        least = gabs if least is None else jax.tree.map(np.minimum, least,
                                                        gabs)
        upd, opt = tx.update(g, opt, params)
        params = optax.apply_updates(params, upd)
    return params, least, first


def test_train_aflink_first_steps_equal_optax():
    v = flax_init(0)
    params, least, first = _jax_adam_steps(v, 3)
    # the first step's gradients
    model = AFLinkModel()
    model.load_state_dict(aflink_to_state_dict(v))
    x1, x2, y = synthesize_batch(np.random.RandomState(0), 64)
    aflink_loss(model(torch.from_numpy(x1), torch.from_numpy(x2)),
                torch.from_numpy(y)).backward()
    g_want = aflink_to_state_dict({'params': jax.tree.map(np.asarray, first)})
    for name, p in model.named_parameters():
        torch.testing.assert_close(p.grad, g_want[name], atol=1e-6, rtol=0)
    # 3 steps of the port's trainer from the same weights and batches
    got, _ = train_aflink(seed=0, steps=3, batch=64, lr=LR, log_every=0,
                          device='cpu', init=aflink_to_state_dict(v))
    want = aflink_to_state_dict({'params': jax.tree.map(np.asarray,
                                                        params)})
    sure = aflink_to_state_dict({'params': jax.tree.map(
        lambda a: (a > 1e-5).astype(np.float32), least)})
    n_sure = 0
    for name in want:
        d = (got[name] - want[name]).abs()
        mask = sure[name] > 0
        assert not mask.any() or float(d[mask].max()) <= 1e-5, name
        assert float(d.max()) <= 3 * LR, name
        n_sure += int(mask.sum())
    assert n_sure > 0.3 * sum(t.numel() for t in want.values())   # 48%


def test_train_aflink_reaches_the_jax_bar(tmp_path):
    sd, acc = train_aflink(seed=0, steps=70, batch=64, log_every=0,
                           device='cpu')
    assert acc >= 0.85, acc
    path = str(tmp_path / 'aflink.pt')
    save_aflink(path, sd)
    back = load_aflink(path)
    assert back.keys() == sd.keys()
    assert all(torch.equal(back[k], sd[k]) for k in sd)
    linker = AppearanceFreeLink(back, device='cpu')
    assert {int(i) for f, (ids, _) in linker.link(_id_switch()).items()
            for i in ids} == {0}
    with pytest.raises(NotImplementedError, match='Queue 1 item 3'):
        load_aflink(str(tmp_path / 'aflink.ckpt'))


def test_train_aflink_cli(tmp_path):
    from stereotracking_tpu_torch.tools import train_aflink as cli
    out = tmp_path / 'w' / 'a.pt'
    acc = cli.main(['--out', str(out), '--steps', '2', '--batch', '8',
                    '--device', 'cpu'])
    assert 0.0 <= acc <= 1.0
    assert load_aflink(str(out)).keys() == AFLinkModel().state_dict().keys()
    with pytest.raises(RuntimeError, match='no CUDA device'):
        cli.main(['--out', str(out), '--steps', '1', '--device', 'cuda'])


# ------------------------------------------------------------------ CLI ----

def test_cli_cmc_interpolate_aflink_equal_jax(tmp_path):
    """The CMC config's eval CLI with both post-processors, the port's
    against the JAX CLI's, run side by side.  The linker's fc2 bias is
    set to (-20, 20): every gated pair scores 1.0 exactly in float32 on
    both sides, so AFLink re-links ids and the Hungarian pass sees the
    same costs."""
    from stereotracking_tpu.train.checkpoint import save_checkpoint
    data = tmp_path / 'data'
    write_airdrone_dataset(str(data), n_videos=2, n_frames=4, h=96, w=128)
    pth = reference_pth(tmp_path / 'mono.pth', 'single', 1)
    v = flax_init(5)
    v['params']['fc2']['bias'] = np.array([-20.0, 20.0], np.float32)
    save_checkpoint(str(tmp_path / 'aflink.ckpt'), v)
    save_aflink(str(tmp_path / 'aflink.pt'), aflink_to_state_dict(v))
    cfg = tmp_path / 'cmc.py'
    cfg.write_text(f"""
_base_ = ['{CMC}']
img_scale = (96, 128)
test_dataloader = dict(dataset=dict(data_root='{data}/',
                                    ann_file='annotations.json',
                                    img_prefix=''))
model = dict(detector=dict(backbone=dict(deepen_factor={DEEPEN},
                                         widen_factor={WIDEN})))
""")
    env = dict(os.environ, JAX_PLATFORMS='cpu', OMP_NUM_THREADS='1',
               PYTHONPATH=f'{REPO}:{os.environ.get("PYTHONPATH", "")}')
    runs = {
        'jax': [sys.executable, str(REPO / 'tools' / 'test.py'), str(cfg),
                '--aflink', str(tmp_path / 'aflink.ckpt')],
        'port': [sys.executable, '-m', 'stereotracking_tpu_torch.tools.test',
                 str(cfg), '--device', 'cpu', '--aflink',
                 str(tmp_path / 'aflink.pt')],
    }
    procs = {}
    for side, cmd in runs.items():
        extra = ['--checkpoint', str(pth), '--work-dir', str(tmp_path / side),
                 '--interpolate']
        procs[side] = subprocess.Popen(cmd + extra, cwd=REPO, env=env,
                                       stdout=subprocess.PIPE,
                                       stderr=subprocess.PIPE, text=True)
    metrics = {}
    for side, proc in procs.items():
        _, err = proc.communicate(timeout=600)
        assert proc.returncode == 0, (side, err[-3000:])
        metrics[side] = json.loads(
            (tmp_path / side / 'metrics.json').read_text())
    mj, mp = metrics['jax'], metrics['port']
    assert mj.keys() == mp.keys() and mp['CLR_FP'] > 0, mp
    for k in mj:
        if k == 'fps':
            continue
        if k in COUNT_KEYS:
            assert mp[k] == mj[k], (k, mp[k], mj[k])
        else:
            assert abs(mp[k] - mj[k]) <= 1e-6, (k, mp[k], mj[k])
