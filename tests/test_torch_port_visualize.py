"""The eval CLI's drawing, the DanceTrack reader and the small tools: the
PyTorch port against the JAX package, on the CPU.

- every function of the port's ``visualization`` module returns arrays
  bit-equal to the JAX module's on seeded inputs;
- ``tools.test --show-dir`` on the synthetic on-disk dataset writes the
  same file tree as the JAX ``tools/test.py`` with the same config and
  ``.pth``, with byte-equal images: sequential without ``--show-errors``,
  ``--streams 2`` with it;
- ``DanceTrackDataset`` reads the tree ``tests/test_tao_dancetrack_data.py``
  writes as the JAX reader does, and the CLI scores it (depth ignored) as
  the JAX CLI does, drawing the same error images;
- ``demo_track --device cpu``, ``print_config`` and ``extract_det_model``
  (EMA and ``--no-ema``) run, and their outputs load.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from synthetic_dataset import write_airdrone_dataset
from test_tao_dancetrack_data import dancetrack_root  # noqa: F401
from test_torch_port_eval import (COUNT_KEYS, CONFIG, DEEPEN, WIDEN,
                                  reference_pth)

REPO = Path(__file__).parent.parent
JAX_ENV = dict(os.environ, JAX_PLATFORMS='cpu',
               PYTHONPATH=f'{REPO}:{os.environ.get("PYTHONPATH", "")}')


@pytest.fixture(autouse=True, scope='module')
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ----------------------------------------------------------- visualizer ----

def _frame(seed, h=72, w=96):
    rng = np.random.RandomState(seed)
    img = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
    gt = np.array([[5, 6, 30, 40], [50, 10, 80, 50], [20, 45, 44, 70]],
                  np.float32)
    pred = np.concatenate([gt[:2] + rng.normal(0, 2, (2, 4)),
                           [[60, 55, 90, 70]]]).astype(np.float32)
    return img, gt, np.array([3, 8, 11]), pred


def _draw_mot_errors(mod):
    img, gt, gt_ids, pred = _frame(1)
    out, prev = mod.draw_mot_errors(img, gt, gt_ids, pred, np.array([1, 2,
                                                                     4]), {})
    # frame 2: gt 3 taken by another id (an ID switch), gt 11 missed
    out2, prev2 = mod.draw_mot_errors(img, gt, gt_ids, pred[[1, 0, 2]],
                                      np.array([2, 7, 4]), prev)
    return [out, out2, np.array(sorted(prev2.items()))]


VIS_CASES = {
    'id_color': lambda m: [np.array([m.id_color(i) for i in
                                     (0, 1, 7, 2 ** 31 + 5, 123456)])],
    'draw': lambda m: [m.TrackVisualizer().draw(
        *_frame(2)[:2], np.array([4, -1, 9]), np.array([0.5, 0.25, 0.125])),
        m.TrackVisualizer(line_width=1, show_score=False).draw(
            _frame(3)[0], _frame(3)[3], color=(10, 20, 30))],
    'draw_gt_pred': lambda m: [m.TrackVisualizer().draw_gt_pred(
        _frame(4)[0], _frame(4)[1], _frame(4)[2], _frame(4)[3],
        np.array([5, 6, 7]), np.array([0.9, 0.8, 0.7]))],
    'draw_mot_errors': _draw_mot_errors,
    'paste_mask': lambda m: [m.paste_mask(
        np.random.RandomState(5).rand(28, 28), b, 60, 80)
        for b in ([3.4, 5.6, 40.2, 30.9], [70, 50, 90, 75], [-5, -5, 2, 1])],
    'overlay_masks': lambda m: [m.overlay_masks(
        _frame(6)[0], np.random.RandomState(6).rand(2, 72, 96) > 0.5,
        np.array([3, 12]), alpha=0.4)],
}


@pytest.mark.parametrize('name', sorted(VIS_CASES))
def test_visualizer_equals_jax(name):
    from stereotracking_tpu.visualization import visualizer as jvis
    from stereotracking_tpu_torch.visualization import visualizer as pvis
    got, want = VIS_CASES[name](pvis), VIS_CASES[name](jvis)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    assert pvis.ERROR_COLORS == jvis.ERROR_COLORS


# ---------------------------------------------------------- --show-dir ----

def _jax_cli(cfg, work, *flags):
    """The JAX ``tools/test.py`` on ``cfg``, started: wait on the returned
    process, then read ``work/metrics.json``."""
    return subprocess.Popen(
        [sys.executable, str(REPO / 'tools' / 'test.py'), str(cfg),
         '--work-dir', str(work), *flags], env=JAX_ENV,
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)


def _tree(root):
    return {p.relative_to(root): p.read_bytes()
            for p in sorted(root.rglob('*')) if p.is_file()}


def _write_cfg(path, dataset):
    path.write_text(f"""
_base_ = ['{CONFIG}']
img_scale = (96, 128)
test_dataloader = dict(dataset=dict({dataset}))
model = dict(detector=dict(backbone=dict(deepen_factor={DEEPEN},
                                         widen_factor={WIDEN})))
""")
    return path


SHOW_MODES = {'sequential': ['--show-interval', '2'],
              'streams2_errors': ['--show-interval', '2', '--show-errors',
                                  '--streams', '2']}
DANCE_FLAGS = ['--show-interval', '2', '--show-errors', '--max-videos', '1']


@pytest.fixture(scope='module')
def cli_runs(tmp_path_factory, dancetrack_root):  # noqa: F811
    """The synthetic on-disk dataset (2 videos x 3 frames) and a DanceTrack
    config, one ``.pth``, and the JAX CLI's runs on them, all started at
    once: each of ``SHOW_MODES`` on the first, ``DANCE_FLAGS`` on the
    second."""
    root = tmp_path_factory.mktemp('show')
    write_airdrone_dataset(str(root), n_videos=2, n_frames=3, h=96, w=128)
    pth = reference_pth(root / 'ref.pth')
    cfg = _write_cfg(root / 'cfg.py', f"data_root='{root}/', "
                     "ann_file='annotations.json', img_prefix='', "
                     "depth_dir_name='depth'")
    dance = _write_cfg(root / 'dance.py', "type='DanceTrackDataset', "
                       f"data_root='{dancetrack_root}/', split='val'")
    procs = [_jax_cli(cfg, root / f'jax_{mode}', '--checkpoint', str(pth),
                      '--show-dir', str(root / f'jax_show_{mode}'), *flags)
             for mode, flags in SHOW_MODES.items()]
    procs.append(_jax_cli(dance, root / 'jax_dance', '--checkpoint',
                          str(pth), '--show-dir', str(root / 'jax_show_dance'),
                          *DANCE_FLAGS))
    for proc in procs:
        _, err = proc.communicate(timeout=600)
        assert proc.returncode == 0, err[-3000:]
    return root, cfg, dance, pth


@pytest.mark.parametrize('mode', sorted(SHOW_MODES))
def test_show_dir_equals_jax(cli_runs, mode):
    from stereotracking_tpu_torch.tools import test as cli
    root, cfg, _, pth = cli_runs
    show = root / f'port_show_{mode}'
    cli.main([str(cfg), '--device', 'cpu', '--checkpoint', str(pth),
              '--work-dir', str(root / f'port_{mode}'), '--show-dir',
              str(show), *SHOW_MODES[mode]])
    got, want = _tree(show), _tree(root / f'jax_show_{mode}')
    assert sorted(map(str, got)) == sorted(
        f'seq{v:02d}/{t:06d}.jpg' for v in range(2) for t in (0, 2))
    assert got.keys() == want.keys()
    for rel in got:
        assert got[rel] == want[rel], rel


# ----------------------------------------------------------- DanceTrack ----

def test_dancetrack_dataset_equals_jax(dancetrack_root):  # noqa: F811
    from stereotracking_tpu.data import DanceTrackDataset as JDance
    from stereotracking_tpu_torch.data import DanceTrackDataset
    for kw in ({}, {'visibility_thr': 0.8}):
        mine = DanceTrackDataset(str(dancetrack_root), split='val', **kw)
        theirs = JDance(str(dancetrack_root), split='val', **kw)
        assert mine.videos() == theirs.videos() and len(mine) == len(theirs)
        for vid in mine.videos():
            assert mine.video_name(vid) == theirs.video_name(vid)
            assert mine.video_frames(vid) == theirs.video_frames(vid)
            for img_id in mine.video_frames(vid):
                a, b = mine.load_frame(img_id), theirs.load_frame(img_id)
                assert a.keys() == b.keys()
                for k in a:
                    np.testing.assert_array_equal(np.asarray(a[k]),
                                                  np.asarray(b[k]),
                                                  err_msg=k)


def test_dancetrack_cli_equals_jax(cli_runs):
    """The CLI on a ``DanceTrackDataset`` config scores as the JAX CLI
    does, depth ignored (no ground-truth depth exists), and draws the same
    error images."""
    from stereotracking_tpu_torch.tools import test as cli
    root, _, dance, pth = cli_runs
    mp = cli.main([str(dance), '--device', 'cpu', '--work-dir',
                   str(root / 'port_dance'), '--checkpoint', str(pth),
                   '--show-dir', str(root / 'port_show_dance'),
                   *DANCE_FLAGS])
    mj = json.loads((root / 'jax_dance' / 'metrics.json').read_text())
    assert mp['CLR_FP'] + mp['CLR_TP'] > 0, mp
    assert mj.keys() == mp.keys()
    for k in mj:
        if k == 'fps':
            continue
        if k in COUNT_KEYS:
            assert mp[k] == mj[k], (k, mp[k], mj[k])
        else:
            assert abs(mp[k] - mj[k]) <= 1e-6, (k, mp[k], mj[k])
    got = _tree(root / 'port_show_dance')
    assert len(got) == 2 and got == _tree(root / 'jax_show_dance')


# ---------------------------------------------------------------- tools ----

def test_demo_track_on_the_cpu(tmp_path):
    from stereotracking_tpu_torch.tools import demo_track
    write_airdrone_dataset(str(tmp_path), n_videos=1, n_frames=3, h=96,
                           w=128)
    pth = reference_pth(tmp_path / 'ref.pth')
    cfg = tmp_path / 'cfg.py'
    cfg.write_text(f"""
_base_ = ['{CONFIG}']
model = dict(detector=dict(backbone=dict(deepen_factor={DEEPEN},
                                         widen_factor={WIDEN})))
""")
    frames = str(tmp_path / 'airsim' / 'seq00')
    out = tmp_path / 'demo'
    ids = demo_track.main([str(cfg), frames, '--checkpoint', str(pth),
                           '--out-dir', str(out), '--device', 'cpu'])
    assert len(ids) == 3 and any(ids)
    assert sorted(p.name for p in out.iterdir()) == [
        f'{t:06d}.jpg' for t in range(3)]
    with pytest.raises(RuntimeError, match='no CUDA device'):
        demo_track.main([str(cfg), frames, '--out-dir', str(out)])


def test_print_config_equals_jax(capsys):
    from stereotracking_tpu.config import apply_overrides, load_config
    from stereotracking_tpu_torch.tools import print_config
    opts = ['model.tracker.num_slots=32', 'img_scale=(96,128)']
    cfg = print_config.main([str(CONFIG), '--cfg-options', *opts])
    assert cfg == apply_overrides(load_config(str(CONFIG)), opts)
    assert cfg['model']['tracker']['num_slots'] == 32
    assert "'num_slots': 32" in capsys.readouterr().out


@pytest.mark.parametrize('ema', [True, False], ids=['ema', 'no_ema'])
def test_extract_det_model(tmp_path, ema):
    """A train checkpoint whose EMA differs from its module: the export
    holds the EMA (or with ``--no-ema`` the module), and ``init_model``
    loads it as it is."""
    from stereotracking_tpu_torch.apis.inference import init_model
    from stereotracking_tpu_torch.config import load_config
    from stereotracking_tpu_torch.models.detector import (DetectorConfig,
                                                          YOLOXDetector)
    from stereotracking_tpu_torch.tools import extract_det_model
    from stereotracking_tpu_torch.train.checkpoint import save_checkpoint
    from stereotracking_tpu_torch.train.train_state import \
        create_train_state
    det = YOLOXDetector(DetectorConfig(deepen_factor=DEEPEN,
                                       widen_factor=WIDEN))
    state = create_train_state(det, lambda s: 1e-3, seed=3)
    with torch.no_grad():
        for p in state.module.parameters():
            p.add_(0.01)
    ckpt = tmp_path / 'epoch_1.pth'
    save_checkpoint(str(ckpt), state.state_dict())
    out = tmp_path / 'det.pth'
    extract_det_model.main([str(ckpt), str(out)]
                           + ([] if ema else ['--no-ema']))
    cfg = load_config(str(CONFIG))
    bb = cfg['model']['detector']['backbone']
    bb['deepen_factor'], bb['widen_factor'] = DEEPEN, WIDEN
    loaded = init_model(cfg, str(out), device='cpu').module.state_dict()
    src = (state.ema if ema else state.module).state_dict()
    other = (state.module if ema else state.ema).state_dict()
    assert loaded.keys() == src.keys()
    for k, v in src.items():
        if v.is_floating_point():
            assert torch.equal(loaded[k], v), k
    assert any(not torch.equal(loaded[k], other[k]) for k in src
               if src[k].is_floating_point())
    for bad in ('ckpt.msgpack', 'orbax_dir/'):
        with pytest.raises(NotImplementedError, match='orbax or msgpack'):
            extract_det_model.main([str(tmp_path / bad), str(out)])
