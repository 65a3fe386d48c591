"""The evaluation entry point: the PyTorch port against the JAX package.

- the metric copies (``MOTDroneMetrics``, ``CocoMAPEvaluator``,
  ``ResultsCSV``) give the JAX package's results on the same seeded frames;
- checkpoint loading: ``init_model`` on a reference-layout ``.pth`` (a
  ``{'state_dict', 'meta'}`` wrapper, ``detector.``-prefixed keys, RGB
  backbone keys only) gives the weights of the JAX converter's ``'mot'``
  route, the RGB stem and stage 1 copied into the disparity branch; a
  missing or mis-shaped key raises;
- ``inference_mot`` and ``track_video`` equal the JAX ones over 4 frames:
  ids exact, boxes within 1e-3 px (float32 reassociation through the
  detector), depths and scales rtol 1e-4;
- the CLI on ``write_airdrone_dataset``: the port's ``--device cpu``
  ``metrics.json`` against the JAX ``tools/test.py``'s with the same config
  and ``.pth`` (count metrics exact, the others within 1e-6), the MOT txt
  files (same frames and ids, boxes within 1e-3 px), and the port's
  ``--streams 2 --stage-frames`` count metrics against its own sequential
  run.
"""
import csv
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from stereotracking_tpu_torch.models.detector import (DetectorConfig,
                                                      YOLOXDetector)
from stereotracking_tpu_torch.models.mot import init_weights
from synthetic_dataset import write_airdrone_dataset

REPO = Path(__file__).parent.parent
CONFIG = REPO / 'configs/stereo_tracking/ocsort/yolox_s_airdrone_disp.py'
# the CLI config's tiny detector (as tests/test_tools_e2e.py cuts it)
DEEPEN, WIDEN = 0.1, 0.125
HEAD_BIAS = 3.0     # detections clear init_track_thr (sigmoid(3)^2 = 0.91)
COUNT_KEYS = ('CLR_TP', 'CLR_FP', 'CLR_FN', 'IDSW', 'MT', 'PT', 'ML', 'Frag')


@pytest.fixture(autouse=True, scope='module')
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def reference_pth(path, deepen=DEEPEN, widen=WIDEN, seed=0):
    """A reference-layout checkpoint: seeded random weights and BatchNorm
    statistics, raised cls / obj head biases, ``detector.`` keys, the RGB
    branch only, wrapped in ``{'state_dict', 'meta'}``."""
    det = YOLOXDetector(DetectorConfig(deepen_factor=deepen,
                                       widen_factor=widen))
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
    sd = {f'detector.{k}': v for k, v in det.state_dict().items()
          if not k.startswith(('backbone.disp_stem', 'backbone.disp_stage1'))}
    torch.save({'state_dict': sd, 'meta': {'epoch': 1}}, path)
    return path


def _cfg(root=None):
    from stereotracking_tpu_torch.config import load_config
    cfg = load_config(str(CONFIG))
    bb = cfg['model']['detector']['backbone']
    bb['deepen_factor'], bb['widen_factor'] = DEEPEN, WIDEN
    return cfg


# -------------------------------------------------------------- metrics ----

def _random_tracks(seed, n_frames=6, n_obj=4):
    rng = np.random.RandomState(seed)
    frames = []
    base = rng.uniform(0, 200, (n_obj, 2))
    for t in range(n_frames):
        xy = base + t * rng.uniform(-3, 3, (n_obj, 2))
        wh = rng.uniform(10, 40, (n_obj, 2))
        gt = np.concatenate([xy, xy + wh], 1).astype(np.float32)
        pred = gt + rng.normal(0, 3, gt.shape).astype(np.float32)
        keep = rng.rand(n_obj) > 0.2
        frames.append(dict(
            gt_ids=np.arange(n_obj), gt_bboxes=gt,
            gt_depths=rng.uniform(10, 120, n_obj).astype(np.float32),
            pred_ids=np.where(rng.rand(n_obj) < 0.1, 9, np.arange(n_obj))[
                keep], pred_bboxes=pred[keep],
            pred_depths=rng.uniform(-5, 120, n_obj).astype(np.float32)[keep],
            scores=rng.rand(int(keep.sum())).astype(np.float32)))
    return frames


def test_mot_and_coco_metrics_equal_jax(tmp_path):
    from stereotracking_tpu.evaluation import CocoMAPEvaluator as JCoco
    from stereotracking_tpu.evaluation import MOTDroneMetrics as JMOT
    from stereotracking_tpu_torch.evaluation import (CocoMAPEvaluator,
                                                     MOTDroneMetrics)
    outs = []
    for mot_cls, coco_cls, name in ((JMOT, JCoco, 'jax'),
                                    (MOTDroneMetrics, CocoMAPEvaluator,
                                     'port')):
        mot = mot_cls(depth_thr=80.0, outfile_dir=str(tmp_path / name))
        coco = coco_cls(num_classes=1)
        for v in range(2):
            for t, fr in enumerate(_random_tracks(v)):
                mot.process_frame(f'v{v}', t, fr['gt_ids'], fr['gt_bboxes'],
                                  fr['gt_depths'], fr['pred_ids'],
                                  fr['pred_bboxes'], fr['pred_depths'])
                img_id = 100 * v + t
                coco.add_gt(img_id, fr['gt_bboxes'],
                            np.zeros(len(fr['gt_ids']), int))
                coco.add_dt(img_id, fr['pred_bboxes'], fr['scores'],
                            np.zeros(len(fr['scores']), int))
        mot.dump_txt()
        txt = {p.relative_to(tmp_path / name): p.read_text()
               for p in sorted((tmp_path / name).rglob('*.txt'))}
        outs.append(({**mot.evaluate(), **coco.evaluate()}, txt))
    (mj, tj), (mp, tp) = outs
    assert mj.keys() == mp.keys() and {'HOTA', 'MOTA', 'mAP'} <= set(mj)
    for k in mj:
        assert mj[k] == mp[k], (k, mj[k], mp[k])
    assert tj == tp and len(tj) == 4


def test_results_csv_equals_jax(tmp_path):
    from stereotracking_tpu.models.mot import FrameResult as JFR
    from stereotracking_tpu.utils.collect_results import ResultsCSV as JCSV
    from stereotracking_tpu_torch.models.mot import FrameResult
    from stereotracking_tpu_torch.utils.collect_results import ResultsCSV
    rng = np.random.RandomState(3)
    fields = dict(
        det_bboxes=rng.rand(5, 4), det_scores=rng.rand(5),
        det_labels=np.zeros(5, int), det_valid=rng.rand(5) > 0.5,
        track_bboxes=rng.rand(6, 4) * 100, track_scores=rng.rand(6),
        track_labels=np.zeros(6, int), track_scales=rng.rand(6) + 1,
        track_depths=rng.rand(6) * 50, track_gt_depths=rng.rand(6) * 50,
        track_ids=rng.randint(0, 9, 6), track_valid=rng.rand(6) > 0.3)
    for cls, fr, name in ((JCSV, JFR, 'j.csv'), (ResultsCSV, FrameResult,
                                                  'p.csv')):
        dump = cls(str(tmp_path / name))
        for t in range(3):
            dump.append_frame(t, fr(**fields))
    assert ((tmp_path / 'j.csv').read_text()
            == (tmp_path / 'p.csv').read_text())


# ----------------------------------------------------------- checkpoint ----

def test_init_model_loads_reference_checkpoint(tmp_path):
    from stereotracking_tpu.utils.torch_convert import convert_zoo_checkpoint
    from stereotracking_tpu_torch.apis.inference import init_model
    from stereotracking_tpu_torch.utils.convert import flax_to_state_dict
    pth = reference_pth(tmp_path / 'ref.pth')
    model = init_model(_cfg(), str(pth), device='cpu')
    want = flax_to_state_dict(convert_zoo_checkpoint(str(pth), 'mot'))
    got = model.module.state_dict()
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k
    assert torch.equal(got['backbone.disp_stage1.1.final_conv.conv.weight'],
                       got['backbone.stage1.1.final_conv.conv.weight'])

    sd = torch.load(pth, weights_only=False)['state_dict']
    bad = dict(sd)
    k = 'detector.neck.out_convs.1.conv.weight'
    bad[k] = torch.zeros(bad[k].shape[0] + 1, *bad[k].shape[1:])
    torch.save({'state_dict': bad}, tmp_path / 'bad.pth')
    with pytest.raises(ValueError, match='another shape'):
        init_model(_cfg(), str(tmp_path / 'bad.pth'), device='cpu')
    del sd['detector.bbox_head.head_module.multi_level_conv_obj.2.bias']
    torch.save(sd, tmp_path / 'short.pth')          # a bare state dict
    with pytest.raises(ValueError, match='missing'):
        init_model(_cfg(), str(tmp_path / 'short.pth'), device='cpu')
    with pytest.raises(NotImplementedError, match='orbax'):
        init_model(_cfg(), str(tmp_path / 'x.ckpt'), device='cpu')


# ------------------------------------------------------- inference APIs ----

def _frames(n=4, h=72, w=100, seed=5):
    rng = np.random.RandomState(seed)
    img0 = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
    disp0 = rng.randint(16, 1600, (h, w)).astype(np.uint16)
    disp0[rng.rand(h, w) < 0.1] = 65535
    depth0 = rng.uniform(5, 90, (h, w)).astype(np.float32)
    return [(np.roll(img0, 2 * f, 1), np.roll(disp0, 2 * f, 1),
             np.roll(depth0, 2 * f, 1)) for f in range(n)]


def _assert_close(a, b, what):
    """Port (numpy) against JAX: ids exact, boxes 1e-3 px, depths and
    scales rtol 1e-4."""
    for name in ('instances_id', 'labels'):
        if name in b:
            np.testing.assert_array_equal(a[name], np.asarray(b[name]),
                                          err_msg=f'{what} {name}')
    np.testing.assert_allclose(a['bboxes'], np.asarray(b['bboxes']),
                               atol=1e-3, rtol=0, err_msg=f'{what} bboxes')
    np.testing.assert_allclose(a['scores'], np.asarray(b['scores']),
                               atol=1e-5, rtol=0, err_msg=f'{what} scores')
    for name in ('depth', 'gt_depth', 'scales'):
        if name in b:
            np.testing.assert_allclose(a[name], np.asarray(b[name]),
                                       rtol=1e-4, atol=1e-4,
                                       err_msg=f'{what} {name}')


def test_inference_mot_equals_jax(tmp_path):
    from stereotracking_tpu.apis.inference import init_model as j_init
    from stereotracking_tpu.apis.inference import inference_mot as j_inf
    from stereotracking_tpu_torch.apis.inference import (init_model,
                                                         inference_mot)
    pth = str(reference_pth(tmp_path / 'ref.pth'))
    scale = (64, 90)                 # a keep-ratio resize of 72 x 100
    jm = j_init(_cfg(), pth, input_shape=(64, 96))
    tm = init_model(_cfg(), pth, device='cpu')
    n_ids = set()
    for f, (img, disp, depth) in enumerate(_frames()):
        rj = j_inf(jm, img, disp, f, depth=depth, scale=scale)
        rt = inference_mot(tm, img, disp, f, depth=depth, scale=scale)
        for part in ('det_instances', 'track_instances'):
            _assert_close(rt[part], rj[part], f'frame {f} {part}')
        n_ids |= set(rt['track_instances']['instances_id'].tolist())
    assert n_ids, 'no track was reported'


def test_track_video_equals_jax(tmp_path):
    import jax.numpy as jnp

    from stereotracking_tpu.apis.inference import init_model as j_init
    from stereotracking_tpu.models import tracker as jtrk
    from stereotracking_tpu.models.mot import track_video as j_track_video
    from stereotracking_tpu.models.preprocessor import preprocess_frame
    from stereotracking_tpu_torch.apis.inference import init_model
    from stereotracking_tpu_torch.models import tracker as trk
    from stereotracking_tpu_torch.models.mot import track_video
    from stereotracking_tpu_torch.models.preprocessor import (
        padded_shape, preprocess_frame_pure)
    pth = str(reference_pth(tmp_path / 'ref.pth'))
    frames = _frames(h=64, w=96)
    oh, ow = padded_shape(64, 96)
    jm = j_init(_cfg(), pth, input_shape=(oh, ow))
    tm = init_model(_cfg(), pth, device='cpu')
    jin = [preprocess_frame(jnp.asarray(i), jnp.asarray(d), oh, ow,
                            depth_raw=jnp.asarray(z)) for i, d, z in frames]
    jframes = {k: jnp.stack([x[k] for x in jin]) for k in jin[0]}
    tin = [preprocess_frame_pure(torch.from_numpy(i)[None],
                                 torch.from_numpy(d)[None], oh, ow,
                                 torch.from_numpy(z)[None])
           for i, d, z in frames]
    tframes = {k: torch.stack([x[k] for x in tin]) for k in tin[0]}
    sf = (1.5, 1.25)
    _, rj = j_track_video(jm.variables, jm.module,
                          jtrk.init_state(jm.cfg.tracker), jframes,
                          jnp.arange(4, dtype=jnp.int32), jm.cfg, sf)
    _, rt = track_video(tm.module, trk.init_state(tm.cfg.tracker), tframes,
                        range(4), tm.cfg, sf)
    assert rt.track_ids.shape[0] == 4
    for name in ('det_valid', 'track_ids', 'track_valid', 'track_labels'):
        np.testing.assert_array_equal(getattr(rt, name).numpy(),
                                      np.asarray(getattr(rj, name)), name)
    for name in ('det_bboxes', 'track_bboxes'):
        np.testing.assert_allclose(getattr(rt, name).numpy(),
                                   np.asarray(getattr(rj, name)), atol=1e-3,
                                   rtol=0, err_msg=name)
    for name in ('track_depths', 'track_scales', 'track_gt_depths'):
        np.testing.assert_allclose(getattr(rt, name).numpy(),
                                   np.asarray(getattr(rj, name)), rtol=1e-4,
                                   atol=1e-4, err_msg=name)
    assert int(rt.track_valid.sum()) > 0


# ------------------------------------------------------------------ CLI ----

@pytest.fixture(scope='module')
def cli_setup(tmp_path_factory):
    """The synthetic dataset, its config, the ``.pth``, and the JAX
    ``tools/test.py`` run on them (once for the module)."""
    root = tmp_path_factory.mktemp('eval')
    write_airdrone_dataset(str(root), n_videos=2, n_frames=4, h=96, w=128)
    pth = reference_pth(root / 'ref.pth')
    cfg = root / 'cfg.py'
    cfg.write_text(f"""
_base_ = ['{CONFIG}']
data_root = '{root}/'
img_scale = (96, 128)
test_dataloader = dict(dataset=dict(data_root='{root}/',
                                    ann_file='annotations.json',
                                    img_prefix='', depth_dir_name='depth'))
model = dict(detector=dict(backbone=dict(deepen_factor={DEEPEN},
                                         widen_factor={WIDEN})))
""")
    out = root / 'jax'
    env = dict(os.environ, JAX_PLATFORMS='cpu',
               PYTHONPATH=f'{REPO}:{os.environ.get("PYTHONPATH", "")}')
    r = subprocess.run(
        [sys.executable, str(REPO / 'tools' / 'test.py'), str(cfg),
         '--checkpoint', str(pth), '--work-dir', str(out), '--dump-txt',
         '--results-csv', str(root / 'jax.csv')],
        env=env, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    return root, cfg, pth, out


def _mot_rows(path):
    rows = {}
    for line in path.read_text().splitlines():
        v = line.split(',')
        rows[(int(v[0]), int(v[1]))] = np.array(v[2:6], float)
    return rows


def test_cli_metrics_equal_jax(cli_setup):
    root, cfg, pth, jax_out = cli_setup
    out = root / 'port'
    env = dict(os.environ, OMP_NUM_THREADS='1',
               PYTHONPATH=f'{REPO}:{os.environ.get("PYTHONPATH", "")}')
    r = subprocess.run(
        [sys.executable, '-m', 'stereotracking_tpu_torch.tools.test',
         str(cfg), '--device', 'cpu', '--checkpoint', str(pth),
         '--work-dir', str(out), '--dump-txt', '--results-csv',
         str(root / 'port.csv')],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert 'jax' not in r.stderr.lower()
    mj = json.loads((jax_out / 'metrics.json').read_text())
    mp = json.loads((out / 'metrics.json').read_text())
    assert mj.keys() == mp.keys() and 'fps' in mp
    assert mp['CLR_FP'] > 0, mp       # the tracker reported tracks
    for k in mj:
        if k == 'fps':
            continue
        if k in COUNT_KEYS:
            assert mp[k] == mj[k], (k, mp[k], mj[k])
        else:
            assert abs(mp[k] - mj[k]) <= 1e-6, (k, mp[k], mj[k])
    txt_j = sorted(p.relative_to(jax_out) for p in jax_out.rglob('*.txt'))
    txt_p = sorted(p.relative_to(out) for p in out.rglob('*.txt'))
    assert txt_j == txt_p and len(txt_j) == 4
    for rel in txt_j:
        a, b = _mot_rows(out / rel), _mot_rows(jax_out / rel)
        assert a.keys() == b.keys(), rel
        for key in a:
            np.testing.assert_allclose(a[key], b[key], atol=1e-3, rtol=0)
    with open(root / 'port.csv') as fp, open(root / 'jax.csv') as fj:
        cp, cj = list(csv.reader(fp)), list(csv.reader(fj))
    assert len(cp) == len(cj) > 1
    for a, b in zip(cp[1:], cj[1:]):
        assert a[:3] == b[:3]                      # frame, id, label
    lines = [json.loads(ln) for ln in
             (out / 'scalars.jsonl').read_text().splitlines()]
    assert any(ln['prefix'] == 'metrics' and 'MOTA' in ln for ln in lines)
    evals = [ln for ln in lines if ln['prefix'] == 'eval']
    assert evals and all({'fps', 'phase.detector_ms', 'phase.tracker_ms',
                          'host.frames_ms', 'host.fetch_ms'} <= set(ln)
                         for ln in evals), evals


def test_cli_streams_equal_sequential(cli_setup):
    from stereotracking_tpu_torch.tools import test as cli
    root, cfg, pth, _ = cli_setup
    base = [str(cfg), '--device', 'cpu', '--checkpoint', str(pth)]
    seq = cli.main(base + ['--work-dir', str(root / 'seq')])
    ms = cli.main(base + ['--work-dir', str(root / 'ms'), '--streams', '2',
                          '--stage-frames'])
    for k in ('MOTA', 'IDF1') + COUNT_KEYS:
        assert seq[k] == ms[k], (k, seq[k], ms[k])
    assert seq['CLR_FP'] > 0
    groups = [json.loads(ln) for ln in
              (root / 'ms' / 'scalars.jsonl').read_text().splitlines()]
    groups = [ln for ln in groups if ln['prefix'] == 'eval']
    assert groups and all(ln['phase.nms_ms'] > 0 and ln['host.frames_ms'] > 0
                          for ln in groups), groups


def test_cli_refuses_unported_flags(cli_setup):
    """The flags of several processes stay refused (ROADMAP Queue 1 item
    6); the drawing flags are taken (their output:
    tests/test_torch_port_visualize.py)."""
    from stereotracking_tpu_torch.tools import test as cli
    _, cfg, _, _ = cli_setup
    for flag in (['--dist-coordinator', 'h:1'], ['--launcher', 'jax'],
                 ['--dist-num-processes', '2'], ['--dist-process-id', '1']):
        with pytest.raises(NotImplementedError, match='Queue 1 item 6'):
            cli.parse_args([str(cfg)] + flag)
    for flags, want in (([], (None, 30, False)),
                        (['--show-errors'], (None, 30, True)),
                        (['--show-dir', 'vis'], ('vis', 30, False)),
                        (['--show-dir', 'vis', '--show-interval', '2',
                          '--show-errors', '--launcher', 'none'],
                         ('vis', 2, True))):
        args = cli.parse_args([str(cfg)] + flags)
        assert (args.show_dir, args.show_interval, args.show_errors) == want
    with pytest.raises(RuntimeError, match='no CUDA device'):
        cli.main([str(cfg), '--device', 'cuda', '--work-dir',
                  str(cfg.parent / 'cuda')])


def test_port_imports_no_pillow():
    """The card's machine has no Pillow: no module of the port imports it
    when imported (the readers import it inside the functions that read
    or resize)."""
    code = (
        'import sys, pkgutil, importlib\n'
        'import stereotracking_tpu_torch as p\n'
        'for m in pkgutil.walk_packages(p.__path__, p.__name__ + "."):\n'
        '    importlib.import_module(m.name)\n'
        'assert "stereotracking_tpu_torch.tools.test" in sys.modules\n'
        'bad = sorted(k for k in sys.modules if k.split(".")[0] == "PIL")\n'
        'assert not bad, bad\n')
    r = subprocess.run([sys.executable, '-c', code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
