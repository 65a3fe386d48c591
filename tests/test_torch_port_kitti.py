"""The KITTI stereo config, its dataset, the MOT-Challenge and KITTI
metrics with the devkit protocol, and the eval CLI on the KITTI and
monocular configs: the PyTorch port against the JAX package, on the CPU.

- ``track_raw`` of the KITTI config (dual backbone, 2 classes; deepen 0.1,
  widen 0.125, 64x96 frames, Flax weights carried by ``utils/convert``)
  over 4 frames: ids, labels and validity exact (both labels detected),
  boxes within 1e-3 px, scores 1e-5, depths and scales rtol 1e-4;
- ``MOTKittiDataset``: the ``img2`` token, the same paths and frames as
  the JAX reader on the same layout; the CLI's ``build_dataset`` picks it
  for the KITTI config;
- ``MOTChallengeMetrics`` and ``MOTKittiMetrics`` (``process_frame`` with
  labels, ``dump_txt`` and ``dump_kitti_txt`` byte-equal),
  ``KittiEvaluator`` (neighbouring-class distractors, occluded, truncated
  and small ground truth, DontCare regions) and ``load_kitti_label_file``:
  results equal to JAX's on the same seeded frames;
- the eval CLI: the port's ``metrics.json`` equal to the JAX
  ``tools/test.py``'s (count metrics exact, the others within 1e-6) for
  the KITTI config on ``write_airdrone_dataset``'s videos renamed to the
  ``img2`` layout (a car and a pedestrian category), and for the monocular
  config on the dataset as written.  The four CLI runs go in parallel.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from stereotracking_tpu.apis.builder import build_model as j_build_model
from stereotracking_tpu_torch.apis.builder import build_model
from stereotracking_tpu_torch.utils.convert import flax_to_state_dict
from synthetic_dataset import write_airdrone_dataset
from test_torch_port_configs import (HEAD_BIAS, assert_results_equal,
                                     random_frames, random_variables,
                                     reference_pth, small_cfg)
from test_torch_port_eval import _random_tracks

REPO = Path(__file__).parent.parent
KITTI = REPO / 'configs/stereo_tracking/ocsort/yolox_s_kitti_disp.py'
MONO = REPO / 'configs/mot/ocsort/yolox_s_ocsort_monocular.py'
DEEPEN, WIDEN = 0.1, 0.125
H, W = 64, 96
COUNT_KEYS = ('CLR_TP', 'CLR_FP', 'CLR_FN', 'IDSW', 'MT', 'PT', 'ML', 'Frag')


@pytest.fixture(autouse=True, scope='module')
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------ track_raw ----

def test_kitti_track_raw_equals_jax():
    v = random_variables('dual', num_classes=2, seed=2, head_bias=HEAD_BIAS)
    cfg = small_cfg(KITTI)
    jm = j_build_model(cfg, variables=v, input_shape=(H, W))
    tm = build_model(cfg, device='cpu')
    assert tm.cfg.detector.num_classes == jm.cfg.detector.num_classes == 2
    tm.module.load_state_dict(flax_to_state_dict(v))
    labels, ids = set(), set()
    for f, (img, disp) in enumerate(random_frames(seed=12)):
        rt = tm.track_raw(img, disp, f)
        assert_results_equal(rt, jm.track_raw(img, disp, f), f'frame {f}')
        labels |= set(rt.det_labels.numpy()[rt.det_valid.numpy()].tolist())
        ids |= set(rt.track_ids.numpy()[rt.track_valid.numpy()].tolist())
    assert labels == {0, 1} and len(ids - {-1}) >= 1


# -------------------------------------------------------------- dataset ----

def write_kitti_dataset(root):
    """``write_airdrone_dataset``'s 2 videos x 4 frames of 96x128 in the
    KITTI naming: each left image moved to ``<seq>/img2/<t>_img2.png``
    (its disparity stays where the ``img2`` token derives it), the
    category renamed 'car' and every odd instance a 'pedestrian'."""
    ann_path = write_airdrone_dataset(str(root), n_videos=2, n_frames=4,
                                      h=96, w=128)
    with open(ann_path) as f:
        ann = json.load(f)
    for img in ann['images']:
        new = img['file_name'].replace('left', 'img2')
        os.makedirs(root / os.path.dirname(new), exist_ok=True)
        os.rename(root / img['file_name'], root / new)
        img['file_name'] = new
    ann['categories'] = [dict(id=1, name='car'),
                         dict(id=2, name='pedestrian')]
    for a in ann['annotations']:
        a['category_id'] = 1 + a['instance_id'] % 2
    with open(ann_path, 'w') as f:
        json.dump(ann, f)
    return ann_path


@pytest.fixture(scope='module')
def kitti_root(tmp_path_factory):
    root = tmp_path_factory.mktemp('kitti')
    write_kitti_dataset(root)
    return root


def test_kitti_dataset_equals_jax(kitti_root):
    from stereotracking_tpu.data import MOTKittiDataset as JKitti
    from stereotracking_tpu_torch.data import (DanceTrackDataset,
                                               MOTDispDataset,
                                               MOTKittiDataset)
    from stereotracking_tpu_torch.tools.test import build_dataset
    ann = str(kitti_root / 'annotations.json')
    kw = dict(data_root=str(kitti_root) + '/',
              classes=('car', 'pedestrian'))
    mine, theirs = MOTKittiDataset(ann, **kw), JKitti(ann, **kw)
    assert mine.path_token == theirs.path_token == 'img2'
    assert mine.videos() == theirs.videos()
    labels = set()
    for vid in mine.videos():
        assert mine.video_frames(vid) == theirs.video_frames(vid)
        for img_id in mine.video_frames(vid):
            a, b = mine.load_frame(img_id), theirs.load_frame(img_id)
            assert a['disp_path'] == b['disp_path']
            assert '/disparity/' in a['disp_path']
            assert a.keys() == b.keys()
            for k in a:
                np.testing.assert_array_equal(np.asarray(a[k]),
                                              np.asarray(b[k]), err_msg=k)
            labels |= set(a['gt_labels'].tolist())
    assert labels == {0, 1}

    cfg = small_cfg(KITTI)
    cfg['test_dataloader']['dataset'].update(
        data_root=str(kitti_root) + '/', ann_file='annotations.json',
        img_prefix='')
    ds = build_dataset(cfg)
    assert type(ds) is MOTKittiDataset and ds.path_token == 'img2'
    cfg['test_dataloader']['dataset'].update(type='MOTDispDataset',
                                             path_token='img2')
    ds = build_dataset(cfg)
    assert type(ds) is MOTDispDataset and ds.path_token == 'img2'
    # a DanceTrack tree (the MOT-challenge layout) is built as the JAX CLI
    # builds it, from data_root, split and visibility_thr
    seq = kitti_root / 'dance' / 'val' / 'dancetrack0001'
    (seq / 'gt').mkdir(parents=True)
    (seq / 'gt' / 'gt.txt').write_text('1,5,10,20,20,32,1,1,1.0\n'
                                       '1,6,40,20,20,32,1,1,0.4\n')
    (seq / 'seqinfo.ini').write_text('[Sequence]\nimDir=img1\nseqLength=1\n'
                                     'imWidth=128\nimHeight=96\n'
                                     'imExt=.jpg\n')
    cfg['test_dataloader']['dataset'] = dict(
        type='DanceTrackDataset', data_root=str(kitti_root / 'dance'),
        split='val', visibility_thr=0.5)
    ds = build_dataset(cfg)
    assert type(ds) is DanceTrackDataset
    assert ds.videos() == ['dancetrack0001']
    info = ds.frame_info(ds.video_frames('dancetrack0001')[0])
    assert (info['width'], info['height']) == (128, 96)
    np.testing.assert_array_equal(info['gt_instance_ids'], [5])
    cfg['test_dataloader']['dataset']['type'] = 'TAODataset'
    with pytest.raises(NotImplementedError, match='Queue 1 item 8'):
        build_dataset(cfg)


# -------------------------------------------------------------- metrics ----

def test_challenge_and_kitti_metrics_equal_jax(tmp_path):
    from stereotracking_tpu.evaluation import MOTChallengeMetrics as JChal
    from stereotracking_tpu.evaluation import MOTKittiMetrics as JKitti
    from stereotracking_tpu_torch.evaluation import (MOTChallengeMetrics,
                                                     MOTKittiMetrics)
    for mine, theirs in ((MOTChallengeMetrics, JChal),
                         (MOTKittiMetrics, JKitti)):
        outs = []
        for cls, name in ((theirs, 'jax'), (mine, 'port')):
            out = tmp_path / cls.__name__ / name
            m = cls(outfile_dir=str(out))
            for v in range(2):
                for t, fr in enumerate(_random_tracks(10 + v)):
                    kw = {}
                    if cls in (MOTKittiMetrics, JKitti):
                        kw['pred_labels'] = np.arange(
                            len(fr['pred_ids'])) % 3
                    m.process_frame(f'v{v}', t, fr['gt_ids'],
                                    fr['gt_bboxes'], fr['gt_depths'],
                                    fr['pred_ids'], fr['pred_bboxes'],
                                    fr['pred_depths'], **kw)
            m.dump_txt()
            if hasattr(m, 'dump_kitti_txt'):
                m.dump_kitti_txt(str(out / 'kitti'))
            txt = {p.relative_to(out): p.read_bytes()
                   for p in sorted(out.rglob('*.txt'))}
            outs.append((m.evaluate(), txt))
        (mj, tj), (mp, tp) = outs
        assert mj == mp and {'HOTA', 'MOTA', 'IDF1'} <= set(mj)
        assert tj == tp and len(tj) == (6 if mine is MOTKittiMetrics
                                        else 4)


def kitti_world(seed, n_frames=6):
    """Per frame the devkit's full annotation surface: cars, vans,
    pedestrians and sitting persons (the neighbouring-class distractors),
    random occlusion / truncation / heights (some ignored), DontCare
    regions, and predictions near the ground truth with misses, false
    positives, swapped ids and some inside the DontCare regions."""
    rng = np.random.RandomState(seed)
    ids = np.arange(8)
    classes = rng.choice([1, 2, 4, 5], 8, p=[0.4, 0.15, 0.3, 0.15])
    base = rng.uniform(0, 300, (8, 2))
    frames = []
    for t in range(n_frames):
        xy = base + t * rng.uniform(-4, 4, (8, 2))
        wh = np.stack([rng.uniform(15, 60, 8), rng.uniform(15, 70, 8)], 1)
        gt = np.concatenate([xy, xy + wh], 1)
        dontcare = np.array([[350, 0, 420, 80], [0, 300, 90, 380]], float)
        keep = rng.rand(8) > 0.15
        pred = gt + rng.normal(0, 2.5, gt.shape)
        fp = np.concatenate([dontcare[:1] + [5, 5, -5, -5],
                             [rng.uniform(100, 200, 2).tolist() * 2]])
        fp[1, 2:] += 30
        pids = np.where(rng.rand(8) < 0.1, 20 + t, ids)
        pcls = np.where(np.isin(classes, (4, 5)), 4, 1)
        frames.append(dict(
            gt_ids=ids, gt_boxes=gt, gt_classes=classes,
            gt_occlusion=rng.randint(0, 4, 8),
            gt_truncation=(rng.rand(8) < 0.15).astype(float),
            pred_ids=np.concatenate([pids[keep], [30, 31]]),
            pred_boxes=np.concatenate([pred[keep], fp]),
            pred_classes=np.concatenate([pcls[keep], [1, 4]]),
            dontcare=dontcare))
    return frames


def test_kitti_protocol_equals_jax(tmp_path):
    from stereotracking_tpu.evaluation import kitti_protocol as JK
    from stereotracking_tpu_torch.evaluation import MOTKittiMetrics
    from stereotracking_tpu_torch.evaluation import kitti_protocol as K
    assert K.KITTI_CLASS_IDS == JK.KITTI_CLASS_IDS
    outs = []
    for mod in (JK, K):
        ev = mod.KittiEvaluator()
        for v in range(2):
            for t, fr in enumerate(kitti_world(20 + v)):
                ev.process_frame(f'v{v}', t, **fr)
        outs.append(ev.evaluate())
    want, got = outs
    assert got.keys() == want.keys() and {'car', 'pedestrian'} <= set(got)
    for k, v in want.items():
        if isinstance(v, dict):
            assert got[k].keys() == v.keys()
            for m in v:
                np.testing.assert_array_equal(np.asarray(got[k][m]),
                                              np.asarray(v[m]), err_msg=k)
        else:
            assert got[k] == v, k
    # the protocol drops something in each frame: distractors, ignores,
    # DontCare
    (gi, _), (pi, _) = K.preprocess_frame('car', **kitti_world(20)[0])
    assert len(gi) < 8 and len(pi) < len(kitti_world(20)[0]['pred_ids'])
    m = MOTKittiMetrics()
    for t, fr in enumerate(kitti_world(20)):
        m.process_frame_kitti('v0', t, **fr)
    res = m.evaluate_kitti()
    assert {'car', 'pedestrian', 'car_MOTA', 'pedestrian_IDF1'} <= set(res)
    with pytest.raises(ValueError, match='invalid KITTI eval class'):
        K.KittiEvaluator(('truck',))

    # a label file with every row kind: evaluated classes, distractors,
    # DontCare, a negative id, other classes, with and without a score
    rows = []
    for t, fr in enumerate(kitti_world(22, 3)):
        names = {1: 'Car', 2: 'Van', 4: 'Pedestrian', 5: 'Person_sitting'}
        for i, b, c, o, tr in zip(fr['gt_ids'], fr['gt_boxes'],
                                  fr['gt_classes'], fr['gt_occlusion'],
                                  fr['gt_truncation']):
            rows.append(f'{t} {i} {names[int(c)]} {tr:.2f} {o} -10 '
                        + ' '.join(f'{x:.2f}' for x in b)
                        + ' 1.5 1.6 3.8 -1 -1 -1 -1'
                        + (' 0.87' if i % 2 else ''))
        rows.append(f'{t} -1 DontCare -1 -1 -10 350 0 420 80 -1 -1 -1 -1000 '
                    f'-1000 -1000 -10')
        rows.append(f'{t} -1 Car 0 0 -10 5 5 50 50 1 1 1 -1 -1 -1 -1')
        rows.append(f'{t} 40 Cyclist 0 0 -10 5 5 50 50 1 1 1 -1 -1 -1 -1')
    path = tmp_path / '0000.txt'
    path.write_text('\n'.join(rows) + '\n')
    for is_gt in (True, False):
        a = K.load_kitti_label_file(str(path), is_gt=is_gt, num_frames=4)
        b = JK.load_kitti_label_file(str(path), is_gt=is_gt, num_frames=4)
        assert a.keys() == b.keys() == {0, 1, 2, 3}
        for t in a:
            assert a[t].keys() == b[t].keys()
            for k in a[t]:
                np.testing.assert_array_equal(a[t][k], b[t][k], err_msg=k)
        assert len(a[0]['dontcare']) == (1 if is_gt else 0)


# ------------------------------------------------------------------ CLI ----

@pytest.fixture(scope='module')
def cli_metrics(tmp_path_factory, kitti_root):
    """metrics.json of the JAX and the port's eval CLIs for the KITTI
    config (on the img2 layout) and the monocular one (on the AirDrone
    layout), the four runs in parallel."""
    root = tmp_path_factory.mktemp('cli')
    mono_root = root / 'mono_data'
    write_airdrone_dataset(str(mono_root), n_videos=2, n_frames=4, h=96,
                           w=128)
    setups = {
        'kitti': (KITTI, kitti_root, reference_pth(root / 'kitti.pth',
                                                   'dual', 2)),
        'mono': (MONO, mono_root, reference_pth(root / 'mono.pth',
                                                'single', 1)),
    }
    env = dict(os.environ, JAX_PLATFORMS='cpu', OMP_NUM_THREADS='1',
               PYTHONPATH=f'{REPO}:{os.environ.get("PYTHONPATH", "")}')
    clis = {'jax': [sys.executable, str(REPO / 'tools' / 'test.py')],
            'port': [sys.executable, '-m',
                     'stereotracking_tpu_torch.tools.test', '--device',
                     'cpu']}
    procs = {}
    for name, (base, data, pth) in setups.items():
        cfg = root / f'{name}.py'
        cfg.write_text(f"""
_base_ = ['{base}']
img_scale = (96, 128)
test_dataloader = dict(dataset=dict(data_root='{data}/',
                                    ann_file='annotations.json',
                                    img_prefix=''))
model = dict(detector=dict(backbone=dict(deepen_factor={DEEPEN},
                                         widen_factor={WIDEN})))
""")
        for side, cmd in clis.items():
            out = root / name / side
            procs[name, side] = (out, subprocess.Popen(
                cmd + [str(cfg), '--checkpoint', pth, '--work-dir',
                       str(out)], cwd=REPO, env=env,
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    metrics = {}
    for key, (out, proc) in procs.items():
        _, err = proc.communicate(timeout=600)
        assert proc.returncode == 0, (key, err[-3000:])
        metrics[key] = json.loads((out / 'metrics.json').read_text())
    return metrics


@pytest.mark.parametrize('config', ['kitti', 'mono'])
def test_cli_metrics_equal_jax(cli_metrics, config):
    mj, mp = cli_metrics[config, 'jax'], cli_metrics[config, 'port']
    assert mj.keys() == mp.keys() and mp['CLR_FP'] > 0, mp
    for k in mj:
        if k == 'fps':
            continue
        if k in COUNT_KEYS:
            assert mp[k] == mj[k], (k, mp[k], mj[k])
        else:
            assert abs(mp[k] - mj[k]) <= 1e-6, (k, mp[k], mj[k])
