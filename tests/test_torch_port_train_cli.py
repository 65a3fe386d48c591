"""The port's train CLI, its export and its bench, on the CPU.

- ``make_batch`` gives arrays and ``gt_*`` equal to the JAX
  ``tools/train.make_batch`` (exact) for the same dataset, indices and
  seed, in both stages (MixUp on, then off);
- ``python -m stereotracking_tpu_torch.tools.train --device cpu`` over 2
  epochs x 2 steps of ``tests/synthetic_dataset.write_airdrone_dataset``,
  with ``save_epoch_intervals = 1`` and ``num_last_epochs = 1`` so that it
  checkpoints every epoch and runs both stages (MixUp, then L1), and with
  validation: finite losses in ``scalars.jsonl`` (``loss_l1`` in stage 2
  only), the checkpoints and the ``last_checkpoint`` marker,
  ``detector_final.pth``; then ``--resume`` twice: each run starts at the
  saved epoch, and the fourth checkpoint rotates the first out;
- the export loads through ``init_model`` as it is, the disparity branch's
  own stem and stage 1 included, while a reference ``.pth`` still gets the
  RGB branch copied; ``tools.test`` evaluates the export;
- the training module in train mode refuses a ``'cuda'`` stage and bf16,
  and ``--launcher`` other than ``none`` raises;
- ``tools.bench_train --device cpu`` (its small rehearsal sizes) prints its
  JSON line.
"""
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from stereotracking_tpu_torch.models.csp_darknet import StageBackends
from stereotracking_tpu_torch.models.detector import (DetectorConfig,
                                                      YOLOXDetector)
from stereotracking_tpu_torch.utils.checkpoint import DETECTOR_FORMAT
from synthetic_dataset import write_airdrone_dataset
from test_torch_port_eval import reference_pth

REPO = Path(__file__).parent.parent
CONFIG = REPO / 'configs/stereo_tracking/ocsort/yolox_s_airdrone_disp.py'
H, W = 96, 128


@pytest.fixture(autouse=True, scope='module')
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope='module')
def setup(tmp_path_factory):
    root = tmp_path_factory.mktemp('train_cli')
    write_airdrone_dataset(str(root), n_videos=2, n_frames=4, h=H, w=W)
    cfg = root / 'cfg.py'
    cfg.write_text(f"""
_base_ = ['{CONFIG}']
data_root = '{root}/'
img_scale = ({H}, {W})
save_epoch_intervals = 1
num_last_epochs = 1
log_interval = 1
train_dataloader = dict(batch_size=2,
                        dataset=dict(data_root='{root}/',
                                     ann_file='annotations.json',
                                     img_prefix=''))
val_dataloader = dict(dataset=dict(data_root='{root}/',
                                   ann_file='annotations.json',
                                   img_prefix='', depth_dir_name='depth'))
test_dataloader = val_dataloader
model = dict(detector=dict(backbone=dict(deepen_factor=0.1,
                                         widen_factor=0.125)))
""")
    return root, cfg


@pytest.mark.parametrize('stage2', [False, True])
def test_make_batch_equals_jax(setup, stage2):
    from stereotracking_tpu.data import CocoDispDataset as JDataset
    from stereotracking_tpu_torch.data import CocoDispDataset
    from stereotracking_tpu_torch.tools.train import make_batch
    from tools.train import make_batch as j_make_batch
    root, _ = setup
    kw = dict(ann_file=str(root / 'annotations.json'), data_root=str(root))
    idx = np.array([0, 5, 3])
    outs = [fn(ds(**kw), idx, (H, W), 8, np.random.RandomState(7), stage2)
            for fn, ds in ((j_make_batch, JDataset),
                           (make_batch, CocoDispDataset))]
    assert outs[0].keys() == outs[1].keys()
    for k in outs[0]:
        assert outs[0][k].dtype == outs[1][k].dtype, k
        np.testing.assert_array_equal(outs[1][k], outs[0][k], err_msg=k)
    assert outs[1]['gt_valid'].sum() > 0
    assert outs[1]['img'].shape == (3, H, W, 3)


def _scalars(work):
    return [json.loads(ln) for ln in
            (work / 'scalars.jsonl').read_text().splitlines()]


def test_cli_trains_checkpoints_resumes_and_exports(setup):
    from stereotracking_tpu_torch.tools import train as cli
    root, cfg = setup
    work = root / 'work'
    common = [str(cfg), '--work-dir', str(work), '--steps-per-epoch', '2',
              '--max-gt', '8', '--device', 'cpu']
    r = subprocess.run(
        [sys.executable, '-m', 'stereotracking_tpu_torch.tools.train']
        + common + ['--max-epochs', '2', '--val-interval', '1'],
        cwd=REPO, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=str(REPO)))
    assert r.returncode == 0, r.stderr[-3000:]
    assert '[val] mAP' in r.stdout
    train = [s for s in _scalars(work) if s['prefix'] == 'train']
    assert [s['step'] for s in train] == [0, 1, 2, 3]
    for s in train:
        for k in ('loss', 'loss_cls', 'loss_bbox', 'loss_obj', 'lr'):
            assert math.isfinite(s[k]), (k, s)
        # stage 1 (MixUp, no L1) is epoch 0; stage 2 (L1) the last epoch
        assert ('loss_l1' in s) == (s['epoch'] == 1), s
        if 'loss_l1' in s:
            assert math.isfinite(s['loss_l1'])
    assert sum(s['prefix'] == 'val' for s in _scalars(work)) == 2
    assert sorted(os.listdir(work)) == [
        'detector_final.pth', 'epoch_1.pth', 'epoch_2.pth',
        'last_checkpoint', 'scalars.jsonl']
    assert (work / 'last_checkpoint').read_text() == str(work / 'epoch_2.pth')
    final = torch.load(work / 'detector_final.pth', weights_only=True)
    assert final['meta'] == {'format': DETECTOR_FORMAT, 'step': 4}

    # --resume starts at the saved epoch; a 4th checkpoint drops the 1st
    epoch2 = torch.load(work / 'epoch_2.pth', weights_only=True)
    for max_epochs, steps in ((3, 6), (4, 8)):
        state = cli.main(common + ['--max-epochs', str(max_epochs),
                                   '--resume'])
        assert state.step == steps
    train = [s for s in _scalars(work) if s['prefix'] == 'train']
    assert [s['step'] for s in train] == list(range(8))
    assert sorted(f for f in os.listdir(work) if f.startswith('epoch_')) == [
        'epoch_2.pth', 'epoch_3.pth', 'epoch_4.pth']
    assert (work / 'last_checkpoint').read_text() == str(work / 'epoch_4.pth')
    again = torch.load(work / 'epoch_2.pth', weights_only=True)
    for part in ('model', 'ema', 'momentum'):
        for k, v in epoch2[part].items():
            assert torch.equal(v, again[part][k]), (part, k)


def test_export_loads_with_its_own_disparity_branch(setup, tmp_path):
    """The trainer's export loads as it is; a reference ``.pth`` still gets
    the RGB stem and stage 1 copied into the disparity branch; the eval
    CLI scores the export."""
    from stereotracking_tpu_torch.apis.inference import init_model
    from stereotracking_tpu_torch.config import load_config
    from stereotracking_tpu_torch.tools import test as test_cli
    from stereotracking_tpu_torch.tools import train as cli
    root, cfg = setup
    work = tmp_path / 'work'
    cli.main([str(cfg), '--work-dir', str(work), '--steps-per-epoch', '1',
              '--max-epochs', '1', '--max-gt', '8', '--device', 'cpu'])
    pth = str(work / 'detector_final.pth')
    export = torch.load(pth, weights_only=True)['state_dict']
    model = init_model(load_config(str(cfg)), pth, device='cpu')
    got = model.module.state_dict()
    assert got.keys() == export.keys()
    for k, v in export.items():
        if not k.endswith('num_batches_tracked'):
            assert torch.equal(got[k], v), k
    key = 'backbone.{}stage1.1.final_conv.conv.weight'
    assert not torch.equal(got[key.format('disp_')], got[key.format('')])
    assert not model.module.training

    ref = init_model(load_config(str(cfg)), str(reference_pth(
        tmp_path / 'ref.pth')), device='cpu').module.state_dict()
    assert torch.equal(ref[key.format('disp_')], ref[key.format('')])

    metrics = test_cli.main([str(cfg), '--device', 'cpu', '--checkpoint', pth,
                             '--work-dir', str(tmp_path / 'test')])
    assert 'MOTA' in metrics and 'mAP' in metrics
    assert (tmp_path / 'test' / 'metrics.json').exists()


def test_train_mode_refuses_kernels_bf16_and_launchers(setup):
    from stereotracking_tpu_torch.tools.train import parse_args
    det = YOLOXDetector(DetectorConfig(deepen_factor=0.1,
                                       widen_factor=0.125)).train()
    inputs = {k: torch.zeros(1, 64, 64, 3) for k in ('img', 'disp_postp')}
    for backends in (StageBackends('cuda', 'torch', 'torch', 'torch'),
                     StageBackends('cuda', 'cuda', 'cuda', 'cuda')):
        with pytest.raises(ValueError, match='train mode'):
            det(inputs, backends)
    bf = YOLOXDetector(DetectorConfig(deepen_factor=0.1, widen_factor=0.125),
                       dtype=torch.bfloat16).train()
    with pytest.raises(ValueError, match='float32 only'):
        bf(inputs)
    with pytest.raises(NotImplementedError, match='Queue 1 item 6'):
        parse_args([str(setup[1]), '--launcher', 'jax'])


def test_bench_train_prints_one_line(capsys):
    from stereotracking_tpu_torch.tools import bench_train
    out = bench_train.main(['--device', 'cpu', '--batch', '2'])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == json.loads(json.dumps(out))
    assert line['metric'] == 'train_step_per_sec' and line['value'] > 0
    assert line['device'] == 'cpu' and line['card'] is None
    assert math.isfinite(line['loss'])
    assert line['input_pipeline_pairs_per_sec'] > 0
