"""Detector training runner: the port of ``tools/train.py``.

    python -m stereotracking_tpu_torch.tools.train CONFIG [--work-dir DIR]
        [--resume] [--max-epochs N] [--steps-per-epoch N] [--batch-size N]
        [--max-gt N] [--img-scale H W] [--seed S] [--val-interval N]
        [--val-max-images N] [--cfg-options K=V ...] [--device cuda|cpu]

The reference tools/train.py flow on one device: the two-stage pipeline
(MixUp on and the L1 loss off, then for the last ``num_last_epochs``
epochs MixUp off and L1 on: the reference YOLOXModeSwitchHook),
SGD-nesterov with the quadratic-warm-up -> cosine schedule, the EMA of the
weights and BatchNorm statistics, rotating train checkpoints with
``--resume``, optional detector mAP validation of the EMA weights, the
logger's ``scalars.jsonl``, and at the end the EMA weights exported as
``detector_final.pth``, which ``apis.inference.init_model`` and
``tools.test --checkpoint`` load.  Runs on the card unless ``--device
cpu``; without a card ``--device cuda`` raises.

``make_batch`` is the JAX runner's host pipeline, with the same numpy
draws, so both runners see the same batches for the same seed.  Pillow
decodes the dataset's PNGs and resizes (MixUp too), so it must be
installed.  ``--launcher`` other than ``none`` (multi-process DDP over
several cards) is not ported: ROADMAP.md Queue 1 item 6.
"""
from __future__ import annotations

import argparse
import os
import time
from typing import List, Optional

import numpy as np
import torch

from ..apis.builder import build_detector_config
from ..config import apply_overrides, load_config
from ..data import CocoDispDataset, MOTDispDataset
from ..data import transforms as T
from ..evaluation import CocoMAPEvaluator
from ..models.detector import YOLOXDetector, detector_predict
from ..train.checkpoint import (CheckpointManager, extract_detector_variables,
                                save_checkpoint)
from ..train.losses import YOLOXLossConfig
from ..train.schedules import yolox_schedule
from ..train.train_state import TrainState, create_train_state, train_step
from ..utils.devices import checked_device, to_device
from ..utils.obs import build_logger


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description='Train the stereo detector')
    p.add_argument('config')
    p.add_argument('--work-dir', default=None)
    p.add_argument('--resume', action='store_true')
    p.add_argument('--max-epochs', type=int, default=None)
    p.add_argument('--steps-per-epoch', type=int, default=None)
    p.add_argument('--batch-size', type=int, default=None)
    p.add_argument('--max-gt', type=int, default=64)
    p.add_argument('--img-scale', type=int, nargs=2, default=None)
    p.add_argument('--seed', type=int, default=0)
    p.add_argument('--val-interval', type=int, default=None,
                   help='epochs between detector mAP validations '
                        '(reference val_interval=5); default: off')
    p.add_argument('--val-max-images', type=int, default=200)
    p.add_argument('--launcher', default='none',
                   help="only 'none': multi-process DDP is not ported "
                        '(ROADMAP.md Queue 1 item 6)')
    p.add_argument('--dist-coordinator', default=None)
    p.add_argument('--dist-num-processes', type=int, default=None)
    p.add_argument('--dist-process-id', type=int, default=None)
    p.add_argument('--cfg-options', nargs='*', default=None)
    p.add_argument('--device', default='cuda',
                   help="'cuda' (default) or 'cpu'")
    args = p.parse_args(argv)
    dist = [f for f in ('dist_coordinator', 'dist_num_processes',
                        'dist_process_id') if getattr(args, f) is not None]
    if args.launcher != 'none' or dist:
        raise NotImplementedError(
            f'--launcher {args.launcher} {dist}: multi-process data-parallel '
            f'training is not ported (ROADMAP.md Queue 1 item 6)')
    return args


def make_batch(dataset, indices, scale, max_gt, rng, stage2: bool) -> dict:
    """Host-side pipeline: load -> resize -> [MixUp] -> HSV -> flip ->
    filter -> pad; stacked into fixed-shape numpy arrays."""
    imgs, disps, masks = [], [], []
    gtb = np.zeros((len(indices), max_gt, 4), np.float32)
    gtl = np.zeros((len(indices), max_gt), np.int32)
    gtv = np.zeros((len(indices), max_gt), bool)
    for bi, idx in enumerate(indices):
        s = dataset.load_sample(idx)
        s = T.resize_keep_ratio(s, scale)
        if not stage2:
            other = dataset.load_sample(rng.randint(len(dataset)))
            other = T.resize_keep_ratio(other, scale)
            s = T.yolox_mixup(s, other, rng, img_scale=scale)
        s['img'] = T.hsv_random_aug(s['img'], rng)
        s = T.random_flip(s, rng)
        s = T.filter_annotations(s)
        s = T.pad_to_divisor(s, 32)
        imgs.append(s['img'].astype(np.float32))
        disps.append(s['disp_postp'].astype(np.float32))
        masks.append(s['disp_mask'].astype(np.float32))
        n = min(len(s['gt_bboxes']), max_gt)
        if n:
            gtb[bi, :n] = s['gt_bboxes'][:n]
            gtl[bi, :n] = s['gt_labels'][:n]
            gtv[bi, :n] = True
    img = np.stack(imgs)
    disp = np.stack(disps)[..., None].repeat(3, -1)
    mask = np.stack(masks)[..., None]
    return dict(img=img, disp_postp=disp, disp_mask=mask,
                gt_bboxes=gtb, gt_labels=gtl, gt_valid=gtv)


def batch_to_device(batch: dict, device) -> dict:
    """``make_batch``'s arrays as tensors on ``device`` (labels int64, the
    index type of ``gather``)."""
    out = {k: to_device(v, device) for k, v in batch.items()}
    out['gt_labels'] = out['gt_labels'].long()
    return out


def run_validation(cfg: dict, ema: YOLOXDetector, scale, max_images: int,
                   device) -> dict:
    """Detector-only COCO mAP of the EMA weights on the val split
    (reference val loop with CocoMetric).  Detections are rescaled to the
    frame's own coordinates, where the ground truth is scored."""
    vd = dict(cfg['val_dataloader']['dataset'])
    val_ds = MOTDispDataset(
        ann_file=os.path.join(vd.get('data_root', ''), vd['ann_file']),
        data_root=vd.get('data_root', ''),
        img_prefix=vd.get('img_prefix', ''),
        classes=tuple(cfg.get('classes', ())) or None)
    ev = CocoMAPEvaluator(num_classes=ema.cfg.num_classes)
    img_ids = [i for v in val_ds.videos()
               for i in val_ds.video_frames(v)][:max_images]
    for img_id in img_ids:
        s = val_ds.load_frame(img_id)
        s = T.resize_keep_ratio(s, scale)
        s = T.pad_to_divisor(s, 32)
        inputs = dict(
            img=to_device(s['img'][None].astype(np.float32), device),
            disp_postp=to_device(
                s['disp_postp'][None, ..., None].repeat(3, -1), device))
        sf = s.get('scale_factor', (1.0, 1.0))
        det = detector_predict(ema, inputs, scale_factor=sf)
        dv = det.valid[0].cpu().numpy()
        ev.add_gt(img_id, s['gt_bboxes'] / sf[0], s['gt_labels'])
        ev.add_dt(img_id, det.boxes[0].cpu().numpy()[dv],
                  det.scores[0].cpu().numpy()[dv],
                  det.labels[0].cpu().numpy()[dv])
    res = ev.evaluate(areas=('all',))
    print(f'[val] mAP {res["mAP"]:.4f} mAP50 {res["mAP_50"]:.4f}',
          flush=True)
    return res


def main(argv: Optional[List[str]] = None) -> TrainState:
    args = parse_args(argv)
    device = checked_device(args.device)
    cfg = apply_overrides(load_config(args.config), args.cfg_options)
    work_dir = args.work_dir or os.path.join(
        'work_dirs', os.path.splitext(os.path.basename(args.config))[0])

    ds_cfg = dict(cfg['train_dataloader']['dataset'])
    dataset = CocoDispDataset(
        ann_file=os.path.join(ds_cfg.get('data_root', ''),
                              ds_cfg['ann_file']),
        data_root=ds_cfg.get('data_root', ''),
        img_prefix=ds_cfg.get('img_prefix', ''),
        classes=tuple(cfg.get('classes', ())) or None)

    scale = tuple(args.img_scale or cfg.get('img_scale', (720, 1280)))
    batch_size = args.batch_size or \
        cfg['train_dataloader'].get('batch_size', 8)
    max_epochs = args.max_epochs or cfg.get('max_epochs', 50)
    num_last = cfg.get('num_last_epochs', 5)
    steps_per_epoch = args.steps_per_epoch or \
        max(len(dataset) // batch_size, 1)
    base_lr = cfg.get('base_lr', 0.001 / 8 * batch_size)

    det_cfg = build_detector_config(cfg['model']['detector'])
    sched = yolox_schedule(base_lr, steps_per_epoch, max_epochs,
                           warmup_epochs=2, num_last_epochs=num_last)
    state = create_train_state(YOLOXDetector(det_cfg).to(device), sched,
                               seed=args.seed)
    ckpt = CheckpointManager(work_dir, interval=cfg.get(
        'save_epoch_intervals', 5))
    start_epoch = 0
    if args.resume:
        state, start_epoch = ckpt.resume(state)
        print(f'resumed at epoch {start_epoch} (step {state.step})',
              flush=True)

    rng = np.random.RandomState(args.seed)
    loss_cfgs = {False: YOLOXLossConfig(num_classes=det_cfg.num_classes)}
    loss_cfgs[True] = loss_cfgs[False]._replace(use_l1=True)
    logger = build_logger(cfg, work_dir)

    for epoch in range(start_epoch, max_epochs):
        stage2 = epoch >= max_epochs - num_last
        t0 = time.perf_counter()
        for it in range(steps_per_epoch):
            idx = rng.randint(0, len(dataset), batch_size)
            batch = batch_to_device(make_batch(
                dataset, idx, scale, args.max_gt, rng, stage2), device)
            losses = train_step(state, batch, loss_cfgs[stage2])
            step = epoch * steps_per_epoch + it
            # the losses are read on the host here, after the step
            if it % 50 == 0:
                print(f'epoch {epoch} it {it}/{steps_per_epoch} '
                      f'loss {float(losses["loss"]):.4f} '
                      f'(cls {float(losses["loss_cls"]):.3f} '
                      f'bbox {float(losses["loss_bbox"]):.3f} '
                      f'obj {float(losses["loss_obj"]):.3f}) '
                      f'pos {int(losses["num_pos"])}', flush=True)
            logger.log_every(step, dict(
                loss=losses['loss'], loss_cls=losses['loss_cls'],
                loss_bbox=losses['loss_bbox'], loss_obj=losses['loss_obj'],
                **({'loss_l1': losses['loss_l1']} if stage2 else {}),
                num_pos=losses['num_pos'], lr=sched(step), epoch=epoch))
        if device.type == 'cuda':
            torch.cuda.synchronize(device)
        dt = time.perf_counter() - t0
        print(f'epoch {epoch} done in {dt:.1f}s', flush=True)
        logger.log((epoch + 1) * steps_per_epoch - 1, dict(
            epoch_time_s=dt, imgs_per_s=steps_per_epoch * batch_size / dt),
            prefix='speed')
        ckpt.maybe_save(epoch, state)
        if args.val_interval and (epoch + 1) % args.val_interval == 0:
            res = run_validation(cfg, state.ema, scale, args.val_max_images,
                                 device)
            logger.log((epoch + 1) * steps_per_epoch - 1, dict(
                mAP=res['mAP'], mAP_50=res['mAP_50']), prefix='val')
    logger.close()

    final = os.path.join(work_dir, 'detector_final.pth')
    save_checkpoint(final, extract_detector_variables(state))
    print(f'saved detector to {final}', flush=True)
    return state


if __name__ == '__main__':
    main()
