"""Training throughput on the card, and the input pipeline's rate.

    python -m stereotracking_tpu_torch.tools.bench_train [--batch 8]
        [--device cuda|cpu]

The port of ``tools/bench_train.py``.  It prints one JSON line:

1. ``train_step_per_sec`` and ``train_pairs_per_sec``: the flagship
   detector (dual-branch YOLOX-S, float32, TF32 off) through
   ``train/train_state.train_step`` (forward, SimOTA and the YOLOX losses,
   backward, SGD-nesterov and the EMA) at the reference's shape, batch 8
   of 1280x720 resized and padded to 736x1280, on 2 random batches built
   on the host as the JAX bench builds them (4-47 ground truths per image)
   and staged on the device once, then cycled; 2 warm-up steps, then the
   timed ones, ended by a synchronisation;
2. ``peak_memory_bytes``: ``torch.cuda.max_memory_allocated`` over the
   steps, and the card's name and power limit (``nvidia-smi``);
3. ``input_pipeline_pairs_per_sec``: ``tools/train.make_batch`` (PNG
   decode, resize, MixUp, HSV, flip, filter, pad) through
   ``PrefetchIterator`` on a synthetic dataset of 1280x720 PNGs, where
   Pillow imports; otherwise the line says that it was not measured and
   why.

Runs on the card unless ``--device cpu``: a rehearsal at the JAX bench's
CPU sizes (96x160 steps, 120x160 frames), whose numbers are not the
card's.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import tempfile
import time
from typing import List, Optional

import numpy as np
import torch

from ..models.detector import DetectorConfig, YOLOXDetector
from ..train.losses import YOLOXLossConfig
from ..train.schedules import yolox_schedule
from ..train.train_state import create_train_state, train_step
from ..utils.devices import checked_device

MAX_GT = 48


def staged_batches(batch: int, h: int, w: int, device, n: int = 2,
                   seed: int = 0) -> List[dict]:
    """``n`` random batches as ``tools/bench_train.py`` builds them (images
    0-255, disparity 0-40, 4-47 ground truths per image), on ``device``."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        nb = rng.randint(4, MAX_GT, size=batch)
        gtb = np.zeros((batch, MAX_GT, 4), np.float32)
        gtv = np.zeros((batch, MAX_GT), bool)
        for b in range(batch):
            x1 = rng.uniform(0, w - 80, nb[b])
            y1 = rng.uniform(0, h - 60, nb[b])
            gtb[b, :nb[b]] = np.stack(
                [x1, y1, x1 + rng.uniform(10, 70, nb[b]),
                 y1 + rng.uniform(10, 50, nb[b])], axis=1)
            gtv[b, :nb[b]] = True
        arrays = dict(
            img=rng.rand(batch, h, w, 3).astype(np.float32) * 255,
            disp_postp=rng.rand(batch, h, w, 3).astype(np.float32) * 40,
            gt_bboxes=gtb, gt_labels=np.zeros((batch, MAX_GT), np.int64),
            gt_valid=gtv)
        out.append({k: torch.from_numpy(v).to(device)
                    for k, v in arrays.items()})
    return out


def card_name() -> str:
    """``nvidia-smi --query-gpu=name,power.limit`` of card 0."""
    return subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader', '--id=0'],
        capture_output=True, text=True, check=True).stdout.strip()


def write_dataset(root: str, n_videos: int = 2, n_frames: int = 16,
                  h: int = 720, w: int = 1280) -> str:
    """AirDrone-layout synthetic stereo pairs as real PNGs (left image,
    uint16 disparity, six boxes a frame); returns the annotation file."""
    from PIL import Image
    images, annotations, videos = [], [], []
    img_id, ann_id = 1, 1
    yy, xx = np.mgrid[0:h, 0:w]
    bg = ((yy * 0.2 + xx * 0.1) % 255).astype(np.uint8)
    for v in range(n_videos):
        videos.append(dict(id=v + 1, name=f'seq{v:02d}'))
        rng = np.random.RandomState(v)
        for t in range(n_frames):
            img = np.stack([bg, bg, bg], axis=-1).copy()
            disp = np.full((h, w), 65535, np.uint16)
            disp[h // 2:] = 800
            anns = []
            for _ in range(6):
                x = int((rng.rand() * 0.8 + 0.05) * w)
                y = int((rng.rand() * 0.8 + 0.05) * h)
                bw, bh = rng.randint(30, 90), rng.randint(20, 60)
                img[y:y + bh, x:x + bw] = rng.randint(0, 255, 3)
                disp[y:y + bh, x:x + bw] = rng.randint(100, 2000)
                anns.append((x, y, min(bw, w - x), min(bh, h - y)))
            rel = f'airsim/seq{v:02d}/left/{t:06d}_left.png'
            path = os.path.join(root, rel)
            os.makedirs(os.path.dirname(path), exist_ok=True)
            Image.fromarray(img).save(path)
            dpath = path.replace('left', 'disparity')
            os.makedirs(os.path.dirname(dpath), exist_ok=True)
            Image.fromarray(disp).save(dpath)
            images.append(dict(id=img_id, file_name=rel, width=w, height=h,
                               video_id=v + 1, frame_id=t))
            for (x, y, bw, bh) in anns:
                annotations.append(dict(
                    id=ann_id, image_id=img_id, category_id=1,
                    bbox=[x, y, bw, bh], area=bw * bh, iscrowd=0,
                    instance_id=ann_id))
                ann_id += 1
            img_id += 1
    ann_path = os.path.join(root, 'train.json')
    with open(ann_path, 'w') as f:
        json.dump(dict(images=images, annotations=annotations, videos=videos,
                       categories=[dict(id=1, name='drone')]), f)
    return ann_path


def pipeline_rate(batch: int, h: int, w: int, n_warm: int, n_timed: int,
                  workers: int = 4) -> float:
    """Pairs/s of ``make_batch`` (stage 1: MixUp on) through
    ``PrefetchIterator`` over a synthetic PNG dataset of h x w frames."""
    from ..data import CocoDispDataset, PrefetchIterator
    from .train import make_batch
    with tempfile.TemporaryDirectory() as root:
        ds = CocoDispDataset(ann_file=write_dataset(root, h=h, w=w),
                             data_root=root)
        drng = np.random.RandomState(0)
        idxs = np.arange(len(ds))

        def batches(n):
            for _ in range(n):
                drng.shuffle(idxs)
                yield idxs[:batch].copy()

        def load(ix):
            return make_batch(ds, ix, (h, w), MAX_GT, drng, stage2=False)

        it = iter(PrefetchIterator(batches(n_warm + n_timed), load,
                                   num_workers=workers))
        for _ in range(n_warm):
            next(it)
        t0 = time.perf_counter()
        for _ in range(n_timed):
            next(it)
        return n_timed * batch / (time.perf_counter() - t0)


def main(argv: Optional[List[str]] = None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    p.add_argument('--batch', type=int, default=8)
    p.add_argument('--device', default='cuda')
    args = p.parse_args(argv)
    device = checked_device(args.device)
    on_card = device.type == 'cuda'
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    # the reference's shape on the card; the JAX bench's CPU rehearsal sizes
    (h, w), n_steps = ((736, 1280), 12) if on_card else ((96, 160), 2)

    module = YOLOXDetector(DetectorConfig()).to(device)
    state = create_train_state(
        module, yolox_schedule(1e-3, steps_per_epoch=100))
    loss_cfg = YOLOXLossConfig()
    staged = staged_batches(args.batch, h, w, device)
    for b in staged[:2]:                              # warm-up
        losses = train_step(state, b, loss_cfg)
    float(losses['loss'])
    if on_card:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    for i in range(n_steps):
        losses = train_step(state, staged[i % 2], loss_cfg)
    if on_card:
        torch.cuda.synchronize(device)
    elapsed = time.perf_counter() - t0
    step_s = n_steps / elapsed
    out = {
        'metric': 'train_step_per_sec', 'value': step_s,
        'train_pairs_per_sec': step_s * args.batch,
        'ms_per_step': elapsed / n_steps * 1e3,
        'batch': args.batch, 'input': [h, w], 'dtype': 'float32',
        'tf32': False, 'device': str(device),
        'loss': float(losses['loss']),
        'peak_memory_bytes': (torch.cuda.max_memory_allocated(device)
                              if on_card else None),
        'card': card_name() if on_card else None,
    }
    try:
        import PIL
    except ImportError:
        out['input_pipeline_pairs_per_sec'] = None
        out['input_pipeline'] = ('not measured: Pillow does not import '
                                 'here, and the pipeline decodes PNGs with it')
    else:
        out['pillow'] = PIL.__version__
        (ph, pw), (n_warm, n_timed) = (((720, 1280), (2, 8)) if on_card
                                       else ((120, 160), (1, 2)))
        out['input_pipeline_pairs_per_sec'] = pipeline_rate(
            args.batch, ph, pw, n_warm, n_timed)
        out['pipeline_workers'] = 4
        out['host_cores'] = len(os.sched_getaffinity(0))
    print(json.dumps(out), flush=True)
    return out


if __name__ == '__main__':
    main()
