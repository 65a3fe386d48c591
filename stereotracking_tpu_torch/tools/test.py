"""Tracking evaluation runner: the port of ``tools/test.py``.

    python -m stereotracking_tpu_torch.tools.test CONFIG [--checkpoint PTH]
        [--work-dir DIR] [--depth-thr M] [--ignore-depth] [--max-videos N]
        [--dump-txt] [--interpolate] [--aflink PT] [--results-csv CSV]
        [--show-dir DIR [--show-interval N] [--show-errors]]
        [--bf16] [--streams N] [--stage-frames] [--cfg-options K=V ...]
        [--device cuda|cpu]

Iterates the test videos frame by frame, runs the per-frame MOT step,
streams ground truth and predictions into the MOT metrics (HOTA / CLEAR /
Identity under the 0-``depth_thr`` m depth protocol) and COCO bbox mAP, and
writes ``metrics.json`` (every metric plus ``fps``), the logger's
``scalars.jsonl``, and with the flags the MOT txt files and the per-frame
depth CSV.  ``--show-dir DIR`` draws every ``--show-interval``-th frame of
each video (frame index 0, N, 2N, ...) into ``DIR/<video>/<frame>.jpg``:
the ground-truth panel over the tracked boxes, or with ``--show-errors``
the TP / FP / FN / ID-switch coding (``visualization``), from the
reader's host image and the step's fetched result, so drawing adds no
synchronisation to the step.  Before scoring, ``--aflink PT`` re-links
each video's tracklets (``evaluation.aflink``, a checkpoint of
``tools.train_aflink``) and then ``--interpolate`` fills their gaps
(``evaluation.postprocess``), in the JAX CLI's order.  Runs on the card
unless ``--device cpu``; without a card ``--device cuda`` raises.

``evaluate`` is the loop: it takes a model, a dataset object (``videos``,
``video_name``, ``video_frames``, ``frame_info``, ``load_frame``), the
videos and the options, and returns ``(n_frames, elapsed)``; ``main`` and
``chip_smoke.py`` (with a dataset held in memory) call it.  Every frame
goes through ``track_raw``; each step's result leaves the card in one
synchronisation (``models.mot.fetch_result``).  With ``--bf16`` on a CUDA
device both loops run with cuDNN off (``batch_invariant_convs``):
cuDNN's bf16 convolutions round differently at batch 1 and at batch N, so
the sequential and ``--streams`` loops would score differently, where the
JAX contract has them equal; PyTorch's own convolutions are
batch-invariant.  Float32 keeps cuDNN.

The datasets are ``MOTDispDataset``, ``MOTKittiDataset`` (the ``img2``
naming) and ``DanceTrackDataset`` (monocular: depth ignored in scoring, as
the JAX CLI does).  The MOT metric is ``MOTDroneMetrics`` for every config,
as the JAX CLI has it: both ignore ``test_evaluator``.  A config with
camera-motion compensation runs in the sequential loop; ``--streams N``
refuses it (``MultiStreamTracker`` does).  Refused with
``NotImplementedError``: ``--launcher`` / ``--dist-*`` (several processes:
ROADMAP.md Queue 1 item 6) and the other dataset types (the task zoo,
Queue 1 item 8).
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..apis.inference import init_model, raw_frame
from ..config import apply_overrides, load_config
from ..data import (DanceTrackDataset, MOTDispDataset, MOTKittiDataset,
                    PrefetchIterator)
from ..data import transforms as T
from ..evaluation import CocoMAPEvaluator, MOTDroneMetrics
from ..models.mot import FrameResult, fetch_result
from ..parallel.multistream import MultiStreamTracker
from ..utils.collect_results import ResultsCSV
from ..utils.devices import to_device
from ..utils.obs import build_logger

NOT_PORTED = ('is not ported (evaluation over several processes: '
              'ROADMAP.md Queue 1 item 6)')
# flags of the JAX CLI that the port accepts only to refuse
_REFUSED = ('launcher', 'dist_coordinator', 'dist_num_processes',
            'dist_process_id')


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description='Test a stereo tracker')
    p.add_argument('config')
    p.add_argument('--checkpoint', default=None,
                   help='reference PyTorch checkpoint (.pth / .pt)')
    p.add_argument('--work-dir', default='work_dirs/test')
    p.add_argument('--depth-thr', type=float, default=80.0)
    p.add_argument('--ignore-depth', action='store_true')
    p.add_argument('--max-videos', type=int, default=None)
    p.add_argument('--dump-txt', action='store_true')
    p.add_argument('--interpolate', action='store_true',
                   help='tracklet gap interpolation before scoring')
    p.add_argument('--aflink', default=None, metavar='PT',
                   help='AFLink tracklet re-linking before scoring, with a '
                        'checkpoint of tools.train_aflink (.pt)')
    p.add_argument('--results-csv', default=None)
    p.add_argument('--show-dir', default=None,
                   help='draw every --show-interval-th frame of each video '
                        'into DIR/<video>/<frame>.jpg: the ground truth '
                        'over the predictions')
    p.add_argument('--show-interval', type=int, default=30,
                   help='frame interval for --show-dir')
    p.add_argument('--show-errors', action='store_true',
                   help='with --show-dir: color-code TP / FP / FN / ID '
                        'switches instead of the ground-truth panel')
    p.add_argument('--bf16', action='store_true',
                   help='bfloat16 compute for the detector layers that run '
                        'on the modules')
    p.add_argument('--streams', type=int, default=1,
                   help='evaluate N videos concurrently through '
                        'MultiStreamTracker (one launch per kernel for all '
                        'N streams)')
    p.add_argument('--stage-frames', action='store_true',
                   help="with --streams: put each video group's raw frames "
                        'on the device before the timed loop')
    p.add_argument('--cfg-options', nargs='*', default=None)
    p.add_argument('--device', default='cuda',
                   help="'cuda' (default) or 'cpu'")
    for flag in ('--launcher', '--dist-coordinator', '--dist-num-processes',
                 '--dist-process-id'):
        p.add_argument(flag, default=None, help=NOT_PORTED)
    args = p.parse_args(argv)
    for name in _REFUSED:
        val = getattr(args, name)
        if val not in (None, False) and not (name == 'launcher'
                                             and val == 'none'):
            raise NotImplementedError(
                f"--{name.replace('_', '-')} {NOT_PORTED}")
    return args


def build_dataset(cfg: dict):
    """The config's ``test_dataloader.dataset``: ``MOTDispDataset`` (with
    its ``path_token`` when the config gives one), ``MOTKittiDataset`` (the
    ``img2`` token) or ``DanceTrackDataset`` (``data_root``, ``split``,
    ``visibility_thr``), as the JAX CLI builds them."""
    ds_cfg = dict(cfg['test_dataloader']['dataset'])
    ds_type = ds_cfg.pop('type', 'MOTDispDataset')
    if ds_type == 'DanceTrackDataset':
        return DanceTrackDataset(
            data_root=ds_cfg.get('data_root', ''),
            split=ds_cfg.get('split', 'val'),
            visibility_thr=ds_cfg.get('visibility_thr', -1.0))
    kw = {}
    if ds_type == 'MOTKittiDataset':
        ds_cls = MOTKittiDataset
    elif ds_type == 'MOTDispDataset':
        ds_cls = MOTDispDataset
        if 'path_token' in ds_cfg:
            kw['path_token'] = ds_cfg['path_token']
    else:
        raise NotImplementedError(
            f'dataset type {ds_type!r} is not ported (the task zoo: '
            f'ROADMAP.md Queue 1 item 8)')
    return ds_cls(
        ann_file=os.path.join(ds_cfg.get('data_root', ''),
                              ds_cfg['ann_file']),
        data_root=ds_cfg.get('data_root', ''),
        img_prefix=ds_cfg.get('img_prefix', ''),
        depth_dir_name=ds_cfg.get('depth_dir_name'),
        classes=tuple(cfg.get('classes', ())) or None, **kw)


@contextlib.contextmanager
def batch_invariant_convs(bf16: bool, device):
    """The eval loops' convolutions: with bf16 on a CUDA device, cuDNN off
    inside the block (its bf16 convolutions depend on the batch, the
    sequential loop's 1 frame against ``--streams N``'s N; PyTorch's own
    do not), restored after; the float32 loops, and the CPU, keep the
    default.  Yields whether cuDNN is off.  The step's CUDA graph keys on
    the switch (models/captured_step.py), so a graph captured with cuDNN
    on is never replayed inside, nor one captured inside after it."""
    off = bool(bf16) and torch.device(device).type == 'cuda'
    prev = torch.backends.cudnn.enabled
    if off:
        torch.backends.cudnn.enabled = False
    try:
        yield off
    finally:
        torch.backends.cudnn.enabled = prev


class FrameShow:
    """``--show-dir``: every ``interval``-th frame of a video drawn as the
    JAX CLI draws it (``draw_gt_pred``, or ``draw_mot_errors`` carrying
    each video's or stream's gt id -> predicted id matches from one shown
    frame to the next), from the reader's host image and the host result,
    into ``<show_dir>/<video>/<frame:06d>.jpg``."""

    def __init__(self, show_dir: str, interval: int, errors: bool):
        from ..visualization import TrackVisualizer
        self.show_dir, self.interval, self.errors = (show_dir, interval,
                                                     errors)
        self.visualizer = TrackVisualizer()

    def __call__(self, video: str, t: int, sample: dict, res: FrameResult,
                 prev_match: dict) -> dict:
        """Draws frame t if the interval says so; returns the matches to
        carry to the next shown frame."""
        if t % self.interval:
            return prev_match
        from PIL import Image
        from ..visualization import draw_mot_errors
        tv = res.track_valid
        out = os.path.join(self.show_dir, video)
        os.makedirs(out, exist_ok=True)
        img = sample['img'].astype(np.uint8)
        if self.errors:
            frame_img, prev_match = draw_mot_errors(
                img, sample['gt_bboxes'], sample['gt_instance_ids'],
                res.track_bboxes[tv], res.track_ids[tv], prev_match)
        else:
            frame_img = self.visualizer.draw_gt_pred(
                img, sample['gt_bboxes'], sample['gt_instance_ids'],
                res.track_bboxes[tv], res.track_ids[tv],
                res.track_scores[tv])
        Image.fromarray(frame_img).save(os.path.join(out, f'{t:06d}.jpg'))
        return prev_match


def frame_show(args) -> Optional[FrameShow]:
    """The ``--show-dir`` writer of ``args``, or None without the flag."""
    if not args.show_dir:
        return None
    return FrameShow(args.show_dir, args.show_interval, args.show_errors)


def _record(video: str, t: int, sample: dict, res: FrameResult,
            mot_metric, coco_metric, csv_dump) -> None:
    """One frame's ground truth and host-side predictions into the
    metrics and the CSV."""
    tv = res.track_valid
    gt_loc = sample['gt_locations']
    mot_metric.process_frame(
        video, t, gt_ids=sample['gt_instance_ids'],
        gt_bboxes=sample['gt_bboxes'],
        gt_depths=gt_loc[:, 2] if len(gt_loc) else None,
        pred_ids=res.track_ids[tv], pred_bboxes=res.track_bboxes[tv],
        pred_depths=res.track_depths[tv])
    dv = res.det_valid
    coco_metric.add_gt(sample['img_id'], sample['gt_bboxes'],
                       sample['gt_labels'])
    coco_metric.add_dt(sample['img_id'], res.det_bboxes[dv],
                       res.det_scores[dv], res.det_labels[dv])
    if csv_dump:
        csv_dump.append_frame(t, res)


def evaluate(model, dataset, videos, args, img_scale, mot_metric,
             coco_metric, csv_dump=None, logger=None) -> Tuple[int, float]:
    """Track ``videos`` of ``dataset`` with ``model`` (an
    ``OCSORTDisparity``) into the metrics, sequentially or, with
    ``args.streams`` > 1, ``args.streams`` videos at a time.  Frames are
    resized keep-ratio to ``img_scale`` (h, w) unless they have that size
    already.  In bf16 on a CUDA device both loops run with cuDNN off
    (``batch_invariant_convs``).  Returns (frames scored, seconds of the
    timed loops)."""
    first = dataset.frame_info(dataset.video_frames(videos[0])[0])
    f = T.rescale_factor(first['height'], first['width'], tuple(img_scale))
    with batch_invariant_convs(args.bf16, model.device) as invariant:
        print(f'[test] {"bf16" if args.bf16 else "float32"} on '
              f'{model.device.type}, '
              + ('cuDNN off (batch-invariant convolutions)' if invariant
                 else 'default convolutions') + f', streams {args.streams}',
              flush=True)
        if args.streams > 1:
            return _multistream_eval(args, model, dataset, videos, img_scale,
                                     f, mot_metric, coco_metric, csv_dump,
                                     logger)
        return _sequential_eval(args, model, dataset, videos, img_scale, f,
                                mot_metric, coco_metric, csv_dump, logger)


def _sequential_eval(args, model, dataset, videos, img_scale, f,
                     mot_metric, coco_metric, csv_dump, logger):
    """One video at a time through ``model.track_raw``."""
    n_frames = 0
    show = frame_show(args)
    t_start = time.perf_counter()
    for vid in videos:
        vname = dataset.video_name(vid)
        frame_ids = dataset.video_frames(vid)
        prev_match = {}
        loader = PrefetchIterator(frame_ids, dataset.load_frame,
                                  num_workers=4)
        for local_f, sample in enumerate(loader):
            if f != 1.0:
                sample = T.resize_keep_ratio(sample, tuple(img_scale))
            img_u8, disp_fixed = raw_frame(sample)
            res = model.track_raw(
                img_u8, disp_fixed, local_f,
                scale_factor=sample.get('scale_factor', (1.0, 1.0)),
                depth_raw=sample.get('depth_postp'))
            n_frames += 1
            res = fetch_result(res)()
            _record(vname, local_f, sample, res, mot_metric, coco_metric,
                    csv_dump)
            if show is not None:
                prev_match = show(vname, local_f, sample, res, prev_match)
        print(f'[test] video {vname}: {len(frame_ids)} frames done',
              flush=True)
        if logger is not None:
            logger.log(n_frames, dict(
                video_frames=len(frame_ids),
                fps=n_frames / max(time.perf_counter() - t_start, 1e-9)),
                prefix='eval')
    return n_frames, time.perf_counter() - t_start


def _multistream_eval(args, model, dataset, videos, img_scale, f,
                      mot_metric, coco_metric, csv_dump, logger):
    """``args.streams`` videos at a time through ``MultiStreamTracker``.

    Videos are grouped S at a time and stepped in lockstep; a group short
    of S videos is padded with its first video, and shorter videos replay
    their last frame, their outputs ignored (each stream has its own track
    state).  With ``args.stage_frames`` each group's raw frames are put on
    the device before the timed loop, after one warm-up step; the timed
    loop's frame 0 (frame_id 0) resets the track states.  Each step's
    result is fetched while the next step runs and consumed one step
    behind."""
    S = args.streams
    ms = MultiStreamTracker(model.cfg, n_streams=S, module=model.module,
                            device=model.device)
    show = frame_show(args)
    n_frames = 0
    elapsed = 0.0
    for g0 in range(0, len(videos), S):
        group = videos[g0:g0 + S]
        real = len(group)
        group = group + [group[0]] * (S - real)     # dummy pad, ignored
        frame_lists = [dataset.video_frames(v) for v in group]
        names = [dataset.video_name(v) for v in group]
        L = max(len(frame_lists[s]) for s in range(real))
        prev_match = [{} for _ in range(real)]

        def load_t(t):
            samples = []
            for fl in frame_lists:
                s = dataset.load_frame(fl[min(t, len(fl) - 1)])
                if f != 1.0:
                    s = T.resize_keep_ratio(s, tuple(img_scale))
                samples.append(s)
            imgs, disps = zip(*(raw_frame(s) for s in samples))
            return samples, [np.stack(imgs), np.stack(disps)]

        def step(entry, t, sf):
            return ms.track_raw(entry[0], entry[1], [t] * S, scale_factor=sf)

        if args.stage_frames:
            staged = []
            for t in range(L):
                samples_t, entry = load_t(t)
                staged.append((samples_t, [to_device(x, ms.device)
                                           for x in entry]))
            sf0 = staged[0][0][0].get('scale_factor', (1.0, 1.0))
            fetch_result(step(staged[0][1], 0, sf0))()     # warm-up
            it = iter(staged)
        else:
            it = iter(PrefetchIterator(list(range(L)), load_t,
                                       num_workers=4))

        def consume(t, samples, fetch):
            nonlocal n_frames
            res = fetch()
            for s in range(real):
                if t >= len(frame_lists[s]):
                    continue
                n_frames += 1
                one = FrameResult(*(x[s] for x in res))
                _record(names[s], t, samples[s], one, mot_metric,
                        coco_metric, csv_dump)
                if show is not None:
                    prev_match[s] = show(names[s], t, samples[s], one,
                                         prev_match[s])

        t_start = time.perf_counter()
        pending = None            # one step behind: step t is issued
        for t, (samples, entry) in enumerate(it):   # before t-1 is read
            sf = samples[0].get('scale_factor', (1.0, 1.0))
            fetch = fetch_result(step(entry, t, sf))
            if pending is not None:
                consume(*pending)
            pending = (t, samples, fetch)
        if pending is not None:
            consume(*pending)
        elapsed += time.perf_counter() - t_start
        print(f'[test] group {[names[s] for s in range(real)]}: '
              f'{L} steps done '
              f'({n_frames / max(elapsed, 1e-9):.1f} pairs/s cum)',
              flush=True)
        if logger is not None:
            logger.log(n_frames, dict(
                group_frames=L * real,
                fps=n_frames / max(elapsed, 1e-9)), prefix='eval')
    return n_frames, elapsed


def postprocess(args, mot_metric) -> None:
    """The tracklet post-processors of the JAX CLI's ``_finish``, in its
    order, on each video's predictions: ``--aflink`` re-links, then
    ``--interpolate`` fills gaps."""
    if args.aflink:
        from ..evaluation.aflink import AppearanceFreeLink, load_aflink
        linker = AppearanceFreeLink(load_aflink(args.aflink),
                                    device=getattr(args, 'device', 'cuda'))
        for v in list(mot_metric._pred):
            mot_metric._pred[v] = linker.link(mot_metric._pred[v])
    if args.interpolate:
        from ..evaluation.postprocess import interpolate_tracklets
        for v in list(mot_metric._pred):
            mot_metric._pred[v] = interpolate_tracklets(mot_metric._pred[v])


def finish(args, mot_metric, coco_metric, n_frames, elapsed,
           logger=None) -> dict:
    """Post-process the tracklets (``postprocess``), score, write
    ``metrics.json`` (and with ``--dump-txt`` the MOT txt files), log and
    print; returns the metrics."""
    postprocess(args, mot_metric)
    results = {}
    results.update(mot_metric.evaluate())
    results.update(coco_metric.evaluate())
    results['fps'] = n_frames / elapsed
    if args.dump_txt:
        mot_metric.dump_txt()
    os.makedirs(args.work_dir, exist_ok=True)
    with open(os.path.join(args.work_dir, 'metrics.json'), 'w') as fjson:
        json.dump({k: float(v) for k, v in results.items()}, fjson, indent=2)
    if logger is not None:
        logger.log(n_frames, {k: v for k, v in results.items()
                              if isinstance(v, (int, float))},
                   prefix='metrics')
        logger.close()
    for k, v in results.items():
        print(f'{k}: {v:.4f}' if isinstance(v, float) else f'{k}: {v}')
    return results


def main(argv: Optional[List[str]] = None) -> dict:
    args = parse_args(argv)
    cfg = apply_overrides(load_config(args.config), args.cfg_options)
    logger = build_logger(cfg, args.work_dir)
    dataset = build_dataset(cfg)
    first = dataset.frame_info(dataset.video_frames(dataset.videos()[0])[0])
    img_scale = cfg.get('img_scale', (first['height'], first['width']))
    model = init_model(cfg, args.checkpoint, device=args.device,
                       dtype=torch.bfloat16 if args.bf16 else None)
    # DanceTrack is monocular: no meaningful depth on either side
    mot_metric = MOTDroneMetrics(
        depth_thr=args.depth_thr,
        ignore_depth=(args.ignore_depth
                      or cfg['test_dataloader']['dataset'].get('type')
                      == 'DanceTrackDataset'),
        outfile_dir=os.path.join(args.work_dir, 'mot_txt'))
    coco_metric = CocoMAPEvaluator(
        num_classes=len(cfg.get('classes', ('x',))))
    csv_dump = ResultsCSV(args.results_csv) if args.results_csv else None
    videos = dataset.videos()
    if args.max_videos:
        videos = videos[:args.max_videos]
    n_frames, elapsed = evaluate(model, dataset, videos, args, img_scale,
                                 mot_metric, coco_metric, csv_dump, logger)
    return finish(args, mot_metric, coco_metric, n_frames, elapsed, logger)


if __name__ == '__main__':
    main()
