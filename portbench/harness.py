"""The benchmark of the PyTorch port: one cell of ``BENCHMARK.json``, run
once.

A cell names a configuration (``configs/<config>.json``: the config's
``model`` dict as it is run, its input scale and its serving dtype) and a
traffic mix (``traffic/<traffic>.json``: streams, source frame size, the
ring of frames, the loop's sizes).  Metrics are readers
(``metrics/<name>.py``, each ``read(rec) -> float | None``) of the run's
record; the limits of ``correct`` are ``limits/<workload>.json``.  Each is
looked up by name, first under ``portbench/`` beside the ``BENCHMARK.json``
given, then beside this file, so a cell is added with files alone.

A run: build the program (``MultiStreamTracker`` of the port, with the
benchmark's seed-made weights), make the frames, warm up the cell's own
shapes (the step's CUDA graph is captured there), then drive ``track_raw``
for ``--seconds`` in a closed loop with one step in flight ahead: the call
for step t + 1 is made before the wait for step t's result.  The stage
backends that the port resolves for the cell's model on a card are
recorded once (``stage_backends``); the stage kernels' bound and the
control's precision follow them.  With
``--trace 1`` a stretch of the same loop runs under ``torch.profiler``
after the window.  Then the steps that follow the window run from the
program's own state, the program is freed, and the reference judges what
the program returned (check.py).  Two guards join its numbers, for the
precision the configuration states where no number tells it: TF32 left
as the run set it, and, in a traced run, no TF32 kernel launched.
"""
from __future__ import annotations

import gc
import importlib.util
import json
import os
import sys
import tempfile
import time
from pathlib import Path
from typing import Callable, Dict, List, NamedTuple, Optional

import numpy as np
import torch

from . import check, flops, frames, tracelib
from .reference import lower
from .reference import model as md
from .reference.pipeline import Reference, state_from
from .weights import seeded_state_dict

HERE = Path(__file__).resolve().parent
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'stereotracking_tpu')
START_STEPS = 6       # window steps the tracker is followed over from empty
SAMPLED_STEPS = 4     # further window steps whose detections are compared
FOLLOW_STEPS = 3      # steps after the window, from the program's state
WARMUP_STEPS = 5
TRACE_STEPS = 30
DTYPES = {'bfloat16': torch.bfloat16, 'float32': torch.float32}
# flops.stage_kernel_work's entries whose backend is another stage's
KERNEL_STAGE = {'disp_stem': 'stem'}
# systems that a run can put in the loop: the program; the controls
# (reference/lower.py); the program with TF32 switched on, (cuBLAS, cuDNN)
TF32_PROGRAMS = {'program_tf32': (True, True),
                 'program_tf32_conv': (False, True)}
CONTROLS = ('control', 'control_tf32')


# ------------------------------------------------------------ the catalog

class Cell(NamedTuple):
    name: str
    config: dict          # the configuration file's content
    traffic: dict
    end_to_end: List[dict]
    per_layer: List[dict]
    limits: Optional[dict]


def _search(root: Path, kind: str, filename: str) -> Optional[Path]:
    for base in (root / 'portbench', HERE):
        p = base / kind / filename
        if p.is_file():
            return p
    return None


def load_cell(bench_path: Path, workload: str) -> Cell:
    bench = json.loads(bench_path.read_text())
    root = bench_path.parent
    cells = {w['name']: w for w in bench['workloads']}
    if workload not in cells:
        raise SystemExit(f'unknown workload {workload!r}; one of '
                         f'{sorted(cells)}')
    w = cells[workload]
    cfg_entry = {c['name']: c for c in bench['configs']}[w['config']]
    config = json.loads((root / cfg_entry['file']).read_text())
    tpath = _search(root, 'traffic', f'{w["traffic"]}.json')
    if tpath is None:
        raise SystemExit(f'no traffic file for {w["traffic"]!r}')
    lpath = _search(root, 'limits', f'{workload}.json')

    def mine(m):
        return 'workloads' not in m or workload in m['workloads']

    return Cell(workload, config, json.loads(tpath.read_text()),
                [m for m in bench['end_to_end'] if mine(m)],
                [m for m in bench['per_layer'] if mine(m)],
                None if lpath is None else json.loads(lpath.read_text()))


def metric_reader(root: Path, name: str) -> Callable:
    path = _search(root, 'metrics', f'{name}.py')
    if path is None:
        raise SystemExit(f'no reader for metric {name!r}')
    spec = importlib.util.spec_from_file_location(
        f'portbench_metric_{name.replace(".", "_")}', path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


# ------------------------------------------------------------ the systems

class ProgramSystem:
    """The port's ``MultiStreamTracker`` behind the loop's interface."""

    def __init__(self, model_cfg: dict, dtype, n_streams: int,
                 state_dict, device):
        from stereotracking_tpu_torch.apis.builder import build_mot_config
        from stereotracking_tpu_torch.models.detector import YOLOXDetector
        from stereotracking_tpu_torch.models.mot import fetch_result
        from stereotracking_tpu_torch.parallel.multistream import \
            MultiStreamTracker
        mot = build_mot_config(model_cfg, device)
        with torch.device(device):
            det = YOLOXDetector(mot.detector, dtype=dtype)
        det.load_state_dict(state_dict)
        self.ms = MultiStreamTracker(mot, n_streams, module=det,
                                     device=device, dtype=dtype)
        self._fetch = fetch_result

    def submit(self, imgs, disps, fids, sf):
        wait = self._fetch(self.ms.track_raw(imgs, disps, fids,
                                             scale_factor=sf))
        return lambda: wait()._asdict()

    @property
    def states(self):
        return self.ms.states

    @property
    def captures(self) -> int:
        return self.ms._step.captures

    def reset(self):
        self.ms.reset()


class ControlSystem:
    """The reference one precision step down (reference/lower.py), in the
    program's place: the control that ``correct`` has to reject.  Each
    layer steps down from what the program computes it in: the stages
    that ``backends`` runs as kernels from bfloat16, the rest from
    ``dtype``.  With ``kernels_as_run`` (the system 'control_tf32') the
    kernels' layers stay in bfloat16, as the program runs them, and the
    tracker is rounded to TF32: the control of the float32 layers alone."""

    def __init__(self, model_cfg: dict, dtype: str, n_streams: int,
                 state_dict, device, backends: Dict[str, str],
                 kernels_as_run: bool = False):
        self.ref = Reference(model_cfg, state_dict, device,
                             round_tracker=lower.round_tf32_state
                             if kernels_as_run else lower.round_bf16)
        lower.lower_detector(self.ref.module, dtype, backends,
                             kernels_as_run)
        self.n = n_streams
        self._state = self.ref.init_state(n_streams)
        self.captures = 0

    def submit(self, imgs, disps, fids, sf):
        dev = self.ref.device
        img, disp = check._t(imgs, dev), check._t(disps, dev)
        _, kept = self.ref.detect(img, disp, sf)
        nd = self.ref.trk_cfg.num_dets
        self._state, tf = self.ref.track(
            self._state, kept.boxes[:, :nd], kept.scores[:, :nd],
            kept.labels[:, :nd], kept.valid[:, :nd],
            self.ref.disparity(disp),
            torch.tensor(fids, dtype=torch.int32, device=dev))
        out = dict(det_bboxes=kept.boxes, det_scores=kept.scores,
                   det_labels=kept.labels, det_valid=kept.valid,
                   **tf._asdict())
        out = {k: v.cpu().numpy() for k, v in out.items()}
        return lambda: out

    @property
    def states(self):
        return self._state

    def reset(self):
        self._state = self.ref.init_state(self.n)


# --------------------------------------------------------------- the loop

class Steps(NamedTuple):
    first: int
    n: int
    call_start: np.ndarray
    call_end: np.ndarray
    done: np.ndarray
    kept: Dict[int, tuple]        # step -> (ring index, output copy)

    @property
    def window_s(self) -> float:
        return float(self.done[-1] - self.call_start[0])


def drive(system, video, sf, first: int, min_steps: int, seconds: float,
          keep=(), max_steps: Optional[int] = None,
          annotate: bool = False, capacity: int = 1 << 17) -> Steps:
    """Closed loop, one step in flight ahead, from frame id ``first``:
    runs until ``seconds`` have passed and ``min_steps`` steps were made
    (or ``max_steps`` were).  Nothing but the calls, the waits and the
    timestamps happens between the first call and the last result; the
    outputs of the steps in ``keep`` are copied as they arrive."""
    imgs, disps = video
    ring = imgs.shape[0]
    n_streams = imgs.shape[1]
    cap = capacity if max_steps is None else max_steps
    call0, call1, done = np.empty(cap), np.empty(cap), np.empty(cap)
    kept = {}
    pending, prev_r = None, None
    clock = time.perf_counter
    rf = torch.profiler.record_function
    t = 0
    t_start = clock()
    while t < cap:
        if max_steps is None and t >= min_steps and \
                clock() - t_start >= seconds:
            break
        step = first + t
        r = frames.ring_index(step, ring)
        call0[t] = clock()
        if annotate:
            with rf('portbench.call'):
                wait = system.submit(imgs[r], disps[r], [step] * n_streams,
                                     sf)
        else:
            wait = system.submit(imgs[r], disps[r], [step] * n_streams, sf)
        call1[t] = clock()
        if pending is not None:
            out = _wait(pending, annotate)
            done[t - 1] = clock()
            if step - 1 in keep:
                kept[step - 1] = (prev_r, {k: np.array(v)
                                           for k, v in out.items()})
        pending, prev_r = wait, r
        t += 1
        if max_steps is not None and t >= max_steps:
            break
    out = _wait(pending, annotate)
    done[t - 1] = clock()
    if first + t - 1 in keep:
        kept[first + t - 1] = (prev_r, {k: np.array(v)
                                        for k, v in out.items()})
    return Steps(first, t, call0[:t], call1[:t], done[:t], kept)


def _wait(pending, annotate):
    if annotate:
        with torch.profiler.record_function('portbench.wait'):
            return pending()
    return pending()


# ---------------------------------------------------------------- the run

def setup_clock() -> Callable[[], float]:
    """Seconds since this process started (its start time in the kernel's
    process table, against the boot-time clock)."""
    try:
        with open('/proc/self/stat') as f:
            ticks = int(f.read().rsplit(')', 1)[1].split()[19])
        born = ticks / os.sysconf('SC_CLK_TCK')
        return lambda: time.clock_gettime(time.CLOCK_BOOTTIME) - born
    except (OSError, ValueError, AttributeError):
        t0 = time.perf_counter()
        return lambda: time.perf_counter() - t0


def forbidden_modules() -> List[str]:
    tops = {m.split('.')[0] for m in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def plan_samples(seed: int, start: int, stop: int, k: int) -> List[int]:
    rng = np.random.default_rng(seed)
    k = min(k, max(stop - start, 0))
    return sorted(int(x) for x in rng.choice(np.arange(start, stop), k,
                                             replace=False))


def shapes(cell: Cell):
    tr = cell.traffic
    (h, w), sf = frames.rescale(tr['source_hw'], cell.config['img_scale'])
    return (h, w, *md.padded_shape(h, w), sf)


def stage_backends(model_cfg: dict) -> Dict[str, str]:
    """'cuda' or 'torch' for each of the stem and stages 1-3: what the
    port's ``apis/builder.resolve_stage_backends`` gives ``model_cfg`` on a
    card (a pure function), on whatever device this run is."""
    from stereotracking_tpu_torch.apis.builder import resolve_stage_backends
    return dict(resolve_stage_backends(model_cfg, 'cuda')._asdict())


def kernel_bound_s(det: dict, h: int, w: int, oh: int, ow: int,
                   backends: Dict[str, str]) -> float:
    """The least time of one frame's stem and stage kernels: the bounds
    of ``flops.stage_kernel_work`` summed over the stages that
    ``backends`` runs as kernels (the disparity stem's with the stem's)."""
    return sum(flops.bound_s(*x) for k, x in flops.stage_kernel_work(
        det, h, w, oh, ow).items()
        if backends[KERNEL_STAGE.get(k, k)] == 'cuda')


def run_cell(bench_path: Path, workload: str, seed: int, seconds: float,
             trace: bool, device='cuda', since_start=None,
             system: str = 'program', wrap=None) -> dict:
    """One run of ``workload``; returns the result line's object.
    ``system`` 'control' or 'control_tf32' puts a control in the program's
    place, 'program_tf32' or 'program_tf32_conv' runs the program with TF32
    switched on (the float32 cell's own lower precision); ``wrap``,
    when given, is applied to the system before the run (the tests break
    the timed path with it)."""
    since_start = since_start or setup_clock()
    cell = load_cell(bench_path, workload)
    dev = torch.device(device)
    tf32 = TF32_PROGRAMS.get(system, (False, False))
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 \
        = tf32
    torch.backends.cudnn.benchmark = False
    torch.set_num_threads(min(4, torch.get_num_threads()))
    model_cfg = cell.config['model']
    tr = cell.traffic
    n_streams = int(tr['streams'])
    h, w, oh, ow, sf = shapes(cell)
    det_cfg = md.detector_config(model_cfg)
    dtype = DTYPES[cell.config['dtype']]
    backends = stage_backends(model_cfg)

    video = frames.make_video(n_streams, h, w, int(tr['ring']), seed,
                              int(tr.get('objects', 6)),
                              float(tr.get('speed_px', 4.0)))
    sd = seeded_state_dict(det_cfg, seed, dev)
    if system in CONTROLS:
        sysm = ControlSystem(model_cfg, cell.config['dtype'], n_streams,
                             sd, dev, backends, system == 'control_tf32')
    else:
        sysm = ProgramSystem(model_cfg, dtype, n_streams, sd, dev)
    del sd
    if wrap is not None:
        sysm = wrap(sysm)
    drive(sysm, video, sf, 0, WARMUP_STEPS, 0.0, max_steps=WARMUP_STEPS)
    sysm.reset()
    _sync(dev)
    captures = sysm.captures
    if dev.type == 'cuda':
        torch.cuda.reset_peak_memory_stats(dev)
    setup_s = since_start()

    min_steps = int(tr['min_steps'])
    samples = plan_samples(seed, START_STEPS, min_steps, SAMPLED_STEPS)
    keep = set(range(START_STEPS)) | set(samples)
    if system not in CONTROLS:
        win = drive(sysm, video, sf, 0, min_steps, seconds, keep=keep)
    else:
        win = drive(sysm, video, sf, 0, min_steps, 0.0, keep=keep,
                    max_steps=min_steps)
    recaptured = sysm.captures != captures
    # reserved, not allocated: the step's activations live in the CUDA
    # graph's private pool, which replays do not allocate from again
    peak = (torch.cuda.max_memory_reserved(dev) if dev.type == 'cuda'
            else 0)

    traced = None
    nxt = win.first + win.n
    if trace:
        traced = _traced_stretch(sysm, video, sf, nxt)
        nxt += TRACE_STEPS
    snapshot = [t.clone() for t in sysm.states]
    follow = drive(sysm, video, sf, nxt, FOLLOW_STEPS, 0.0,
                   keep=set(range(nxt, nxt + FOLLOW_STEPS)),
                   max_steps=FOLLOW_STEPS)
    del sysm
    now = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    # the reference judges in float32 whatever ran
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gc.collect()
    if dev.type == 'cuda':
        torch.cuda.empty_cache()

    ref = Reference(model_cfg, seeded_state_dict(det_cfg, seed, dev), dev)
    det_steps = [win.kept[t] for t in sorted(win.kept)] + \
        [follow.kept[t] for t in sorted(follow.kept)]
    runs = [(ref.init_state(n_streams),
             [(t, *win.kept[t]) for t in range(START_STEPS)]),
            (state_from(snapshot, dev),
             [(t, *follow.kept[t]) for t in sorted(follow.kept)])]
    values = check.judge(ref, video, sf, det_steps, runs)
    correct, rows = check.verdict(values, cell.limits)
    del ref
    if recaptured:
        correct = False
        print('the step was captured again inside the window',
              file=sys.stderr)
    # the precision the configuration states, where no number can tell
    # it: TF32 switched on or off inside the run (cuBLAS, cuDNN), and, in
    # a traced run, TF32 kernels launched
    guards = {'tf32_switched': float(now != tf32)}
    if traced is not None:
        guards['tf32_kernels'] = float(tracelib.tf32_kernels(traced))
    for name, v in guards.items():
        rows[name] = {'value': v, 'limit': 0}
        correct = correct and v == 0

    rec = dict(setup_s=setup_s, streams=n_streams, steps=win.n,
               window_s=win.window_s, call_s=win.call_end - win.call_start,
               latency_s=win.done - win.call_start,
               flops_per_step=n_streams * flops.detector_flops(
                   det_cfg._asdict(), oh, ow),
               stage_bound_s=n_streams * kernel_bound_s(
                   det_cfg._asdict(), h, w, oh, ow, backends),
               stage_backends=backends, trace=traced, device=dev.type)
    specs = cell.per_layer if trace else cell.end_to_end
    metrics = {}
    for m in specs:
        v = metric_reader(bench_path.parent, m['name'])(rec)
        if v is not None:
            metrics[m['name']] = {'value': float(v), 'unit': m['unit']}
    device_info = _device_info(dev, peak)
    device_info['stage_backends'] = backends
    if traced is not None:
        device_info['busy_s'] = tracelib.busy_s(traced)
        device_info['window_s'] = traced.window_s
    result = {'correct': bool(correct), 'attempted': n_streams * win.n,
              'failed': 0, 'metrics': metrics, 'device': device_info}
    if traced is not None:
        result['breakdown'] = {'device_ops': tracelib.top_ops(traced),
                               'idle_gaps': tracelib.idle_gaps(traced)}
    result['readings'] = values
    result['checks'] = rows
    return result


def _traced_stretch(sysm, video, sf, first: int):
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        drive(sysm, video, sf, first, TRACE_STEPS, 0.0,
              max_steps=TRACE_STEPS, annotate=True)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, 'trace.json')
        prof.export_chrome_trace(path)
        return tracelib.load_chrome_trace(path, TRACE_STEPS)


def _sync(dev):
    if dev.type == 'cuda':
        torch.cuda.synchronize(dev)


def _device_info(dev, peak) -> dict:
    if dev.type != 'cuda':
        return {'platform': 'cpu', 'kind': 'cpu', 'count': 1,
                'memory_peak_bytes': 0}
    return {'platform': 'gpu', 'kind': torch.cuda.get_device_name(dev),
            'count': 1, 'memory_peak_bytes': int(peak)}
