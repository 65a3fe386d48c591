#!/usr/bin/env python3
"""Drive the PyTorch port's paths once on one NVIDIA GPU.

    python3 chip_smoke.py [--profile]

Phases, in order; any failure exits non-zero:

1. device: requires ``torch.cuda.is_available()``; prints the card's
   ``nvidia-smi`` name and power limit; turns TF32 off for the float32
   reference computations;
2. build: compiles the CUDA kernels from ``stereotracking_tpu_torch/csrc``
   (one nvcc per source, all at once, sm_90a, with ``-Xptxas -v``) and
   prints the build time and, for the kernels redesigned for the H100
   (the stem, stages 1-3, depth, the JV and NMS), their registers, shared
   memory and spills from that build;
3. kernels: each kernel against its plain PyTorch version on the same
   inputs, at one stream and at 8 streams of 1080x1920 raw frames padded to
   1088x1920, with the tolerance stated beside each check; kernel, plain
   version and (where one PyTorch call computes the same function) that
   call timed with CUDA events; each kernel's bound from its bytes and
   operations; for the stem and stages 1-3 the achieved rate and share of
   the bound, and for stages 1-3 the weight bytes read from L2 per region
   before (wmma B fragments from device memory) and after (the slice
   ring); the float32 stage-3 modules (TF32 off) timed beside the stage-3
   kernel; for depth also its vote branches against the plain composite's
   and the host wall of one whole extraction beside the eager box scalars
   + epilogue it runs inside; the JV and NMS kernels exactly against their
   plain versions on the inputs that the second of two eager main-path
   steps hands them (the JV also on an all-conflicted problem, the NMS
   with the main path's cap ``max_keep`` = ``max_out`` and without one,
   also on candidates of the same shape that suppress, from
   ``tests/device_step_cases.py``, where every stream must keep some and
   drop some); the device times of the depth, JV and NMS kernels (and the
   kernel launches of one depth extraction) come from ``torch.profiler``
   after the timed phases, since a profiler session slows the host work
   after it; the stem kernel also at O = 24, 48 and 80 (YOLOX-tiny, -m
   and -x) on both branches of the 8-stream frames with seeded random
   weights, the same tolerance, times and bound (JSON ``stem.widths``);
   and each stage kernel at YOLOX-nano's and -tiny's widths (stage 1 C =
   16, 24; stage 2 C = 32, 48; stage 3 C = 64, 96) on seeded activations
   of its 8-stream input shape with seeded random weights, the flagship
   rows' tolerance, one launch a call, times and bound (JSON
   ``stage1.widths`` etc.);
4. reference: on a small frame the kernel path's head outputs (stage 3
   through its kernel too) must agree with the float32 module path;
5. slice: ``build_model(flagship config)`` on the card, ``track_raw`` over
   6 synthetic 1080p frames, replayed from the step's CUDA graph (captured
   by a first call, the state then reset); no wrapper launches a kernel
   during the replays; outputs finite; no host sync in a frame; the same
   frames through the eager step (``predict_frames_batched``) equal (ids
   and validity exact, boxes within 1e-2 px) and timed beside the replays;
   then over 2 frames each, replayed as above (0 host syncs, replayed ==
   eager): the stem and stage-1 kernels with stage 2 on the float32
   modules; widen-0.25 and 0.375 configs with every stage 'auto' (the
   stem, stage-1 and stage-2 kernels, no builder warning) and with
   ``stage3_backend='cuda'`` (stage 3 too); a widen-0.75 config with every
   stage 'auto' (the stem kernel only, at O = 48; the builder's warning
   for stages 1 and 2, naming ROADMAP Queue 3 item 1, printed);
6. multi-stream: ``MultiStreamTracker`` with the flagship config and
   ``stage3_backend='cuda'``, 8 replayed steps of 8 streams (each stream
   its own seed); ms per step and stereo pairs/s, replayed and eager;
   outputs finite; no host sync in a step; no wrapper launches a kernel
   during the replays; replayed equal to eager; stream 0 over the first 3
   steps equal to a single-stream run of its frames (ids and validity
   exact, boxes within 1e-2 px);
7. bf16: phase 6's 8 steps of 8 streams again with the detector's module
   layers computing in bf16 (``MultiStreamTracker(dtype=torch.bfloat16)``,
   the same weights); replayed and eager ms per step beside phase 6's; no
   host sync; replayed equal to eager; outputs finite; printed as
   findings, not checks: the largest bf16 - float32 difference of the head
   maps on one frame and how many of stream 0's track slots differ over 3
   steps; then the device time of the tracker's fixed-trip smoothing
   replay alone (one CUDA graph) at 8 and one stream; then YOLOX-tiny's
   widths (widen 0.375, seeded random weights) on the same 8 steps in
   bf16, replayed (0 host syncs, replayed == eager), every stage 'auto'
   (stem, stage-1 and stage-2 kernels) against the stem kernel with
   stages 1-3 on the bf16 modules, ms per step of each;
8. eval: the eval CLI's loop (``stereotracking_tpu_torch.tools.test.
   evaluate``) over 2 videos x 6 frames of 1080x1920 held in memory (ground
   truth: the rectangles ``make_frames`` draws), weights through
   ``init_model`` from a ``.pth`` written to a temporary directory;
   sequentially and with ``--streams 2 --stage-frames``, in float32 and with
   ``--bf16``, as the CLI runs them (bf16 with cuDNN off, its
   batch-invariant choice): the count metrics of the two loops must be
   equal; pairs/s; no host sync per step besides the result fetch; as a
   finding, the bf16 loops with cuDNN on (the CLI's choice overridden):
   whether they differ, and their pairs/s; the float32 sequential loop
   once more with ``--show-dir --show-interval 2 --show-errors``: 0 host
   syncs per step, and one JPEG of the frame's size for frames 0, 2, 4 of
   each video under ``<dir>/<video>/``; then ``inference_mot`` over 2
   frames must equal ``track_raw`` (ids exact, boxes within 1e-3 px);
9. train: the flagship detector (full width, float32, TF32 off) in train
   mode, ``train/train_state.train_step`` at batch 8 of 736x1280 on the two
   host-staged random batches of ``tools/bench_train.py`` (4-47 ground
   truths per image): 2 warm-up and 10 timed steps with each loss config
   (stage 1; stage 2 with L1): ms per step, steps/s, pairs/s and
   ``torch.cuda.max_memory_allocated``; finite losses, parameters and EMA
   moved, no host sync in a step, the kernel weight cache rebuilt after an
   optimizer step; 20 steps at a constant lr of 0.01 on one fixed batch
   (the head's cls and obj biases at the reference's prior probability
   0.01) must lower the loss; at a small size (deepen 0.1, widen 0.125,
   batch 2, 64x96) one step on the card against the same step on the CPU
   from the same weights and batch, cuDNN deterministic (``num_pos``
   equal; losses, gradients (the momentum buffers) and the updated state
   within the tolerances stated in ``check_train_on_cpu``); then the EMA
   weights exported, loaded through ``init_model`` (every tensor equal to
   the EMA's, the packed kernel weights too) and served over 2 frames
   through ``track_raw`` with the kernels, replayed, 0 host syncs;
10. launches: after the timed phases, each tracker of phases 5-7 is reset
   and its steps replayed again under ``torch.profiler``, the wrappers'
   counts set to 0 just before: the hand-written kernels in the trace must
   be stem 2, stage 1 1, stage 2 1, stage 3 1 (0 in phase 5), depth 2,
   assignment 3 and nms 1 per step (phase 5's backend mixes: stem 2, each
   stage 1 where it resolved to its kernel, else 0, depth 2, assignment
   3, nms 1), the wrappers' counts 0 (every step a replay), and ids and
   validity as in the timed run;
11. probe: the stage-1 kernel's six variants at 8 streams, each held to
   the plain version and timed (``tools/probe_stage1_variants.py``), the
   production one beside the wmma 16x16 region it replaced;
12. other configs, among the timed phases (their launches counted in
   phase 10's traces): the KITTI stereo config (YOLOX-S, 2 classes) with
   seeded weights on 375x1242 frames resized as the CLI does (386x1280,
   padded to 416x1280): every kernel of its path held to its plain version
   at 8 streams of this shape with phase 3's tolerances (stage 3
   explicitly; depth, JV and NMS on the main path's own inputs, both labels
   kept; the stem also at O = 24, 48, 80, the stage kernels at phase 3's
   other widths), one stream over 6 frames and
   8 streams over 8 steps replayed equal to eager with 0 host syncs (ms per frame, pairs/s), the eval
   CLI's loop over 2 videos x 6 frames sequential and ``--streams 2`` in
   float32 (count metrics equal); the monocular config (single backbone,
   every stage on the modules; an explicit ``stem_backend='cuda'`` must
   raise) over 6 frames of 1080x1920 resized to 720x1280, replayed equal to
   eager, 0 host syncs, launches stem 0, stages 0, depth 1 (the config
   keeps ``reuse_det_depth``'s default, True), assignment 3, nms 1 per
   step; the flagship config with the V0 concatenated backbone over 2
   frames, the same with depth 2; 3 train steps of the single backbone at batch
   8 x 736x1280 (finite losses, ms per step);
13. moving camera (its launches counted in phase 10's traces): the
   monocular config with camera-motion compensation
   (``yolox_s_ocsort_monocular_cmc.py``, ``backend='device'``) through
   ``init_model`` -> ``track_raw`` over 8 frames of 1080x1920 panning by
   a known (dy, dx) = (-8, 15) px a frame: replayed from the step's graph
   (no wrapper launch), 0 host syncs, equal to the eager step (ids
   exact); the camera-motion chain alone captured in a graph and replayed
   equal to its eager run (warps exact), the shift recovered within the
   JAX test's bounds (2.5 px, 0.05 on the linear part), 0 host syncs;
   ms per frame with and without the chain on the same frames and the
   chain's torch.profiler device time (findings); the eval CLI
   (``tools.test.main``) on the synthetic on-disk dataset with the config,
   ``--interpolate`` and ``--aflink`` (a checkpoint the port's AFLink
   trainer writes in 30 steps on the card) and without them, count
   metrics printed, ``--streams 2`` refused; whether ``cv2`` imports, and
   where it does 3 frames of ``backend='opencv'``.

``--profile`` adds, after the timed phases, a ``torch.profiler`` window
over two replayed steps of one stream in float32 and of 8 streams in
float32 and in bf16 (and of each phase-12 tracker: KITTI at one and 8
streams, monocular, concat), and prints the device time by kernel, the card's busy
share and each hand-written kernel's launches and device time per step in
the trace; and a window of two train steps of phase 9, its device time
split into forward, loss (with SimOTA), backward, and optimizer plus EMA.

Output: the per-phase lines, then the card line and one JSON line of kernel
results (8-stream shapes; launches from the trace of phase 6's replayed
steps, the probe's from the probe run; ``kitti_416x1280``: the same
kernel's error, times and bound at 8 streams of the KITTI shape;
``stem.widths``: the stem at O = 24, 48 and 80; ``stage1.widths``,
``stage2.widths``, ``stage3.widths``: the stage kernels at YOLOX-nano's
and -tiny's widths), then, as the last line, ``{"ok": true, "device":
{...}}``.
"""
import contextlib
import json
import math
import os
import subprocess
import sys
import time
import warnings

REPO = os.path.dirname(os.path.abspath(__file__))
CONFIG = os.path.join(REPO, 'configs', 'stereo_tracking', 'ocsort',
                      'yolox_s_airdrone_disp.py')
FRAME_H, FRAME_W = 1080, 1920
N_FRAMES = 6             # single-stream slice
N_STREAMS, N_STEPS = 8, 8
N_PARITY = 3             # multi-stream steps checked against one stream
SEED = 0
# head biases set so that random-weight detections clear init_track_thr and
# the tracker spawns, matches and evicts tracks (sigmoid(3)^2 = 0.91)
HEAD_BIAS = 3.0
# published H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor cores,
# float32 outside the tensor cores, HBM3
PEAK_BF16, PEAK_F32, HBM_RATE = 989e12, 67e12, 3.35e12

KERNELS = {
    # name: (source, TPU kernel it replaces)
    'stem': ('stereotracking_tpu_torch/csrc/stem.cu',
             'stereotracking_tpu/ops/stem_pallas.py:104'),
    'stage1': ('stereotracking_tpu_torch/csrc/stage1.cu',
               'stereotracking_tpu/ops/stage1_pallas.py:303'),
    'stage2': ('stereotracking_tpu_torch/csrc/stage2.cu',
               'stereotracking_tpu/ops/stage2_pallas.py:256'),
    'stage3': ('stereotracking_tpu_torch/csrc/stage3.cu',
               'stereotracking_tpu/ops/stage2_pallas.py:334'),
    'depth': ('stereotracking_tpu_torch/csrc/depth.cu',
              'stereotracking_tpu/ops/depth_pallas.py:84'),
    'assignment': ('stereotracking_tpu_torch/csrc/assignment.cu',
                   'stereotracking_tpu/ops/assignment.py:209'),
    'nms': ('stereotracking_tpu_torch/csrc/nms.cu',
            'stereotracking_tpu/ops/nms.py:31'),
    'stage1_variants': ('stereotracking_tpu_torch/csrc/stage1.cu',
                        'tools/probe_stage1_variants.py:153'),
}

# kernels redesigned for the H100: their ptxas registers, shared memory and
# spills are printed, and their device time in torch.profiler (depth,
# assignment, nms) or achieved rate and share of the bound (the others)
REDESIGNED = ('stem', 'stage1', 'stage2', 'stage3', 'depth', 'assignment',
              'nms')
ALL_KERNELS = ('cuda',) * 4       # a StageBackends with every stage kernel


class SmokeFailure(Exception):
    pass


def require(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def make_frames(n, h, w, seed, with_boxes=False):
    """Synthetic raw frames as ``bench.py`` makes them: noise, six bright
    rectangles with constant disparity, invalid (65535) upper half.  With
    ``with_boxes`` each frame also gives its rectangles as (6, 4) float32
    xyxy boxes and their (6,) raw disparities, in drawing order."""
    import numpy as np
    rng = np.random.RandomState(seed)
    frames = []
    for _ in range(n):
        img = rng.randint(0, 255, (h, w, 3), np.uint8)
        disp = np.full((h, w), 65535, np.uint16)
        disp[h // 2:] = rng.randint(16, 1600, (h - h // 2, w), np.uint16)
        boxes, raw = [], []
        for _ in range(6):
            x, y = rng.randint(0, w - 60), rng.randint(0, h - 40)
            img[y:y + 30, x:x + 40] = rng.randint(100, 255, 3, np.uint8)
            d = rng.randint(40, 800)
            disp[y:y + 30, x:x + 40] = d
            boxes.append((x, y, x + 40, y + 30))
            raw.append(d)
        frames.append((img, disp, np.asarray(boxes, np.float32),
                       np.asarray(raw)) if with_boxes else (img, disp))
    return frames


def to_card(frames, device):
    """[(img, disp)] numpy -> (S, H, W, 3) uint8, (S, H, W) uint16 on the
    card."""
    import numpy as np
    import torch
    img = torch.from_numpy(np.stack([f[0] for f in frames])).to(device)
    disp = torch.from_numpy(np.stack([f[1] for f in frames]).astype(
        'int32')).to(device).to(torch.uint16)
    return img, disp


def flagship_cfg(stage3_backend=None):
    from stereotracking_tpu_torch.config import load_config
    cfg = load_config(CONFIG)
    if stage3_backend is not None:
        cfg['model']['stage3_backend'] = stage3_backend
    return cfg


def build_flagship(device, seed=SEED):
    """The flagship model with seeded random weights and HEAD_BIAS."""
    import torch
    from stereotracking_tpu_torch.apis.builder import build_model
    model = build_model(flagship_cfg(), device=device, seed=seed)
    head = model.module.bbox_head.head_module
    with torch.no_grad():
        for conv in (*head.multi_level_conv_cls, *head.multi_level_conv_obj):
            conv.bias.fill_(HEAD_BIAS)
    return model


def time_ms(fn, iters):
    """Mean milliseconds per call by CUDA events, after one warm-up."""
    from stereotracking_tpu_torch.tools.probe_stage1_variants import cuda_ms
    return cuda_ms(fn, iters)


def device_kernels(fn, calls):
    """(name, device us) of each kernel that ``calls`` calls of ``fn``
    launch, from torch.profiler's trace.  ``fn`` launches at least one
    kernel, so a trace with none was dropped (torch.profiler on the card
    now and then drops device events, and at times all of them): it is
    taken again, up to 5 times."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(5):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        ks = [(e.name, e.time_range.elapsed_us()) for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and not e.name.startswith(('Memcpy', 'Memset'))]
        if ks:
            return ks
    raise SmokeFailure('torch.profiler recorded no kernel in 5 traces')


def device_ms(fn, kernel, iters):
    """Mean device milliseconds of the kernel whose name holds ``kernel``,
    one launch per call of ``fn``, over the launches the trace holds (it
    may drop one now and then; a trace that dropped more than half is
    taken again, up to 3 times)."""
    for _ in range(3):
        us = [t for name, t in device_kernels(fn, iters) if kernel in name]
        if iters // 2 <= len(us):
            break
    require(iters // 2 <= len(us) <= iters,
            f'{kernel}: {len(us)} kernels in the trace of {iters} calls')
    return sum(us) / len(us) / 1e3


def bound(nbytes, ops, rate):
    """(least ms, what bounds it): the bytes over the HBM rate or the
    operations over the peak rate of their type, the larger."""
    t_bytes, t_ops = nbytes / HBM_RATE * 1e3, ops / rate * 1e3
    return (t_bytes, 'bytes') if t_bytes >= t_ops else (t_ops, 'operations')


def stage_ops(k, hout, wout):
    """FLOPs of one stage chain (entry 3x3 s2, main|short, nb
    bottlenecks, final 1x1) over a (hout, wout) output."""
    cin, cout, mid, nb = k.dims
    per_px = 2 * (9 * cin * cout + cout * 2 * mid
                  + nb * (mid * mid + 9 * mid * mid) + 2 * mid * cout)
    return per_px * hout * wout


def nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


def depth_boxes(device):
    """64 boxes: on every pyramid level (crop 96: sizes 40, 150, 300, 700),
    degenerate, leaving the frame, > 800 px wide, with n = 0 (the invalid
    upper half of make_frames' maps), 1 and 2, on the all-equal window of
    check_depth, and NaN (empty tracker slots)."""
    import torch
    nan = math.nan
    b = [[100, 600, 140, 630], [400, 700, 550, 800], [800, 560, 1100, 760],
         [200, 400, 900, 1000], [1000, 540, 1010, 541],   # levels 0-3, tiny
         [-30, -30, -5, -5], [-10, 600, 40, 640],         # negative corners
         [1900, 1070, 1990, 1150], [1950, 700, 2000, 720],  # leaving / out
         [500, 700, 500, 760], [300, 650, 1200, 700],     # zero width, >800
         [0, 0, 1920, 1088], [600, 2, 612, 8],            # n = 0
         [700, 800, 701, 801], [700, 800, 702, 801],      # n = 1, 2
         [1505, 905, 1550, 945], [nan, nan, nan, nan],    # equal, NaN
         [nan, 10.0, nan, 50.0]]
    for i in range(64 - len(b)):
        x, y = 37 * i % 1800, 540 + 13 * i % 500
        b.append([x, y, x + 8 + 3 * i, y + 6 + 2 * i])
    return torch.tensor(b, dtype=torch.float32, device=device)


# L2 weight reads per call, (regions, bytes before, bytes after), at output
# (hout, wout) per stream.  Before: the wmma chain of csp_chain.cuh loads
# every GEMM's whole (K, N) matrix from device memory once per m tile (16
# pixels) of the region; after: the slice ring reads each slice once per
# region (mma_chain.cuh).
def _tiles(hout, wout, th, tw):
    return math.ceil(hout / th) * math.ceil(wout / tw)


def l2_stage1(k1, kd1, out_hw):
    """Both branches; before: the 16 x 16 wmma region (16 m tiles, 14 x 14
    tile), after: the production region."""
    from stereotracking_tpu_torch.ops.stage1_cuda import PRODUCTION
    gh = 16 if PRODUCTION.startswith('r16') else 8
    old = _tiles(*out_hw, 14, 14)
    new = _tiles(*out_hw, gh - 2, 14)
    return (new, old * 16 * nbytes(k1.w, kd1.w), new * nbytes(k1.ws, kd1.ws))


def l2_stage2(k2, out_hw):
    r = _tiles(*out_hw, 10, 10)
    return r, r * 16 * nbytes(k2.w), r * nbytes(k2.ws)


def l2_stage3(k3, out_hw):
    """Launch A: 8 x 16 tiles, 8 m tiles, the entry conv and main|short;
    launch B: 16 x 16 regions (10 x 10 tiles), 16 m tiles, the rest."""
    from stereotracking_tpu_torch.ops.stage2_cuda import (CHAIN_GEMM,
                                                          slice_offsets)
    cin, cout, mid, _ = k3.dims
    a, b = _tiles(*out_hw, 8, 16), _tiles(*out_hw, 10, 10)
    flat_a = 2 * (9 * cin * cout + cout * 2 * mid)
    split = slice_offsets(k3.dims)[CHAIN_GEMM]
    slice_b = nbytes(k3.ws) // k3.ws.shape[0]
    return (a + b, a * 8 * flat_a + b * 16 * (nbytes(k3.w) - flat_a),
            a * split * slice_b + b * (nbytes(k3.ws) - split * slice_b))


def weight_reads(n, name, regions, before, after):
    print(f'{name} x{n}: {n * regions} regions; L2 weight reads per call '
          f'{n * before / 1e9:.2f} GB (per-tile wmma loads) -> '
          f'{n * after / 1e9:.2f} GB (slice ring)', flush=True)


def stem_check(frm, wk, sb, oh, ow, what):
    """The stem kernel against its plain version on one branch's raw
    frames, with its tolerance (phase 3): one bf16 ulp after BN + SiLU,
    plus the float32 reassociation bound 2 K 2^-24 sum|x w| |scale| of the
    two sums (K = 36 C).  Returns the kernel's output, the largest error,
    the largest error over its tolerance, the operations and the library
    call's (input, weight) pair."""
    import torch.nn.functional as F
    from stereotracking_tpu_torch.ops import stem_cuda
    n = frm.shape[0]
    k = stem_cuda.focus_stem(frm, wk, sb, oh, ow)
    p = stem_cuda.focus_stem_plain(frm, wk, sb, oh, ow).float()
    require(k.shape == (n, oh // 2, ow // 2, wk.shape[-1]),
            f'{what} shape {tuple(k.shape)}')
    x = F.pad(stem_cuda.stem_input(frm, oh, ow), (2, 3, 2, 3))
    c = x.shape[1]
    w6 = stem_cuda.stem_hwio(wk, c)
    mag = F.conv2d(x.abs(), w6.abs().permute(3, 2, 0, 1), stride=2)
    mag = mag.permute(0, 2, 3, 1) * sb[0].abs()
    tol = 2 ** -7 * p.abs() + 2 * 36 * c * 2 ** -24 * mag
    d = (k.float() - p).abs()
    bad = d > tol
    require(not bool(bad.any()),
            f'{what}: {int(bad.sum())} elements beyond tolerance, e.g. '
            f'kernel {k.float()[bad][:4].tolist()} plain '
            f'{p[bad][:4].tolist()} tol {tol[bad][:4].tolist()}')
    worst = float((d / tol.clamp_min(1e-30)).max())
    return (k, float(d.max()), worst, 2 * k.numel() * 36 * c,
            (x, w6.permute(3, 2, 0, 1).contiguous()))


# the stem kernel's YOLOX widths beyond the flagship's 32 (tiny, m, x):
# seeded random weights, both branches, 8 streams of 1080p (phase 3)
STEM_EXTRA_WIDTHS = (24, 48, 80)


def check_stem_widths(img, disp_u16, oh, ow, iters=10):
    """Phase 3 (widths): the stem kernel at O = 24, 48 and 80 against its
    plain version with the same tolerance as at O = 32, on both branches'
    8-stream frames; kernel, plain version and ``F.conv2d`` timed, the
    bound from the bytes and operations.  Returns {'o<O>': row}."""
    import torch
    import torch.nn.functional as F
    from stereotracking_tpu_torch.ops import stem_cuda
    n = img.shape[0]
    rows = {}
    for o in STEM_EXTRA_WIDTHS:
        g = torch.Generator().manual_seed(SEED + o)
        weights = []
        for c in (3, 1):
            w6 = (torch.randn((6, 6, c, o), generator=g) * 0.05).to(
                torch.bfloat16).float()
            sb = torch.stack([torch.rand((o,), generator=g) + 0.5,
                              torch.randn((o,), generator=g)])
            weights.append((stem_cuda.stem_matrix(w6).to(img.device),
                            sb.to(img.device).contiguous()))
        outs, xs, err, worst, ops = [], [], 0.0, 0.0, 0
        for frm, (wk, sb) in zip((img, disp_u16), weights):
            k, e, wst, op, x = stem_check(frm, wk, sb, oh, ow, f'stem O={o}')
            outs.append(k)
            xs.append(x)
            err, worst, ops = max(err, e), max(worst, wst), ops + op
        (wi, si), (wd, sd) = weights
        t, by = bound(nbytes(img, disp_u16, *outs), ops, PEAK_BF16)
        row = dict(
            max_abs_err=err,
            ms=time_ms(lambda: (stem_cuda.focus_stem(img, wi, si, oh, ow),
                                stem_cuda.focus_stem(disp_u16, wd, sd, oh,
                                                     ow)), iters),
            plain_ms=time_ms(lambda: (
                stem_cuda.focus_stem_plain(img, wi, si, oh, ow),
                stem_cuda.focus_stem_plain(disp_u16, wd, sd, oh, ow)),
                iters),
            bound_ms=t, bound_by=by,
            library_ms=time_ms(lambda: [F.conv2d(x, w, stride=2)
                                        for x, w in xs], iters))
        row['tflops'] = ops / row['ms'] * 1e-9
        row['bound_share'] = t / row['ms']
        rows[f'o{o}'] = row
        print(f'kernel stem O={o} x{n}: max_abs_err {err:.6g} (largest '
              f'|kernel - plain| / tolerance {worst:.4f})  kernel '
              f'{row["ms"]:.4f} ms  plain {row["plain_ms"]:.4f} ms  library '
              f'{row["library_ms"]:.4f} ms  bound {t:.4f} ms ({by}); '
              f'{ops / 1e9:.2f} GFLOP = {row["tflops"]:.1f} TFLOP/s, '
              f'{100 * row["bound_share"]:.1f}% of the bound', flush=True)
        del outs, xs
    return rows


# the stage kernels' YOLOX widths beyond the flagship's: (stage, C) at
# deepen 0.33, nano (widen 0.25: stage 1 16, stage 2 32, stage 3 64) and
# tiny (0.375: 24, 48, 96); seeded random weights and inputs (phase 3)
STAGE_EXTRA_WIDTHS = (('stage1', 16), ('stage1', 24), ('stage2', 32),
                      ('stage2', 48), ('stage3', 64), ('stage3', 96))


def random_stage_kernel(dims, seed, device):
    """Seeded random stage weights of ``dims`` (C_in, C_out, mid, nb) packed
    for the kernels: bf16 values, BN scales in [0.5, 1.5)."""
    import torch
    from stereotracking_tpu_torch.ops import stage2_cuda
    cin, cout, mid, nb = dims
    g = torch.Generator().manual_seed(seed)

    def w(*shape):
        return (torch.randn(shape, generator=g) * 0.1).to(
            torch.bfloat16).float().to(device)

    def sb(*shape):
        return torch.stack([torch.rand(shape, generator=g) + 0.5,
                            torch.randn(shape, generator=g) * 0.1],
                           dim=-2).to(device)

    return stage2_cuda.pack_stage(stage2_cuda.StageWeights(
        entry_w=w(3, 3, cin, cout), entry_sb=sb(cout),
        ms_w=w(cout, 2 * mid), ms_sb=sb(2 * mid),
        c1_w=w(nb, mid, mid), c1_sb=sb(nb, mid),
        c2_w=w(nb, 3, 3, mid, mid), c2_sb=sb(nb, mid),
        fin_w=w(2 * mid, cout), fin_sb=sb(cout)))


def stage_close(name, k, p):
    """A stage kernel's output against its plain version: bf16 chains
    whose roundings may flip by one ulp and carry on, held to 2e-2 of the
    output's largest magnitude (the JAX package's own stage tolerance,
    tests/test_stage2_pallas.py).  Returns the largest error."""
    import torch
    require(k.shape == p.shape, f'{name} shape {k.shape} vs {p.shape}')
    err = float((k.float() - p.float()).abs().max())
    scale = float(p.float().abs().max())
    require(err <= 2e-2 * scale + 1e-3,
            f'{name}: max_abs_err {err} > 2e-2 * {scale} + 1e-3')
    require(bool(torch.isfinite(k.float()).all()), f'{name} not finite')
    return err, scale


def check_stage_widths(n, oh, ow, device, iters=10):
    """Phase 3 (widths): each stage kernel at YOLOX-nano's and -tiny's
    widths (``STAGE_EXTRA_WIDTHS``) against its plain version with the
    flagship rows' tolerance, on n streams of an (oh, ow) frame's stage
    input (stem output / 1, 2, 4: seeded bf16 activations); kernel and
    plain version timed, the bound from the bytes and operations, the
    launches of one call.  Returns {stage: {'c<C>': row}}."""
    import torch
    from stereotracking_tpu_torch import _kernels
    from stereotracking_tpu_torch.ops import (stage1_cuda, stage2_cuda,
                                              stage3_cuda)
    rows = {}
    for stage, c in STAGE_EXTRA_WIDTHS:
        nb = 1 if stage == 'stage1' else 3
        dims = (c, 2 * c, c, nb)
        scale_hw = {'stage1': 2, 'stage2': 4, 'stage3': 8}[stage]
        h, w = oh // scale_hw, ow // scale_hw
        g = torch.Generator().manual_seed(SEED + 7 * c)
        n_in = 2 if stage == 'stage1' else 1
        xs = [(torch.randn((n, h, w, c), generator=g) * 0.8).to(
            torch.bfloat16).to(device) for _ in range(n_in)]
        ks = [random_stage_kernel(dims, SEED + 100 * b + c, device)
              for b in range(n_in)]
        kernel = {'stage1': stage1_cuda.stage1_dual,
                  'stage2': stage2_cuda.stage_csp,
                  'stage3': stage3_cuda.stage3_csp}[stage]
        reference = (stage1_cuda.stage1_dual_plain if stage == 'stage1'
                     else stage2_cuda.stage_csp_plain)

        def fn():
            return kernel(*xs, *ks)

        def plain():
            return reference(*xs, *ks)
        _kernels.reset_launch_counts()
        k = fn()
        launches = _kernels.launch_counts()
        require({m: v for m, v in launches.items() if v} == {stage: 1},
                f'{stage} C={c}: one call launched {launches}')
        err, scale = stage_close(f'{stage} C={c}', k, plain())
        ops = n * n_in * stage_ops(ks[0], k.shape[1], k.shape[2])
        t, by = bound(nbytes(*xs, k) + sum(nbytes(kk.ws, kk.sb)
                                           for kk in ks), ops, PEAK_BF16)
        row = dict(max_abs_err=err, tolerance=2e-2 * scale + 1e-3,
                   ms=time_ms(fn, iters), plain_ms=time_ms(plain, iters),
                   bound_ms=t, bound_by=by, library_ms=None)
        row['tflops'] = ops / row['ms'] * 1e-9
        row['bound_share'] = t / row['ms']
        rows.setdefault(stage, {})[f'c{c}'] = row
        print(f'kernel {stage} C={c} x{n} ({h}x{w} in): max_abs_err '
              f'{err:.6g} (tolerance {row["tolerance"]:.4g})  kernel '
              f'{row["ms"]:.4f} ms  plain {row["plain_ms"]:.4f} ms  bound '
              f'{t:.4f} ms ({by}); {ops / 1e9:.2f} GFLOP = '
              f'{row["tflops"]:.1f} TFLOP/s, {100 * row["bound_share"]:.1f}%'
              f' of the bound', flush=True)
        del xs, k
    return rows


def check_kernels(model, frames, next_frames, device, iters=10):
    """Phase 3 at S = len(frames) streams: each kernel against its plain
    version, all timed, the depth, assignment and NMS kernels on the
    inputs the main path gives them at its second step (``frames``, then
    ``next_frames``; ``check_path_kernels``).  Returns {name: result row}
    and a function that adds the JV and NMS kernels' torch.profiler device
    times, to call after the timed phases."""
    import torch
    import torch.nn.functional as F
    from stereotracking_tpu_torch.models.preprocessor import padded_shape
    from stereotracking_tpu_torch.ops import (stage1_cuda, stage2_cuda,
                                              stage3_cuda, stem_cuda)
    n = len(frames)
    img, disp_u16 = to_card(frames, device)
    oh, ow = padded_shape(*img.shape[1:3])
    kw = model.module.backbone.kernel_weights()
    res = {}

    def record(name, err, fn, plain, library=None, bound_ms=None,
               ops=None):
        t, by = bound_ms
        res[name] = dict(max_abs_err=float(err), ms=time_ms(fn, iters),
                         plain_ms=time_ms(plain, iters), bound_ms=t,
                         bound_by=by, library_ms=(
                             None if library is None
                             else time_ms(library, iters)))
        r = res[name]
        lib = ('none' if r['library_ms'] is None
               else f'{r["library_ms"]:.4f} ms')
        print(f'kernel {name} x{n}: max_abs_err {err:.6g}  kernel '
              f'{r["ms"]:.4f} ms  plain {r["plain_ms"]:.4f} ms  library '
              f'{lib}  bound {t:.4f} ms ({by})', flush=True)
        if name in REDESIGNED:
            r['tflops'] = ops / r['ms'] * 1e-9
            r['bound_share'] = t / r['ms']
            print(f'kernel {name} x{n}: {ops / 1e9:.2f} GFLOP in '
                  f'{r["ms"]:.4f} ms = {r["tflops"]:.1f} TFLOP/s achieved, '
                  f'{100 * r["bound_share"]:.1f}% of the bound', flush=True)

    # stem: the float32 sums differ by reassociation, at most
    # 2 * K * 2^-24 * sum|x * w| (K = 36 C taps, both sides), times |scale|;
    # then one bf16 rounding, at most one ulp (2^-7 relative) apart (the
    # kernel's SiLU, within ~1e-6 of the plain one, moves it no further)
    stems, err, ops, worst = [], 0.0, 0, 0.0
    xs = []
    for frm, (wk, sb) in ((img, kw['stem']), (disp_u16, kw['disp_stem'])):
        k, e, wst, op, x = stem_check(frm, wk, sb, oh, ow, 'stem')
        err, worst, ops = max(err, e), max(worst, wst), ops + op
        xs.append(x)
        stems.append(k)
    print(f'stem x{n}: largest |kernel - plain| / tolerance {worst:.4f}',
          flush=True)
    record('stem', err,
           lambda: (stem_cuda.focus_stem(img, *kw['stem'], oh, ow),
                    stem_cuda.focus_stem(disp_u16, *kw['disp_stem'], oh,
                                         ow)),
           lambda: (stem_cuda.focus_stem_plain(img, *kw['stem'], oh, ow),
                    stem_cuda.focus_stem_plain(disp_u16, *kw['disp_stem'],
                                               oh, ow)),
           library=lambda: [F.conv2d(x, w, stride=2) for x, w in xs],
           # the weights hold bf16 values and the inputs (0-255, bf16 of
           # disp / 16) are exact in bf16: the tensor cores' bf16 rate
           bound_ms=bound(nbytes(img, disp_u16, *stems), ops, PEAK_BF16),
           ops=ops)
    del xs

    # stages: held to 2e-2 of the output's largest magnitude (stage_close)
    def stage_check(name, fn, plain, ins, ks):
        k = fn()
        err, _ = stage_close(name, k, plain())
        ops = n * sum(stage_ops(kk, k.shape[1], k.shape[2]) for kk in ks)
        weights = sum(nbytes(kk.w, kk.sb) for kk in ks)
        record(name, err, fn, plain, bound_ms=bound(
            nbytes(*ins, k) + weights, ops, PEAK_BF16), ops=ops)
        return k

    k1, kd1 = kw['stage1'], kw['disp_stage1']
    y1 = stage_check(
        'stage1', lambda: stage1_cuda.stage1_dual(*stems, k1, kd1),
        lambda: stage1_cuda.stage1_dual_plain(*stems, k1, kd1), stems,
        [k1, kd1])
    k2 = kw['stage2']
    y2 = stage_check('stage2', lambda: stage2_cuda.stage_csp(y1, k2),
                     lambda: stage2_cuda.stage_csp_plain(y1, k2),
                     [y1], [k2])
    weight_reads(n, 'stage1', *l2_stage1(k1, kd1, y1.shape[1:3]))
    weight_reads(n, 'stage2', *l2_stage2(k2, y2.shape[1:3]))
    y3 = stage_check(
        'stage3', lambda: stage3_cuda.stage3_csp(y2, kw['stage3']),
        lambda: stage3_cuda.stage3_csp_plain(y2, kw['stage3']), [y2],
        [kw['stage3']])
    weight_reads(n, 'stage3', *l2_stage3(kw['stage3'], y3.shape[1:3]))
    y2f = y2.float().permute(0, 3, 1, 2).contiguous()
    with torch.no_grad():
        mod_ms = time_ms(lambda: model.module.backbone.stage3(y2f), iters)
    res['stage3']['module_f32_ms'] = mod_ms
    print(f'stage 3 x{n}: kernel {res["stage3"]["ms"]:.4f} ms, float32 '
          f'modules (model.backbone.stage3, TF32 off) {mod_ms:.4f} ms',
          flush=True)

    path, trace = check_path_kernels(model, frames, next_frames, device,
                                     iters)
    res.update(path)
    return res, trace


def check_path_kernels(model, frames, next_frames, device, iters=10):
    """The depth, JV and NMS kernels against their plain versions, timed,
    on the inputs that ``model``'s own path hands them at its second step
    (``frames``, then ``next_frames``: ``nms_jv_inputs``), with phase 3's
    tolerances.  Returns their rows and a function that adds the JV and
    NMS kernels' torch.profiler device times."""
    ins = nms_jv_inputs(model, frames, next_frames, device)
    res = dict(depth=check_depth_main(ins['depth'], iters))
    res['assignment'], jv_trace = check_assignment(ins['jv'],
                                                   ins['conflicted'], iters)
    res['nms'], nms_trace = check_nms(ins['nms'], ins['suppressing'], iters)

    def trace():
        jv_trace()
        nms_trace()

    return res, trace


def json_rows(res):
    """A config's kernel rows as the JSON line nests them under its
    kernels' own rows: the contract's measured keys."""
    return {k: {f: v[f] for f in ('max_abs_err', 'ms', 'plain_ms',
                                  'bound_ms', 'bound_by')}
            for k, v in res.items()}


def depth_inputs(img, disp_u16, oh, ow, device):
    """The depth phase's (S, H, W) disparity maps (the frames' preprocessed
    disparity with an all-equal window) and depth_boxes on each stream."""
    import torch
    from stereotracking_tpu_torch.models.preprocessor import \
        preprocess_frame_pure
    disp = preprocess_frame_pure(img, disp_u16, oh, ow)['disp_postp'][
        ..., 0].contiguous()
    disp[:, 900:950, 1500:1560] = 30.0               # an all-equal window
    boxes = depth_boxes(device)[None].repeat(img.shape[0], 1, 1)
    return disp, boxes, torch.isfinite(boxes).all(2)


def window_depths(stats, boxes, valid, h, w, bf):
    """(S * N, 3): the depth that each of the corner vote's three rank
    windows gives from the stats rows of the (S, N, 4) boxes, so that a
    check can tell which window a depth came from."""
    import torch
    from stereotracking_tpu_torch.ops import depth_cuda as dc
    n = stats[:, 0].to(torch.int32)
    r_vals = dc.f_depth(stats[:, 1:9].to(torch.int32), bf)
    skip = dc.skip_mask(boxes.reshape(-1, 4), valid.reshape(-1), h, w)
    cols = []
    for votes in (0, 3, 4):                 # the corners of each branch
        corners = torch.full((n.shape[0], 4), -math.inf, device=stats.device)
        corners[:, :votes] = math.inf
        cols.append(dc.finish(n, r_vals, stats[:, 9:16].to(torch.int32),
                              stats[:, 16:23], corners, skip)[0])
    return torch.stack(cols, 1)


def depth_agree(disp, boxes, valid, crop, bf):
    """The depth kernel and its plain composite on the same inputs, held
    together: integer statistics exact; float sums within rtol 1e-5
    (float32 reassociation over up to 9,216 terms); depths and scales within
    rtol 2e-6, atol 1e-5, as tests/test_depth_pallas.py holds the Pallas
    kernel.  Returns both sides' (depth, scale, stats)."""
    import torch
    from stereotracking_tpu_torch.ops import depth_cuda as dc
    kd, ksc, ks = dc.box_depths(disp, boxes, valid, crop, bf)
    pd, psc, ps = dc.box_depths_plain(disp, boxes, valid, crop, bf)
    torch.cuda.synchronize()
    require(torch.equal(ks[:, :16], ps[:, :16]),
            'depth: integer statistics differ')
    require(torch.allclose(ks[:, 16:], ps[:, 16:], rtol=1e-5, atol=1e-3),
            'depth: sums beyond rtol 1e-5')
    require(torch.equal(kd == -1, pd == -1), 'depth: invalid pattern')
    require(torch.allclose(kd, pd, rtol=2e-6, atol=1e-5)
            and torch.allclose(ksc, psc, rtol=2e-6, atol=1e-5),
            'depth: depths beyond rtol 2e-6')
    return kd, ksc, ks, pd, psc, ps


def depth_bound(disp, boxes, stats, crop, depth, scale):
    """The depth kernel's (bound ms, 'bytes' or 'operations', bytes, ops)
    on these inputs: each window pixel read once, the 16 corner pixels,
    boxes and flags in, depth, scale and stats rows out; per window pixel
    one exact pass of 7 rank compares and 12 count/sum adds on the CUDA
    cores (their float32 rate)."""
    from stereotracking_tpu_torch.ops import depth_cuda as dc
    # the windows do not depend on rmin
    scal = dc.box_scalars(boxes, crop, 0, *disp.shape[1:])
    _, inside = dc.box_windows(disp, scal, crop)
    px = int(inside.sum())
    moved = 4 * px + scal.shape[0] * (16 * 4 + 16 + 1) + nbytes(
        depth, scale, stats)
    ops = 19 * px
    return (*bound(moved, ops, PEAK_F32), moved, ops)


def check_depth_main(depth_inputs, iters):
    """The depth kernel against its plain composite on the main path's own
    inputs of one step (its 2 extractions: the detections, the un-inflated
    tracks), as ``depth_agree`` holds them; the first extraction timed."""
    from stereotracking_tpu_torch.ops import depth_cuda as dc
    err = 0.0
    for disp, boxes, valid, crop, bf in depth_inputs:
        kd, ksc, ks, pd, _, _ = depth_agree(disp, boxes, valid, crop, bf)
        err = max(err, float((kd - pd).abs().max()))
    disp, boxes, valid, crop, bf = depth_inputs[0]
    n_ok = int((kd > 0).sum())
    r = dict(max_abs_err=err,
             ms=time_ms(lambda: dc.box_depths(disp, boxes, valid, crop, bf),
                        10 * iters),
             plain_ms=time_ms(lambda: dc.box_depths_plain(
                 disp, boxes, valid, crop, bf), iters),
             library_ms=None)
    kd, ksc, ks = dc.box_depths(disp, boxes, valid, crop, bf)
    r['bound_ms'], r['bound_by'], moved, ops = depth_bound(
        disp, boxes, ks, crop, kd, ksc)
    print(f'kernel depth x{disp.shape[0]} (main path, {disp.shape[1]}x'
          f'{disp.shape[2]} maps, {len(depth_inputs)} extractions, '
          f'{tuple(boxes.shape[:2])} boxes): max_abs_err {err:.6g}, integer '
          f'statistics exact, {n_ok} boxes of the last with a depth; kernel '
          f'{r["ms"]:.4f} ms  plain {r["plain_ms"]:.4f} ms  library none  '
          f'bound {r["bound_ms"]:.5f} ms ({r["bound_by"]}: '
          f'{moved / 1e6:.3f} MB, {ops / 1e9:.4f} G ops)', flush=True)
    return r


def check_depth(cfg, img, disp_u16, oh, ow, device, iters):
    """The depth kernel against its plain composite (box scalars, stats,
    corner vote) on boxes at every pyramid level, with n = 0, 1 and 2, an
    all-equal window, boxes leaving the frame or wider than 800 px and NaN
    boxes flagged invalid; timed by CUDA events as every kernel is, with
    the host wall of one whole extraction beside the eager box scalars +
    epilogue it runs inside.  Returns the kernel's row and a function that
    adds to it the torch.profiler figures: the kernel's device time and the
    kernel launches of one extraction and of the eager parts."""
    import torch
    from stereotracking_tpu_torch.ops import depth_cuda as dc
    from stereotracking_tpu_torch.ops.depth import extract_box_depths_disp
    n = img.shape[0]
    crop = cfg.depth_crop
    disp, boxes, valid = depth_inputs(img, disp_u16, oh, ow, device)
    bf = float(cfg.baseline) * float(cfg.focal_length)
    scal = dc.box_scalars(boxes, crop, dc.depth_rmin(bf), oh, ow)
    levels = set(scal[:, 0].tolist())
    require(levels == {0, 1, 2, 3}, f'depth boxes hit levels {levels}')
    kd, ksc, ks, pd, psc, ps = depth_agree(disp, boxes, valid, crop, bf)
    # the kernel's vote branch: its depth is the candidate of the plain
    # version's branch, wherever the three candidates tell them apart
    flat = boxes.reshape(-1, 4)
    cand = window_depths(ps, boxes, valid, oh, ow, bf)
    pbranch = dc.vote_branch(dc.disp_corners(disp, boxes, crop, bf),
                             dc.f_depth(ps[:, 1].to(torch.int32), bf))
    kbranch = (cand - kd.reshape(-1, 1)).abs().argmin(1)
    gap = (cand - cand.gather(1, pbranch[:, None])).abs()
    gap.scatter_(1, pbranch[:, None], math.inf)
    told = (kd.reshape(-1) > 0) & (gap.min(1).values > 1e-4)
    require(torch.equal(kbranch[told], pbranch[told]),
            'depth: vote branches differ')
    nvals = ks[:, 0].to(torch.int32)
    for want in (0, 1, 2):
        require(bool((nvals == want).any()), f'depth: no box with n={want}')
    n_ok = int((kd > 0).sum())
    require(n_ok > 0, 'depth: no box got a depth')

    nb = flat.shape[0]

    def kernel():
        dc.box_depths(disp, boxes, valid, crop, bf)

    def extraction():
        extract_box_depths_disp(disp, boxes, valid, cfg.baseline,
                                cfg.focal_length, crop)

    # the box scalars + epilogue of the plain composite, as eager torch ops
    # on the card around the kernel's own stats rows: what the kernel now
    # runs inside (tools/time_depth.py times a parent checkout's own path)
    def eager():
        dc.box_scalars(boxes, crop, dc.depth_rmin(bf), oh, ow)
        dc.depth_epilogue(disp, boxes, valid, ks, crop, bf)

    r = dict(max_abs_err=float((kd - pd).abs().max()),
             ms=time_ms(kernel, 10 * iters),
             plain_ms=time_ms(lambda: dc.box_depths_plain(
                 disp, boxes, valid, crop, bf), iters),
             library_ms=None)
    r['bound_ms'], r['bound_by'], moved, ops = depth_bound(
        disp, boxes, ks, crop, kd, ksc)
    r['bound_share'] = r['bound_ms'] / r['ms']
    r['tops'] = ops / r['ms'] * 1e-9
    # one whole extraction as the step runs it, and the eager parts,
    # synchronised
    for name, fn in (('extraction', extraction), ('eager', eager)):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
            torch.cuda.synchronize()
        r[f'{name}_host_ms'] = (time.perf_counter() - t0) * 1e3 / iters
    print(f'kernel depth x{n}: max_abs_err {r["max_abs_err"]:.6g}  kernel '
          f'{r["ms"]:.4f} ms  plain {r["plain_ms"]:.4f} ms  library none  '
          f'bound {r["bound_ms"]:.4f} ms ({r["bound_by"]}: '
          f'{moved / 1e6:.2f} MB, {ops / 1e9:.3f} G ops), '
          f'{100 * r["bound_share"]:.1f}% of the bound', flush=True)
    print(f'depth x{n}: {nb} boxes, {n_ok} with a depth, {int(told.sum())} '
          f'vote branches told apart, integer statistics exact; one '
          f'extraction (extract_box_depths_disp, synchronised) '
          f'{r["extraction_host_ms"]:.4f} ms host wall; the eager box '
          f'scalars + epilogue alone {r["eager_host_ms"]:.4f} ms', flush=True)

    def trace():
        """The kernel's device time in torch.profiler and the kernel
        launches of one extraction and of the eager parts."""
        r['device_ms'] = device_ms(kernel, 'box_depths_kernel', 10 * iters)
        r['extraction_launches'] = len(device_kernels(extraction, 1))
        r['eager_launches'] = len(device_kernels(eager, 1))
        print(f'depth x{n}: kernel {r["device_ms"]:.4f} ms device time '
              f'(torch.profiler; {r["ms"]:.4f} ms per call by CUDA events), '
              f'{100 * r["bound_ms"] / r["device_ms"]:.1f}% of the bound; '
              f'{r["extraction_launches"]} kernel launch per extraction, '
              f'{r["eager_launches"]} for the eager box scalars + epilogue',
              flush=True)
        require(r['extraction_launches'] == 1,
                f'depth: {r["extraction_launches"]} kernel launches per '
                f'extraction, expected 1')

    return r, trace


def step_inputs(model, frames, device):
    """The inputs that the main path hands the assignment, NMS and depth
    kernels: two eager steps of ``predict_frames_batched`` over ``frames``
    (a list of steps, each a list of S (img, disp)), the model's config
    (every stage kernel on where the backbone has them: the dual), with
    the wrappers' arguments of the second step recorded: [(ext, need)] for the 3 assignments, (boxes, finite,
    thr, max_keep) for the NMS and [(disp, boxes, valid, crop, bf)] for the
    2 depth extractions."""
    import torch
    from stereotracking_tpu_torch.models.csp_darknet import StageBackends
    from stereotracking_tpu_torch.models.mot import (predict_frames_batched,
                                                     preprocess_raw)
    from stereotracking_tpu_torch.models.preprocessor import padded_shape
    from stereotracking_tpu_torch.ops import assignment, depth, nms
    from stereotracking_tpu_torch.parallel.multistream import \
        init_stream_states
    mot = model.cfg
    if mot.detector.backbone == 'dual':
        mot = mot._replace(backends=StageBackends(*ALL_KERNELS))
    n = len(frames[0])
    states = init_stream_states(mot, n, device)
    seen = dict(jv=[], nms=[], depth=[])
    jv, keep, box_depths = assignment.jv_assign, nms.nms_keep, \
        depth.box_depths

    def jv_rec(ext, need):
        seen['jv'].append((ext.clone(), need.clone()))
        return jv(ext, need)

    def nms_rec(boxes, finite, thr, max_keep=None):
        seen['nms'].append((boxes.clone(), finite.clone(), thr, max_keep))
        return keep(boxes, finite, thr, max_keep)

    def depth_rec(disp, boxes, valid, crop, bf):
        seen['depth'].append((disp.clone(), boxes.clone(), valid.clone(),
                              crop, bf))
        return box_depths(disp, boxes, valid, crop, bf)

    assignment.jv_assign, nms.nms_keep, depth.box_depths = \
        jv_rec, nms_rec, depth_rec
    try:
        for t, step in enumerate(frames):
            for calls in seen.values():
                calls.clear()
            img, disp = to_card(step, device)
            inputs = preprocess_raw(img, disp, *padded_shape(*img.shape[1:3]))
            states, _ = predict_frames_batched(model.module, states, inputs,
                                               [t] * n, mot)
    finally:
        assignment.jv_assign, nms.nms_keep, depth.box_depths = \
            jv, keep, box_depths
    torch.cuda.synchronize()
    return seen['jv'], seen['nms'][0], seen['depth']


def conflicted_jv_input(n, k, c, device):
    """(ext, need) of an all-conflicted random problem at the main path's
    (n, k, c): every pair a candidate, every row through the JV."""
    import numpy as np
    import torch
    from stereotracking_tpu_torch.ops.assignment import jv_problem
    rng = np.random.RandomState(SEED)
    cost = torch.from_numpy(rng.uniform(0, 0.5, (n, k, c - k)).astype(
        np.float32)).to(device)
    ones = torch.ones((n, k), dtype=torch.bool, device=device)
    ext, need, _, _ = jv_problem(cost, ones, ones[:, :c - k], 0.9)
    return ext, need


def nms_jv_inputs(model, frames, next_frames, device):
    """The JV and NMS kernels' inputs of phase 3 (and of
    ``tools/time_nms_jv.py``): the main path's at its second step
    (``step_inputs``; its depth inputs too), the all-conflicted JV problem
    and the suppressing NMS candidates at the same shapes."""
    jv_in, nms_in, depth_in = step_inputs(model, [frames, next_frames],
                                          device)
    n, k, c = jv_in[0][0].shape
    boxes, finite, thr, max_keep = nms_in
    return dict(jv=jv_in, conflicted=conflicted_jv_input(n, k, c, device),
                nms=nms_in, suppressing=suppressing_nms_input(
                    *finite.shape, thr, model.cfg.detector.score_thr,
                    max_keep, device), depth=depth_in)


def check_assignment(jv_inputs, conflicted, iters):
    """The JV kernel against its numpy plain version, exactly, on the main
    path's 3 problems of one step and on ``conflicted`` (every active row
    through the JV); the main path's problem with the most rows to assign
    and ``conflicted`` timed.  Its bound is latency's business: the bytes
    (each cost once) and one relaxation of C columns per assigned row are
    microseconds' work, the kernel a chain of dependent Dijkstra steps.
    Returns the row and a function that adds the kernel's
    ``torch.profiler`` device times (``device_ms``, ``worst_device_ms``),
    to call after the timed phases."""
    import torch
    from stereotracking_tpu_torch.ops import assignment_cuda as ac
    n, k, c = jv_inputs[0][0].shape
    ext, need = conflicted
    cases = list(jv_inputs) + [(ext, need)]
    for i, (e, nd) in enumerate(cases):
        got = ac.jv_assign(e, nd)
        want = ac.jv_assign_plain(e.cpu(), nd.cpu())
        require(torch.equal(got.cpu(), want),
                f'assignment: problem {i} differs from the plain version')
    rows = [int(nd.sum()) for _, nd in cases]
    e, nd = max(jv_inputs, key=lambda p: int(p[1].sum()))
    need_rows = int(nd.sum())
    r = dict(max_abs_err=0.0,
             ms=time_ms(lambda: ac.jv_assign(e, nd), 10 * iters),
             plain_ms=time_ms(lambda: ac.jv_assign_plain(e.cpu(), nd.cpu()),
                              iters),
             library_ms=None, rows=need_rows)
    r['bound_ms'], r['bound_by'] = bound(
        nbytes(e, nd) + n * k * 4, need_rows * c * 4, PEAK_F32)
    r['worst_ms'] = time_ms(lambda: ac.jv_assign(ext, need), iters)
    cpl, staged = ac.jv_instance(k, c)
    print(f'kernel assignment x{n}: rows to assign per call '
          f'{rows[:-1]} (main path), {rows[-1]} (all conflicted); row2col '
          f'exact on all 4; instance {cpl} columns per lane, cost '
          f'{"staged in shared memory" if staged else "read from global"}; '
          f'kernel {r["ms"]:.4f} ms ({need_rows} rows), all conflicted '
          f'{r["worst_ms"]:.4f} ms, plain (numpy, with the copies to the '
          f'host) {r["plain_ms"]:.4f} ms, library none, bound '
          f'{r["bound_ms"]:.5f} ms ({r["bound_by"]}; latency bounds the '
          f'kernel: a chain of dependent Dijkstra steps)', flush=True)

    def trace():
        r['device_ms'] = device_ms(lambda: ac.jv_assign(e, nd), 'jv_kernel',
                                   10 * iters)
        r['worst_device_ms'] = device_ms(lambda: ac.jv_assign(ext, need),
                                         'jv_kernel', 10 * iters)
        print(f'assignment x{n}: kernel {r["device_ms"]:.4f} ms device time '
              f'({need_rows} rows), all conflicted '
              f'{r["worst_device_ms"]:.4f} ms (torch.profiler; by CUDA '
              f'events {r["ms"]:.4f} / {r["worst_ms"]:.4f} ms)', flush=True)

    return r, trace


def suppressing_nms_input(n, k, thr, score_thr, max_out, device):
    """(boxes, finite, thr, max_keep) as the main path's ``batched_nms``
    hands them to ``nms_keep`` (score-sorted top k, class-shifted; max_keep
    its ``max_out``), for ``tests/device_step_cases.nms_case``'s n
    streams of k + k / 4 candidates: two labels, chains of 8 boxes each a
    few px from the one before (so many pairs overlap past the threshold),
    tied scores and 5 NaN boxes with finite scores."""
    import torch
    from stereotracking_tpu_torch.ops import nms
    sys.path.insert(0, os.path.join(REPO, 'tests'))
    try:
        from device_step_cases import nms_case
    finally:
        sys.path.pop(0)
    boxes, scores, labels = (torch.from_numpy(x).to(device) for x in
                             nms_case(seed=SEED, streams=n, n=k + k // 4))
    seen, keep = [], nms.nms_keep

    def record(b, f, t, max_keep=None):
        seen.append((b.clone(), f.clone(), t, max_keep))
        return keep(b, f, t, max_keep)

    nms.nms_keep = record
    try:
        nms.batched_nms(boxes, scores, labels, thr, score_thr, k, max_out)
    finally:
        nms.nms_keep = keep
    return seen[0]


def nms_work(keep, finite, max_keep):
    """IoUs that these inputs need for the capped keep set: per stream the
    pairs of finite candidates up to the max_keep-th kept one (all k
    without a cap or with fewer kept)."""
    import torch
    k = keep.shape[1]
    pos = torch.arange(1, k + 1, device=keep.device)
    if max_keep is None:
        upto = torch.full((keep.shape[0],), k, device=keep.device)
    else:
        reached = torch.cumsum(keep.long(), 1) >= max_keep
        upto = torch.where(reached.any(1),
                           torch.where(reached, pos, k + 1).amin(1), k)
    fin = (finite & (pos[None] <= upto[:, None])).sum(1).double()
    return float((fin * (fin - 1) / 2).sum())


def check_nms(nms_inputs, sup, iters):
    """The NMS kernel's keep set against the plain fixed point, exactly, on
    the main path's class-shifted, score-sorted candidates and on
    candidates at the same shape that suppress (``sup``: every stream must
    keep some and drop some of its finite candidates), each with the main
    path's cap (max_keep, batched_nms's max_out) and without one, all
    timed; bound of the main path's call: boxes and flags read once, the
    keep set written once, and 12 float32 operations per IoU of a pair of
    finite candidates up to the cap (``nms_work``; ``full_bound_ms``: all
    pairs) on the CUDA cores.  Returns the row and a function that adds
    the kernel's ``torch.profiler`` device times, to call after the timed
    phases."""
    import torch
    from stereotracking_tpu_torch.ops import nms_cuda
    boxes, finite, thr, max_keep = nms_inputs
    n, k = finite.shape
    require(max_keep is not None and sup[3] == max_keep,
            f'nms: the main path passes max_keep {max_keep}, the '
            f'suppressing input {sup[3]}')
    require(sup[1].shape == (n, k), f'nms: suppressing input of shape '
            f'{tuple(sup[1].shape)}, expected {(n, k)}')
    r = dict(max_abs_err=0.0, library_ms=None, max_keep=max_keep)
    kept, out, calls = {}, {}, {}
    for what, (b, f, t, _) in (('main path', nms_inputs),
                               ('suppressing', sup)):
        for cap in (max_keep, None):
            key = (what, cap)
            out[key] = nms_cuda.nms_keep(b, f, t, cap)
            want = nms_cuda.nms_keep_plain(b, f, t, cap)
            require(torch.equal(out[key], want), f'nms ({what}, max_keep '
                    f'{cap}): keep set differs from the plain fixed point')
            kept[key] = out[key].sum(1).tolist()
            calls[key] = (lambda b=b, f=f, t=t, cap=cap:
                          nms_cuda.nms_keep(b, f, t, cap))
            pre = ('' if what == 'main path' else 'suppress_') + (
                '' if cap is not None else 'full_')
            r[pre + 'ms'] = time_ms(calls[key], iters)
            r[pre + 'plain_ms'] = time_ms(
                lambda b=b, f=f, t=t, cap=cap:
                nms_cuda.nms_keep_plain(b, f, t, cap), iters)
    n_kept, n_fin = out[('suppressing', None)].sum(1), sup[1].sum(1)
    require(bool(((0 < n_kept) & (n_kept < n_fin)).all()),
            f'nms (suppressing): kept {n_kept.tolist()} of '
            f'{n_fin.tolist()} finite candidates per stream; every stream '
            f'must keep some and drop some')
    full = out[('main path', None)]
    pairs = nms_work(full, finite, max_keep)
    all_pairs = nms_work(full, finite, None)
    moved = nbytes(boxes, finite, full)
    r['bound_ms'], r['bound_by'] = bound(moved, 12 * pairs, PEAK_F32)
    r['full_bound_ms'], _ = bound(moved, 12 * all_pairs, PEAK_F32)
    print(f'kernel nms x{n}: {k} candidates per stream, IoU > {thr}, '
          f'max_keep {max_keep} (the main path\'s) or none; main path: kept '
          f'{kept[("main path", max_keep)]} / {kept[("main path", None)]} of '
          f'{finite.sum(1).tolist()}, kernel {r["ms"]:.4f} / '
          f'{r["full_ms"]:.4f} ms, plain {r["plain_ms"]:.4f} / '
          f'{r["full_plain_ms"]:.4f} ms; suppressing: kept '
          f'{kept[("suppressing", max_keep)]} / '
          f'{kept[("suppressing", None)]}, kernel {r["suppress_ms"]:.4f} / '
          f'{r["suppress_full_ms"]:.4f} ms, plain '
          f'{r["suppress_plain_ms"]:.4f} / {r["suppress_full_plain_ms"]:.4f}'
          f' ms; keep sets exact on all 4; library none (no PyTorch call '
          f'computes greedy NMS); bound of the main path\'s call '
          f'{r["bound_ms"]:.5f} ms ({r["bound_by"]}: {pairs / 1e6:.3f} M '
          f'IoUs up to the cap), without the cap {r["full_bound_ms"]:.5f} '
          f'ms ({all_pairs / 1e6:.2f} M IoUs)', flush=True)

    def trace():
        for key, name in ((('main path', max_keep), 'device_ms'),
                          (('main path', None), 'full_device_ms'),
                          (('suppressing', max_keep), 'suppress_device_ms'),
                          (('suppressing', None),
                           'suppress_full_device_ms')):
            r[name] = device_ms(calls[key], 'nms_kernel', 10 * iters)
        print(f'nms x{n}: kernel device time (torch.profiler), max_keep '
              f'{max_keep} / none: main path {r["device_ms"]:.4f} / '
              f'{r["full_device_ms"]:.4f} ms, suppressing '
              f'{r["suppress_device_ms"]:.4f} / '
              f'{r["suppress_full_device_ms"]:.4f} ms; '
              f'{100 * r["bound_ms"] / r["device_ms"]:.2f}% of the main '
              f'path call\'s bound', flush=True)

    return r, trace


def replay_cost(tcfg, device, n_streams, iters=20):
    """Device time of the tracker's fixed-trip smoothing replay alone
    (``replay_bound`` Kalman updates over (S, 64) slots, as the step runs
    it), captured in a CUDA graph and timed by CUDA events."""
    import torch
    from stereotracking_tpu_torch.models import kalman
    from stereotracking_tpu_torch.models import tracker as trk
    from stereotracking_tpu_torch.structures.bbox import bbox_xyxy_to_cxcyah
    g = torch.Generator().manual_seed(SEED)
    k = tcfg.num_slots
    box = torch.rand((n_streams, k, 4), generator=g) * 100
    box[..., 2:] += box[..., :2] + 10
    box = box.to(device)
    mean, cov = kalman.initiate(bbox_xyxy_to_cxcyah(box))
    shift = torch.ones_like(box)
    unmatch = torch.randint(0, tcfg.num_frames_retain, (n_streams, k),
                            generator=g).to(device)
    recovered = unmatch > 20

    def replay():
        m, c = mean, cov
        for i in range(trk.replay_bound(tcfg)):
            virtual = box + float(i + 1) * shift
            m2, c2 = kalman.update(m, c, bbox_xyxy_to_cxcyah(virtual))
            apply = recovered & (i < unmatch)
            m = torch.where(apply[..., None], m2, m)
            c = torch.where(apply[..., None, None], c2, c)
        return m, c

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        replay()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        replay()
    ms = time_ms(graph.replay, iters)
    print(f'tracker x{n_streams}: the smoothing replay\'s '
          f'{trk.replay_bound(tcfg)} Kalman updates over ({n_streams}, {k}) '
          f'slots, one CUDA graph: {ms:.4f} ms device time', flush=True)
    return ms


def check_small_reference(model, device):
    """The kernel path's head outputs, stage 3 through its kernel too,
    against the float32 module path on a small frame.  The kernels round to
    bf16 after every ConvBNAct of the stems and stages 1-3 (about 0.4%
    each, a dozen times) and the float32 layers after them carry that on;
    tolerance 1e-1 of each output's largest magnitude."""
    import torch
    from stereotracking_tpu_torch.models.csp_darknet import StageBackends
    from stereotracking_tpu_torch.models.mot import preprocess_raw
    from stereotracking_tpu_torch.models.preprocessor import padded_shape
    img, du = to_card(make_frames(1, 256, 320, SEED + 1), device)
    inputs = preprocess_raw(img, du, *padded_shape(256, 320))
    with torch.no_grad():
        ker = model.module(inputs, StageBackends(*ALL_KERNELS))
        ref = model.module(inputs, StageBackends())
    worst = 0.0
    for k, r in zip(sum(ker, []), sum(ref, [])):
        scale = float(r.abs().max())
        err = float((k - r).abs().max())
        require(err <= 1e-1 * scale + 1e-3,
                f'head output off the float32 path: {err} vs scale {scale}')
        worst = max(worst, err / max(scale, 1e-6))
    print(f'reference: kernel-path head outputs (stage 3 kernel on) within '
          f'{worst:.4g} of the float32 path (relative to max |output|; '
          f'limit 1e-1)', flush=True)


def count_syncs(fn):
    """Host syncs of one call of ``fn``, as torch's sync debug mode reports
    them (it does not see every synchronizing call)."""
    import torch
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode('warn')
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter('always')
            fn()
            torch.cuda.synchronize()
    finally:
        torch.cuda.set_sync_debug_mode('default')
    return sum('synchroniz' in str(w.message).lower() for w in caught)


def check_result(r, lead, num_dets, what):
    import torch
    for name, t in r._asdict().items():
        require(bool(torch.isfinite(t.float()).all()),
                f'{what}: {name} not finite')
    require(r.det_bboxes.shape == lead + (300, 4), f'{what}: det slots')
    require(r.track_ids.shape == lead + (num_dets,), f'{what}: track slots')


# launches per step of every hand-written kernel of the main path
PER_STEP = {'stem': 2, 'stage1': 1, 'stage2': 1, 'stage3': 1, 'depth': 2,
            'assignment': 3, 'nms': 1}


# the kernel that each wrapper launches, as a torch.profiler trace names it
# (stage 3's wrapper launches an entry and a chain kernel, one count)
TRACE_KERNELS = {'stem': ('focus_stem_kernel',),
                 'stage1': ('stage1_mma_kernel',),
                 'stage2': ('stage_csp_kernel',),
                 'stage3': ('stage3_chain_kernel', 'stage3_fused_kernel'),
                 'depth': ('box_depths_kernel',), 'assignment': ('jv_kernel',),
                 'nms': ('nms_kernel',)}


def require_launches(counts, want, steps, what):
    for name, per in want.items():
        require(counts[name] == per * steps,
                f'{what} {name}: {counts[name]} launches over {steps} steps, '
                f'expected {per} per step')


def require_replayed(what):
    """No wrapper launched a kernel since the counts were set to 0: every
    step replayed its graph, none ran eagerly."""
    from stereotracking_tpu_torch import _kernels
    counts = _kernels.launch_counts()
    require(not any(counts.values()), f'{what}: wrappers launched {counts} '
            f'during replayed steps')


def trace_job(tracker, frames, ids, want, results, what):
    """The arguments of a ``trace_launches`` run after the timed phases."""
    return dict(tracker=tracker, frames=frames, ids=ids, want=want,
                results=results, what=what)


def trace_launches(tracker, frames, ids, want, results, what, tries=3):
    """The main path's launches: ``tracker`` reset and its steps replayed
    over ``frames`` with frame ids ``ids`` under ``torch.profiler``, the
    wrappers' counts set to 0 just before and read just after.  The
    hand-written kernels in the trace must be ``want`` per step (stage 3's
    entry kernel as often as its chain kernel); the wrappers' counts must
    stay 0 (each step a replay); ids and validity must equal ``results``,
    the timed run's.  A trace whose kernel counts fall short is taken
    again, up to ``tries`` times: torch.profiler on the card drops device
    events now and then, more so after the training phase.  Returns the
    launches in the trace."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from stereotracking_tpu_torch import _kernels
    for attempt in range(1, tries + 1):
        tracker.reset()
        torch.cuda.synchronize()
        _kernels.reset_launch_counts()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            got = [tracker.track_raw(*f, i) for f, i in zip(frames, ids)]
            torch.cuda.synchronize()
        require_replayed(f'{what} (traced)')
        keys = [(e.key, e.count) for e in prof.key_averages()]
        seen = {name: sum(c for k, c in keys if any(y in k for y in syms))
                for name, syms in TRACE_KERNELS.items()}
        entry = sum(c for k, c in keys if 'stage3_entry_kernel' in k)
        chain = sum(c for k, c in keys if 'stage3_chain_kernel' in k)
        short = [n for n, per in want.items() if seen[n] < per * len(frames)]
        if not short or attempt == tries:
            break
        print(f'launches {what}: trace {attempt} holds {seen}, short of '
              f'{short}: taken again', flush=True)
    require(entry == chain, f'{what}: {entry} stage-3 entry kernels beside '
            f'{chain} chain kernels in the trace')
    require_launches(seen, want, len(frames), f'{what} (trace)')
    for t, (a, b) in enumerate(zip(got, results)):
        for name in ('track_ids', 'track_valid', 'det_valid'):
            require(torch.equal(getattr(a, name), getattr(b, name)),
                    f'{what} (traced) step {t}: {name} differs from the '
                    f'timed run')
    print(f'launches {what}: {len(frames)} replayed steps in a '
          f'torch.profiler trace: {seen} (wrappers: 0; ids equal to the '
          f'timed run; trace {attempt} of up to {tries})', flush=True)
    return seen


def prime(tracker, img, disp, n_streams):
    """Capture the tracker's step graph on its first call (warm-up step,
    capture, one replay), then reset its states; returns the ms it took."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tracker.track_raw(img, disp, [0] * n_streams if n_streams else 0)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    tracker.reset()
    return ms


def eager_steps(module, cfg, steps, device):
    """The same steps eagerly (``predict_frames_batched`` from fresh
    states, and a fresh camera-motion state where ``cfg.cmc`` asks for one,
    frame ids t), each synchronised: (results, ms per step)."""
    import torch
    from stereotracking_tpu_torch.models.mot import (predict_frames_batched,
                                                     preprocess_raw)
    from stereotracking_tpu_torch.models.preprocessor import padded_shape
    from stereotracking_tpu_torch.models.mot import init_cmc_state
    from stereotracking_tpu_torch.models.tracker import init_state
    n = steps[0][0].shape[0]
    states = init_state(cfg.tracker, device, n)
    cmc = None if cfg.cmc is None else init_cmc_state(cfg.cmc, device, n)
    results, per_step = [], []
    for t, (img, disp) in enumerate(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        inputs = preprocess_raw(img, disp, *padded_shape(*img.shape[1:3]))
        states, r = predict_frames_batched(module, states, inputs,
                                           [t] * n, cfg, cmc=cmc,
                                           cmc_frame=img)
        torch.cuda.synchronize()
        per_step.append((time.perf_counter() - t0) * 1e3)
        results.append(r)
    return results, per_step


def same_results(got, want, what):
    """Replayed against eager: ids and validity exact, tracked boxes within
    1e-2 px; returns the largest box difference."""
    import torch
    worst = 0.0
    for t, (a, b) in enumerate(zip(got, want)):
        for name in ('track_ids', 'track_valid', 'det_valid'):
            require(torch.equal(getattr(a, name), getattr(b, name)),
                    f'{what} step {t}: {name} differs from the eager step')
        err = float((a.track_bboxes - b.track_bboxes).abs().max())
        require(err <= 1e-2, f'{what} step {t}: track_bboxes off the eager '
                f'step by {err} px')
        worst = max(worst, err)
    return worst


def median(xs):
    xs = sorted(xs)
    return xs[len(xs) // 2]


def replayed_run(tracker, steps, n_streams, what, want):
    """``tracker``'s step over ``steps`` ((img, disp) on the card with a
    leading stream axis; ``n_streams`` 0 for a one-stream tracker): the
    graph captured by a first call (state then reset), every step replayed
    and timed (no wrapper launch), outputs finite, 0 host syncs in a
    replayed step, replayed equal to the eager step (ids and validity
    exact, boxes within 1e-2 px).  Returns per_step and results (the
    replays'), ms and eager_ms (medians of the steps after the first two),
    capture_ms, syncs, err (the largest box difference from eager) and the
    trace job that counts the launches, ``want`` per step."""
    import torch
    from stereotracking_tpu_torch import _kernels
    ids = [[t] * n_streams if n_streams else t for t in range(len(steps))]
    frames = steps if n_streams else [(i[0], d[0]) for i, d in steps]
    capture_ms = prime(tracker, *frames[0], n_streams)
    torch.cuda.synchronize()
    _kernels.reset_launch_counts()
    per_step, results = [], []
    for frame, i in zip(frames, ids):
        t0 = time.perf_counter()
        results.append(tracker.track_raw(*frame, i))
        torch.cuda.synchronize()
        per_step.append((time.perf_counter() - t0) * 1e3)
    require_replayed(what)
    lead = (n_streams,) if n_streams else ()
    for t, r in enumerate(results):
        check_result(r, lead, tracker.cfg.tracker.num_dets, f'{what} {t}')
    n = len(steps)
    syncs = count_syncs(lambda: tracker.track_raw(
        *frames[0], [n] * n_streams if n_streams else n))
    require(syncs == 0, f'{what}: {syncs} host syncs in a replayed step')
    eager, eager_ms = eager_steps(tracker.module, tracker.cfg, steps,
                                  steps[0][0].device)
    err = same_results(results if n_streams else [
        r._replace(**{k: v[None] for k, v in r._asdict().items()})
        for r in results], eager, what)
    return dict(per_step=per_step, results=results,
                ms=median(per_step[2:] or per_step),
                eager_ms=median(eager_ms[2:] or eager_ms),
                capture_ms=capture_ms, syncs=syncs, err=err,
                job=trace_job(tracker, frames, ids, want, results, what))


def run_slice(model, frames, device):
    """Phase 5: the single-stream flagship slice, graph-replayed, counters
    checked, against the eager step."""
    dev_frames = [to_card([f], device) for f in frames]
    r = replayed_run(model, dev_frames, 0, 'slice', dict(PER_STEP, stage3=0))
    n_ids = set()
    for f, (res, ms) in enumerate(zip(r['results'], r['per_step'])):
        ids = res.track_ids[res.track_valid].tolist()
        n_ids.update(i for i in ids if i >= 0)
        print(f'frame {f}: {int(res.det_valid.sum())} valid detections, '
              f'{int(res.track_valid.sum())} valid tracks, {ms:.2f} ms',
              flush=True)
    require(len(n_ids) > 0, 'no track id assigned')
    per_frame = r['per_step']
    print(f'slice: {len(frames)} frames of {FRAME_H}x{FRAME_W}, '
          f'{len(n_ids)} track ids; graph capture (warm-up step included) '
          f'{r["capture_ms"]:.2f} ms; replayed ms/frame first two '
          f'{per_frame[0]:.2f} {per_frame[1]:.2f}, frames 2-{len(frames) - 1}'
          f' median {r["ms"]:.2f}; eager median {r["eager_ms"]:.2f} '
          f'(this run); host syncs per frame {r["syncs"]}; replayed == eager '
          f'(ids exact, boxes within {r["err"]:.3g} px)', flush=True)
    return r['job']


def run_mixed(model, frames, device):
    """Phase 5b: backend mixes over 2 frames each, graph-replayed
    (``replayed_run``: no wrapper launch, 0 host syncs, replayed == eager).
    One the JAX builder accepts: the stem and stage-1 kernels with stage 2
    on the float32 modules.  Then configs at other widths (seeded random
    weights): YOLOX-nano (widen 0.25) and -tiny (0.375) with every stage
    'auto' resolve to the stem, stage-1 and stage-2 kernels with no
    builder warning (stage 3 'auto' stays on the modules, as the JAX
    builder decides), and with ``stage3_backend='cuda'`` run the stage-3
    kernel too; widen 0.75 with every stage 'auto' runs the stem kernel
    (O = 48) only, the builder warning that 'auto' moved stages 1 and 2 to
    the modules (ROADMAP Queue 3 item 1)."""
    from stereotracking_tpu_torch.apis.builder import build_mot_config
    from stereotracking_tpu_torch.models.csp_darknet import StageBackends
    from stereotracking_tpu_torch.models.mot import OCSORTDisparity
    dev_frames = [to_card([f], device) for f in frames]
    jobs = []
    mixed = flagship_cfg()['model']
    mixed.update(stem_backend='cuda', stage1_backend='cuda',
                 stage2_backend='torch')

    def widened(widen, **backends):
        m = flagship_cfg()['model']
        m['detector']['backbone']['widen_factor'] = widen
        m.update(backends)
        return m

    kernels3, kernels4 = ('cuda',) * 3 + ('torch',), ('cuda',) * 4
    for what, cfg, module, backends, moved in (
            ('stem + stage-1 kernels, stage 2-3 modules', mixed,
             model.module, ('cuda', 'cuda', 'torch', 'torch'), ()),
            ("widen 0.25, all 'auto'", widened(0.25), None, kernels3, ()),
            ("widen 0.25, stage 3 'cuda'",
             widened(0.25, stage3_backend='cuda'), None, kernels4, ()),
            ("widen 0.375, all 'auto'", widened(0.375), None, kernels3, ()),
            ("widen 0.375, stage 3 'cuda'",
             widened(0.375, stage3_backend='cuda'), None, kernels4, ()),
            # YOLOX-m's widths: stages 1-3 not built (Queue 3 item 1)
            ("widen 0.75, all 'auto'", widened(0.75), None,
             ('cuda', 'torch', 'torch', 'torch'), ('stage1', 'stage2'))):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter('always')
            mot = build_mot_config(cfg, device)
        said = [str(w.message) for w in caught
                if 'runs on the float32 modules' in str(w.message)]
        require(mot.backends == StageBackends(*backends),
                f'{what}: resolved to {mot.backends}')
        require(sorted(m.split('_backend')[0] for m in said) == list(moved),
                f'{what}: the builder reported {said}')
        require(all('Queue 3 item 1' in m for m in said),
                f'{what}: the builder\'s warning names no roadmap item: '
                f'{said}')
        one = OCSORTDisparity(mot, module=module, device=device, seed=SEED)
        want = {name: per if b == 'cuda' else 0 for name, per, b in zip(
            StageBackends._fields, (2, 1, 1, 1), backends)}
        want.update(depth=2, assignment=3, nms=1)
        r = replayed_run(one, dev_frames, 0, f'mixed ({what})', want)
        jobs.append(r['job'])
        for m in said:
            print(f'mixed backends ({what}): builder: {m}', flush=True)
        print(f'mixed backends ({what}): {len(frames)} frames replayed, '
              f'{r["syncs"]} host syncs, replayed == eager (ids exact, boxes '
              f'within {r["err"]:.3g} px); expected launches per step '
              f'{want}', flush=True)
    return jobs


def run_multistream(model, device):
    """Phase 6: MultiStreamTracker, 8 streams x 8 steps, stage-3 kernel on,
    graph-replayed; against the eager step and single-stream runs."""
    import torch
    from stereotracking_tpu_torch.apis.builder import build_mot_config
    from stereotracking_tpu_torch.models.mot import OCSORTDisparity
    from stereotracking_tpu_torch.parallel.multistream import \
        MultiStreamTracker
    from stereotracking_tpu_torch.models.csp_darknet import StageBackends
    mot = build_mot_config(flagship_cfg('cuda')['model'], device)
    require(mot.backends == StageBackends(*ALL_KERNELS),
            f'multi-stream config: {mot.backends}')
    ms = MultiStreamTracker(mot, N_STREAMS, module=model.module,
                            device=device)
    streams = [make_frames(N_STEPS, FRAME_H, FRAME_W, 100 + s)
               for s in range(N_STREAMS)]
    steps = [to_card([streams[s][t] for s in range(N_STREAMS)], device)
             for t in range(N_STEPS)]
    run = replayed_run(ms, steps, N_STREAMS, 'multi-stream', PER_STEP)
    results, per_step = run['results'], run['per_step']
    n_ids = set()
    for t, r in enumerate(results):
        n_ids.update(r.track_ids[r.track_valid].tolist())
        print(f'step {t}: {int(r.det_valid.sum())} valid detections, '
              f'{int(r.track_valid.sum())} valid tracks over {N_STREAMS} '
              f'streams, {per_step[t]:.2f} ms', flush=True)
    require(len(n_ids - {-1}) > 0, 'multi-stream: no track id assigned')
    med, emed = run['ms'], run['eager_ms']
    print(f'multi-stream: {N_STREAMS} streams x {N_STEPS} steps of '
          f'{FRAME_H}x{FRAME_W}; graph capture (warm-up '
          f'step included) {run["capture_ms"]:.2f} ms; replayed ms/step '
          f'first two {per_step[0]:.2f} {per_step[1]:.2f}, steps '
          f'2-{N_STEPS - 1} median {med:.2f} ({N_STREAMS / med * 1e3:.1f} '
          f'stereo pairs/s); eager median {emed:.2f} '
          f'({N_STREAMS / emed * 1e3:.1f} pairs/s, this run); host syncs per '
          f'step {run["syncs"]}; replayed == eager (ids exact, boxes within '
          f'{run["err"]:.3g} px)',
          flush=True)

    one = OCSORTDisparity(mot, module=model.module, device=device)
    for t in range(N_PARITY):
        r1 = one.track_raw(steps[t][0][0], steps[t][1][0], t)
        rb = results[t]
        for name in ('track_ids', 'track_valid', 'det_valid'):
            require(torch.equal(getattr(rb, name)[0], getattr(r1, name)),
                    f'step {t}: stream 0 {name} differs from its '
                    f'single-stream run')
        # boxes of the tracked slots: the detector's float32 layers sum in
        # another order at another batch size, which may swap near-tied
        # detections deep in the 300 NMS slots, never among the tracked
        err = float((rb.track_bboxes[0] - r1.track_bboxes).abs().max())
        require(err <= 1e-2, f'step {t}: stream 0 track_bboxes off its '
                f'single-stream run by {err} px')
    print(f'multi-stream: stream 0 equals its single-stream run over '
          f'{N_PARITY} steps (ids and validity exact, boxes within 1e-2 px)',
          flush=True)
    del one
    return dict(ms_per_step=med, eager_ms_per_step=emed,
                results=results[:N_PARITY], steps=steps, mot=mot,
                tracker=ms, job=run['job'])


def profile_steps(step, what):
    """Device time by kernel over two replayed steps (``step(t)`` runs step
    t), the kernel sum against the steps' wall time (the card's busy
    share), and each hand-written kernel's launches and device time per
    step in the trace."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for t in range(2):
            step(t)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e6
    rows = [(getattr(e, 'device_time_total', 0) or
             getattr(e, 'cuda_time_total', 0), e.count, e.key)
            for e in prof.key_averages()]
    rows = sorted((r for r in rows if r[0] > 0), reverse=True)
    total = sum(r[0] for r in rows if not r[2].startswith('aten::'))
    print(f'profile {what}: device time over 2 replayed steps by kernel (us);'
          f' kernel sum {total:.0f} us of {wall:.0f} us wall: the card busy '
          f'{100 * total / wall:.1f}%', flush=True)
    for us, cnt, key in rows[:40]:
        print(f'profile {what}: {us:12.1f} us {cnt:6d}x {key[:90]}',
              flush=True)
    names = sum(TRACE_KERNELS.values(), ()) + ('stage3_entry_kernel',)
    seen = {n: sum(c for _, c, k in rows if n in k) for n in names}
    print(f'profile {what}: hand-written kernel launches in the trace of 2 '
          f'steps: {seen}', flush=True)
    us = {n: round(sum(t for t, _, k in rows if n in k) / 2, 1)
          for n in names}
    print(f'profile {what}: hand-written kernels\' device time per step '
          f'(us): {us}', flush=True)


def run_bf16(model, device, f32):
    """Phase 7: the multi-stream phase's 8 steps of 8 streams again with
    the detector's module layers in bf16 (``dtype=torch.bfloat16``, the
    same weights), graph-replayed, beside phase 6's float32 numbers and the
    eager bf16 step.  Launches as in float32; no host sync; outputs
    finite.  Findings, not checks: the largest bf16 - float32 difference
    of the head maps on one frame, and how many of stream 0's track ids
    differ from the float32 run over its first steps."""
    import torch
    from stereotracking_tpu_torch.models.detector import YOLOXDetector
    from stereotracking_tpu_torch.models.mot import preprocess_raw
    from stereotracking_tpu_torch.models.preprocessor import padded_shape
    from stereotracking_tpu_torch.parallel.multistream import \
        MultiStreamTracker
    bf16 = torch.bfloat16
    mot = f32['mot']
    det = YOLOXDetector(mot.detector, dtype=bf16)
    det.load_state_dict(model.module.state_dict())
    ms = MultiStreamTracker(mot, N_STREAMS, module=det, device=device,
                            dtype=bf16)
    steps = f32['steps']
    run = replayed_run(ms, steps, N_STREAMS, 'bf16', PER_STEP)
    results, per_step = run['results'], run['per_step']
    med, emed = run['ms'], run['eager_ms']
    print(f'bf16: {N_STREAMS} streams x {N_STEPS} steps of {FRAME_H}x'
          f'{FRAME_W}; graph capture {run["capture_ms"]:.2f} ms; '
          f'replayed ms/step first two {per_step[0]:.2f} {per_step[1]:.2f}, '
          f'steps 2-{N_STEPS - 1} median {med:.2f} ({N_STREAMS / med * 1e3:.1f}'
          f' stereo pairs/s); eager median {emed:.2f} '
          f'({N_STREAMS / emed * 1e3:.1f} pairs/s); float32 replayed (phase '
          f'6, this run) {f32["ms_per_step"]:.2f} ms/step, eager '
          f'{f32["eager_ms_per_step"]:.2f}; host syncs per step '
          f'{run["syncs"]}; replayed == eager (ids exact, boxes within '
          f'{run["err"]:.3g} px)', flush=True)

    img, disp = steps[0][0][:1], steps[0][1][:1]
    inputs = preprocess_raw(img, disp, *padded_shape(*img.shape[1:3]))
    with torch.no_grad():
        hb = det(inputs, mot.backends)
        hf = model.module(inputs, mot.backends)
    for name, b, f in zip(('cls', 'reg', 'obj'), hb, hf):
        e = max(float((x.float() - y).abs().max()) for x, y in zip(b, f))
        top = max(float(y.abs().max()) for y in f)
        print(f'bf16 finding: head {name} maps, one {FRAME_H}x{FRAME_W} '
              f'frame: largest |bf16 - float32| {e:.4g} (largest '
              f'|float32| {top:.4g})', flush=True)
    differ = total = 0
    for rb, rf in zip(results, f32['results']):
        vb, vf = rb.track_valid[0], rf.track_valid[0]
        both = vb | vf
        total += int(both.sum())
        differ += int((both & ((vb != vf) | (rb.track_ids[0]
                                             != rf.track_ids[0]))).sum())
    print(f'bf16 finding: stream 0 over {len(f32["results"])} steps: '
          f'{differ} of {total} track slots differ in id or validity from '
          f'the float32 run', flush=True)
    return dict(tracker=ms, job=run['job'])


def run_tiny_bf16(device, steps):
    """Phase 7b: YOLOX-tiny's widths (widen 0.375, deepen 0.33; seeded
    random weights, head biases ``HEAD_BIAS``) on the multi-stream phase's
    8 steps of 8 streams in bf16, graph-replayed (0 host syncs, replayed ==
    eager): every stage 'auto' (the stem, stage-1 and stage-2 kernels)
    against the stem kernel with stages 1-3 on the bf16 modules, what
    'auto' chose before the stage kernels were built for these widths.
    Returns the two runs' trace jobs."""
    import torch
    from stereotracking_tpu_torch.apis.builder import build_mot_config
    from stereotracking_tpu_torch.models.csp_darknet import StageBackends
    from stereotracking_tpu_torch.models.detector import YOLOXDetector
    from stereotracking_tpu_torch.models.mot import init_weights
    from stereotracking_tpu_torch.parallel.multistream import \
        MultiStreamTracker
    bf16 = torch.bfloat16
    cfg = flagship_cfg()['model']
    cfg['detector']['backbone']['widen_factor'] = 0.375
    jobs, ms = [], {}
    for what, keys, backends in (
            ('kernels', {}, ('cuda',) * 3 + ('torch',)),
            ('modules', dict(stem_backend='cuda', stage1_backend='torch',
                             stage2_backend='torch', stage3_backend='torch'),
             ('cuda',) + ('torch',) * 3)):
        mot = build_mot_config({**cfg, **keys}, device)
        require(mot.backends == StageBackends(*backends),
                f'widen 0.375 {what}: resolved to {mot.backends}')
        det = YOLOXDetector(mot.detector, dtype=bf16)
        with torch.no_grad():
            init_weights(det, torch.Generator().manual_seed(SEED + 375))
        set_head_bias(det, HEAD_BIAS)
        tracker = MultiStreamTracker(mot, N_STREAMS, module=det,
                                     device=device, dtype=bf16)
        want = {name: per if b == 'cuda' else 0 for name, per, b in zip(
            StageBackends._fields, (2, 1, 1, 1), backends)}
        want.update(depth=2, assignment=3, nms=1)
        run = replayed_run(tracker, steps, N_STREAMS,
                           f'widen 0.375 bf16 {what}', want)
        ms[what] = run['ms']
        jobs.append(run['job'])
        print(f'widen 0.375 bf16 ({what}, stages {backends}): {N_STREAMS} '
              f'streams x {N_STEPS} steps of {FRAME_H}x{FRAME_W}; replayed '
              f'ms/step {[round(x, 2) for x in run["per_step"]]}, median of '
              f'steps 2-{N_STEPS - 1} {run["ms"]:.2f} '
              f'({N_STREAMS / run["ms"] * 1e3:.1f} stereo pairs/s); eager '
              f'median {run["eager_ms"]:.2f}; host syncs per step '
              f'{run["syncs"]}; replayed == eager (ids exact, boxes within '
              f'{run["err"]:.3g} px)', flush=True)
    print(f'widen 0.375 bf16: the stage kernels {ms["kernels"]:.2f} ms per '
          f'step against the modules {ms["modules"]:.2f}: '
          f'{ms["modules"] / ms["kernels"]:.2f}x', flush=True)
    return jobs


class MemoryDataset:
    """Videos of ``make_frames`` frames held in memory, with the reader
    interface ``tools/test.evaluate`` takes.  Ground truth: each frame's
    six rectangles, id = drawing order + 100 x video, Z from their
    disparity (focal x baseline / (raw / 16))."""

    def __init__(self, n_videos, n_frames, h, w, bf):
        import numpy as np
        self.h, self.w, self.bf = h, w, bf
        self.frame_shape = (h, w)
        self.frames = {}
        self.vids = {}
        for v in range(n_videos):
            ids = []
            for t, f in enumerate(make_frames(n_frames, h, w, 300 + v,
                                              with_boxes=True)):
                img_id = 1000 * v + t
                self.frames[img_id] = (v,) + f
                ids.append(img_id)
            self.vids[v] = ids
        self._np = np

    def videos(self):
        return sorted(self.vids)

    def video_name(self, vid):
        return f'mem{vid:02d}'

    def video_frames(self, vid):
        return self.vids[vid]

    def frame_info(self, img_id):
        np = self._np
        v, _, _, boxes, raw = self.frames[img_id]
        n = len(boxes)
        return dict(img_id=img_id, height=self.h, width=self.w,
                    gt_bboxes=boxes, gt_labels=np.zeros(n, np.int64),
                    gt_instance_ids=np.arange(n) + 100 * v,
                    gt_locations=np.stack([np.zeros(n), np.zeros(n),
                                           self.bf / (raw / 16.0)], 1))

    def load_frame(self, img_id):
        np = self._np
        _, img, disp, _, _ = self.frames[img_id]
        sample = self.frame_info(img_id)
        sample['img'] = img
        sample['disp_mask'] = (disp < 65535).astype(np.float32)
        sample['disp_postp'] = np.where(disp == 65535, 0, disp).astype(
            np.float32) / 16.0
        return sample


def eval_loops(m, data, cfg, flags, device, tmp, counts, n_classes=1,
               what=''):
    """The eval CLI's loop (``tools/test.evaluate``) over ``data``
    sequentially and with ``--streams 2 --stage-frames``, as the CLI runs
    it with ``flags``; each loop run twice, the second time under torch's
    sync debug mode (0 host syncs per step besides the result fetch
    required).  Returns {mode: (metrics, pairs/s)}."""
    from stereotracking_tpu_torch.evaluation import (CocoMAPEvaluator,
                                                     MOTDroneMetrics)
    from stereotracking_tpu_torch.tools import test as cli
    videos = data.videos()
    frames = sum(len(data.video_frames(v)) for v in videos)
    got = {}
    for mode, extra in (('sequential', []),
                        ('streams 2', ['--streams', '2', '--stage-frames'])):
        args = cli.parse_args([CONFIG, '--device', str(device),
                               '--work-dir', tmp] + flags + extra)

        def run():
            mot = MOTDroneMetrics(outfile_dir=tmp)
            coco = CocoMAPEvaluator(num_classes=n_classes)
            n, el = cli.evaluate(m, data, videos, args, cfg['img_scale'],
                                 mot, coco)
            return n, el, {**mot.evaluate(), **coco.evaluate()}

        n, elapsed, metrics = run()
        longest = max(len(data.video_frames(v)) for v in videos)
        n_steps = frames if mode == 'sequential' else longest + 1  # warm-up
        syncs = count_syncs(run) / n_steps
        require(syncs == 0, f'eval {what} {mode}: {syncs} host syncs per '
                f'step besides the result fetch')
        require(n == frames, f'eval {what} {mode}: {n} frames scored')
        got[mode] = (metrics, n / elapsed)
        h, w = data.frame_shape
        print(f'eval {what} {mode}: {n} frames of {h}x{w} in '
              f'{elapsed * 1e3:.1f} ms = {n / elapsed:.1f} stereo pairs/s; '
              f'host syncs per step {syncs:.2f} (torch sync debug mode) + 1 '
              f'result fetch; ' + ', '.join(f'{k} {metrics[k]:.4f}'
                                            for k in counts), flush=True)
    return got


def check_show_dir(m, data, cfg, device, tmp):
    """Phase 8 (drawing): the eval CLI's loop with ``--show-dir
    --show-interval 2 --show-errors`` (sequential, float32): 0 host syncs
    per step besides the result fetch (the frames are drawn from the
    reader's host images and the fetched results); the files
    ``<dir>/<video>/<frame:06d>.jpg`` of frames 0, 2, 4, ... of each
    video, each a JPEG of the frame's size."""
    from PIL import Image
    from stereotracking_tpu_torch.evaluation import (CocoMAPEvaluator,
                                                     MOTDroneMetrics)
    from stereotracking_tpu_torch.tools import test as cli
    show = os.path.join(tmp, 'show')
    args = cli.parse_args([CONFIG, '--device', str(device), '--work-dir',
                           tmp, '--show-dir', show, '--show-interval', '2',
                           '--show-errors'])
    videos = data.videos()
    frames = sum(len(data.video_frames(v)) for v in videos)
    t0 = time.perf_counter()
    syncs = count_syncs(lambda: cli.evaluate(
        m, data, videos, args, cfg['img_scale'],
        MOTDroneMetrics(outfile_dir=tmp), CocoMAPEvaluator(num_classes=1)))
    elapsed = time.perf_counter() - t0
    require(syncs == 0, f'eval --show-dir: {syncs} host syncs besides the '
            f'result fetches')
    want = sorted(os.path.join(data.video_name(v), f'{t:06d}.jpg')
                  for v in videos
                  for t in range(0, len(data.video_frames(v)), 2))
    got = sorted(os.path.relpath(os.path.join(d, f), show)
                 for d, _, fs in os.walk(show) for f in fs)
    require(got == want, f'eval --show-dir wrote {got}, expected {want}')
    for rel in got:
        with Image.open(os.path.join(show, rel)) as im:
            require(im.format == 'JPEG' and im.size == (data.w, data.h),
                    f'eval --show-dir {rel}: {im.format} {im.size}')
    print(f'eval --show-dir --show-interval 2 --show-errors: {len(got)} '
          f'JPEG files of {data.w}x{data.h} for {frames} frames, '
          f'{frames / elapsed:.1f} stereo pairs/s with the drawing (under '
          f'the sync debug mode), 0 host syncs besides the result fetch',
          flush=True)


def run_eval(model, device):
    """Phase 8: the eval CLI's loop (``tools/test.evaluate``) on a dataset
    held in memory (2 videos x 6 frames of 1080x1920, ``img_scale`` the
    frame size), with the flagship config and ``init_model`` weights from a
    ``.pth`` written from the phases' model; sequentially and with
    ``--streams 2 --stage-frames``, in float32 and with ``--bf16``, as the
    CLI runs them (in bf16 on the card with cuDNN off:
    ``tools/test.batch_invariant_convs``); pairs/s and host syncs per step
    printed.  The count metrics of the two loops must be equal.  A finding,
    not a check: the bf16 loops again with the CLI's choice overridden
    (cuDNN on, the loop as it ran before), how far they differ and their
    pairs/s.  Then ``inference_mot`` over 2 frames must equal
    ``track_raw`` on them (ids exact, boxes within 1e-3 px)."""
    import tempfile

    import numpy as np
    import torch
    from stereotracking_tpu_torch.apis.inference import (inference_mot,
                                                         init_model)
    from stereotracking_tpu_torch.models.mot import (OCSORTDisparity,
                                                     result_to_host)
    from stereotracking_tpu_torch.tools import test as cli
    cfg = flagship_cfg()
    cfg['img_scale'] = (FRAME_H, FRAME_W)
    bf = float(cfg['model']['baseline']) * float(cfg['model']['focal_length'])
    data = MemoryDataset(2, 6, FRAME_H, FRAME_W, bf)
    videos = data.videos()
    counts = ('CLR_TP', 'CLR_FP', 'CLR_FN', 'IDSW', 'MOTA', 'IDF1')
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        pth = os.path.join(tmp, 'flagship.pth')
        torch.save({'state_dict': {
            f'detector.{k}': v.cpu()
            for k, v in model.module.state_dict().items()
            if not k.startswith(('backbone.disp_stem', 'backbone.disp_stage1'))
        }, 'meta': {'seed': SEED}}, pth)
        for dtype in ('float32', 'bf16'):
            flags = ['--bf16'] if dtype == 'bf16' else []
            m = init_model(cfg, pth, device=device,
                           dtype=torch.bfloat16 if flags else None)
            with cli.batch_invariant_convs(bool(flags), device) as off:
                pass
            require(off == (dtype == 'bf16'),
                    f'eval {dtype}: the CLI chose cuDNN off = {off}')
            got = eval_loops(m, data, cfg, flags, device, tmp, counts,
                             what=dtype)
            require(torch.backends.cudnn.enabled, 'eval: cuDNN stayed off '
                    'after the CLI loop')
            apart = [k for k in counts
                     if got['sequential'][0][k] != got['streams 2'][0][k]]
            require(not apart, f'eval {dtype}: {apart} differ: sequential '
                    f'{got["sequential"][0]}, streams 2 '
                    f'{got["streams 2"][0]}')
            out[dtype] = {mode: pps for mode, (_, pps) in got.items()}
            if dtype != 'bf16':
                check_show_dir(m, data, cfg, device, tmp)
                continue
            # the finding: the bf16 loops with cuDNN on
            choose = cli.batch_invariant_convs
            cli.batch_invariant_convs = (
                lambda bf16, dev: contextlib.nullcontext(False))
            try:
                on = eval_loops(m, data, cfg, flags, device, tmp, counts,
                                what='bf16 with cuDNN (the CLI\'s choice '
                                'overridden)')
            finally:
                cli.batch_invariant_convs = choose
            apart = [k for k in counts
                     if on['sequential'][0][k] != on['streams 2'][0][k]]
            out['bf16 cudnn'] = {mode: pps for mode, (_, pps) in on.items()}
            print(f'eval finding: bf16 with cuDNN, sequential and streams 2 '
                  f'differ in {apart or "none"} of {counts}; pairs/s '
                  f'sequential {on["sequential"][1]:.1f} with cuDNN, '
                  f'{got["sequential"][1]:.1f} as the CLI runs (cuDNN off); '
                  f'streams 2 {on["streams 2"][1]:.1f} and '
                  f'{got["streams 2"][1]:.1f}', flush=True)

    # inference_mot against track_raw on the same frames and weights
    ref = OCSORTDisparity(m.cfg, module=m.module, device=device)
    for f, img_id in enumerate(data.video_frames(videos[0])[:2]):
        _, img, disp, _, _ = data.frames[img_id]
        a = inference_mot(m, img, disp, f)['track_instances']
        b = result_to_host(ref.track_raw(img, disp, f))
        tv = b.track_valid
        require(np.array_equal(a['instances_id'], b.track_ids[tv]),
                f'inference_mot frame {f}: ids differ from track_raw')
        err = float(np.abs(a['bboxes'] - b.track_bboxes[tv]).max(
            initial=0.0))
        require(err <= 1e-3, f'inference_mot frame {f}: boxes off '
                f'track_raw by {err} px')
    print('eval: inference_mot equals track_raw over 2 frames (ids exact, '
          'boxes within 1e-3 px)', flush=True)
    return out


# ------------------------------------------------------------ training ----

TRAIN_BATCH, TRAIN_H, TRAIN_W = 8, 736, 1280   # 1280x720 padded to /32
TRAIN_WARM, TRAIN_STEPS, FIXED_STEPS = 2, 10, 20
# the small-size check of the card against the CPU: deepen 0.1, widen
# 0.125, batch 2, 64x96; the learning rates of steps 0 and 1 are 2.5e-4 and
# 1e-3 (base lr, steps per epoch, max epochs, warm-up, last epochs)
SMALL = dict(deepen=0.1, widen=0.125, batch=2, h=64, w=96,
             sched=(1e-3, 2, 4, 1, 1))


def train_state(device, det_cfg, schedule, seed=SEED):
    """A ``TrainState`` of a detector on ``device`` with seeded weights
    (drawn on the CPU, so every device gets the same ones)."""
    from stereotracking_tpu_torch.models.detector import YOLOXDetector
    from stereotracking_tpu_torch.train.train_state import create_train_state
    return create_train_state(YOLOXDetector(det_cfg).to(device), schedule,
                              seed=seed)


def state_copy(state):
    """Every tensor of the module and of the EMA, cloned."""
    return {f'{part}.{k}': v.detach().clone() for part, m in
            (('model', state.module), ('ema', state.ema))
            for k, v in m.state_dict().items()}


def moved(state, before, part):
    """How many of ``part``'s ('model' or 'ema') float tensors changed
    since ``before``, and how many there are."""
    now = state_copy(state)
    keys = [k for k in before if k.startswith(part + '.')
            and before[k].is_floating_point()]
    return sum(not bool((now[k] == before[k]).all()) for k in keys), len(keys)


def train_losses_finite(losses, what):
    import torch
    for t, out in enumerate(losses):
        for k, v in out.items():
            require(bool(torch.isfinite(v.float()).all()),
                    f'{what} step {t}: {k} = {v} is not finite')
        require(int(out['num_pos']) > 0, f'{what} step {t}: no positive')


def run_train(device):
    """Phase 9: the flagship detector (full width, float32, TF32 off) in
    train mode: 2 warm-up and 10 timed ``train_step``s at batch 8 of
    736x1280 on the two host-staged random batches of the train bench,
    once with each loss config (stage 1, stage 2 with L1); ms per step,
    steps/s, pairs/s and peak memory; finite losses, parameters and EMA
    moved, no host sync in a step, the kernel weight cache rebuilt after a
    step; then 20 steps on one fixed batch at a constant lr of 0.01, from
    the reference head's prior-probability cls and obj biases, must lower
    the loss.  Returns the state and the batches."""
    import torch
    from stereotracking_tpu_torch.apis.builder import build_detector_config
    from stereotracking_tpu_torch.tools.bench_train import (card_name,
                                                            staged_batches)
    from stereotracking_tpu_torch.train.losses import YOLOXLossConfig
    from stereotracking_tpu_torch.train.schedules import yolox_schedule
    from stereotracking_tpu_torch.train.train_state import train_step
    card = card_name()
    det_cfg = build_detector_config(flagship_cfg()['model']['detector'])
    t0 = time.perf_counter()
    state = train_state(device, det_cfg, yolox_schedule(
        0.001 / 8 * TRAIN_BATCH, steps_per_epoch=100))
    batches = staged_batches(TRAIN_BATCH, TRAIN_H, TRAIN_W, device)
    torch.cuda.synchronize()
    print(f'train: flagship detector (deepen {det_cfg.deepen_factor}, widen '
          f'{det_cfg.widen_factor}) in train mode, batches of '
          f'{TRAIN_BATCH}x{TRAIN_H}x{TRAIN_W} staged on the card in '
          f'{time.perf_counter() - t0:.1f} s', flush=True)
    before = state_copy(state)
    stage1 = YOLOXLossConfig(num_classes=det_cfg.num_classes)
    for what, loss_cfg in (('stage 1', stage1),
                           ('stage 2 (L1)', stage1._replace(use_l1=True))):
        losses = [train_step(state, batches[i % 2], loss_cfg)
                  for i in range(TRAIN_WARM)]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(device)
        t0 = time.perf_counter()
        for i in range(TRAIN_STEPS):
            losses.append(train_step(state, batches[i % 2], loss_cfg))
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / TRAIN_STEPS * 1e3
        peak = torch.cuda.max_memory_allocated(device)
        train_losses_finite(losses, f'train {what}')
        syncs = count_syncs(lambda: train_step(state, batches[0], loss_cfg))
        require(syncs == 0, f'train {what}: {syncs} host syncs in a step')
        last = losses[-1]
        print(f'train {what} ({card}): {TRAIN_STEPS} steps of batch '
              f'{TRAIN_BATCH} x {TRAIN_H}x{TRAIN_W} float32 (TF32 off) after '
              f'{TRAIN_WARM} warm-up steps: {ms:.2f} ms/step = '
              f'{1e3 / ms:.3f} steps/s = {TRAIN_BATCH * 1e3 / ms:.2f} '
              f'pairs/s; peak memory '
              f'{peak / 2**30:.2f} GiB (torch.cuda.max_memory_allocated); '
              f'host syncs per step {syncs}; last loss '
              f'{float(last["loss"]):.4f}, num_pos {int(last["num_pos"])}',
              flush=True)
    for part in ('model', 'ema'):
        n, total = moved(state, before, part)
        require(n > total // 2, f'train: only {n} of {total} {part} tensors '
                f'moved')
        print(f'train: {n} of {total} {part} tensors moved', flush=True)

    # an in-place step invalidates the packed kernel weights
    bb = state.module.backbone
    bb.kernel_weights()
    key = bb._kernel_cache[0]
    train_step(state, batches[0], stage1)
    bb.kernel_weights()
    require(bb._kernel_cache[0] != key, 'train: the kernel weight cache '
            'kept its key after an optimizer step')

    # from the reference head's prior-probability bias (mmyolo
    # YOLOXHeadModule.init_weights: cls and obj biases -log((1 - 0.01) /
    # 0.01)); from zero biases, as the JAX package initialises them, the
    # objectness loss of 8 x 19,320 priors starts near 450 and this lr
    # diverges (measured: NaN from step 6)
    fixed = train_state(device, det_cfg, lambda step: 0.01, seed=SEED + 1)
    head = fixed.module.bbox_head.head_module
    with torch.no_grad():
        for conv in (*head.multi_level_conv_cls, *head.multi_level_conv_obj):
            conv.bias.fill_(-math.log((1 - 0.01) / 0.01))
    seq = [float(train_step(fixed, batches[0], stage1)['loss'])
           for _ in range(FIXED_STEPS)]
    require(all(math.isfinite(x) for x in seq) and seq[-1] < seq[0],
            f'train: {FIXED_STEPS} steps at lr 0.01 on one batch did not '
            f'lower the loss: {seq}')
    print(f'train: {FIXED_STEPS} steps at a constant lr of 0.01 on one fixed '
          f'batch: loss {seq[0]:.4f} -> {seq[-1]:.4f} (every 5th: '
          f'{[round(x, 4) for x in seq[::5]]})', flush=True)
    del fixed
    return state, batches


def check_train_on_cpu(device):
    """Phase 9b: one step (L1 on) at a small size on the card against the
    same step on the CPU from the same weights and batch, cuDNN
    deterministic.  ``num_pos`` must be equal.  Limits, from the float32
    errors of this step against its float64 version (measured on the card
    and on the CPU: losses 1.3e-5 and 4.5e-6, gradients up to 1.5e-4 and
    1.9e-4 of each tensor's largest magnitude), about 5x their sum: the
    losses rtol 1e-4; the momentum buffers, which after a first step hold
    each parameter's gradient plus its decay, within 2e-3 of their largest
    magnitude; every weight, BatchNorm statistic and EMA tensor within 2e-3
    of the largest change the step made to it plus 4 float32 eps of its
    largest value (each side rounds the stored value once, and a step at lr
    2.5e-4 changes a weight by a few of its ulps).  The parameters'
    ``.grad`` is not compared: SGD's foreach form on the card adds the
    nesterov term into the gradients of the group without decay in place,
    its single-tensor form on the CPU into a copy."""
    import torch
    from stereotracking_tpu_torch.models.detector import DetectorConfig
    from stereotracking_tpu_torch.tools.bench_train import staged_batches
    from stereotracking_tpu_torch.train.losses import YOLOXLossConfig
    from stereotracking_tpu_torch.train.schedules import yolox_schedule
    from stereotracking_tpu_torch.train.train_state import train_step
    s = SMALL
    det_cfg = DetectorConfig(deepen_factor=s['deepen'],
                             widen_factor=s['widen'])
    batch = staged_batches(s['batch'], s['h'], s['w'], 'cpu')[0]
    loss_cfg = YOLOXLossConfig(use_l1=True)
    runs, init = {}, None
    for dev in ('cpu', device):
        st = train_state(dev, det_cfg, yolox_schedule(*s['sched']))
        if init is None:       # the same seeded weights on both devices
            init = {part: {k: v.detach().clone() for k, v in d.items()}
                    for part, d in st.state_dict().items()
                    if part in ('model', 'ema')}
        with torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                        deterministic=True,
                                        allow_tf32=False):
            losses = train_step(st, {k: v.to(dev) for k, v in batch.items()},
                                loss_cfg)
        runs[str(dev)] = (
            {k: float(v) for k, v in losses.items()},
            {part: {k: v.detach().cpu() for k, v in d.items()}
             for part, d in st.state_dict().items()
             if part in ('model', 'ema', 'momentum')})
    (lc, sc), (lg, sg) = runs['cpu'], runs[str(device)]
    require(lc['num_pos'] == lg['num_pos'] > 0, f'train card vs CPU: '
            f'num_pos {lg["num_pos"]} vs {lc["num_pos"]}')
    worst, over = {}, []
    for k in lc:
        if k != 'num_pos':
            share = abs(lg[k] - lc[k]) / abs(lc[k]) / 1e-4
            worst['losses'] = max(worst.get('losses', 0.0), share)
            if share > 1:
                over.append((share, k))
    eps = float(torch.finfo(torch.float32).eps)
    for part in ('model', 'ema', 'momentum'):
        for k, want in sc[part].items():
            if not want.is_floating_point():
                continue
            err = float((sg[part][k] - want).abs().max())
            if part == 'momentum':
                limit = 2e-3 * float(want.abs().max())
            else:
                limit = 2e-3 * float((want - init[part][k]).abs().max()) + \
                    4 * eps * float(want.abs().max())
            share = err / limit if limit > 0 else float(err > 0) * math.inf
            worst[part] = max(worst.get(part, 0.0), share)
            if share > 1:
                over.append((share, f'{part} {k}'))
    require(not over, f'train card vs CPU: {len(over)} over their limit, '
            f'the worst (difference / limit, what): '
            f'{sorted(over, reverse=True)[:5]}')
    print(f'train card vs CPU (deepen {s["deepen"]}, widen {s["widen"]}, '
          f'batch {s["batch"]} x {s["h"]}x{s["w"]}, one step with L1, cuDNN '
          f'deterministic): num_pos {int(lc["num_pos"])} on both; the '
          f'largest difference as a share of its limit: '
          + ', '.join(f'{k} {v:.3g}' for k, v in worst.items())
          + ' (limits: losses rtol 1e-4; momentum 2e-3 of its largest '
          'magnitude; weights, statistics and EMA 2e-3 of the largest change '
          '+ 4 float32 eps of the largest value)', flush=True)
    return worst


def serve_export(state, device):
    """Phase 9c: the EMA weights exported and loaded through ``init_model``
    (every tensor, the disparity branch's own included, must equal the
    EMA's; the packed kernel weights must equal those packed from the
    EMA); the exported model then serves 2 frames through ``track_raw``
    with the kernels, replayed from its CUDA graph: no wrapper launches in
    the replays, 0 host syncs, finite outputs."""
    import tempfile

    import torch
    from stereotracking_tpu_torch import _kernels
    from stereotracking_tpu_torch.apis.inference import init_model
    from stereotracking_tpu_torch.train.checkpoint import (
        extract_detector_variables, save_checkpoint)
    with tempfile.TemporaryDirectory() as tmp:
        pth = os.path.join(tmp, 'detector_final.pth')
        save_checkpoint(pth, extract_detector_variables(state))
        model = init_model(flagship_cfg(), pth, device=device)
    got, want = model.module.state_dict(), state.ema.state_dict()
    for k, v in want.items():
        if not k.endswith('num_batches_tracked'):
            require(torch.equal(got[k], v), f'export: {k} differs from the '
                    f'EMA')
    mine = model.module.backbone.kernel_weights()
    theirs = state.ema.backbone.kernel_weights()
    for name in mine:
        for a, b in zip(mine[name], theirs[name]):
            if torch.is_tensor(a):
                require(torch.equal(a, b), f'export: packed {name} kernel '
                        f'weights differ from the EMA\'s')
    frames = [to_card([f], device) for f in make_frames(2, FRAME_H, FRAME_W,
                                                        SEED + 7)]
    prime(model, frames[0][0][0], frames[0][1][0], 0)
    torch.cuda.synchronize()
    _kernels.reset_launch_counts()
    results = [model.track_raw(img[0], disp[0], f)
               for f, (img, disp) in enumerate(frames)]
    torch.cuda.synchronize()
    require_replayed('train export')
    for f, r in enumerate(results):
        check_result(r, (), model.cfg.tracker.num_dets, f'export frame {f}')
    syncs = count_syncs(lambda: model.track_raw(frames[0][0][0],
                                                frames[0][1][0], 2))
    require(syncs == 0, f'export: {syncs} host syncs in a replayed frame')
    print(f'train export: init_model loaded the EMA weights (disparity '
          f'branch its own, packed kernel weights equal); 2 frames of '
          f'{FRAME_H}x{FRAME_W} served through track_raw with the kernels '
          f'({model.cfg.backends}), replayed, host syncs per frame {syncs}; '
          f'{[int(r.det_valid.sum()) for r in results]} valid detections',
          flush=True)


# ------------------------------------------------------ other configs ----

KITTI_CONFIG = os.path.join(REPO, 'configs', 'stereo_tracking', 'ocsort',
                            'yolox_s_kitti_disp.py')
MONO_CONFIG = os.path.join(REPO, 'configs', 'mot', 'ocsort',
                           'yolox_s_ocsort_monocular.py')
KITTI_H, KITTI_W = 375, 1242     # a KITTI left image
OTHER_TRAIN_STEPS = 3


def no_stage_kernels(mot):
    """Launches per step of a path with no stage kernel (the single and
    concatenated backbones): depth twice, or once where the config keeps
    the detection's depth (``reuse_det_depth``, the default of both
    packages, which the monocular config keeps), 3 assignments, 1 NMS."""
    return dict(stem=0, stage1=0, stage2=0, stage3=0,
                depth=1 if mot.reuse_det_depth else 2, assignment=3, nms=1)


def load_cfg(path):
    from stereotracking_tpu_torch.config import load_config
    return load_config(path)


def set_head_bias(module, bias):
    """The head's cls and obj biases, so that random-weight detections
    pass the tracker's gates."""
    import torch
    head = module.bbox_head.head_module
    with torch.no_grad():
        for conv in (*head.multi_level_conv_cls, *head.multi_level_conv_obj):
            conv.bias.fill_(bias)


def resized_frames(n, h, w, scale, seed):
    """``make_frames``' raw (h, w) frames resized keep-ratio to ``scale`` as
    the eval CLI resizes them (bilinear image, nearest disparity), as the
    (img uint8, disp uint16) that it hands ``track_raw``."""
    from stereotracking_tpu_torch.apis.inference import raw_frame
    from stereotracking_tpu_torch.data import transforms as T
    out = []
    for img, disp in make_frames(n, h, w, seed):
        sample = dict(img=img, **T.disparity_postprocess(disp))
        out.append(raw_frame(T.resize_keep_ratio(sample, scale)))
    return out


def run_kitti(device, card):
    """Phase 12a: the KITTI stereo config (dual backbone, 2 classes) at full
    width, seeded weights, on 375x1242 frames resized as the CLI does (386
    x 1280, padded to 416x1280): every kernel of the path against its plain
    version at 8 streams of this shape (stage 3 explicitly; depth, JV and
    NMS on the main path's own inputs, both labels among them); one stream
    over 6 frames and 8 streams over 8 steps, replayed; the eval CLI's loop
    over 2 videos x 6 frames in memory, sequential and ``--streams 2``,
    float32: count metrics equal.  Returns the kernel rows and the trace
    jobs."""
    import tempfile

    import torch
    from stereotracking_tpu_torch.apis.builder import build_model
    from stereotracking_tpu_torch.models.csp_darknet import StageBackends
    from stereotracking_tpu_torch.models.preprocessor import padded_shape
    from stereotracking_tpu_torch.parallel.multistream import \
        MultiStreamTracker
    cfg = load_cfg(KITTI_CONFIG)
    scale = tuple(cfg['img_scale'])
    model = build_model(cfg, device=device, seed=SEED + 11)
    # both classes' biases equal: which class a box keeps is the weights'
    set_head_bias(model.module, HEAD_BIAS)
    mot = model.cfg
    require(mot.detector.num_classes == 2 and mot.backends == StageBackends(
        'cuda', 'cuda', 'cuda', 'torch'), f'KITTI config: {mot}')
    streams = [resized_frames(N_STEPS, KITTI_H, KITTI_W, scale, 400 + s)
               for s in range(N_STREAMS)]
    h, w = streams[0][0][0].shape[:2]
    oh, ow = padded_shape(h, w)
    require((h, w, oh, ow) == (386, 1280, 416, 1280),
            f'KITTI frames {(h, w)} padded to {(oh, ow)}')
    print(f'KITTI kernels: {N_STREAMS} streams of {KITTI_H}x{KITTI_W} '
          f'resized to {h}x{w}, padded to {oh}x{ow}; stage outputs '
          f'{oh // 4}x{ow // 4}, {oh // 8}x{ow // 8}, {oh // 16}x{ow // 16}',
          flush=True)
    res, _ = check_kernels(model, [f[0] for f in streams],
                           [f[1] for f in streams], device)
    img, disp_u16 = to_card([f[0] for f in streams], device)
    widths = check_stem_widths(img, disp_u16, oh, ow)
    del img, disp_u16
    stage_widths = check_stage_widths(N_STREAMS, oh, ow, device)

    one = [to_card([f], device) for f in resized_frames(
        N_FRAMES, KITTI_H, KITTI_W, scale, 500)]
    r1 = replayed_run(model, one, 0, 'KITTI one stream',
                      dict(PER_STEP, stage3=0))
    ms = MultiStreamTracker(mot, N_STREAMS, module=model.module,
                            device=device)
    steps = [to_card([streams[s][t] for s in range(N_STREAMS)], device)
             for t in range(N_STEPS)]
    r8 = replayed_run(ms, steps, N_STREAMS, 'KITTI 8 streams',
                      dict(PER_STEP, stage3=0))
    # the NMS inputs checked above are those of step 1: both labels kept
    step1 = r8['results'][1]
    labels = set(step1.det_labels[step1.det_valid].tolist())
    require(labels == {0, 1}, f'KITTI: step 1 kept labels {labels}')
    for what, r in (('one stream', r1), ('8 streams', r8)):
        print(f'KITTI {what}: ms per step {[round(x, 2) for x in r["per_step"]]}; host syncs per '
              f'step {r["syncs"]}; replayed == eager (ids exact, boxes '
              f'within {r["err"]:.3g} px)', flush=True)
    print(f'KITTI ({card}): one stream {r1["ms"]:.2f} ms per frame (median '
          f'of frames 2-{N_FRAMES - 1}), 8 streams {r8["ms"]:.2f} ms per '
          f'step = {N_STREAMS / r8["ms"] * 1e3:.1f} stereo pairs/s, '
          f'replayed; labels kept at step 1: {sorted(labels)}', flush=True)

    bf = float(cfg['model']['baseline']) * float(cfg['model']['focal_length'])
    data = MemoryDataset(2, 6, KITTI_H, KITTI_W, bf)
    counts = ('CLR_TP', 'CLR_FP', 'CLR_FN', 'IDSW', 'MOTA', 'IDF1')
    with tempfile.TemporaryDirectory() as tmp:
        got = eval_loops(model, data, cfg, [], device, tmp, counts,
                         n_classes=2, what='KITTI float32')
    apart = [k for k in counts
             if got['sequential'][0][k] != got['streams 2'][0][k]]
    require(not apart, f'KITTI eval: {apart} differ between the loops')
    rows = json_rows(res)
    rows['stem']['widths'] = json_rows(widths)
    for stage, by_c in stage_widths.items():
        rows[stage]['widths'] = json_rows(by_c)
    return rows, [r1['job'], r8['job']]


def path_kernels(model, raw, device, what):
    """A path without stage kernels: its depth, JV and NMS kernels against
    their plain versions on the inputs that the path hands them at its
    second step over one stream's ``raw`` frames (``check_path_kernels``).
    Returns {'<what>_<H>x<W>': JSON rows} at the padded frame shape."""
    from stereotracking_tpu_torch.models.preprocessor import padded_shape
    oh, ow = padded_shape(*raw[0][0].shape[:2])
    print(f'{what} kernels: one stream of {oh}x{ow} (padded), the '
          f'{model.cfg.detector.backbone!r} backbone\'s candidates',
          flush=True)
    res, _ = check_path_kernels(model, [raw[0]], [raw[1]], device)
    return {f'{what}_{oh}x{ow}': json_rows(res)}


def run_mono(device, card):
    """Phase 12b: the monocular config (single backbone, every stage on the
    modules) over 6 frames of 1080x1920 resized to 720x1280 (padded to
    736x1280): depth, JV and NMS held against their plain versions on the
    path's own inputs; replayed, 0 host syncs, equal to the eager step; an
    explicit ``stem_backend='cuda'`` must raise in ``build_mot_config``.
    Returns its raw frames, the kernel rows and the trace job."""
    from stereotracking_tpu_torch.apis.builder import (build_model,
                                                       build_mot_config)
    from stereotracking_tpu_torch.models.csp_darknet import StageBackends
    cfg = load_cfg(MONO_CONFIG)
    bad = dict(cfg['model'], stem_backend='cuda')
    try:
        build_mot_config(bad, device)
    except ValueError as e:
        print(f'mono: stem_backend=\'cuda\' refused: {e}', flush=True)
    else:
        raise SmokeFailure("mono: build_mot_config took stem_backend='cuda'")
    model = build_model(cfg, device=device, seed=SEED + 12)
    set_head_bias(model.module, HEAD_BIAS)
    require(model.cfg.detector.backbone == 'single'
            and model.cfg.backends == StageBackends(),
            f'mono config: {model.cfg.detector}, {model.cfg.backends}')
    raw = resized_frames(N_FRAMES, FRAME_H, FRAME_W,
                         tuple(cfg['img_scale']), 600)
    rows = path_kernels(model, raw, device, 'mono')
    frames = [to_card([f], device) for f in raw]
    r = replayed_run(model, frames, 0, 'mono one stream',
                     no_stage_kernels(model.cfg))
    print(f'mono ({card}): {r["ms"]:.2f} ms per frame (median of frames '
          f'2-{N_FRAMES - 1}) at {tuple(frames[0][0].shape[1:3])}, replayed; '
          f'ms per step {[round(x, 2) for x in r["per_step"]]}; host syncs per step {r["syncs"]}; '
          f'replayed == eager (ids exact, boxes within {r["err"]:.3g} px)',
          flush=True)
    return raw, rows, r['job']


def run_concat(device, raw):
    """Phase 12c: the flagship config with the V0 concatenated backbone
    over 2 of the monocular phase's raw frames: depth, JV and NMS held
    against their plain versions on the path's own inputs; replayed,
    equal to the eager step; its 'auto' stage keys move to the modules
    with one warning.  Returns the kernel rows and the trace job."""
    from stereotracking_tpu_torch.apis.builder import build_model
    cfg = flagship_cfg()
    cfg['model']['detector']['backbone']['type'] = \
        'YOLOXCSPDarknet_Disparity_V0_MMYOLO'
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter('always')
        model = build_model(cfg, device=device, seed=SEED + 13)
    said = [str(w.message) for w in caught if 'stage kernel' in
            str(w.message)]
    require(len(said) == 1 and model.cfg.detector.backbone == 'concat',
            f'concat: {model.cfg.detector.backbone}, warnings {said}')
    set_head_bias(model.module, HEAD_BIAS)
    rows = path_kernels(model, raw, device, 'concat')
    frames = [to_card([f], device) for f in raw[:2]]
    r = replayed_run(model, frames, 0, 'concat one stream',
                     no_stage_kernels(model.cfg))
    print(f'concat: builder: {said[0]}; ms per step {[round(x, 2) for x in r["per_step"]]}; host '
          f'syncs per step {r["syncs"]}; replayed == eager (ids exact, boxes '
          f'within {r["err"]:.3g} px)', flush=True)
    return rows, r['job']


def run_train_single(device, batches, card):
    """Phase 12d: the single backbone (the monocular config's detector, full
    width, float32) in train mode: one warm-up and OTHER_TRAIN_STEPS timed
    ``train_step``s at batch 8 of 736x1280 on phase 9's batches, the image
    only; finite losses, ms per step."""
    import torch
    from stereotracking_tpu_torch.apis.builder import build_detector_config
    from stereotracking_tpu_torch.train.losses import YOLOXLossConfig
    from stereotracking_tpu_torch.train.schedules import yolox_schedule
    from stereotracking_tpu_torch.train.train_state import train_step
    det_cfg = build_detector_config(load_cfg(MONO_CONFIG)['model'][
        'detector'])
    require(det_cfg.backbone == 'single', f'train: {det_cfg}')
    state = train_state(device, det_cfg, yolox_schedule(
        0.001 / 8 * TRAIN_BATCH, steps_per_epoch=100))
    loss_cfg = YOLOXLossConfig(num_classes=det_cfg.num_classes)
    mono = [{k: v for k, v in b.items() if k != 'disp_postp'}
            for b in batches]
    losses = [train_step(state, mono[0], loss_cfg)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(OTHER_TRAIN_STEPS):
        losses.append(train_step(state, mono[i % 2], loss_cfg))
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / OTHER_TRAIN_STEPS * 1e3
    train_losses_finite(losses, 'train single')
    print(f'train single ({card}): {OTHER_TRAIN_STEPS} steps of batch '
          f'{TRAIN_BATCH} x {TRAIN_H}x{TRAIN_W} float32 (TF32 off), the image '
          f'only, after 1 warm-up step: {ms:.2f} ms/step; losses '
          f'{[round(float(x["loss"]), 4) for x in losses]}', flush=True)
    return ms


def run_other_configs(device, batches):
    """Phase 12: the KITTI, monocular and concatenated configs and the
    single backbone's train step.  Returns {'<config>_<H>x<W>': kernel
    rows} and the trace jobs (phase 10 traces them: the single and concat
    paths' counts by ``no_stage_kernels``, the flagship's for KITTI's)."""
    from stereotracking_tpu_torch.tools.bench_train import card_name
    card = card_name()
    t0 = time.perf_counter()
    kitti, jobs = run_kitti(device, card)
    rows = {'kitti_416x1280': kitti}
    raw, mono, job = run_mono(device, card)
    rows.update(mono)
    jobs.append(job)
    concat, job = run_concat(device, raw)
    rows.update(concat)
    jobs.append(job)
    run_train_single(device, batches, card)
    print(f'other configs: {time.perf_counter() - t0:.1f} s', flush=True)
    return rows, jobs


def profile_train(device):
    """``--profile``: a torch.profiler window of two train steps (stage 1)
    of phase 9's detector and batches, built anew, each kernel's device
    time assigned to the phase (``train.forward``, ``train.loss``,
    ``train.backward``, ``train.optimizer_ema``) during whose host range it
    was launched, from the exported trace's correlation ids (the main
    thread waits inside ``backward`` while the autograd thread
    launches)."""
    import tempfile

    import torch
    from torch.profiler import ProfilerActivity, profile
    from stereotracking_tpu_torch.apis.builder import build_detector_config
    from stereotracking_tpu_torch.tools.bench_train import staged_batches
    from stereotracking_tpu_torch.train.losses import YOLOXLossConfig
    from stereotracking_tpu_torch.train.schedules import yolox_schedule
    from stereotracking_tpu_torch.train.train_state import train_step
    state = train_state(device, build_detector_config(
        flagship_cfg()['model']['detector']), yolox_schedule(
        0.001 / 8 * TRAIN_BATCH, steps_per_epoch=100))
    batches = staged_batches(TRAIN_BATCH, TRAIN_H, TRAIN_W, device)
    cfg = YOLOXLossConfig()
    train_step(state, batches[0], cfg)
    torch.cuda.synchronize()
    phases = ('train.forward', 'train.loss', 'train.backward',
              'train.optimizer_ema')
    for _ in range(3):         # the profiler now and then drops device events
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for i in range(2):
                train_step(state, batches[i], cfg)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e6
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, 'trace.json')
            prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)['traceEvents']
        ranges = [(e['ts'], e['ts'] + e['dur'], e['name']) for e in events
                  if e.get('cat') == 'user_annotation'
                  and e.get('name') in phases]
        launch = {e['args']['correlation']: e['ts'] for e in events
                  if e.get('cat') in ('cuda_runtime', 'cuda_driver')
                  and 'correlation' in e.get('args', {})}
        device = [e for e in events
                  if e.get('cat') in ('kernel', 'gpu_memcpy', 'gpu_memset')]
        if device and len(ranges) == 2 * len(phases):
            break
    else:
        raise SmokeFailure('train profile: no device events or phase ranges '
                           'in 3 traces')
    split = dict.fromkeys(phases + ('other',), 0.0)
    for e in device:
        ts = launch.get(e.get('args', {}).get('correlation'))
        name = next((n for a, b, n in ranges
                     if ts is not None and a <= ts <= b), 'other')
        split[name] += e['dur']
    total = sum(split.values())
    print(f'profile train: 2 steps of batch {TRAIN_BATCH} x '
          f'{TRAIN_H}x{TRAIN_W}: device time {total / 2 / 1e3:.2f} ms per '
          f'step of {wall / 2 / 1e3:.2f} ms wall (busy '
          f'{100 * total / wall:.1f}%); by phase, ms per step: '
          + ', '.join(f'{k} {v / 2 / 1e3:.2f}' for k, v in split.items()),
          flush=True)
    rows = sorted(((getattr(e, 'device_time_total', 0) or
                    getattr(e, 'cuda_time_total', 0), e.count, e.key)
                   for e in prof.key_averages()), reverse=True)
    for us, cnt, key in [r for r in rows if r[0] > 0
                         and not r[2].startswith(('aten::', 'train.'))][:15]:
        print(f'profile train: {us / 2:12.1f} us/step {cnt // 2:5d}x '
              f'{key[:90]}', flush=True)
    return split



# ------------------------------------------------------- camera motion ----

CMC_CONFIG = os.path.join(REPO, 'configs', 'mot', 'ocsort',
                          'yolox_s_ocsort_monocular_cmc.py')
CMC_FRAMES = 8
CMC_SHIFT = (-8, 15)     # (dy, dx) px a frame the scene moves in the image
# the JAX test's bounds on a recovered camera motion (tests/test_gmc.py):
# translation within 2.5 px, the linear part within 0.05 of the identity
CMC_T_TOL, CMC_R_TOL = 2.5, 0.05


def panning_frames(n, h, w, shift, seed):
    """n raw (img, disp) frames of a camera panning over a scene of 8-px
    random blocks with make_frames' bright rectangles: frame t shows the
    scene moved by t * ``shift`` (dy, dx) px; the disparity (a monocular
    config ignores it) valid and constant."""
    import numpy as np
    rng = np.random.RandomState(seed)
    pad = max(abs(shift[0]), abs(shift[1])) * n + 8
    hh, ww = h + 2 * pad, w + 2 * pad
    base = rng.randint(0, 256, (hh // 8 + 1, ww // 8 + 1, 3), np.uint8)
    scene = np.repeat(np.repeat(base, 8, 0), 8, 1)[:hh, :ww].copy()
    for _ in range(12):
        y, x = rng.randint(0, hh - 40), rng.randint(0, ww - 60)
        scene[y:y + 30, x:x + 40] = rng.randint(100, 255, 3, np.uint8)
    disp = np.full((h, w), 320, np.uint16)
    frames = []
    for t in range(n):
        y0, x0 = pad - t * shift[0], pad - t * shift[1]
        frames.append((np.ascontiguousarray(scene[y0:y0 + h, x0:x0 + w]),
                       disp))
    return frames


def cmc_chain_graph(cmc, img, device):
    """The camera-motion chain of one stream (``mot.camera_warp``: gray,
    histogram, block matching, the RANSAC draws and fits) captured alone
    in a CUDA graph over input buffers: (graph, img buffer, frame-id
    buffer, its state, its (warp, on) outputs)."""
    import torch
    from stereotracking_tpu_torch.models.mot import (camera_warp,
                                                     init_cmc_state)
    buf = img.clone()
    fid = torch.zeros(1, dtype=torch.int32, device=device)
    state = init_cmc_state(cmc, device, 1)
    side = torch.cuda.Stream(device=device)
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        camera_warp(cmc, state, buf, fid)                    # warm-up
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        out = camera_warp(cmc, state, buf, fid)
    state.prev.zero_()
    state.has_prev.fill_(False)
    return graph, buf, fid, state, out


def check_cmc_chain(cmc, frames, device):
    """The chain replayed from its own graph against ``camera_warp`` run
    eagerly on the same frames: warps and flags exact, 0 host syncs in a
    replay; the warp on from frame 1 and the known shift recovered within
    the JAX test's bounds.  Returns the warps and the chain's device time
    per frame (torch.profiler, 4 replays)."""
    import torch
    from stereotracking_tpu_torch.models.mot import (camera_warp,
                                                     init_cmc_state)
    # the graph writes its state's tensors: they stay referenced here
    graph, buf, fid, state, out = cmc_chain_graph(cmc, frames[0][0], device)
    eager = init_cmc_state(cmc, device, 1)
    warps = []
    for t, (img, _) in enumerate(frames):
        buf.copy_(img)
        fid.fill_(t)
        graph.replay()
        w_r, on_r = out[0].clone(), out[1].clone()
        w_e, on_e = camera_warp(cmc, eager, img, [t])
        require(torch.equal(w_r, w_e) and torch.equal(on_r, on_e),
                f'cmc frame {t}: replayed warp {w_r.tolist()} '
                f'({on_r.tolist()}) != eager {w_e.tolist()} '
                f'({on_e.tolist()})')
        require(bool(on_r[0]) == (t > 0), f'cmc frame {t}: warp on '
                f'{on_r.tolist()}')
        warps.append(w_r[0].cpu())
    dy, dx = CMC_SHIFT
    for t, w in enumerate(warps[1:], 1):
        dt = (float(w[0, 2]) - dx, float(w[1, 2]) - dy)
        dr = float((w[:, :2] - torch.eye(2)).abs().max())
        require(max(map(abs, dt)) <= CMC_T_TOL and dr <= CMC_R_TOL,
                f'cmc frame {t}: warp {w.tolist()} against the applied '
                f'shift (dx, dy) = {(dx, dy)}')
    syncs = count_syncs(graph.replay)
    require(syncs == 0, f'cmc chain: {syncs} host syncs in a replay')
    ks = device_kernels(graph.replay, 4)
    us = sum(t for _, t in ks) / 4
    del graph, state
    print(f'cmc chain (one stream, {tuple(frames[0][0].shape[1:3])}): '
          f'replayed == eager (warps and flags exact) over {len(frames)} '
          f'frames; 0 host syncs; applied shift (dx, dy) = {(dx, dy)} px, '
          f'recovered ' + ', '.join(
              f'({float(w[0, 2]):.3f}, {float(w[1, 2]):.3f})'
              for w in warps[1:]) + f'; device time {us / 1e3:.4f} ms per '
          f'frame in {len(ks) / 4:.0f} kernels (torch.profiler, kernels of '
          f'one replay)', flush=True)
    return warps, us / 1e3


def cmc_eval_cli(module, device, card):
    """The eval CLI (``tools.test.main``) with the CMC config on the
    synthetic on-disk dataset (``tests/synthetic_dataset``: 2 videos x 8
    frames of 544x960), ``module``'s weights through a ``.pth``, with
    ``--interpolate`` and ``--aflink`` (a checkpoint that the port's AFLink
    trainer writes in 30 steps on the card), and once without them; the
    count metrics printed."""
    import tempfile

    import torch
    from stereotracking_tpu_torch.tools import test as cli
    from stereotracking_tpu_torch.train.train_aflink import (save_aflink,
                                                             train_aflink)
    sys.path.insert(0, os.path.join(REPO, 'tests'))
    from synthetic_dataset import write_airdrone_dataset
    keys = ('CLR_TP', 'CLR_FP', 'CLR_FN', 'IDSW', 'Frag', 'MOTA', 'IDF1')
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        sd, acc = train_aflink(seed=SEED, steps=30, batch=64, log_every=0,
                               device=device)
        pt = os.path.join(tmp, 'aflink.pt')
        save_aflink(pt, sd)
        print(f'cmc eval: AFLink trained 30 steps of batch 64 on {device} '
              f'in {time.perf_counter() - t0:.1f} s, held-out accuracy '
              f'{acc:.3f}', flush=True)
        pth = os.path.join(tmp, 'mono.pth')
        torch.save({'state_dict': {f'detector.{k}': v.cpu() for k, v in
                                   module.state_dict().items()}}, pth)
        data = os.path.join(tmp, 'data')
        write_airdrone_dataset(data, n_videos=2, n_frames=8, h=544, w=960)
        cfg = os.path.join(tmp, 'cmc.py')
        with open(cfg, 'w') as f:
            f.write(f"_base_ = ['{CMC_CONFIG}']\n"
                    f"img_scale = (544, 960)\n"
                    f"test_dataloader = dict(dataset=dict(data_root="
                    f"'{data}/', ann_file='annotations.json', "
                    f"img_prefix=''))\n")
        got = {}
        for what, flags in (('--interpolate --aflink',
                             ['--interpolate', '--aflink', pt]),
                            ('no post-processing', [])):
            m = cli.main([cfg, '--device', str(device), '--checkpoint', pth,
                          '--work-dir', os.path.join(tmp, 'w'), *flags])
            got[what] = m
            require(m['CLR_TP'] + m['CLR_FN'] > 0, f'cmc eval {what}: {m}')
            print(f'cmc eval ({card}) {what}: ' + ', '.join(
                f'{k} {m[k]:.4f}' for k in keys) + f', fps {m["fps"]:.1f}',
                flush=True)
        try:
            cli.main([cfg, '--device', str(device), '--streams', '2',
                      '--work-dir', os.path.join(tmp, 'w')])
        except NotImplementedError as e:
            print(f'cmc eval: --streams 2 refused: {e}', flush=True)
        else:
            raise SmokeFailure('cmc eval: --streams 2 took a CMC config')
    return got


def cmc_opencv(model, raw, device):
    """Whether OpenCV imports here; where it does, 3 frames of the
    ``backend='opencv'`` route (the host's Farneback warp fed into the
    replayed step), outputs finite, warp found from frame 1."""
    import torch
    from stereotracking_tpu_torch.models.mot import OCSORTDisparity
    try:
        import cv2
    except ImportError as e:
        print(f'cmc opencv: cv2 does not import on this machine ({e}); '
              f"the backend='opencv' route was not run", flush=True)
        return None
    cfg = model.cfg._replace(cmc=model.cfg.cmc._replace(backend='opencv'))
    one = OCSORTDisparity(cfg, module=model.module, device=device)
    ms = []
    for t, (img, disp) in enumerate(raw[:3]):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = one.track_raw(img, disp, t)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        check_result(r, (), cfg.tracker.num_dets, f'cmc opencv {t}')
    warp, on = one._host_warp(raw[3][0], 3)
    print(f'cmc opencv: cv2 {cv2.__version__}; 3 frames replayed, ms per '
          f'frame (host warp included) {[round(x, 2) for x in ms]}; the '
          f'host warp of frame 3: on {bool(on[0])}, '
          f'{warp[0].round(3).tolist()}', flush=True)
    return ms


def run_cmc(device, card):
    """Phase 13: the moving-camera config (``yolox_s_ocsort_monocular_cmc.
    py``, ``backend='device'``) at 1080p through ``init_model`` ->
    ``track_raw``: 8 frames of a camera panning by a known shift, the step
    replayed from its CUDA graph (no wrapper launch), 0 host syncs, equal to
    the eager step (ids exact); the chain alone replayed equal to eager
    (warps exact) and the shift recovered; ms per frame with and without
    the camera-motion chain on the same frames and the chain's device time
    (findings); the eval CLI with ``--interpolate`` and ``--aflink``; and
    the opencv route where cv2 imports.  Returns the trace job."""
    from stereotracking_tpu_torch.apis.inference import init_model
    from stereotracking_tpu_torch.models.mot import OCSORTDisparity
    t_start = time.perf_counter()
    model = init_model(CMC_CONFIG, device=device)
    set_head_bias(model.module, HEAD_BIAS)
    cmc = model.cfg.cmc
    require(cmc is not None and cmc.backend == 'device'
            and model.cfg.detector.backbone == 'single',
            f'cmc config: {model.cfg.cmc}, {model.cfg.detector.backbone}')
    raw = panning_frames(CMC_FRAMES, FRAME_H, FRAME_W, CMC_SHIFT, 1300)
    frames = [to_card([f], device) for f in raw]
    want = no_stage_kernels(model.cfg)
    r = replayed_run(model, frames, 0, 'cmc one stream', want)
    plain = OCSORTDisparity(model.cfg._replace(cmc=None),
                            module=model.module, device=device)
    r0 = replayed_run(plain, frames, 0, 'cmc off one stream', want)
    n_ids = {i for res in r['results']
             for i in res.track_ids[res.track_valid].tolist()}
    require(len(n_ids) > 0, 'cmc: no track id assigned')
    _, chain_ms = check_cmc_chain(cmc, frames, device)
    print(f'cmc ({card}): {CMC_FRAMES} frames of {FRAME_H}x{FRAME_W}, '
          f'{len(n_ids)} track ids; replayed ms per frame with the chain '
          f'{r["ms"]:.2f}, without {r0["ms"]:.2f} (medians of frames '
          f'2-{CMC_FRAMES - 1}, the same frames and weights); eager '
          f'{r["eager_ms"]:.2f} and {r0["eager_ms"]:.2f}; the chain\'s '
          f'device time {chain_ms:.4f} ms; host syncs per step {r["syncs"]};'
          f' replayed == eager (ids exact, boxes within {r["err"]:.3g} px)',
          flush=True)
    cmc_eval_cli(model.module, device, card)
    cmc_opencv(model, raw, device)
    print(f'cmc: {time.perf_counter() - t_start:.1f} s', flush=True)
    # phase 10 counts the launches over the first 3 steps: the chain's many
    # small kernels a step make a long trace slow to read
    return {k: v[:3] if k in ('frames', 'ids', 'results') else v
            for k, v in r['job'].items()}


def run_probe():
    """Phase 11: the stage-1 kernel's variants at 8 streams."""
    from stereotracking_tpu_torch import _kernels
    from stereotracking_tpu_torch.ops.stage1_cuda import PRODUCTION
    from stereotracking_tpu_torch.tools.probe_stage1_variants import \
        run_probe as probe
    _kernels.reset_launch_counts()
    out = probe(N_STREAMS, FRAME_H, FRAME_W, SEED)
    launches = _kernels.launch_counts()['stage1_variants']
    print('probe: ' + json.dumps({k: out[k] for k in sorted(out)}),
          flush=True)
    require(launches > 0, 'probe: no variant launched')
    print(f'probe: production {PRODUCTION} {out[f"{PRODUCTION}_ms"]:.4f} ms '
          f'vs the wmma 16x16 region it replaced '
          f'{out["r16x16_wmma_ms"]:.4f} ms: '
          f'{out["r16x16_wmma_ms"] / out[f"{PRODUCTION}_ms"]:.2f}x',
          flush=True)
    return launches, out, PRODUCTION


def main():
    import torch
    if not torch.cuda.is_available():
        raise SmokeFailure('torch.cuda.is_available() is False: this check '
                           'needs an NVIDIA GPU')
    if not os.path.isdir(os.path.join(REPO, 'stereotracking_tpu_torch')):
        raise SmokeFailure('run from a checkout of the repository: '
                           'stereotracking_tpu_torch/ not found beside '
                           'this script')
    sys.path.insert(0, REPO)
    from stereotracking_tpu_torch import _kernels
    from stereotracking_tpu_torch.models.preprocessor import padded_shape
    t_start = time.perf_counter()
    device = torch.device('cuda', 0)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader', '--id=0'],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f'device: {torch.cuda.get_device_name(0)}; {card}; torch '
          f'{torch.__version__}, CUDA {torch.version.cuda}', flush=True)

    t0 = time.perf_counter()
    path = _kernels.build()
    _kernels.library()
    print(f'build: {path.name} in {time.perf_counter() - t0:.1f} s '
          f'(nvcc {_kernels.build_seconds})', flush=True)
    laps = [time.perf_counter()]

    def lap(what):
        """Seconds since the last lap, printed: where the run's time goes."""
        laps.append(time.perf_counter())
        print(f'time: {what} {laps[-1] - laps[-2]:.1f} s', flush=True)

    for name, lines in _kernels.ptxas_usage(
            sorted({KERNELS[k][0] for k in REDESIGNED})).items():
        for line in lines:
            print(f'ptxas {name}: {line}', flush=True)

    lap('ptxas')
    model = build_flagship(device)
    two = [make_frames(2, FRAME_H, FRAME_W, 100 + s) for s in range(N_STREAMS)]
    streams, nexts = [f[0] for f in two], [f[1] for f in two]
    _, trace_one = check_kernels(model, streams[:1], nexts[:1], device)
    res, trace = check_kernels(model, streams, nexts, device)
    img, disp_u16 = to_card(streams, device)
    res['stem']['widths'] = check_stem_widths(
        img, disp_u16, *padded_shape(FRAME_H, FRAME_W))
    for stage, rows in check_stage_widths(
            N_STREAMS, *padded_shape(FRAME_H, FRAME_W), device).items():
        res[stage]['widths'] = rows
    # the flagship only: the depth kernel also on synthetic boxes at every
    # pyramid level and through every vote branch
    res['depth']['synthetic'], depth_trace = check_depth(
        model.cfg, img, disp_u16, *padded_shape(FRAME_H, FRAME_W), device,
        10)
    del two, nexts, img, disp_u16
    lap('kernels (phase 3)')
    check_small_reference(model, device)
    slice_frames = make_frames(N_FRAMES, FRAME_H, FRAME_W, SEED)
    slice_job = run_slice(model, slice_frames, device)
    lap('reference and slice (phases 4-5)')
    mixed_jobs = run_mixed(model, slice_frames[:2], device)
    lap('mixed backends (phase 5)')
    f32 = run_multistream(model, device)
    bf16 = run_bf16(model, device, f32)
    tiny_jobs = run_tiny_bf16(device, f32['steps'])
    replay_cost(f32['mot'].tracker, device, N_STREAMS)
    replay_cost(f32['mot'].tracker, device, 1)
    lap('multi-stream and bf16 (phases 6-7)')
    run_eval(model, device)
    lap('eval (phase 8)')
    state, batches = run_train(device)
    check_train_on_cpu(device)
    serve_export(state, device)
    lap('train (phase 9)')
    del state
    other_rows, other_jobs = run_other_configs(device, batches)
    del batches
    lap('other configs (phase 12)')
    other_jobs.append(run_cmc(device, card))
    lap('moving camera (phase 13)')
    # the main paths' launches, from torch.profiler traces of their replayed
    # steps, after the timed phases: a profiler session slows the host work
    # of the process after it
    # the depth, JV and NMS kernels' torch.profiler figures, after the
    # timed phases (a profiler session slows the host work of the process
    # after it) and before phase 10's traces and --profile's windows (after
    # many sessions the profiler drops device events)
    trace_one()
    trace()
    depth_trace()
    lap('kernel device times')
    for job in [slice_job] + mixed_jobs + [bf16['job']] + tiny_jobs + \
            other_jobs:
        trace_launches(**job)
    counts = trace_launches(**f32['job'])
    del slice_job, mixed_jobs, tiny_jobs
    if '--profile' in sys.argv[1:]:
        for job in other_jobs:          # the traced steps' ids, continued
            n = len(job['frames'])
            profile_steps(lambda t, job=job, n=n: job['tracker'].track_raw(
                *job['frames'][t], [n + t] * N_STREAMS
                if isinstance(job['ids'][0], list) else n + t), job['what'])
        one = [to_card([f], device) for f in slice_frames[:2]]
        profile_steps(lambda t: model.track_raw(one[t][0][0], one[t][1][0],
                                                N_FRAMES + 1 + t),
                      'one stream float32')
        for what, run in (('float32', f32), ('bf16', bf16)):
            profile_steps(lambda t: run['tracker'].track_raw(
                *f32['steps'][t], [N_STEPS + 1 + t] * N_STREAMS),
                f'8 streams {what}')
        del one
    del other_jobs, f32, bf16
    lap('launch traces (phase 10)')
    probe_launches, probe, prod = run_probe()
    lap('probe (phase 11)')
    if '--profile' in sys.argv[1:]:
        # last: a trace this large left the profiler dropping every device
        # event in the sessions after it
        profile_train(device)
    counts['stage1_variants'] = probe_launches
    res['stage1_variants'] = dict(
        max_abs_err=max(v for k, v in probe.items() if k.endswith('_maxerr')),
        ms=probe[f'{prod}_ms'], plain_ms=res['stage1']['plain_ms'],
        bound_ms=res['stage1']['bound_ms'],
        bound_by=res['stage1']['bound_by'], library_ms=None)
    print(f'smoke: {time.perf_counter() - t_start:.1f} s in all', flush=True)

    for config, rows in other_rows.items():
        for name, row in rows.items():
            res[name][config] = row
    kernels = [dict(name=name, route='cuda', source=src, replaces=rep,
                    launches=counts[name], **res[name])
               for name, (src, rep) in KERNELS.items()]
    print(card)
    print(json.dumps({'kernels': kernels}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))


if __name__ == '__main__':
    try:
        main()
    except SmokeFailure as e:
        print(f'chip_smoke: FAILED: {e}', file=sys.stderr)
        sys.exit(1)
