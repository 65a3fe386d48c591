#!/usr/bin/env python3
"""Drive the PyTorch port's paths once on one NVIDIA GPU.

    python3 chip_smoke.py [--profile]

Phases, in order; any failure exits non-zero:

1. device: requires ``torch.cuda.is_available()``; prints the card's
   ``nvidia-smi`` name and power limit; turns TF32 off for the float32
   reference computations;
2. build: compiles the CUDA kernels from ``stereotracking_tpu_torch/csrc``
   (one nvcc per source, all at once, sm_90a) and prints the build time;
   compiles the sources of the kernels redesigned for the H100 (the stem,
   stages 1-3, depth, the JV and NMS) once more with ``-Xptxas -v`` and
   prints their registers, shared memory and spills;
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
   after it;
4. reference: on a small frame the kernel path's head outputs (stage 3
   through its kernel too) must agree with the float32 module path;
5. slice: ``build_model(flagship config)`` on the card, ``track_raw`` over
   6 synthetic 1080p frames, replayed from the step's CUDA graph (captured
   by a first call, the state then reset); no wrapper launches a kernel
   during the replays; outputs finite; no host sync in a frame; the same
   frames through the eager step (``predict_frames_batched``) equal (ids
   and validity exact, boxes within 1e-2 px) and timed beside the replays;
   then over 2 frames each the stem and stage-1 kernels with stage 2 on
   the float32 modules, and a widen-0.25 config with every stage 'auto'
   (the stem kernel only; the builder's warning for stage 1 printed);
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
   replay alone (one CUDA graph) at 8 and one stream;
8. eval: the eval CLI's loop (``stereotracking_tpu_torch.tools.test.
   evaluate``) over 2 videos x 6 frames of 1080x1920 held in memory (ground
   truth: the rectangles ``make_frames`` draws), weights through
   ``init_model`` from a ``.pth`` written to a temporary directory;
   sequentially and with ``--streams 2 --stage-frames``, in float32 and with
   ``--bf16``: the count metrics of the two loops must be equal; pairs/s;
   no host sync per step besides the result fetch; then ``inference_mot``
   over 2 frames must equal ``track_raw`` (ids exact, boxes within 1e-3
   px);
9. launches: after the timed phases, each tracker of phases 5-7 is reset
   and its steps replayed again under ``torch.profiler``, the wrappers'
   counts set to 0 just before: the hand-written kernels in the trace must
   be stem 2, stage 1 1, stage 2 1, stage 3 1 (0 in phase 5), depth 2,
   assignment 3 and nms 1 per step (phase 5's backend mixes: stem 2, stage
   1 1 or 0, stages 2-3 0, depth 2, assignment 3, nms 1), the wrappers'
   counts 0 (every step a replay), and ids and validity as in the timed
   run;
10. probe: the stage-1 kernel's six variants at 8 streams, each held to
   the plain version and timed (``tools/probe_stage1_variants.py``), the
   production one beside the wmma 16x16 region it replaced.

``--profile`` adds, after the timed phases, a ``torch.profiler`` window
over two replayed steps of one stream in float32 and of 8 streams in
float32 and in bf16, and prints the device time by kernel, the card's busy
share and each hand-written kernel's launches and device time per step in
the trace.

Output: the per-phase lines, then the card line and one JSON line of kernel
results (8-stream shapes; launches from the trace of phase 6's replayed
steps, the probe's from the probe run), then, as the last line, ``{"ok":
true, "device": {...}}``.
"""
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
    taken again, up to 3 times."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
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
    raise SmokeFailure('torch.profiler recorded no kernel in 3 traces')


def device_ms(fn, kernel, iters):
    """Mean device milliseconds of the kernel whose name holds ``kernel``,
    one launch per call of ``fn``, over the launches the trace holds (it
    may drop one now and then)."""
    us = [t for name, t in device_kernels(fn, iters) if kernel in name]
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


def check_kernels(model, frames, next_frames, device, iters=10):
    """Phase 3 at S = len(frames) streams: each kernel against its plain
    version, all timed, the assignment and NMS kernels on the inputs the
    main path gives them at its second step (``frames``, then
    ``next_frames``); returns {name: result row} and a function that adds
    the depth, JV and NMS kernels' torch.profiler device times, to call
    after the timed phases."""
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
        k = stem_cuda.focus_stem(frm, wk, sb, oh, ow)
        p = stem_cuda.focus_stem_plain(frm, wk, sb, oh, ow).float()
        require(k.shape == (n, oh // 2, ow // 2, wk.shape[-1]), 'stem shape')
        x = F.pad(stem_cuda.stem_input(frm, oh, ow), (2, 3, 2, 3))
        c = x.shape[1]
        w6 = stem_cuda.stem_hwio(wk, c)
        xs.append((x, w6.permute(3, 2, 0, 1).contiguous()))
        mag = F.conv2d(x.abs(), w6.abs().permute(3, 2, 0, 1), stride=2)
        mag = mag.permute(0, 2, 3, 1) * sb[0].abs()
        tol = 2 ** -7 * p.abs() + 2 * 36 * c * 2 ** -24 * mag
        d = (k.float() - p).abs()
        bad = d > tol
        require(not bool(bad.any()),
                f'stem: {int(bad.sum())} elements beyond tolerance, e.g. '
                f'kernel {k.float()[bad][:4].tolist()} plain '
                f'{p[bad][:4].tolist()} tol {tol[bad][:4].tolist()}')
        err = max(err, float(d.max()))
        worst = max(worst, float((d / tol.clamp_min(1e-30)).max()))
        ops += 2 * k.numel() * 36 * c
        stems.append(k)
    del mag, tol, d, bad, p
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

    # stages: bf16 chains whose roundings may flip by one ulp and carry on,
    # held to 2e-2 of the output's largest magnitude (the JAX package's own
    # stage tolerance, tests/test_stage2_pallas.py)
    def stage_check(name, fn, plain, ins, ks):
        k, p = fn(), plain()
        require(k.shape == p.shape, f'{name} shape {k.shape} vs {p.shape}')
        err = float((k.float() - p.float()).abs().max())
        scale = float(p.float().abs().max())
        require(err <= 2e-2 * scale + 1e-3,
                f'{name}: max_abs_err {err} > 2e-2 * {scale} + 1e-3')
        require(bool(torch.isfinite(k.float()).all()), f'{name} not finite')
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

    res['depth'], depth_trace = check_depth(model.cfg, img, disp_u16, oh, ow,
                                            device, iters)
    ins = nms_jv_inputs(model, frames, next_frames, device)
    res['assignment'], jv_trace = check_assignment(ins['jv'],
                                                   ins['conflicted'], iters)
    res['nms'], nms_trace = check_nms(ins['nms'], ins['suppressing'], iters)

    def trace():
        depth_trace()
        jv_trace()
        nms_trace()

    return res, trace


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
    kd, ksc, ks = dc.box_depths(disp, boxes, valid, crop, bf)
    pd, psc, ps = dc.box_depths_plain(disp, boxes, valid, crop, bf)
    torch.cuda.synchronize()
    # integer statistics exact; float sums within rtol 1e-5 (float32
    # reassociation over up to 9,216 terms); depths and scales within rtol
    # 2e-6, atol 1e-5, as tests/test_depth_pallas.py holds the Pallas kernel
    require(torch.equal(ks[:, :16], ps[:, :16]),
            'depth: integer statistics differ')
    require(torch.allclose(ks[:, 16:], ps[:, 16:], rtol=1e-5, atol=1e-3),
            'depth: sums beyond rtol 1e-5')
    require(torch.equal(kd == -1, pd == -1), 'depth: invalid pattern')
    require(torch.allclose(kd, pd, rtol=2e-6, atol=1e-5)
            and torch.allclose(ksc, psc, rtol=2e-6, atol=1e-5),
            'depth: depths beyond rtol 2e-6')
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

    # what these boxes need: each window pixel read once, the 16 corner
    # pixels, boxes and flags in, depth, scale and stats rows out; per
    # window pixel one exact pass of 7 rank compares and 12 count/sum adds
    # on the CUDA cores (their float32 rate)
    _, inside = dc.box_windows(disp, scal, crop)
    px = int(inside.sum())
    nb = flat.shape[0]
    moved = 4 * px + nb * (16 * 4 + 16 + 1) + nbytes(kd, ksc, ks)
    ops = 19 * px

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
    r['bound_ms'], r['bound_by'] = bound(moved, ops, PEAK_F32)
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
    """The inputs that the main path hands the assignment and NMS kernels:
    two eager steps of ``predict_frames_batched`` over ``frames`` (a list
    of steps, each a list of S (img, disp)), the stage-3 kernel on, with
    the wrappers' arguments of the second step recorded: [(ext, need)] for
    the 3 assignments and (boxes, finite, thr, max_keep) for the NMS."""
    import torch
    from stereotracking_tpu_torch.apis.builder import build_mot_config
    from stereotracking_tpu_torch.models.mot import (predict_frames_batched,
                                                     preprocess_raw)
    from stereotracking_tpu_torch.models.preprocessor import padded_shape
    from stereotracking_tpu_torch.ops import assignment, nms
    from stereotracking_tpu_torch.parallel.multistream import \
        init_stream_states
    mot = build_mot_config(flagship_cfg('cuda')['model'], device)
    n = len(frames[0])
    states = init_stream_states(mot, n, device)
    seen = dict(jv=[], nms=[])
    jv, keep = assignment.jv_assign, nms.nms_keep

    def jv_rec(ext, need):
        seen['jv'].append((ext.clone(), need.clone()))
        return jv(ext, need)

    def nms_rec(boxes, finite, thr, max_keep=None):
        seen['nms'].append((boxes.clone(), finite.clone(), thr, max_keep))
        return keep(boxes, finite, thr, max_keep)

    assignment.jv_assign, nms.nms_keep = jv_rec, nms_rec
    try:
        for t, step in enumerate(frames):
            seen['jv'].clear()
            seen['nms'].clear()
            img, disp = to_card(step, device)
            inputs = preprocess_raw(img, disp, *padded_shape(*img.shape[1:3]))
            states, _ = predict_frames_batched(model.module, states, inputs,
                                               [t] * n, mot)
    finally:
        assignment.jv_assign, nms.nms_keep = jv, keep
    torch.cuda.synchronize()
    return seen['jv'], seen['nms'][0]


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
    (``step_inputs``), the all-conflicted JV problem and the suppressing
    NMS candidates at the same shapes."""
    jv_in, nms_in = step_inputs(model, [frames, next_frames], device)
    n, k, c = jv_in[0][0].shape
    boxes, finite, thr, max_keep = nms_in
    return dict(jv=jv_in, conflicted=conflicted_jv_input(n, k, c, device),
                nms=nms_in, suppressing=suppressing_nms_input(
                    *finite.shape, thr, model.cfg.detector.score_thr,
                    max_keep, device))


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
TRACE_KERNELS = {'stem': 'focus_stem_kernel', 'stage1': 'stage1_mma_kernel',
                 'stage2': 'stage_csp_kernel', 'stage3': 'stage3_chain_kernel',
                 'depth': 'box_depths_kernel', 'assignment': 'jv_kernel',
                 'nms': 'nms_kernel'}


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


def trace_launches(tracker, frames, ids, want, results, what):
    """The main path's launches: ``tracker`` reset and its steps replayed
    over ``frames`` with frame ids ``ids`` under ``torch.profiler``, the
    wrappers' counts set to 0 just before and read just after.  The
    hand-written kernels in the trace must be ``want`` per step (stage 3's
    entry kernel as often as its chain kernel); the wrappers' counts must
    stay 0 (each step a replay); ids and validity must equal ``results``,
    the timed run's.  Returns the launches in the trace."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from stereotracking_tpu_torch import _kernels
    tracker.reset()
    torch.cuda.synchronize()
    _kernels.reset_launch_counts()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        got = [tracker.track_raw(*f, i) for f, i in zip(frames, ids)]
        torch.cuda.synchronize()
    require_replayed(f'{what} (traced)')
    keys = [(e.key, e.count) for e in prof.key_averages()]
    seen = {name: sum(c for k, c in keys if sym in k)
            for name, sym in TRACE_KERNELS.items()}
    entry = sum(c for k, c in keys if 'stage3_entry_kernel' in k)
    require(entry == seen['stage3'], f'{what}: {entry} stage-3 entry '
            f'kernels beside {seen["stage3"]} chain kernels in the trace')
    require_launches(seen, want, len(frames), f'{what} (trace)')
    for t, (a, b) in enumerate(zip(got, results)):
        for name in ('track_ids', 'track_valid', 'det_valid'):
            require(torch.equal(getattr(a, name), getattr(b, name)),
                    f'{what} (traced) step {t}: {name} differs from the '
                    f'timed run')
    print(f'launches {what}: {len(frames)} replayed steps in a '
          f'torch.profiler trace: {seen} (wrappers: 0; ids equal to the '
          f'timed run)', flush=True)
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
    states, frame ids t), each synchronised: (results, ms per step)."""
    import torch
    from stereotracking_tpu_torch.models.mot import (predict_frames_batched,
                                                     preprocess_raw)
    from stereotracking_tpu_torch.models.preprocessor import padded_shape
    from stereotracking_tpu_torch.parallel.multistream import \
        init_stream_states
    states = init_stream_states(cfg, steps[0][0].shape[0], device)
    results, per_step = [], []
    for t, (img, disp) in enumerate(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        inputs = preprocess_raw(img, disp, *padded_shape(*img.shape[1:3]))
        states, r = predict_frames_batched(module, states, inputs,
                                           [t] * img.shape[0], cfg)
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


def run_slice(model, frames, device):
    """Phase 5: the single-stream flagship slice, graph-replayed, counters
    checked, against the eager step."""
    import torch
    from stereotracking_tpu_torch import _kernels
    dev_frames = [to_card([f], device) for f in frames]
    capture_ms = prime(model, dev_frames[0][0][0], dev_frames[0][1][0], 0)
    torch.cuda.synchronize()
    _kernels.reset_launch_counts()
    per_frame, results = [], []
    for f, (img, disp) in enumerate(dev_frames):
        t0 = time.perf_counter()
        r = model.track_raw(img[0], disp[0], f)
        torch.cuda.synchronize()
        per_frame.append((time.perf_counter() - t0) * 1e3)
        results.append(r)
    require_replayed('slice')
    n_ids = set()
    for f, (r, ms) in enumerate(zip(results, per_frame)):
        check_result(r, (), model.cfg.tracker.num_dets, f'frame {f}')
        ids = r.track_ids[r.track_valid].tolist()
        n_ids.update(i for i in ids if i >= 0)
        print(f'frame {f}: {int(r.det_valid.sum())} valid detections, '
              f'{int(r.track_valid.sum())} valid tracks, {ms:.2f} ms',
              flush=True)
    require(len(n_ids) > 0, 'no track id assigned')
    syncs = count_syncs(lambda: model.track_raw(*(x[0] for x in
                                                  dev_frames[0]),
                                                len(frames)))
    require(syncs == 0, f'slice: {syncs} host syncs in a replayed frame')
    eager, eager_ms = eager_steps(model.module, model.cfg, dev_frames,
                                  device)
    err = same_results([r._replace(**{k: v[None] for k, v in
                                      r._asdict().items()})
                        for r in results], eager, 'slice')
    out = dict(ms=median(per_frame[2:]), eager_ms=median(eager_ms[2:]),
               capture_ms=capture_ms)
    print(f'slice: {len(frames)} frames of {FRAME_H}x{FRAME_W}, '
          f'{len(n_ids)} track ids; graph capture (warm-up step included) '
          f'{capture_ms:.2f} ms; replayed ms/frame first two '
          f'{per_frame[0]:.2f} {per_frame[1]:.2f}, frames 2-{len(frames) - 1}'
          f' median {out["ms"]:.2f}; eager median {out["eager_ms"]:.2f} '
          f'(this run); host syncs per frame {syncs}; replayed == eager (ids '
          f'exact, boxes within {err:.3g} px)', flush=True)
    return out, trace_job(model, [(img[0], disp[0]) for img, disp in
                                  dev_frames], list(range(len(frames))),
                          dict(PER_STEP, stage3=0), results, 'slice')


def run_mixed(model, frames, device):
    """Phase 5b: backend mixes over 2 frames each.  One the JAX builder
    accepts: the stem and stage-1 kernels with stage 2 on the float32
    modules.  And a widen-0.25 config (seeded random weights) with every
    stage 'auto': the stem kernel (O = 16) hands over to the float32 stage
    1, whose kernel is built for C = 32 only, and the builder warns that
    'auto' moved stage 1 to the modules (stage 2 follows it there)."""
    import torch
    from stereotracking_tpu_torch import _kernels
    from stereotracking_tpu_torch.apis.builder import build_mot_config
    from stereotracking_tpu_torch.models.csp_darknet import StageBackends
    from stereotracking_tpu_torch.models.mot import OCSORTDisparity
    dev_frames = [to_card([f], device) for f in frames]
    jobs = []
    mixed = flagship_cfg()['model']
    mixed.update(stem_backend='cuda', stage1_backend='cuda',
                 stage2_backend='torch')
    narrow = flagship_cfg()['model']
    narrow['detector']['backbone']['widen_factor'] = 0.25
    for what, cfg, module, backends, moved in (
            ('stem + stage-1 kernels, stage 2-3 modules', mixed,
             model.module, ('cuda', 'cuda', 'torch', 'torch'), ()),
            ("widen 0.25, all 'auto'", narrow, None,
             ('cuda', 'torch', 'torch', 'torch'), ('stage1',))):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter('always')
            mot = build_mot_config(cfg, device)
        said = [str(w.message) for w in caught
                if 'runs on the float32 modules' in str(w.message)]
        require(mot.backends == StageBackends(*backends),
                f'{what}: resolved to {mot.backends}')
        require(sorted(m.split('_backend')[0] for m in said) == list(moved),
                f'{what}: the builder reported {said}')
        one = OCSORTDisparity(mot, module=module, device=device, seed=SEED)
        prime(one, dev_frames[0][0][0], dev_frames[0][1][0], 0)
        torch.cuda.synchronize()
        _kernels.reset_launch_counts()
        results = []
        for f, (img, disp) in enumerate(dev_frames):
            r = one.track_raw(img[0], disp[0], f)
            check_result(r, (), mot.tracker.num_dets, f'{what}, frame {f}')
            results.append(r)
        torch.cuda.synchronize()
        require_replayed(f'mixed ({what})')
        want = {name: per if b == 'cuda' else 0 for name, per, b in zip(
            StageBackends._fields, (2, 1, 1, 1), backends)}
        want.update(depth=2, assignment=3, nms=1)
        jobs.append(trace_job(
            one, [(img[0], disp[0]) for img, disp in dev_frames],
            list(range(len(frames))), want, results, f'mixed ({what})'))
        for m in said:
            print(f'mixed backends ({what}): builder: {m}', flush=True)
        print(f'mixed backends ({what}): {len(frames)} frames replayed',
              flush=True)
    return jobs


def run_steps(ms, steps, what):
    """The timed steps of a primed MultiStreamTracker, each a replay:
    (results, ms per step)."""
    import torch
    from stereotracking_tpu_torch import _kernels
    torch.cuda.synchronize()
    _kernels.reset_launch_counts()
    per_step, results = [], []
    for t, (imgs, disps) in enumerate(steps):
        t0 = time.perf_counter()
        r = ms.track_raw(imgs, disps, [t] * N_STREAMS)
        torch.cuda.synchronize()
        per_step.append((time.perf_counter() - t0) * 1e3)
        results.append(r)
    require_replayed(what)
    for t, r in enumerate(results):
        check_result(r, (N_STREAMS,), ms.cfg.tracker.num_dets,
                     f'{what} step {t}')
    return results, per_step


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
    capture_ms = prime(ms, *steps[0], N_STREAMS)
    results, per_step = run_steps(ms, steps, 'multi-stream')
    n_ids = set()
    for t, r in enumerate(results):
        n_ids.update(r.track_ids[r.track_valid].tolist())
        print(f'step {t}: {int(r.det_valid.sum())} valid detections, '
              f'{int(r.track_valid.sum())} valid tracks over {N_STREAMS} '
              f'streams, {per_step[t]:.2f} ms', flush=True)
    require(len(n_ids - {-1}) > 0, 'multi-stream: no track id assigned')
    syncs = count_syncs(lambda: ms.track_raw(*steps[0], [N_STEPS] * N_STREAMS))
    require(syncs == 0, f'multi-stream: {syncs} host syncs in a replayed '
            f'step')
    eager, eager_ms = eager_steps(model.module, mot, steps, device)
    err = same_results(results, eager, 'multi-stream')
    med, emed = median(per_step[2:]), median(eager_ms[2:])
    print(f'multi-stream: {N_STREAMS} streams x {N_STEPS} steps of '
          f'{FRAME_H}x{FRAME_W}; graph capture (warm-up '
          f'step included) {capture_ms:.2f} ms; replayed ms/step first two '
          f'{per_step[0]:.2f} {per_step[1]:.2f}, steps 2-{N_STEPS - 1} median '
          f'{med:.2f} ({N_STREAMS / med * 1e3:.1f} stereo pairs/s); eager '
          f'median {emed:.2f} ({N_STREAMS / emed * 1e3:.1f} pairs/s, this '
          f'run); host syncs per step {syncs}; replayed == eager (ids exact, '
          f'boxes within {err:.3g} px)', flush=True)

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
    return dict(ms_per_step=med, pairs_per_s=N_STREAMS / med * 1e3,
                eager_ms_per_step=emed, capture_ms=capture_ms,
                syncs_per_step=syncs, results=results[:N_PARITY],
                steps=steps, mot=mot, tracker=ms,
                job=trace_job(ms, steps, [[t] * N_STREAMS
                                          for t in range(N_STEPS)],
                              PER_STEP, results, 'multi-stream'))


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
    names = tuple(TRACE_KERNELS.values()) + ('stage3_entry_kernel',)
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
    capture_ms = prime(ms, *steps[0], N_STREAMS)
    results, per_step = run_steps(ms, steps, 'bf16')
    syncs = count_syncs(lambda: ms.track_raw(*steps[0], [N_STEPS] * N_STREAMS))
    require(syncs == 0, f'bf16: {syncs} host syncs in a replayed step')
    eager, eager_ms = eager_steps(ms.module, mot, steps, device)
    err = same_results(results, eager, 'bf16')
    med, emed = median(per_step[2:]), median(eager_ms[2:])
    print(f'bf16: {N_STREAMS} streams x {N_STEPS} steps of {FRAME_H}x'
          f'{FRAME_W}; graph capture {capture_ms:.2f} ms; '
          f'replayed ms/step first two {per_step[0]:.2f} {per_step[1]:.2f}, '
          f'steps 2-{N_STEPS - 1} median {med:.2f} ({N_STREAMS / med * 1e3:.1f}'
          f' stereo pairs/s); eager median {emed:.2f} '
          f'({N_STREAMS / emed * 1e3:.1f} pairs/s); float32 replayed (phase '
          f'6, this run) {f32["ms_per_step"]:.2f} ms/step, eager '
          f'{f32["eager_ms_per_step"]:.2f}; host syncs per step {syncs}; '
          f'replayed == eager (ids exact, boxes within {err:.3g} px)',
          flush=True)

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
    return dict(ms_per_step=med, pairs_per_s=N_STREAMS / med * 1e3,
                eager_ms_per_step=emed, syncs_per_step=syncs, tracker=ms,
                job=trace_job(ms, steps, [[t] * N_STREAMS
                                          for t in range(N_STEPS)],
                              PER_STEP, results, 'bf16'))


class MemoryDataset:
    """Videos of ``make_frames`` frames held in memory, with the reader
    interface ``tools/test.evaluate`` takes.  Ground truth: each frame's
    six rectangles, id = drawing order + 100 x video, Z from their
    disparity (focal x baseline / (raw / 16))."""

    def __init__(self, n_videos, n_frames, h, w, bf):
        import numpy as np
        self.h, self.w, self.bf = h, w, bf
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


def run_eval(model, device):
    """Phase 9: the eval CLI's loop (``tools/test.evaluate``) on a dataset
    held in memory (2 videos x 6 frames of 1080x1920, ``img_scale`` the
    frame size), with the flagship config and ``init_model`` weights from a
    ``.pth`` written from the phases' model; sequentially and with
    ``--streams 2 --stage-frames``, in float32 and with ``--bf16``; pairs/s
    and host syncs per step printed.  The count metrics of the two loops
    must be equal: in float32 as run; in bf16 with cuDNN off, since cuDNN's
    bf16 convolutions round differently at batch 1 and 2 (the bf16 runs
    with cuDNN print how far they differ, a finding).  Then ``inference_mot`` over 2 frames must equal
    ``track_raw`` on them (ids exact, boxes within 1e-3 px)."""
    import contextlib
    import tempfile

    import numpy as np
    import torch
    from stereotracking_tpu_torch.apis.inference import (inference_mot,
                                                         init_model)
    from stereotracking_tpu_torch.evaluation import (CocoMAPEvaluator,
                                                     MOTDroneMetrics)
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
            # bf16: cuDNN's bf16 convolutions round differently at batch 1
            # and 2 (tools/batch_invariance.py), so the loops' equality is
            # held with cuDNN off, PyTorch's batch-invariant convolutions
            for cudnn in ((True,) if dtype == 'float32' else (True, False)):
                got = {}
                for mode, extra in (('sequential', []),
                                    ('streams 2', ['--streams', '2',
                                                   '--stage-frames'])):
                    args = cli.parse_args([CONFIG, '--device', str(device),
                                           '--work-dir', tmp] + flags + extra)

                    def run():
                        mot = MOTDroneMetrics(outfile_dir=tmp)
                        coco = CocoMAPEvaluator(num_classes=1)
                        with (contextlib.nullcontext() if cudnn else
                              torch.backends.cudnn.flags(enabled=False)):
                            n, el = cli.evaluate(m, data, videos, args,
                                                 cfg['img_scale'], mot, coco)
                        return n, el, {**mot.evaluate(), **coco.evaluate()}

                    n, elapsed, metrics = run()
                    n_steps = 12 if mode == 'sequential' else 6 + 1  # warm-up
                    syncs = count_syncs(run) / n_steps
                    require(syncs == 0, f'eval {dtype} {mode}: {syncs} host '
                            f'syncs per step besides the result fetch')
                    require(n == 12, f'eval {dtype} {mode}: {n} frames scored')
                    got[mode] = metrics
                    what = f'{dtype} {mode}' + ('' if cudnn else ', cuDNN off')
                    out[what] = dict(pairs_per_s=n / elapsed,
                                     syncs_per_step=syncs)
                    print(f'eval {what}: {n} frames of {FRAME_H}x{FRAME_W} in '
                          f'{elapsed * 1e3:.1f} ms = {n / elapsed:.1f} stereo '
                          f'pairs/s; host syncs per step {syncs:.2f} (torch '
                          f'sync debug mode) + 1 result fetch; '
                          + ', '.join(f'{k} {metrics[k]:.4f}' for k in counts),
                          flush=True)
                apart = [k for k in counts
                         if got['sequential'][k] != got['streams 2'][k]]
                if dtype == 'bf16' and cudnn:
                    print(f'eval finding: bf16 with cuDNN, sequential and '
                          f'streams 2 differ in {apart or "none"} of {counts}',
                          flush=True)
                    continue
                require(not apart, f'eval {dtype}' + (
                    '' if cudnn else ' (cuDNN off)') + f': {apart} differ: '
                    f'sequential {got["sequential"]}, streams 2 '
                    f'{got["streams 2"]}')

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


def run_probe():
    """Phase 7: the stage-1 kernel's variants at 8 streams."""
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
    for name, lines in _kernels.ptxas_usage(
            sorted({KERNELS[k][0] for k in REDESIGNED})).items():
        for line in lines:
            print(f'ptxas {name}: {line}', flush=True)

    model = build_flagship(device)
    two = [make_frames(2, FRAME_H, FRAME_W, 100 + s) for s in range(N_STREAMS)]
    streams, nexts = [f[0] for f in two], [f[1] for f in two]
    _, trace_one = check_kernels(model, streams[:1], nexts[:1], device)
    res, trace = check_kernels(model, streams, nexts, device)
    del two, nexts
    check_small_reference(model, device)
    slice_frames = make_frames(N_FRAMES, FRAME_H, FRAME_W, SEED)
    _, slice_job = run_slice(model, slice_frames, device)
    mixed_jobs = run_mixed(model, slice_frames[:2], device)
    f32 = run_multistream(model, device)
    bf16 = run_bf16(model, device, f32)
    replay_cost(f32['mot'].tracker, device, N_STREAMS)
    replay_cost(f32['mot'].tracker, device, 1)
    run_eval(model, device)
    # the main paths' launches, from torch.profiler traces of their replayed
    # steps, after the timed phases: a profiler session slows the host work
    # of the process after it
    for job in [slice_job] + mixed_jobs + [bf16['job']]:
        trace_launches(**job)
    counts = trace_launches(**f32['job'])
    del slice_job, mixed_jobs
    if '--profile' in sys.argv[1:]:
        # after the timed phases: a profiler session slows the host work of
        # the process after it
        one = [to_card([f], device) for f in slice_frames[:2]]
        profile_steps(lambda t: model.track_raw(one[t][0][0], one[t][1][0],
                                                N_FRAMES + 1 + t),
                      'one stream float32')
        for what, run in (('float32', f32), ('bf16', bf16)):
            profile_steps(lambda t: run['tracker'].track_raw(
                *f32['steps'][t], [N_STEPS + 1 + t] * N_STREAMS),
                f'8 streams {what}')
        del one
    del f32, bf16
    # the depth kernel's torch.profiler figures, after the timed phases: a
    # profiler session slows the host work of the process after it
    trace_one()
    trace()
    probe_launches, probe, prod = run_probe()
    counts['stage1_variants'] = probe_launches
    res['stage1_variants'] = dict(
        max_abs_err=max(v for k, v in probe.items() if k.endswith('_maxerr')),
        ms=probe[f'{prod}_ms'], plain_ms=res['stage1']['plain_ms'],
        bound_ms=res['stage1']['bound_ms'],
        bound_by=res['stage1']['bound_by'], library_ms=None)
    print(f'smoke: {time.perf_counter() - t_start:.1f} s in all', flush=True)

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
