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
   stages 1-3, depth) once more with ``-Xptxas -v`` and prints their
   registers, shared memory and spills;
3. kernels: each kernel against its plain PyTorch version on the same
   inputs, at one stream and at 8 streams of 1080x1920 raw frames padded to
   1088x1920, with the tolerance stated beside each check; kernel, plain
   version and (where one PyTorch call computes the same function) that
   call timed with CUDA events; each kernel's bound from its bytes and
   operations; for the stem, stages 1-3 and depth the achieved rate and
   share of the bound, and for stages 1-3 the weight bytes read from L2
   per region before (wmma B fragments from device memory) and after (the
   slice ring); the float32 stage-3 modules (TF32 off) timed beside the
   stage-3 kernel; for depth also its vote branches against the plain
   composite's and the host wall of one whole extraction beside the eager
   box scalars + epilogue it runs inside; its device time and the kernel
   launches of each (one per extraction) come from ``torch.profiler``
   after phase 6, since a profiler session slows the host work after it;
4. reference: on a small frame the kernel path's head outputs (stage 3
   through its kernel too) must agree with the float32 module path;
5. slice: ``build_model(flagship config)`` on the card, ``track_raw`` over
   6 synthetic 1080p frames; launch counts must show stem 2, stage 1 1,
   stage 2 1 and depth 2 per frame; outputs finite; host syncs per frame;
   then over 2 frames each the stem and stage-1 kernels with stage 2 on
   the float32 modules (launches stem 2, stage 1 1, stage 2 0, depth 2 per
   frame), and a widen-0.25 config with every stage 'auto' (the stem
   kernel only: stem 2, stages 1-3 0, depth 2; the builder's warning for
   stage 1 printed);
6. multi-stream: ``MultiStreamTracker`` with the flagship config and
   ``stage3_backend='cuda'``, 8 steps of 8 streams (each stream its own
   seed); ms per step and stereo pairs/s; launch counts must show stem 2,
   stage 1 1, stage 2 1, stage 3 1 and depth 2 per step; outputs finite;
   host syncs per step no more than the single-stream frame's; stream 0
   over the first 3 steps equal to a single-stream run of its frames (ids
   and validity exact, boxes within 1e-2 px);
7. probe: the stage-1 kernel's six variants at 8 streams, each held to
   the plain version and timed (``tools/probe_stage1_variants.py``), the
   production one beside the wmma 16x16 region it replaced.

``--profile`` adds a ``torch.profiler`` window over two multi-stream steps
and prints the device time by kernel.

Output: the per-phase lines, then the card line and one JSON line of kernel
results (8-stream shapes; launches from the multi-stream run, the probe's
from the probe run), then, as the last line, ``{"ok": true, "device":
{...}}``.
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
    'stage1_variants': ('stereotracking_tpu_torch/csrc/stage1.cu',
                        'tools/probe_stage1_variants.py:153'),
}

# kernels redesigned for the H100: their achieved rate, share of the bound
# and ptxas resource usage are printed too
REDESIGNED = ('stem', 'stage1', 'stage2', 'stage3', 'depth')
ALL_KERNELS = ('cuda',) * 4       # a StageBackends with every stage kernel


class SmokeFailure(Exception):
    pass


def require(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def make_frames(n, h, w, seed):
    """Synthetic raw frames as ``bench.py`` makes them: noise, six bright
    rectangles with constant disparity, invalid (65535) upper half."""
    import numpy as np
    rng = np.random.RandomState(seed)
    frames = []
    for _ in range(n):
        img = rng.randint(0, 255, (h, w, 3), np.uint8)
        disp = np.full((h, w), 65535, np.uint16)
        disp[h // 2:] = rng.randint(16, 1600, (h - h // 2, w), np.uint16)
        for _ in range(6):
            x, y = rng.randint(0, w - 60), rng.randint(0, h - 40)
            img[y:y + 30, x:x + 40] = rng.randint(100, 255, 3, np.uint8)
            disp[y:y + 30, x:x + 40] = rng.randint(40, 800)
        frames.append((img, disp))
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


def check_kernels(model, frames, device, iters=10):
    """Phase 3 at S = len(frames) streams: each kernel against its plain
    version, all timed; returns {name: result row} and the depth check's
    torch.profiler function (``check_depth``)."""
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

    res['depth'], trace = check_depth(model.cfg, img, disp_u16, oh, ow,
                                      device, iters)
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


def run_slice(model, frames, device):
    """Phase 5: the single-stream flagship slice, counters checked."""
    import torch
    from stereotracking_tpu_torch import _kernels
    dev_frames = [to_card([f], device) for f in frames]
    dev_frames = [(i[0], d[0]) for i, d in dev_frames]
    model.reset()
    torch.cuda.synchronize()
    _kernels.reset_launch_counts()
    per_frame, results = [], []
    for f, (img, disp) in enumerate(dev_frames):
        t0 = time.perf_counter()
        r = model.track_raw(img, disp, f)
        torch.cuda.synchronize()
        per_frame.append((time.perf_counter() - t0) * 1e3)
        results.append(r)
    counts = _kernels.launch_counts()
    n_ids = set()
    for f, (r, ms) in enumerate(zip(results, per_frame)):
        check_result(r, (), model.cfg.tracker.num_dets, f'frame {f}')
        ids = r.track_ids[r.track_valid].tolist()
        n_ids.update(i for i in ids if i >= 0)
        print(f'frame {f}: {int(r.det_valid.sum())} valid detections, '
              f'{int(r.track_valid.sum())} valid tracks, {ms:.2f} ms',
              flush=True)
    want = {'stem': 2, 'stage1': 1, 'stage2': 1, 'stage3': 0, 'depth': 2}
    for name, per in want.items():
        require(counts[name] == per * len(frames),
                f'{name}: {counts[name]} launches over {len(frames)} frames,'
                f' expected {per} per frame')
    require(len(n_ids) > 0, 'no track id assigned')
    syncs = count_syncs(lambda: model.track_raw(*dev_frames[0], len(frames)))
    print(f'host syncs in one frame (torch sync debug mode): {syncs}',
          flush=True)
    steady = sorted(per_frame[2:])        # after cuDNN's first-call setup
    print(f'slice: {len(frames)} frames of {FRAME_H}x{FRAME_W}, '
          f'{len(n_ids)} track ids, launches {counts}, ms/frame first two '
          f'{per_frame[0]:.2f} {per_frame[1]:.2f}, frames 2-{len(frames) - 1}'
          f' median {steady[len(steady) // 2]:.2f}', flush=True)
    return counts, syncs


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
        torch.cuda.synchronize()
        _kernels.reset_launch_counts()
        for f, (img, disp) in enumerate(dev_frames):
            r = one.track_raw(img[0], disp[0], f)
            check_result(r, (), mot.tracker.num_dets, f'{what}, frame {f}')
        torch.cuda.synchronize()
        counts = _kernels.launch_counts()
        want = {name: per if b == 'cuda' else 0 for name, per, b in zip(
            StageBackends._fields, (2, 1, 1, 1), backends)}
        want['depth'] = 2
        for name, per in want.items():
            require(counts[name] == per * len(frames),
                    f'{what}: {counts[name]} {name} launches over '
                    f'{len(frames)} frames, expected {per} per frame')
        for m in said:
            print(f'mixed backends ({what}): builder: {m}', flush=True)
        print(f'mixed backends ({what}): {len(frames)} frames, launches '
              f'{counts}', flush=True)


def run_multistream(model, device, single_syncs, profile=False):
    """Phase 6: MultiStreamTracker, 8 streams x 8 steps, stage-3 kernel on."""
    import numpy as np
    import torch
    from stereotracking_tpu_torch import _kernels
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
    torch.cuda.synchronize()
    _kernels.reset_launch_counts()
    per_step, results = [], []
    for t, (imgs, disps) in enumerate(steps):
        t0 = time.perf_counter()
        r = ms.track_raw(imgs, disps, [t] * N_STREAMS)
        torch.cuda.synchronize()
        per_step.append((time.perf_counter() - t0) * 1e3)
        results.append(r)
    counts = _kernels.launch_counts()
    want = {'stem': 2, 'stage1': 1, 'stage2': 1, 'stage3': 1, 'depth': 2}
    for name, per in want.items():
        require(counts[name] == per * N_STEPS,
                f'multi-stream {name}: {counts[name]} launches over '
                f'{N_STEPS} steps, expected {per} per step')
    n_ids = set()
    for t, r in enumerate(results):
        check_result(r, (N_STREAMS,), mot.tracker.num_dets, f'step {t}')
        n_ids.update(r.track_ids[r.track_valid].tolist())
        print(f'step {t}: {int(r.det_valid.sum())} valid detections, '
              f'{int(r.track_valid.sum())} valid tracks over {N_STREAMS} '
              f'streams, {per_step[t]:.2f} ms', flush=True)
    require(len(n_ids - {-1}) > 0, 'multi-stream: no track id assigned')
    syncs = count_syncs(lambda: ms.track_raw(*steps[0], [N_STEPS] * N_STREAMS))
    steady = sorted(per_step[2:])
    med = steady[len(steady) // 2]
    print(f'multi-stream: {N_STREAMS} streams x {N_STEPS} steps of '
          f'{FRAME_H}x{FRAME_W}, launches {counts}, ms/step first two '
          f'{per_step[0]:.2f} {per_step[1]:.2f}, steps 2-{N_STEPS - 1} '
          f'median {med:.2f} ({N_STREAMS / med * 1e3:.1f} stereo pairs/s), '
          f'host syncs per step {syncs} (single stream {single_syncs})',
          flush=True)
    require(syncs <= single_syncs,
            f'multi-stream: {syncs} host syncs per step > {single_syncs} of '
            f'the single-stream frame')

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
    if profile:
        profile_steps(ms, steps)
    return counts, dict(ms_per_step=med, pairs_per_s=N_STREAMS / med * 1e3,
                        syncs_per_step=syncs)


def profile_steps(ms, steps):
    """Device time by kernel over two multi-stream steps."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for t in range(2):
            ms.track_raw(*steps[t], [N_STEPS + 1 + t] * N_STREAMS)
        torch.cuda.synchronize()
    rows = [(getattr(e, 'device_time_total', 0) or
             getattr(e, 'cuda_time_total', 0), e.count, e.key)
            for e in prof.key_averages()]
    rows = sorted((r for r in rows if r[0] > 0), reverse=True)
    total = sum(r[0] for r in rows if not r[2].startswith('aten::'))
    print(f'profile: device time over 2 steps by kernel (us); kernel sum '
          f'{total:.0f} us', flush=True)
    for us, cnt, key in rows[:40]:
        print(f'profile: {us:12.1f} us {cnt:6d}x {key[:90]}', flush=True)


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
    streams = [make_frames(1, FRAME_H, FRAME_W, 100 + s)[0]
               for s in range(N_STREAMS)]
    _, trace_one = check_kernels(model, streams[:1], device)
    res, trace = check_kernels(model, streams, device)
    check_small_reference(model, device)
    slice_frames = make_frames(N_FRAMES, FRAME_H, FRAME_W, SEED)
    _, single_syncs = run_slice(model, slice_frames, device)
    run_mixed(model, slice_frames[:2], device)
    counts, _ = run_multistream(model, device, single_syncs,
                                profile='--profile' in sys.argv[1:])
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
