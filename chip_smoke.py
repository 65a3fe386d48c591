#!/usr/bin/env python3
"""Drive the PyTorch port's flagship path once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:

1. device: requires ``torch.cuda.is_available()``; prints the card's
   ``nvidia-smi`` name and power limit; turns TF32 off for the float32
   reference computations;
2. build: compiles the CUDA kernels from ``stereotracking_tpu_torch/csrc``
   (nvcc, sm_90a) and prints the build time;
3. kernels: each kernel against its plain PyTorch version on the same
   inputs at the main-path shapes (1080x1920 raw frames padded to
   1088x1920), with the tolerance stated beside each check, and both timed
   with CUDA events;
4. slice: ``build_model(flagship config)`` on the card, then ``track_raw``
   over 8 synthetic 1080p frames; per frame the valid detections, valid
   tracks and milliseconds; the kernels' launch counters must show stem 2,
   stage 1 1, stage 2 1 and depth 2 launches per frame; every output must
   be finite; on a small frame the kernel path's head outputs must agree
   with the float32 module path.

Output: the per-phase lines, then the card line and one JSON line of kernel
results, then, as the last line, ``{"ok": true, "device": {...}}``.
"""
import json
import os
import subprocess
import sys
import time
import warnings

REPO = os.path.dirname(os.path.abspath(__file__))
CONFIG = os.path.join(REPO, 'configs', 'stereo_tracking', 'ocsort',
                      'yolox_s_airdrone_disp.py')
FRAME_H, FRAME_W = 1080, 1920
N_FRAMES = 8
SEED = 0
# head biases set so that random-weight detections clear init_track_thr and
# the tracker spawns, matches and evicts tracks (sigmoid(3)^2 = 0.91)
HEAD_BIAS = 3.0

KERNELS = {
    # name: (source, TPU kernel it replaces)
    'stem': ('stereotracking_tpu_torch/csrc/stem.cu',
             'stereotracking_tpu/ops/stem_pallas.py:104'),
    'stage1': ('stereotracking_tpu_torch/csrc/stage1.cu',
               'stereotracking_tpu/ops/stage1_pallas.py:303'),
    'stage2': ('stereotracking_tpu_torch/csrc/stage2.cu',
               'stereotracking_tpu/ops/stage2_pallas.py:256'),
    'depth': ('stereotracking_tpu_torch/csrc/depth.cu',
              'stereotracking_tpu/ops/depth_pallas.py:84'),
}


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


def build_flagship(device, seed=SEED):
    """The flagship model with seeded random weights and HEAD_BIAS."""
    import torch
    from stereotracking_tpu_torch.apis.builder import build_model
    from stereotracking_tpu_torch.config import load_config
    model = build_model(load_config(CONFIG), device=device, seed=seed)
    head = model.module.bbox_head.head_module
    with torch.no_grad():
        for conv in (*head.multi_level_conv_cls, *head.multi_level_conv_obj):
            conv.bias.fill_(HEAD_BIAS)
    return model


def time_ms(fn, iters):
    """Mean milliseconds per call by CUDA events, after one warm-up."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def depth_boxes(device):
    """Boxes on every pyramid level (crop 96: sizes 40, 150, 300, 700),
    degenerate boxes, boxes leaving the frame and > 800 px wide."""
    import torch
    b = [[100, 600, 140, 630], [400, 700, 550, 800], [800, 560, 1100, 760],
         [200, 400, 900, 1000], [1000, 540, 1010, 541],   # levels 0-3, tiny
         [-30, -30, -5, -5], [-10, 600, 40, 640],         # negative corners
         [1900, 1070, 1990, 1150], [1950, 700, 2000, 720],  # leaving / out
         [500, 700, 500, 760], [300, 650, 1200, 700],     # zero width, >800
         [0, 0, 1920, 1088]]
    for i in range(52):                                  # 64 in all
        x, y = 37 * i % 1800, 540 + 13 * i % 500
        b.append([x, y, x + 8 + 3 * i, y + 6 + 2 * i])
    return torch.tensor(b, dtype=torch.float32, device=device)


def check_kernels(model, frame, device):
    """Phase 3: each kernel against its plain version on one frame."""
    import torch
    import torch.nn.functional as F
    from stereotracking_tpu_torch.models.preprocessor import (
        padded_shape, preprocess_frame_pure)
    from stereotracking_tpu_torch.ops import (depth_cuda, stage1_cuda,
                                              stage2_cuda, stem_cuda)
    from stereotracking_tpu_torch.ops.depth import depth_epilogue
    img = torch.from_numpy(frame[0]).to(device)
    disp_u16 = torch.from_numpy(frame[1].astype('int32')).to(
        device).to(torch.uint16)
    oh, ow = padded_shape(*img.shape[:2])
    kw = model.module.backbone.kernel_weights()
    res = {}

    def record(name, err, fn, plain, iters=20):
        res[name] = dict(max_abs_err=float(err), ms=time_ms(fn, iters),
                         plain_ms=time_ms(plain, iters))
        print(f'kernel {name}: max_abs_err {err:.6g}  kernel '
              f'{res[name]["ms"]:.4f} ms  plain {res[name]["plain_ms"]:.4f}'
              f' ms', flush=True)

    # stem: the float32 sums differ by reassociation, at most
    # 2 * K * 2^-24 * sum|x * w| (K = 36 C taps, both sides), times |scale|;
    # then one bf16 rounding, at most one ulp (2^-7 relative) apart
    stems, err = [], 0.0
    for frm, (w6, sb) in ((img, kw['stem']), (disp_u16, kw['disp_stem'])):
        k = stem_cuda.focus_stem(frm, w6, sb, oh, ow)
        p = stem_cuda.focus_stem_plain(frm, w6, sb, oh, ow).float()
        require(k.shape == (oh // 2, ow // 2, w6.shape[-1]), 'stem shape')
        x = F.pad(stem_cuda.stem_input(frm, oh, ow), (2, 3, 2, 3))
        mag = F.conv2d(x.abs(), w6.abs().permute(3, 2, 0, 1), stride=2)
        mag = mag[0].permute(1, 2, 0) * sb[0].abs()
        tol = 2 ** -7 * p.abs() + 2 * 36 * w6.shape[2] * 2 ** -24 * mag
        d = (k.float() - p).abs()
        bad = d > tol
        require(not bool(bad.any()),
                f'stem: {int(bad.sum())} elements beyond tolerance, e.g. '
                f'kernel {k.float()[bad][:4].tolist()} plain '
                f'{p[bad][:4].tolist()} tol {tol[bad][:4].tolist()}')
        err = max(err, float(d.max()))
        stems.append(k)
    record('stem',
           err, lambda: (stem_cuda.focus_stem(img, *kw['stem'], oh, ow),
                         stem_cuda.focus_stem(disp_u16, *kw['disp_stem'],
                                              oh, ow)),
           lambda: (stem_cuda.focus_stem_plain(img, *kw['stem'], oh, ow),
                    stem_cuda.focus_stem_plain(disp_u16, *kw['disp_stem'],
                                               oh, ow)))

    # stages: bf16 chains whose roundings may flip by one ulp and carry on,
    # held to 2e-2 of the output's largest magnitude (the JAX package's own
    # stage tolerance, tests/test_stage2_pallas.py)
    def stage_check(name, fn, plain):
        k, p = fn(), plain()
        require(k.shape == p.shape, f'{name} shape {k.shape} vs {p.shape}')
        err = float((k.float() - p.float()).abs().max())
        scale = float(p.float().abs().max())
        require(err <= 2e-2 * scale + 1e-3,
                f'{name}: max_abs_err {err} > 2e-2 * {scale} + 1e-3')
        require(bool(torch.isfinite(k.float()).all()), f'{name} not finite')
        record(name, err, fn, plain)
        return k

    y1 = stage_check(
        'stage1',
        lambda: stage1_cuda.stage1_dual(*stems, kw['stage1'],
                                        kw['disp_stage1']),
        lambda: stage1_cuda.stage1_dual_plain(*stems, kw['stage1'],
                                              kw['disp_stage1']))
    stage_check('stage2', lambda: stage2_cuda.stage_csp(y1, kw['stage2']),
                lambda: stage2_cuda.stage_csp_plain(y1, kw['stage2']))

    # depth: integer statistics exact; float sums and depths within float32
    # reassociation (rtol 2e-6, atol 1e-5 on depths as in
    # tests/test_depth_pallas.py; rtol 1e-5 on the raw sums)
    cfg = model.cfg
    disp = preprocess_frame_pure(img, disp_u16, oh, ow)['disp_postp'][
        0, :, :, 0].contiguous()
    boxes = depth_boxes(device)
    valid = torch.ones(boxes.shape[0], dtype=torch.bool, device=device)
    bf = float(cfg.baseline) * float(cfg.focal_length)
    scal = depth_cuda.box_scalars(boxes, cfg.depth_crop,
                                  depth_cuda.depth_rmin(bf), oh, ow)
    levels = set(scal[:, 0].tolist())
    require(levels == {0, 1, 2, 3}, f'depth boxes hit levels {levels}')
    ks = depth_cuda.box_depth_stats(disp, scal, cfg.depth_crop, bf)
    ps = depth_cuda.box_depth_stats_plain(disp, scal, cfg.depth_crop, bf)
    require(torch.equal(ks[:, :16], ps[:, :16]),
            'depth: integer statistics differ')
    require(torch.allclose(ks[:, 16:], ps[:, 16:], rtol=1e-5, atol=1e-3),
            'depth: sums beyond rtol 1e-5')
    kd, ksc = depth_epilogue(disp, boxes, valid, ks, cfg.depth_crop, bf)
    pd, psc = depth_epilogue(disp, boxes, valid, ps, cfg.depth_crop, bf)
    require(torch.equal(kd == -1, pd == -1), 'depth: invalid pattern')
    require(torch.allclose(kd, pd, rtol=2e-6, atol=1e-5)
            and torch.allclose(ksc, psc, rtol=2e-6, atol=1e-5),
            'depth: depths beyond rtol 2e-6')
    n_ok = int((kd > 0).sum())
    require(n_ok > 0, 'depth: no box got a depth')
    record('depth', float((kd - pd).abs().max()),
           lambda: depth_cuda.box_depth_stats(disp, scal, cfg.depth_crop, bf),
           lambda: depth_cuda.box_depth_stats_plain(disp, scal,
                                                    cfg.depth_crop, bf))
    print(f'depth: {n_ok} of {boxes.shape[0]} boxes with a depth, integer '
          f'statistics exact', flush=True)
    return res


def check_small_reference(model, device):
    """The kernel path's head outputs against the float32 module path on a
    small frame.  The kernels round to bf16 after every ConvBNAct of the
    stems and stages 1-2 (about 0.4% each, a dozen times) and the float32
    layers after them carry that on; tolerance 1e-1 of each output's
    largest magnitude."""
    import torch
    from stereotracking_tpu_torch.models.preprocessor import (
        padded_shape, preprocess_frame_pure)
    img, disp = make_frames(1, 256, 320, SEED + 1)[0]
    img = torch.from_numpy(img).to(device)
    du = torch.from_numpy(disp.astype('int32')).to(device).to(torch.uint16)
    oh, ow = padded_shape(256, 320)
    inputs = preprocess_frame_pure(img, du, oh, ow)
    inputs.update(img_u8=img, disp_u16=du)
    with torch.no_grad():
        ker = model.module(inputs, 'cuda')
        ref = model.module(inputs, 'torch')
    worst = 0.0
    for k, r in zip(sum(ker, []), sum(ref, [])):
        scale = float(r.abs().max())
        err = float((k - r).abs().max())
        require(err <= 1e-1 * scale + 1e-3,
                f'head output off the float32 path: {err} vs scale {scale}')
        worst = max(worst, err / max(scale, 1e-6))
    print(f'reference: kernel-path head outputs within {worst:.4g} of the '
          f'float32 path (relative to max |output|; limit 1e-1)', flush=True)


def run_slice(model, frames, device):
    """Phase 4: the flagship slice over the frames, counters checked."""
    import torch
    from stereotracking_tpu_torch import _kernels
    dev_frames = [(torch.from_numpy(i).to(device),
                   torch.from_numpy(d.astype('int32')).to(device).to(
                       torch.uint16)) for i, d in frames]
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
        for name, t in r._asdict().items():
            require(bool(torch.isfinite(t.float()).all()),
                    f'frame {f}: {name} not finite')
        require(r.det_bboxes.shape == (300, 4), 'det slots')
        require(r.track_ids.shape == (model.cfg.tracker.num_dets,),
                'track slots')
        ids = r.track_ids[r.track_valid].tolist()
        n_ids.update(i for i in ids if i >= 0)
        print(f'frame {f}: {int(r.det_valid.sum())} valid detections, '
              f'{int(r.track_valid.sum())} valid tracks, {ms:.2f} ms',
              flush=True)
    want = {'stem': 2, 'stage1': 1, 'stage2': 1, 'depth': 2}
    for name, per in want.items():
        require(counts[name] == per * len(frames),
                f'{name}: {counts[name]} launches over {len(frames)} frames,'
                f' expected {per} per frame')
    require(len(n_ids) > 0, 'no track id assigned')
    # host syncs of one more (untimed) frame, as torch's sync debug mode
    # reports them (it does not see every synchronizing call)
    torch.cuda.set_sync_debug_mode('warn')
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter('always')
            model.track_raw(*dev_frames[0], len(frames))
            torch.cuda.synchronize()
    finally:
        torch.cuda.set_sync_debug_mode('default')
    syncs = sum('synchroniz' in str(w.message).lower() for w in caught)
    print(f'host syncs in one frame (torch sync debug mode): {syncs}',
          flush=True)
    steady = sorted(per_frame[2:])        # after cuDNN's first-call setup
    print(f'slice: {len(frames)} frames of {FRAME_H}x{FRAME_W}, '
          f'{len(n_ids)} track ids, launches {counts}, ms/frame first two '
          f'{per_frame[0]:.2f} {per_frame[1]:.2f}, frames 2-{len(frames) - 1}'
          f' median {steady[len(steady) // 2]:.2f}', flush=True)
    return counts


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
    device = torch.device('cuda', 0)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader', '--id=0'],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f'device: {torch.cuda.get_device_name(0)}; torch '
          f'{torch.__version__}, CUDA {torch.version.cuda}', flush=True)

    t0 = time.perf_counter()
    path = _kernels.build()
    _kernels.library()
    print(f'build: {path.name} in {time.perf_counter() - t0:.1f} s '
          f'(nvcc {_kernels.build_seconds})', flush=True)

    frames = make_frames(N_FRAMES, FRAME_H, FRAME_W, SEED)
    model = build_flagship(device)
    res = check_kernels(model, frames[0], device)
    check_small_reference(model, device)
    counts = run_slice(model, frames, device)

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
