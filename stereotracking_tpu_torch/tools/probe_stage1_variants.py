"""A/B probe of the stage-1 kernel's variants on the card.

    python -m stereotracking_tpu_torch.tools.probe_stage1_variants

The port's counterpart of ``tools/probe_stage1_variants.py`` (the TPU
probe's suspects were layout matters of the TPU: band size, the in-kernel
even/odd split, bf16 rolls).  On the card the choices are the region shape
and the GEMMs' inner loop: ``ops.stage1_cuda.VARIANTS`` are the six
template instantiations of the stage-1 kernel, 16 x 16 or 8 x 16 regions
times three inner loops: wmma bf16 (``r16x16_wmma``, ``r8x16_wmma``) or
scalar float32 FMA (``r16x16_fma``, ``r8x16_fma``), both with B fragments
from device memory, and ``mma.sync`` on the weight-ring core
(``r16x16_mma``, ``r8x16_mma``).  ``r8x16_mma`` is production: on an H100
80GB HBM3 at 700 W it took 1.80 ms against 2.03 (``r16x16_mma``), 8.36 /
10.68 (wmma) and 42.2 / 43.8 (FMA), its two blocks per SM hiding each
other's barriers.  Each runs on 8 streams of 1080p stem outputs (seeded random frames
and weights at the flagship's widths), is held to ``stage1_dual_plain``
within 2e-2 * max|ref| + 1e-3 (the stage tolerance of
tests/test_stage2_pallas.py) and timed with CUDA events.  Prints one JSON
line of ``<variant>_ms`` and ``<variant>_maxerr``.  A variant that does not
build, launch or match fails the run.  Needs an NVIDIA GPU.
"""
from __future__ import annotations

import argparse
import json
from typing import Dict

import numpy as np
import torch

from ..models.detector import DetectorConfig, YOLOXDetector
from ..models.mot import init_weights
from ..models.preprocessor import padded_shape
from ..ops.stage1_cuda import VARIANTS, stage1_dual_plain, stage1_dual_variant
from ..ops.stem_cuda import focus_stem
from ..utils.devices import checked_device


def cuda_ms(fn, iters: int) -> float:
    """Mean milliseconds per call by CUDA events, after one warm-up."""
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


def probe_inputs(n_streams: int, h: int, w: int, seed: int, device):
    """(stem RGB, stem disparity, stage-1 kernel weights) of ``n_streams``
    seeded random raw frames through the stem kernel."""
    det = YOLOXDetector(DetectorConfig())
    init_weights(det, torch.Generator().manual_seed(seed))
    kw = det.to(device).eval().backbone.kernel_weights()
    rng = np.random.RandomState(seed)
    imgs = torch.from_numpy(rng.randint(0, 256, (n_streams, h, w, 3),
                                        np.uint8)).to(device)
    disps = torch.from_numpy(rng.randint(16, 1600, (n_streams, h, w),
                                         np.int32)).to(device)
    disps = disps.to(torch.uint16)
    oh, ow = padded_shape(h, w)
    so = focus_stem(imgs, *kw['stem'], oh, ow)
    dso = focus_stem(disps, *kw['disp_stem'], oh, ow)
    return so, dso, kw['stage1'], kw['disp_stage1']


def run_probe(n_streams: int = 8, h: int = 1080, w: int = 1920,
              seed: int = 0, iters: int = 10, device='cuda'
              ) -> Dict[str, float]:
    """Every variant checked against the plain version and timed, in one
    process on one card; raises on the first variant that fails."""
    device = checked_device(device)
    if device.type != 'cuda':
        raise RuntimeError('the stage-1 variant probe times CUDA kernels: '
                           'it needs an NVIDIA GPU')
    so, dso, k_rgb, k_dsp = probe_inputs(n_streams, h, w, seed, device)
    ref = stage1_dual_plain(so, dso, k_rgb, k_dsp).float()
    tol = 2e-2 * float(ref.abs().max()) + 1e-3
    out = {}
    for v in VARIANTS:
        y = stage1_dual_variant(so, dso, k_rgb, k_dsp, v)
        torch.cuda.synchronize()
        if y.shape != ref.shape or not bool(torch.isfinite(y.float()).all()):
            raise RuntimeError(f'variant {v}: shape {tuple(y.shape)} or '
                               f'non-finite values')
        err = float((y.float() - ref).abs().max())
        if err > tol:
            raise RuntimeError(f'variant {v}: max_abs_err {err} > {tol}')
        out[f'{v}_maxerr'] = err
        out[f'{v}_ms'] = cuda_ms(
            lambda: stage1_dual_variant(so, dso, k_rgb, k_dsp, v), iters)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--streams', type=int, default=8)
    ap.add_argument('--height', type=int, default=1080)
    ap.add_argument('--width', type=int, default=1920)
    ap.add_argument('--seed', type=int, default=0)
    ap.add_argument('--iters', type=int, default=10)
    args = ap.parse_args(argv)
    out = run_probe(args.streams, args.height, args.width, args.seed,
                    args.iters)
    out['device'] = torch.cuda.get_device_name(0)
    print(json.dumps({k: out[k] for k in sorted(out)}), flush=True)


if __name__ == '__main__':
    main()
