"""Where the time of the stem and the stage-chain kernels goes, on the card.

    python -m stereotracking_tpu_torch.tools.ablate_kernels

Builds copies of ``csrc/`` in each of which one part of a kernel is
switched off or replaced (the source edits in ``ABLATIONS``), one ``nvcc``
per copy, all at once, and loads each as a library of its own.  The
``chain`` ablations edit ``mma_chain.cuh``, the core of stages 1, 2 and 3.
It then times the stem (both branches), or the stage-1 (production
variant), stage-2 and stage-3 kernels, of each copy at ``--streams``
streams of 1080p (seeded random frames and weights at the flagship's
widths) beside the unedited kernels, with CUDA events.  An ablated kernel
computes wrong values: its output is used for nothing but the timing.
Prints one JSON line of ``<kernel>_<ablation>_ms``.  Needs an NVIDIA GPU
and ``nvcc``.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import shutil
import subprocess
from typing import Dict

import numpy as np
import torch

from .. import _kernels
from ..models.detector import DetectorConfig, YOLOXDetector
from ..models.mot import init_weights
from ..models.preprocessor import padded_shape
from ..ops.stage1_cuda import PRODUCTION, VARIANTS, stage1_dual
from ..ops.stage2_cuda import CHAIN_GEMM, slice_offsets, stage_csp
from ..ops.stage3_cuda import stage3_csp
from ..ops.stem_cuda import focus_stem
from ..utils.devices import checked_device
from .probe_stage1_variants import cuda_ms

_MMA2 = ('''                mma_bf16(acc[i][2 * jp], a[i], b[0], b[1]);
#pragma unroll
              for (int i = 0; i < MT; ++i)
                mma_bf16(acc[i][2 * jp + 1], a[i], b[2], b[3]);''',
         '''                acc[i][2 * jp][0] += __uint_as_float(a[i][0] ^ b[0]);
#pragma unroll
              for (int i = 0; i < MT; ++i)
                acc[i][2 * jp + 1][1] += __uint_as_float(a[i][1] ^ b[3]);''')
_ACT2 = ('act_fast(acc[i][j][2 * hh]', 'act_fast(acc[i][j][2 * hh + 1]')
_ACT1 = ('act_fast(acc[i][j][2 * hh], s0, b0)',
         'act_fast(acc[i][j][2 * hh + 1], s1, b1)')

# kernel -> ablation -> [(file under csrc/, text, replacement)]
ABLATIONS = {
    'stem': {
        # the IEEE exponential and division of st_act (csrc/common.cuh)
        'exact_act': [('stem.cu', a, a.replace('act_fast', 'st_act'))
                      for a in _ACT1],
        # BN scale only: no exponential, no division
        'no_act': [('stem.cu', _ACT1[0],
                    '__float2bfloat16_rn(acc[i][j][2 * hh] * s0)'),
                   ('stem.cu', _ACT1[1],
                    '__float2bfloat16_rn(acc[i][j][2 * hh + 1] * s1)')],
        'no_mma': [('stem.cu', '''        mma_bf16(acc[0][j], a[0], b0, b1);
        mma_bf16(acc[1][j], a[1], b0, b1);''',
                    '''        acc[0][j][0] += __uint_as_float(a[0][0] ^ b0);
        acc[1][j][1] += __uint_as_float(a[1][3] ^ b1);''')],
        'no_load': [('stem.cu', 'if (a >= hi) continue;',
                     'if (a >= hi || h > 0) continue;')],
        'no_store': [('stem.cu', 'if (oy < hout && ox < wout)\n',
                      'if (oy < hout && ox < wout && h < 0)\n')],
    },
    # mma_chain.cuh, run by stages 1-3
    'chain': {
        'exact_act': [('mma_chain.cuh', a, a.replace('act_fast', 'st_act'))
                      for a in _ACT2],
        'no_act': [('mma_chain.cuh', f'act_fast(acc[i][j][2 * hh{q}], '
                    f'sc[j].{c}, bi[j].{c})', f'__float2bfloat16_rn(acc[i][j]'
                    f'[2 * hh{q}] * sc[j].{c})') for q, c in (('', 'x'),
                                                            (' + 1', 'y'))],
        'no_mma': [('mma_chain.cuh', *_MMA2)],
        # the input patch is not copied (the entry conv reads stale bytes)
        'no_patch': [('mma_chain.cuh', 'const bool ok = y >= 0',
                      'const bool ok = hin < 0 && y >= 0')],
        # no wait and no barrier per weight slice (races: timing only)
        'no_barrier': [('mma_chain.cuh', '''    cp_async_wait<STAGES - 2>();
    __syncthreads();
    issue();''', '''    issue();''')],
        'ring3': [('mma_chain.cuh', 'constexpr int STAGES = 2;',
                   'constexpr int STAGES = 3;')],
    },
}
_SOURCES = {'stem': ('stem.cu',),
            'chain': ('stage1.cu', 'stage2.cu', 'stage3.cu')}
_CHAIN = ('stage1', 'stage2', 'stage3')
# a third ring slot does not fit stage 3's first launch (225,536 + 8,192 B
# of shared memory > 232,448 B)
_SKIP = {('stage3', 'ring3')}


def build_ablations() -> Dict[str, ctypes.CDLL]:
    """{'<kernel>_<ablation>': library} built from edited copies of csrc/."""
    root = _kernels.BUILD_DIR / f'ablate.{os.getpid()}'
    try:
        procs = {}
        for kernel, ablations in ABLATIONS.items():
            for name, edits in ablations.items():
                tag = f'{kernel}_{name}'
                src = root / tag
                shutil.copytree(_kernels.CSRC, src)
                for fname, old, new in edits:
                    text = (src / fname).read_text()
                    if old not in text:
                        raise RuntimeError(f'{tag}: {fname} no longer holds '
                                           f'{old!r}')
                    (src / fname).write_text(text.replace(old, new, 1))
                procs[tag] = subprocess.Popen(
                    [_kernels._nvcc(), *_kernels.NVCC_FLAGS, '-shared', '-o',
                     str(root / f'{tag}.so'),
                     *(str(src / s) for s in _SOURCES[kernel]),
                     str(src / 'errors.cu')], stdout=subprocess.PIPE,
                    stderr=subprocess.STDOUT, text=True)
        logs = {tag: proc.communicate()[0] for tag, proc in procs.items()}
        for tag, proc in procs.items():
            if proc.returncode != 0:
                raise RuntimeError(f'{tag}: nvcc failed\n{logs[tag]}')
        return {tag: ctypes.CDLL(str(root / f'{tag}.so')) for tag in procs}
    finally:
        shutil.rmtree(root, ignore_errors=True)


def run_ablations(n_streams: int = 8, h: int = 1080, w: int = 1920,
                  seed: int = 0, iters: int = 10, device='cuda'
                  ) -> Dict[str, float]:
    device = checked_device(device)
    if device.type != 'cuda':
        raise RuntimeError('the ablation probe times CUDA kernels: it needs '
                           'an NVIDIA GPU')
    det = YOLOXDetector(DetectorConfig())
    init_weights(det, torch.Generator().manual_seed(seed))
    kw = det.to(device).eval().backbone.kernel_weights()
    rng = np.random.RandomState(seed)
    img = torch.from_numpy(rng.randint(0, 256, (n_streams, h, w, 3),
                                       np.uint8)).to(device)
    disp = torch.from_numpy(rng.randint(16, 1600, (n_streams, h, w),
                                        np.int32)).to(device).to(torch.uint16)
    oh, ow = padded_shape(h, w)
    so = focus_stem(img, *kw['stem'], oh, ow)
    dso = focus_stem(disp, *kw['disp_stem'], oh, ow)
    k1, kd1, k2, k3 = (kw[k] for k in ('stage1', 'disp_stage1', 'stage2',
                                       'stage3'))
    y1 = stage1_dual(so, dso, k1, kd1)
    y2 = stage_csp(y1, k2)
    y3 = stage3_csp(y2, k3)
    ms = torch.empty((*y2.shape[:3], 2 * k3.dims[2]), dtype=torch.bfloat16,
                     device=device)
    stream = _kernels.stream_ptr(img)

    def bind(lib, name):
        fn = getattr(lib, name)
        fn.argtypes = list(_kernels._SIGNATURES[name])
        return fn

    def stem_call(lib):
        fn = bind(lib, 'st_focus_stem')
        outs = [torch.empty_like(so), torch.empty_like(dso)]

        def call():
            for frame, key, out in ((img, 'stem', outs[0]),
                                    (disp, 'disp_stem', outs[1])):
                wk, sb = kw[key]
                _kernels.check(fn(frame.data_ptr(), int(key != 'stem'),
                                  n_streams, h, w, oh, ow, wk.shape[1],
                                  wk.data_ptr(), sb.data_ptr(),
                                  out.data_ptr(), stream), key)
        return call

    def stage1_call(lib):
        fn = bind(lib, 'st_stage1_dual')

        def call():
            _kernels.check(fn(so.data_ptr(), dso.data_ptr(), n_streams,
                              *so.shape[1:3], *k1.dims, k1.ws.data_ptr(),
                              k1.sb.data_ptr(), kd1.ws.data_ptr(),
                              kd1.sb.data_ptr(), y1.data_ptr(),
                              VARIANTS.index(PRODUCTION), stream), 'stage1')
        return call

    def stage2_call(lib):
        fn = bind(lib, 'st_stage_csp')

        def call():
            _kernels.check(fn(y1.data_ptr(), n_streams, *y1.shape[1:3],
                              *k2.dims, k2.ws.data_ptr(), k2.sb.data_ptr(),
                              y2.data_ptr(), stream), 'stage2')
        return call

    def stage3_call(lib):
        fn = bind(lib, 'st_stage3')
        first = slice_offsets(k3.dims)[CHAIN_GEMM]

        def call():
            _kernels.check(fn(y2.data_ptr(), n_streams, *y2.shape[1:3],
                              *k3.dims, k3.ws.data_ptr(), k3.sb.data_ptr(),
                              first, ms.data_ptr(), y3.data_ptr(), stream),
                           'stage3')
        return call

    calls = {'stem': stem_call, 'stage1': stage1_call,
             'stage2': stage2_call, 'stage3': stage3_call}
    libs = build_ablations()
    out = {'stem_ms': cuda_ms(lambda: (focus_stem(img, *kw['stem'], oh, ow),
                                       focus_stem(disp, *kw['disp_stem'],
                                                  oh, ow)), iters),
           'stage1_ms': cuda_ms(lambda: stage1_dual(so, dso, k1, kd1), iters),
           'stage2_ms': cuda_ms(lambda: stage_csp(y1, k2), iters),
           'stage3_ms': cuda_ms(lambda: stage3_csp(y2, k3), iters)}
    for tag, lib in libs.items():
        group, ablation = tag.split('_', 1)
        for kernel in (_CHAIN if group == 'chain' else (group,)):
            if (kernel, ablation) not in _SKIP:
                out[f'{kernel}_{ablation}_ms'] = cuda_ms(calls[kernel](lib),
                                                         iters)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--streams', type=int, default=8)
    ap.add_argument('--seed', type=int, default=0)
    ap.add_argument('--iters', type=int, default=10)
    args = ap.parse_args(argv)
    out = run_ablations(args.streams, seed=args.seed, iters=args.iters)
    out['device'] = torch.cuda.get_device_name(0)
    print(json.dumps({k: out[k] for k in sorted(out)}), flush=True)


if __name__ == '__main__':
    main()
