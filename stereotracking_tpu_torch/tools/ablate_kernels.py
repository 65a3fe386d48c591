"""Where the time of the stem and stage-2 kernels goes, on the card.

    python -m stereotracking_tpu_torch.tools.ablate_kernels

Builds copies of ``csrc/`` in each of which one part of a kernel is
switched off or replaced (the source edits in ``ABLATIONS``), one ``nvcc``
per copy, all at once, and loads each as a library of its own.  It then
times the stem (both branches) and the stage-2 kernel of each copy at
``--streams`` streams of 1080p (seeded random frames and weights at the
flagship's widths) beside the unedited kernels, with CUDA events.  An
ablated kernel computes wrong values: its output is used for nothing but
the timing.  Prints one JSON line of ``<kernel>_<ablation>_ms``.  Needs an
NVIDIA GPU and ``nvcc``.
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
from ..ops.stage1_cuda import stage1_dual
from ..ops.stage2_cuda import stage_csp
from ..ops.stem_cuda import focus_stem
from ..utils.devices import checked_device
from .probe_stage1_variants import cuda_ms

_MMA2 = ('''              mma_bf16(acc[0][2 * jp], a0, b[0], b[1]);
              mma_bf16(acc[1][2 * jp], a1, b[0], b[1]);
              mma_bf16(acc[0][2 * jp + 1], a0, b[2], b[3]);
              mma_bf16(acc[1][2 * jp + 1], a1, b[2], b[3]);''',
         '''              acc[0][2 * jp][0] += __uint_as_float(a0[0] ^ b[0]);
              acc[1][2 * jp][1] += __uint_as_float(a1[1] ^ b[3]);''')
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
    'stage2': {
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
_MAIN = {'stem': 'stem.cu', 'stage2': 'stage2.cu'}


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
                     str(root / f'{tag}.so'), str(src / _MAIN[kernel]),
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
    y1 = stage1_dual(so, dso, kw['stage1'], kw['disp_stage1'])
    k2 = kw['stage2']
    y2 = stage_csp(y1, k2)
    stream = _kernels.stream_ptr(img)
    p, i = ctypes.c_void_p, ctypes.c_int

    def stem_call(lib):
        fn = lib.st_focus_stem
        fn.argtypes = [p, i, i, i, i, i, i, i, p, p, p, p]
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

    def stage2_call(lib):
        fn = lib.st_stage_csp
        fn.argtypes = [p, i, i, i, i, i, i, i, p, p, p, p]
        cin, cout, mid, nb = k2.dims

        def call():
            _kernels.check(fn(y1.data_ptr(), n_streams, *y1.shape[1:3],
                              cin, cout, mid, nb, k2.ws.data_ptr(),
                              k2.sb.data_ptr(), y2.data_ptr(), stream),
                           'stage2')
        return call

    libs = build_ablations()
    out = {'stem_ms': cuda_ms(lambda: (focus_stem(img, *kw['stem'], oh, ow),
                                       focus_stem(disp, *kw['disp_stem'],
                                                  oh, ow)), iters),
           'stage2_ms': cuda_ms(lambda: stage_csp(y1, k2), iters)}
    for tag, lib in libs.items():
        call = (stem_call if tag.startswith('stem_') else stage2_call)(lib)
        out[f'{tag}_ms'] = cuda_ms(call, iters)
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
