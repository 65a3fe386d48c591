"""Build, load and count the hand-written CUDA kernels.

All ``csrc/*.cu`` sources compile with ``nvcc`` (one process per source,
all started together) and link into ONE shared library with a plain C
interface, loaded through ``ctypes``.  The build runs at first use and again
whenever a source or a flag changes (the library's file name carries a hash
of both), into ``_build/`` beside this file.  Nothing is built or loaded
when this module is imported.

Each C entry point launches on the stream it is given and returns
``cudaGetLastError()``; ``check`` raises on a non-zero status.  Each Python
wrapper adds one to its kernel's launch count right after a launch, and
nowhere else, so a run can show which kernels its main path went through
(a CUDA graph's replay calls no wrapper: a ``torch.profiler`` trace counts
the kernels it runs).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parent / 'csrc'
BUILD_DIR = Path(__file__).resolve().parent / '_build'
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-O3',
              '-std=c++17', '-Xcompiler', '-fPIC')
KERNELS = ('stem', 'stage1', 'stage2', 'stage3', 'depth', 'assignment',
           'nms', 'stage1_variants', 'slot_update')

_launches: Dict[str, int] = dict.fromkeys(KERNELS, 0)
_lib = None
_ptxas_logs: Dict[str, str] = {}   # source -> its ptxas -v output, as built

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C signatures: every entry returns the cudaError_t of its launch as int
_SIGNATURES = {
    # frame, is_disp, n, h, w, out_h, out_w, cout, weight, sb, out, stream
    'st_focus_stem': (_P, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P),
    # x_rgb, x_disp, n, h, w, cin, cout, mid, nb, w_rgb, sb_rgb, w_disp,
    # sb_disp, out, variant, stream
    'st_stage1_dual': (_P, _P, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P,
                       _P, _I, _P),
    # x, n, h, w, cin, cout, mid, nb, weights, sb, out, stream
    'st_stage_csp': (_P, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P),
    # x, n, h, w, cin, cout, mid, nb, weights, sb, b_slice, ms scratch,
    # out, stream
    'st_stage3': (_P, _I, _I, _I, _I, _I, _I, _I, _P, _P, _I, _P, _P, _P),
    # disp (n maps), n, h, w, boxes, boxes stream stride, valid, valid
    # stream stride, boxes per stream, crop, bf, rmin, depth, scale, stats,
    # stream
    'st_box_depths': (_P, _I, _I, _I, _P, _I, _P, _I, _I, _I, _F, _I, _P,
                      _P, _P, _P),
    # cost, need, n, k, c, row2col, stream
    'st_jv_assign': (_P, _P, _I, _I, _I, _P, _P),
    # boxes, finite, n, k, thr, eps, max_keep, mask scratch, tickets, keep,
    # stream
    'st_nms_keep': (_P, _P, _I, _I, _F, _F, _I, _P, _P, _P, _P),
    # rows, ctl (NULL: stamp rows[0] alone), n rows, n cols, phase, stream
    'st_phase_mark': (_P, _P, _I, _I, _I, _P),
    # pointers (ops/slot_update_cuda.POINTERS), their count, ints
    # (slot_update_cuda.DIMS), their count, stream
    'st_slot_update': (_P, _I, _P, _I, _P),
}


def launch_counts() -> Dict[str, int]:
    """Launches per kernel since the last ``reset_launch_counts``."""
    return dict(_launches)


def reset_launch_counts() -> None:
    for k in _launches:
        _launches[k] = 0


def count_launch(name: str) -> None:
    _launches[name] += 1


def _nvcc() -> str:
    home = os.environ.get('CUDA_HOME') or '/usr/local/cuda'
    cand = Path(home) / 'bin' / 'nvcc'
    if cand.exists():
        return str(cand)
    found = shutil.which('nvcc')
    if found is None:
        raise RuntimeError('nvcc not found (set CUDA_HOME); the CUDA '
                           'kernels can only be built where the CUDA '
                           'toolkit is installed')
    return found


def _sources():
    return sorted(CSRC.glob('*.cu')), sorted(CSRC.glob('*.cuh'))


def library_path() -> Path:
    cu, cuh = _sources()
    h = hashlib.sha256(' '.join(NVCC_FLAGS).encode())
    for p in cu + cuh:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f'libst_kernels_{h.hexdigest()[:16]}.so'


def build() -> Path:
    """Compile the kernels unless a library of the same sources exists."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu, _ = _sources()
    tag = f'{out.stem}.{os.getpid()}'
    objs = [BUILD_DIR / f'{tag}.{p.stem}.o' for p in cu]
    # -Xptxas -v only reports (registers, shared memory, spills): the code
    # is the same, and ptxas_usage reads the reports without a recompile
    cmds = [[_nvcc(), *NVCC_FLAGS, '-Xptxas', '-v', '-c', '-o', str(o),
             str(p)] for p, o in zip(cu, objs)]
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    logs = [p.communicate()[0] for p in procs]
    tmp = out.with_suffix(f'.{os.getpid()}.tmp')
    link = [_nvcc(), '-shared', *NVCC_FLAGS[:2], '-o', str(tmp),
            *map(str, objs)]
    try:
        for cmd, proc, log in zip(cmds, procs, logs):
            if proc.returncode != 0:
                raise RuntimeError(f'nvcc failed ({proc.returncode}):\n'
                                   f'{" ".join(cmd)}\n{log}')
        res = subprocess.run(link, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f'nvcc link failed ({res.returncode}):\n'
                               f'{" ".join(link)}\n{res.stdout}\n'
                               f'{res.stderr}')
    finally:
        for o in objs:
            o.unlink(missing_ok=True)
    os.replace(tmp, out)
    _ptxas_logs.update((p.name, log) for p, log in zip(cu, logs))
    return out


def ptxas_usage(sources) -> Dict[str, list]:
    """Each named source's (file names under ``csrc/``, or paths ending in
    them) ptxas lines on entry functions, registers, shared memory and
    spills: from this process's build where it built them, else from a
    compile with ``-Xptxas -v``, all at once."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    names = [Path(s).name for s in sources]
    logs = {n: _ptxas_logs[n] for n in names if n in _ptxas_logs}
    todo = [n for n in names if n not in logs]
    objs = [BUILD_DIR / f'ptxas.{os.getpid()}.{Path(n).stem}.o' for n in todo]
    procs = [subprocess.Popen(
        [_nvcc(), *NVCC_FLAGS, '-Xptxas', '-v', '-c', '-o', str(o),
         str(CSRC / n)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for n, o in zip(todo, objs)]
    for n, o, p in zip(todo, objs, procs):
        logs[n] = p.communicate()[0]
        o.unlink(missing_ok=True)
        if p.returncode != 0:
            raise RuntimeError(f'nvcc -Xptxas -v {n} failed:\n{logs[n]}')
    return {n: [line.strip() for line in logs[n].splitlines()
                if any(k in line for k in ('Compiling entry', 'registers',
                                           'spill'))] for n in names}


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call), its build or load
    timed by the tracer's ``library`` span."""
    global _lib
    if _lib is None:
        from .utils import trace
        with trace.span('library'):
            lib = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
        lib.st_error_string.argtypes = [ctypes.c_int]
        lib.st_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def check(status: int, name: str) -> None:
    if status != 0:
        msg = library().st_error_string(status).decode()
        raise RuntimeError(f'{name}: CUDA error {status} ({msg})')


def stream_ptr(t) -> int:
    """The current stream of ``t``'s device, as a C pointer value."""
    import torch
    return torch.cuda.current_stream(t.device).cuda_stream


def require_cuda(name: str, *tensors, strided=()) -> None:
    """Raise unless every tensor lies on the same CUDA device and each of
    ``tensors`` is contiguous (the kernels take dense NHWC / row-major
    buffers; those in ``strided`` come with strides the kernel is given)."""
    dev = tensors[0].device
    for t in (*tensors, *strided):
        if t.device.type != 'cuda' or t.device != dev:
            raise ValueError(f'{name}: every tensor must be on {dev}, '
                             f'got {t.device}')
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f'{name}: tensors must be contiguous')
