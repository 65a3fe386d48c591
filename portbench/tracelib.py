"""What a ``torch.profiler`` trace of the traced stretch holds, reduced for
the metric readers: the device's kernels and copies inside the stretch,
the host's operations, and the stretch itself (from the first call of
``track_raw`` to the last result on the host, by the benchmark's own
``portbench.call`` / ``portbench.wait`` ranges).  Times in seconds.
"""
from __future__ import annotations

import json
import re
from typing import Callable, Dict, List, NamedTuple, Optional, Sequence

DEVICE_CATS = ('kernel', 'gpu_memcpy', 'gpu_memset')
HOST_CATS = ('cpu_op', 'cuda_runtime', 'cuda_driver', 'user_annotation')

# the program's hand-written kernels, by the names of their __global__
# functions (stereotracking_tpu_torch/csrc/*.cu), matched whole: a
# library kernel's name may hold one of them (cuBLAS's ``..._stage3_...``)
STAGE_KERNELS = frozenset((
    'focus_stem_kernel', 'stage1_dual_kernel', 'stage1_mma_kernel',
    'stage_csp_kernel', 'stage3_fused_kernel', 'stage3_entry_kernel',
    'stage3_chain_kernel'))
TRACK_KERNELS = frozenset(('box_depths_kernel', 'jv_kernel', 'nms_kernel'))
# convolution and matrix-product kernels of cuDNN and cuBLAS, by parts of
# their names; cuDNN's FFT convolutions (its ``DSE::`` transforms and their
# complex products) among them
LIBRARY_KERNELS = ('cudnn', 'cublas', 'xmma', 'cutlass', 'gemm', 'gemv',
                   'implicit_convolve', 'convolve_', 'winograd', 'fft2d',
                   'DSE::', 'pointwise_mult_and_sum_complex',
                   'nchwToNhwc', 'nhwcToNchw', 'sm90_', 'sm80_', 'sm75_',
                   'fprop', 'dgrad', 'wgrad', 'magma', 'trsm', 'potrf')

# TF32 kernels of cuDNN and cuBLAS, by parts of their names
# (``sm90_xmma_fprop_implicit_gemm_f32f32_tf32f32_f32_...``, cuBLAS's
# CUTLASS ``tensorop_s1688gemm``): no cell runs one, since each states
# float32 with TF32 off or a 16-bit dtype
TF32_KERNELS = ('tf32', 's1688gemm')


class Event(NamedTuple):
    cat: str
    name: str
    start: float
    end: float


class Trace(NamedTuple):
    steps: int
    start: float
    end: float
    device: List[Event]
    host: List[Event]

    @property
    def window_s(self) -> float:
        return self.end - self.start


def load_chrome_trace(path: str, steps: int) -> Optional['Trace']:
    """The stretch of ``steps`` steps in a chrome trace; None when the
    trace holds no ``portbench.call`` range."""
    with open(path) as f:
        raw = json.load(f)
    events = raw['traceEvents'] if isinstance(raw, dict) else raw
    dev, host, marks = [], [], []
    for e in events:
        if e.get('ph') != 'X' or 'dur' not in e:
            continue
        ev = Event(e.get('cat', ''), str(e.get('name', '')),
                   float(e['ts']) * 1e-6,
                   (float(e['ts']) + float(e['dur'])) * 1e-6)
        if ev.cat in DEVICE_CATS:
            dev.append(ev)
        elif ev.cat in HOST_CATS:
            host.append(ev)
            if ev.name in ('portbench.call', 'portbench.wait'):
                marks.append(ev)
    if not marks:
        return None
    start = min(m.start for m in marks)
    end = max(m.end for m in marks)
    dev = [e for e in dev if e.end > start and e.start < end]
    return Trace(steps, start, end, dev, host)


def merged(intervals: Sequence[Event], start: float, end: float):
    """The union of the events' intervals, clipped to [start, end]."""
    spans = sorted((max(e.start, start), min(e.end, end)) for e in intervals)
    out: List[List[float]] = []
    for a, b in spans:
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def busy_s(tr: Trace) -> float:
    return sum(b - a for a, b in merged(tr.device, tr.start, tr.end))


def function_name(name: str) -> str:
    """The unqualified function of a kernel's name as the profiler gives
    it: ``void (anonymous namespace)::stage1_mma_kernel<8, 64>(...)`` ->
    ``stage1_mma_kernel``; a name with no argument list is itself."""
    name = name.replace('(anonymous namespace)::', '')
    head = re.split(r'[<(]', name, maxsplit=1)[0].split()
    return head[-1].rsplit('::', 1)[-1] if head else ''


def kind(e: Event) -> str:
    """'copy', 'stage', 'track', 'library' or 'torch' for a device event."""
    if e.cat != 'kernel':
        return 'copy'
    fn = function_name(e.name)
    if fn in STAGE_KERNELS:
        return 'stage'
    if fn in TRACK_KERNELS:
        return 'track'
    if any(k in e.name for k in LIBRARY_KERNELS):
        return 'library'
    return 'torch'


def tf32_kernels(tr: Trace) -> int:
    """Launches of TF32 kernels (``TF32_KERNELS``) in the trace."""
    return sum(e.cat == 'kernel' and any(k in e.name.lower()
                                         for k in TF32_KERNELS)
               for e in tr.device)


def device_s(tr: Trace, keep: Callable[[Event], bool]) -> float:
    return sum(e.end - e.start for e in tr.device if keep(e))


def per_step_ms(tr: Optional[Trace], keep: Callable[[Event], bool]
                ) -> Optional[float]:
    """Device milliseconds per step of the events ``keep`` selects; None
    without a trace or when it holds none of them."""
    if tr is None or not any(keep(e) for e in tr.device):
        return None
    return device_s(tr, keep) / tr.steps * 1e3


def top_ops(tr: Trace, n: int = 10) -> List[list]:
    tot: Dict[str, float] = {}
    for e in tr.device:
        tot[e.name[:64]] = tot.get(e.name[:64], 0.0) + (e.end - e.start)
    return [[k, v] for k, v in sorted(tot.items(), key=lambda kv: -kv[1])[:n]]


def idle_gaps(tr: Trace, n: int = 10) -> List[list]:
    """The ``n`` longest stretches with nothing on the device, each named
    by the innermost host operation running at its middle."""
    spans = merged(tr.device, tr.start, tr.end)
    edges = [tr.start] + [x for s in spans for x in s] + [tr.end]
    gaps = sorted(((edges[i + 1] - edges[i], edges[i])
                   for i in range(0, len(edges), 2)
                   if edges[i + 1] > edges[i]), reverse=True)[:n]
    out = []
    for length, a in gaps:
        mid = a + length / 2
        inner = [e for e in tr.host if e.start <= mid <= e.end]
        name = (min(inner, key=lambda e: e.end - e.start).name[:64]
                if inner else 'no_host_operation')
        out.append([name, length])
    return out
