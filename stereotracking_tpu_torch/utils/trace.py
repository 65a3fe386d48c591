"""The port's tracer: a phase clock inside the tracker step and host spans
around it, on one clock.

Always on and process-wide, with rings of fixed size allocated at first
use.

- Phase marks (``mark(phase, like)``): ``PHASES`` delimit the step's
  layers.  On a CUDA tensor a mark launches ``phase_mark_kernel``
  (``csrc/trace.cu``), one thread that reads the device's ``%globaltimer``
  (ns) and stores it into the current step's row of the phase ring; the
  ``'start'`` mark first advances a step counter on the device and writes
  it into a fresh row.  Inside a CUDA graph the marks are captured with
  the step, so every replay fills a row of its own with no host work.  The
  ring lives in pinned host memory that the kernel writes through its
  mapped address (the same pointer under unified addressing): reading it
  needs neither a copy nor a synchronisation, and the device's writes are
  posted.  On a CPU tensor a mark stores ``time.perf_counter_ns()`` (the
  eager CPU step is synchronous).  A row is open from its ``'start'`` mark
  to its ``'finish'`` mark; a mark outside an open row stores nothing, so a
  detector or tracker call outside the step leaves the ring as it is.
- Host spans (``span(name)``): the ``perf_counter_ns`` start and end of
  ``SPANS``, each with the step number of the call it belongs to
  (``begin_step``, once per ``track_raw``), which equals the device row's
  counter.  While a ``torch.profiler`` session runs, a span also opens
  ``record_function(name)``, so the profiler's trace carries the program's
  names; otherwise it costs one flag check.
- One clock (``device_offset_ns``): the device's timer against
  ``perf_counter_ns``, from the fastest of several round trips, with its
  error bound.  ``phase_rows`` gives device stamps on the host's clock,
  interpolating between the offsets measured (the first when the device is
  made ready, another when rows newer than the last are read).
- The replay counter (``replay_counter``): the Kalman updates the
  tracker's smoothing replay applied, and the steps, counted by the step
  itself (ops/slot_update_cuda.py), on the card by the kernel into a
  device tensor, on the CPU into a host tensor; nothing is counted inside
  ``unmarked``.  ``replay_counts`` reads both, a synchronisation: after
  the steps, never inside one.

The rings hold ``STEPS`` steps and ``SPAN_SLOTS`` spans; ``wrapped`` says
whether either has dropped rows since ``reset``.  The tracer follows the
first CUDA device it meets: marks on another are not recorded.  Spans are
written from the thread that drives the tracker.
"""
from __future__ import annotations

import array
import time
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

PHASES = ('start', 'preprocess', 'cmc', 'detector', 'nms', 'depth',
          'tracker', 'finish')
SPANS = ('frames', 'key', 'capture', 'load', 'replay', 'clone', 'fetch',
         'library')
# host layers: the spans each one sums, per step
HOST_LAYERS = {'host.frames_ms': ('frames',), 'host.key_ms': ('key',),
               'host.launch_ms': ('load', 'replay', 'clone'),
               'host.fetch_ms': ('fetch',)}
STEPS = 1 << 14
SPAN_SLOTS = 1 << 17
_COLS = 2 + len(PHASES)      # step, on the device, one stamp per phase
_PHASE = {p: i for i, p in enumerate(PHASES)}
_SPAN = {s: i for i, s in enumerate(SPANS)}
OFFSET_TRIES = 8


class _Span:
    __slots__ = ('tracer', 'index', 'name', 'start', 'range')

    def __init__(self, tracer: 'Tracer', name: str):
        self.tracer = tracer
        self.index = _SPAN[name]
        self.name = name
        self.range = None

    def __enter__(self):
        if torch._C._autograd._profiler_enabled():
            self.range = torch.profiler.record_function(self.name)
            self.range.__enter__()
        self.start = self.tracer.clock()

    def __exit__(self, *exc):
        self.tracer._put_span(self.index, self.start, self.tracer.clock())
        if self.range is not None:
            self.range.__exit__(*exc)


class _Unmarked:
    __slots__ = ('tracer',)

    def __init__(self, tracer):
        self.tracer = tracer

    def __enter__(self):
        self.tracer._unmarked += 1

    def __exit__(self, *exc):
        self.tracer._unmarked -= 1


class Tracer:
    """The rings and counters; ``TRACER`` is the process's own, and the
    module's functions act on it."""

    def __init__(self, steps: int = STEPS, span_slots: int = SPAN_SLOTS,
                 clock: Callable[[], int] = time.perf_counter_ns):
        self.steps = steps
        self.span_slots = span_slots
        self.clock = clock
        self.step = 0               # the host's step number (begin_step)
        self._rows = None           # (steps, _COLS) int64
        self._rows_t = None         # its pinned tensor, once on a card
        self._host_step = 0         # the CPU marks' step counter
        self._host_open = False
        self._spans = None          # name, step, start, end per span
        self._n_spans = 0
        self._unmarked = 0
        self._ctl = None            # (2,) int64 on the device: step, open
        self._stamp = None          # (1,) pinned int64: the offset's stamp
        self._offsets = []          # (device ns, offset ns, bound ns)
        # replay updates, steps: on the CPU, and on the card once ready
        self._host_replay = torch.zeros(2, dtype=torch.int64)
        self._replay = None

    # ---------------------------------------------------------- writing

    def begin_step(self) -> int:
        """Count one call of the step; its spans carry the number."""
        self.step += 1
        return self.step

    def span(self, name: str) -> _Span:
        return _Span(self, name)

    def _put_span(self, index: int, start: int, end: int) -> None:
        spans = self._spans
        if spans is None:           # an array: its items write fast
            spans = self._spans = array.array(
                'q', bytes(8 * 4 * self.span_slots))
        i = (self._n_spans % self.span_slots) * 4
        spans[i] = index
        spans[i + 1] = self.step
        spans[i + 2] = start
        spans[i + 3] = end
        self._n_spans += 1

    def unmarked(self) -> _Unmarked:
        """Inside it, marks store nothing: a run of the step that is not a
        step of the stream (the warm-up before a capture, whose state is
        put back)."""
        return _Unmarked(self)

    def _ring(self) -> np.ndarray:
        if self._rows is None:
            self._rows = np.zeros((self.steps, _COLS), np.int64)
        return self._rows

    def mark(self, phase: str, like: torch.Tensor) -> None:
        """Stamp ``phase`` of the step running on ``like``'s device."""
        if self._unmarked:
            return
        col = _PHASE[phase]
        if like.device.type == 'cuda':
            self._mark_device(col, like)
            return
        rows = self._ring()
        if col == 0:
            self._host_step += 1
            self._host_open = True
            row = rows[self._host_step % self.steps]
            row[:] = 0
            row[0] = self._host_step
            row[2] = self.clock()
        elif self._host_open:
            rows[self._host_step % self.steps, 2 + col] = self.clock()
            self._host_open = col != len(PHASES) - 1

    def ready(self, device: torch.device) -> None:
        """Load the kernel library, allocate the rings and the device's
        counter, and measure the clock offset: outside any capture, before
        the first marked step on ``device``."""
        if self._ctl is not None:
            return
        from .. import _kernels
        _kernels.library()
        self._rows_t = torch.zeros((self.steps, _COLS), dtype=torch.int64,
                                   pin_memory=True)
        self._rows_t.numpy()[:] = self._ring()     # the CPU's rows, if any
        self._rows = self._rows_t.numpy()
        self._ctl = torch.zeros(2, dtype=torch.int64, device=device)
        self._replay = torch.zeros(2, dtype=torch.int64, device=device)
        self._stamp = torch.zeros(1, dtype=torch.int64, pin_memory=True)
        self.device_offset_ns()

    def _mark_device(self, col: int, like: torch.Tensor) -> None:
        from .. import _kernels
        if self._ctl is None:
            if torch.cuda.is_current_stream_capturing():
                raise RuntimeError('trace.ready(device) must run before a '
                                   'marked step is captured')
            self.ready(like.device)
        if like.device != self._ctl.device:
            return
        status = _kernels.library().st_phase_mark(
            self._rows_t.data_ptr(), self._ctl.data_ptr(), self.steps,
            _COLS, col, _kernels.stream_ptr(like))
        _kernels.check(status, 'phase_mark')

    def replay_counter(self, like: torch.Tensor) -> Optional[torch.Tensor]:
        """The (2,) int64 counter of replay updates and steps that a
        tracker step on ``like``'s device adds to: the host's on the CPU,
        the card's on the card (made ready first, outside a capture).  None
        inside ``unmarked``, on a card the tracer does not follow, and in a
        capture before ``ready``."""
        if self._unmarked:
            return None
        if like.device.type != 'cuda':
            return self._host_replay
        if self._ctl is None:
            if torch.cuda.is_current_stream_capturing():
                return None
            self.ready(like.device)
        return self._replay if like.device == self._ctl.device else None

    def replay_counts(self) -> Tuple[int, int]:
        """(replay updates, steps) counted since the last reset, the host's
        and the card's together; reading the card's waits for it."""
        n = self._host_replay.clone()
        if self._replay is not None:
            n += self._replay.cpu()
        return int(n[0]), int(n[1])

    def device_offset_ns(self) -> int:
        """The device's timer less the host's ``perf_counter_ns``, from the
        fastest of ``OFFSET_TRIES`` round trips (host clock, a mark kernel
        stamping the slot, the host seeing it); its error bound, half that
        round trip, is kept beside it (``offset``)."""
        from .. import _kernels
        lib = _kernels.library()
        dev = self._ctl.device
        stream = torch.cuda.current_stream(dev)
        torch.cuda.synchronize(dev)
        slot = self._stamp.numpy()
        best = None
        for _ in range(OFFSET_TRIES):
            slot[0] = 0
            t0 = self.clock()
            _kernels.check(lib.st_phase_mark(self._stamp.data_ptr(), None,
                                             1, 1, 0, stream.cuda_stream),
                           'phase_mark')
            for _ in range(1 << 20):
                if slot[0]:
                    break
            else:
                stream.synchronize()
            t1 = self.clock()
            stamp = int(slot[0])
            if best is None or t1 - t0 < best[1] - best[0]:
                best = (t0, t1, stamp)
        stream.synchronize()
        t0, t1, stamp = best
        offset = stamp - (t0 + t1) // 2
        self._offsets.append((stamp, offset, (t1 - t0 + 1) // 2))
        return offset

    def offset(self) -> Optional[Tuple[int, int]]:
        """The last offset measured and its error bound, in ns."""
        return self._offsets[-1][1:] if self._offsets else None

    def reset(self) -> None:
        """Empty the rings and restart the step numbers (with no step in
        flight)."""
        if self._rows is not None:
            self._rows[:] = 0
        if self._ctl is not None:
            self._ctl.zero_()
            self._replay.zero_()
        self._host_replay.zero_()
        self.step = self._host_step = self._n_spans = 0
        self._host_open = False

    # ---------------------------------------------------------- reading

    def wrapped(self) -> bool:
        """Whether a ring has dropped rows since the last reset."""
        last = 0 if self._rows is None else int(self._rows[:, 0].max())
        return last > self.steps or self._n_spans > self.span_slots

    def phase_rows(self) -> np.ndarray:
        """The phase ring's rows in step order, a copy: fields ``step``,
        ``device`` and one per phase, each stamp in ns on the host's
        ``perf_counter_ns`` clock (0: not marked)."""
        raw = (np.zeros((0, _COLS), np.int64) if self._rows is None
               else self._rows.copy())
        raw = raw[raw[:, 0] > 0]
        raw = raw[np.argsort(raw[:, 0], kind='stable')]
        stamps = raw[:, 2:]
        on_dev = raw[:, 1] != 0
        if on_dev.any():
            newest = int(stamps[on_dev].max())
            if self._ctl is not None and (
                    not self._offsets or self._offsets[-1][0] < newest):
                self.device_offset_ns()
            dev = stamps[on_dev]
            at = np.array([o[0] for o in self._offsets], np.float64)
            off = np.array([o[1] for o in self._offsets], np.float64)
            shift = np.rint(np.interp(dev, at, off)).astype(np.int64)
            stamps[on_dev] = np.where(dev > 0, dev - shift, 0)
        out = np.zeros(len(raw), [('step', 'i8'), ('device', '?')]
                       + [(p, 'i8') for p in PHASES])
        out['step'] = raw[:, 0]
        out['device'] = on_dev
        for i, p in enumerate(PHASES):
            out[p] = stamps[:, i]
        return out

    def span_rows(self) -> np.ndarray:
        """The span ring's rows in the order written, a copy: fields
        ``name``, ``step``, ``start`` and ``end`` (ns, ``perf_counter``)."""
        n = min(self._n_spans, self.span_slots)
        raw = (np.zeros((0, 4), np.int64) if self._spans is None else
               np.frombuffer(self._spans, np.int64).reshape(-1, 4))
        if self._n_spans > self.span_slots:
            raw = np.roll(raw, -(self._n_spans % self.span_slots), axis=0)
        raw = raw[:n].copy()
        out = np.zeros(n, [('name', 'U8'), ('step', 'i8'), ('start', 'i8'),
                           ('end', 'i8')])
        out['name'] = np.array(SPANS)[raw[:, 0]]
        out['step'], out['start'], out['end'] = raw[:, 1], raw[:, 2], \
            raw[:, 3]
        return out


TRACER = Tracer()


# ------------------------------------------------ the process's tracer

def begin_step() -> int:
    return TRACER.begin_step()


def last_step() -> int:
    """The number of the last step begun."""
    return TRACER.step


def span(name: str) -> _Span:
    """``with span(name):`` times a host stretch of the current step."""
    return TRACER.span(name)


def unmarked() -> _Unmarked:
    return TRACER.unmarked()


def mark(phase: str, like: torch.Tensor) -> None:
    TRACER.mark(phase, like)


def ready(device: torch.device) -> None:
    TRACER.ready(device)


def device_offset_ns() -> int:
    return TRACER.device_offset_ns()


def replay_counter(like: torch.Tensor) -> Optional[torch.Tensor]:
    return TRACER.replay_counter(like)


def replay_counts() -> Tuple[int, int]:
    return TRACER.replay_counts()


def replay_updates_per_step(since: Tuple[int, int] = (0, 0)
                            ) -> Optional[float]:
    """Replay updates a tracker step (all its streams), over the steps
    counted after ``since`` (an earlier ``replay_counts()``, by default the
    last reset); None without a step."""
    updates, steps = replay_counts()
    steps -= since[1]
    return (updates - since[0]) / steps if steps > 0 else None


def offset() -> Optional[Tuple[int, int]]:
    return TRACER.offset()


def reset() -> None:
    TRACER.reset()


def wrapped() -> bool:
    return TRACER.wrapped()


def phase_rows() -> np.ndarray:
    return TRACER.phase_rows()


def span_rows() -> np.ndarray:
    return TRACER.span_rows()


# ------------------------------------------------- per-step tables

def per_step(rows: np.ndarray) -> Dict[str, np.ndarray]:
    """Milliseconds per step for ``rows`` (``phase_rows``), NaN where a step
    lacks the stamp or span: ``phase.<p>_ms`` (from the latest earlier mark
    to the mark of ``p``), ``step.device_ms`` (start to finish),
    ``step.between_ms`` (this finish to the next row's start),
    ``step.queue_ms`` (the start mark less the start of the step's
    ``replay`` span) and the ``HOST_LAYERS`` (their spans' total)."""
    n = len(rows)
    out = {}
    last = rows['start'].astype(np.float64)
    for p in PHASES[1:]:
        t = rows[p].astype(np.float64)
        t[rows[p] == 0] = np.nan
        out[f'phase.{p}_ms'] = (t - last) * 1e-6
        last = np.where(np.isnan(t), last, t)
    start = rows['start'].astype(np.float64)
    finish = rows['finish'].astype(np.float64)
    finish[rows['finish'] == 0] = np.nan
    out['step.device_ms'] = (finish - start) * 1e-6
    out['step.between_ms'] = np.append(start[1:] - finish[:-1],
                                       np.nan)[:n] * 1e-6
    spans = span_rows()
    pos = np.zeros(len(spans), np.int64)
    mine = np.zeros(len(spans), bool)
    if n:
        pos = np.minimum(np.searchsorted(rows['step'], spans['step']), n - 1)
        mine = rows['step'][pos] == spans['step']
    dur = (spans['end'] - spans['start']).astype(np.float64) * 1e-6
    for layer, names in HOST_LAYERS.items():
        sel = mine & np.isin(spans['name'], names)
        total = np.bincount(pos[sel], dur[sel], n)
        seen = np.bincount(pos[sel], minlength=n) > 0
        out[layer] = np.where(seen, total, np.nan)
    replay = np.full(n, np.inf)
    sel = mine & (spans['name'] == 'replay')
    np.minimum.at(replay, pos[sel], spans['start'][sel].astype(np.float64))
    out['step.queue_ms'] = np.where(np.isfinite(replay),
                                    (start - replay) * 1e-6, np.nan)
    return out


def window(steps: int, tail: int) -> Optional[Dict[str, np.ndarray]]:
    """``per_step`` of the ``steps`` rows just before the last ``tail``
    rows; None if a ring wrapped, or those rows are fewer or their step
    numbers not consecutive."""
    rows = phase_rows()
    if wrapped() or steps < 1 or len(rows) < steps + tail:
        return None
    rows = rows[len(rows) - tail - steps:len(rows) - tail]
    if np.any(np.diff(rows['step']) != 1):
        return None
    return per_step(rows)


def median(values: np.ndarray) -> Optional[float]:
    """The median of the values that are not NaN; None without any."""
    v = values[~np.isnan(values)]
    return float(np.median(v)) if len(v) else None


def percentile(values: np.ndarray, q: float) -> Optional[float]:
    v = values[~np.isnan(values)]
    return float(np.percentile(v, q)) if len(v) else None


def span_total_s(name: str) -> Optional[float]:
    """Seconds of every ``name`` span in the ring; None without one or
    after a wrap."""
    spans = span_rows()
    sel = spans['name'] == name
    if wrapped() or not sel.any():
        return None
    return float((spans['end'][sel] - spans['start'][sel]).sum()) * 1e-9


def summary(first_step: int, since: Optional[Tuple[int, int]] = None
            ) -> Dict[str, float]:
    """The medians of ``phase.*_ms`` and ``host.*_ms`` over the finished
    steps numbered ``first_step`` on, for an operator's log; given
    ``since`` (``replay_counts()`` before those steps), also
    ``tracker.replay_updates``, the replay updates a step after it."""
    rows = phase_rows()
    rows = rows[(rows['step'] >= first_step) & (rows['finish'] > 0)]
    out = {}
    for k, v in per_step(rows).items():
        if k.startswith(('phase.', 'host.')):
            m = median(v)
            if m is not None:
                out[k] = m
    updates = None if since is None else replay_updates_per_step(since)
    if updates is not None:
        out['tracker.replay_updates'] = updates
    return out
