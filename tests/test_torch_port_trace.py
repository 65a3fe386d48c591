"""The port's tracer (``stereotracking_tpu_torch/utils/trace.py``) on the
CPU: the phase rows and host spans that ``track_raw`` leaves, and the
benchmark's readers of them (``portbench/metrics/``) on synthetic rows.
The card's side (the mark kernel inside the CUDA graph, the clock offset)
is in tests/test_torch_port_cuda.py."""
from pathlib import Path

import numpy as np
import pytest
import torch

from stereotracking_tpu_torch.models import tracker as tt
from stereotracking_tpu_torch.models.detector import DetectorConfig
from stereotracking_tpu_torch.models.mot import (MOTConfig, OCSORTDisparity,
                                                 fetch_result,
                                                 predict_frame_raw)
from stereotracking_tpu_torch.ops.gmc import GMCConfig
from stereotracking_tpu_torch.parallel.multistream import MultiStreamTracker
from stereotracking_tpu_torch.utils import trace

REPO = Path(__file__).resolve().parents[1]
H, W = 64, 96
ORDER = ('start', 'preprocess', 'cmc', 'detector', 'nms', 'depth', 'tracker',
         'finish')


@pytest.fixture(autouse=True, scope='module')
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def tracer(monkeypatch):
    """A fresh process tracer for the test."""
    t = trace.Tracer()
    monkeypatch.setattr(trace, 'TRACER', t)
    return t


def small_cfg(cmc=None):
    return MOTConfig(
        detector=DetectorConfig(widen_factor=0.25, pre_nms_top_k=128,
                                max_per_img=32),
        tracker=tt.TrackerConfig(num_slots=8, num_dets=8), cmc=cmc)


def _frames(n, streams, h=H, w=W, seed=0):
    rng = np.random.RandomState(seed)
    img = rng.randint(0, 256, (n, streams, h, w, 3)).astype(np.uint8)
    disp = rng.randint(16, 1600, (n, streams, h, w)).astype(np.uint16)
    return img, disp


def _assert_in_order(rows, cmc):
    for r in rows:
        stamps = [int(r[p]) for p in ORDER if p != 'cmc' or cmc]
        assert all(s > 0 for s in stamps), r
        assert stamps == sorted(stamps), r
        assert (int(r['cmc']) > 0) == cmc, r
    assert (np.diff(rows['start']) > 0).all()
    assert (rows['start'][1:] >= rows['finish'][:-1]).all()


def test_track_raw_one_row_a_step(tracer):
    """Four MultiStreamTracker.track_raw steps give four phase rows in step
    order, every phase stamped once and in order; each call's frames and
    fetch spans carry its row's step number and fall around its row."""
    ms = MultiStreamTracker(small_cfg(), 2, device='cpu', seed=0)
    img, disp = _frames(4, 2)
    for t in range(4):
        fetch_result(ms.track_raw(img[t], disp[t], [t, t]))()
    rows = trace.phase_rows()
    assert rows['step'].tolist() == [1, 2, 3, 4]
    assert not rows['device'].any()
    _assert_in_order(rows, cmc=False)
    spans = trace.span_rows()
    assert sorted(set(spans['name'])) == ['fetch', 'frames']
    for name in ('frames', 'fetch'):
        assert spans['step'][spans['name'] == name].tolist() == [1, 2, 3, 4]
    for r in rows:
        mine = spans[spans['step'] == r['step']]
        frames = mine[mine['name'] == 'frames'][0]
        fetch = mine[mine['name'] == 'fetch'][0]
        assert frames['end'] <= r['start'] and r['finish'] <= fetch['start']
    assert trace.last_step() == 4 and not trace.wrapped()


@pytest.mark.parametrize('cmc', [False, True])
def test_cmc_adds_its_phase(tracer, cmc):
    """OCSORTDisparity.track_raw stamps the camera-motion phase, between
    preprocessing and the detector, only with ``cfg.cmc``."""
    cfg = small_cfg(GMCConfig(size=64) if cmc else None)
    model = OCSORTDisparity(cfg, device='cpu', seed=1)
    img, disp = _frames(2, 1, 128, 128, seed=3)
    for t in range(2):
        fetch_result(model.track_raw(img[t, 0], disp[t, 0], t))()
    rows = trace.phase_rows()
    assert rows['step'].tolist() == [1, 2]
    _assert_in_order(rows, cmc)
    assert trace.span_rows()['step'].tolist() == [1, 1, 2, 2]


def test_marks_outside_the_step_store_nothing(tracer):
    """A detector + tracker call outside the raw-frame step (no start
    mark) leaves the ring as it was; a step's row stays its own."""
    model = OCSORTDisparity(small_cfg(), device='cpu', seed=2)
    img, disp = _frames(2, 1)
    model.track_raw(img[0, 0], disp[0, 0], 0)
    before = trace.phase_rows()
    with tracer.unmarked():
        model.track_raw(img[1, 0], disp[1, 0], 1)
    predict_frame_raw(model.module, model.state, torch.from_numpy(img[1, 0]),
                      torch.from_numpy(disp[1, 0]), 1, model.cfg, H, W)
    after = trace.phase_rows()
    assert after.tolist() == before.tolist()


def test_a_wrapped_ring_says_so():
    t = trace.Tracer(steps=4, span_slots=8, clock=iter(range(1, 10**6))
                     .__next__)
    like = torch.zeros(1)
    for _ in range(4):
        t.begin_step()
        with t.span('frames'):
            pass
        t.mark('start', like)
        t.mark('finish', like)
    assert not t.wrapped()
    assert t.phase_rows()['step'].tolist() == [1, 2, 3, 4]
    t.begin_step()
    t.mark('start', like)
    assert t.wrapped()
    assert t.phase_rows()['step'].tolist() == [2, 3, 4, 5]
    for _ in range(5):
        with t.span('key'):
            pass
    spans = t.span_rows()
    assert spans['name'].tolist() == ['frames'] * 3 + ['key'] * 5
    assert (np.diff(spans['start']) > 0).all()


# --------------------------------------------- readers, synthetic rows

LEAD, STEPS, TAIL = 5, 9, 33      # warm-up, window, traced + follow steps
PHASE_NS = {'preprocess': (100_000, 11), 'detector': (2_000_000, 13),
            'nms': (300_000, 17), 'depth': (100_000, 19),
            'tracker': (500_000, 23), 'finish': (200_000, 29)}
LIBRARY_NS = 12_345_678
CAPTURE_NS = 5_000_000


class _Clock:
    t = 0

    def __call__(self):
        return self.t


def _base(s):
    return s * 10_000_000


def _queue(s):
    return 3000 + 7 * s


def _phase(p, s):
    a, b = PHASE_NS[p]
    return a + b * s


def _synthetic(monkeypatch, n_rows, steps=None):
    """A tracer holding ``n_rows`` steps written as track_raw writes them,
    each duration a linear function of the step number."""
    clock = _Clock()
    t = trace.Tracer(steps=steps or trace.STEPS, clock=clock)
    monkeypatch.setattr(trace, 'TRACER', t)
    like = torch.zeros(1)

    def span(name, at, dur):
        clock.t = at
        with t.span(name):
            clock.t = at + dur

    for s in range(1, n_rows + 1):
        b = _base(s)
        t.begin_step()
        span('frames', b, 1000 + 10 * s)
        span('frames', b + 2000, 500)
        if s == 1:
            span('library', b + 3000, LIBRARY_NS)
        span('key', b + 4000, 300 + s)
        span('capture' if s == 1 else 'load', b + 5000,
             CAPTURE_NS if s == 1 else 2000 + 5 * s)
        replay = b + 10_000 + (CAPTURE_NS if s == 1 else 0)
        span('replay', replay, 400 + s)
        clock.t = at = replay + _queue(s)
        t.mark('start', like)
        for p in ('preprocess', 'detector', 'nms', 'depth', 'tracker',
                  'finish'):
            clock.t = at = at + _phase(p, s)
            t.mark(p, like)
        span('clone', at + 100, 700 + 2 * s)
        span('fetch', at + 1000, 900 + 3 * s)
    return t


def _window():
    return np.arange(LEAD + 1, LEAD + STEPS + 1)


def _device_ms(s):
    return sum(_phase(p, s) for p in PHASE_NS) * 1e-6


def _start(s):
    return _base(s) + 10_000 + (CAPTURE_NS if s == 1 else 0) + _queue(s)


WANT = {
    **{f'phase.{p}_ms': (lambda p: lambda: np.median(
        [_phase(p, s) * 1e-6 for s in _window()]))(p) for p in PHASE_NS},
    'step.device_ms_p95': lambda: np.percentile(
        [_device_ms(s) for s in _window()], 95),
    'step.between_ms': lambda: np.median(
        [(_start(s + 1) - _start(s)) * 1e-6 - _device_ms(s)
         for s in _window()[:-1]]),
    'step.queue_ms': lambda: np.median([_queue(s) * 1e-6
                                        for s in _window()]),
    'host.frames_ms': lambda: np.median([(1500 + 10 * s) * 1e-6
                                         for s in _window()]),
    'host.key_ms': lambda: np.median([(300 + s) * 1e-6 for s in _window()]),
    'host.launch_ms': lambda: np.median(
        [(2000 + 5 * s + 400 + s + 700 + 2 * s) * 1e-6 for s in _window()]),
    'host.fetch_ms': lambda: np.median([(900 + 3 * s) * 1e-6
                                        for s in _window()]),
    'setup.library_s': lambda: LIBRARY_NS * 1e-9,
    'setup.capture_s': lambda: CAPTURE_NS * 1e-9,
}


def _reader(name):
    from portbench import harness
    return harness.metric_reader(REPO, name)


def test_every_new_metric_has_a_reader_and_an_entry():
    import json
    bench = json.loads((REPO / 'BENCHMARK.json').read_text())
    per_layer = {m['name']: m for m in bench['per_layer']}
    for name in WANT:
        assert name in per_layer, name
        assert per_layer[name]['moves'] == (
            'setup_s' if name.startswith('setup.') else 'pairs_per_s')
        assert callable(_reader(name))


@pytest.mark.parametrize('name', sorted(WANT))
def test_reader_reads_the_window(monkeypatch, name):
    """Each reader, on rows written through the tracer, reads exactly the
    window's steps (the rows before the traced and following steps)."""
    _synthetic(monkeypatch, LEAD + STEPS + TAIL)
    got = _reader(name)({'steps': STEPS})
    assert got == pytest.approx(float(WANT[name]()), rel=1e-9, abs=1e-12)


@pytest.mark.parametrize('name', sorted(WANT))
def test_reader_gives_none_on_a_wrapped_ring(monkeypatch, name):
    _synthetic(monkeypatch, LEAD + STEPS + TAIL,
               steps=LEAD + STEPS + TAIL - 1)
    assert trace.wrapped()
    assert _reader(name)({'steps': STEPS}) is None


@pytest.mark.parametrize('name', sorted(WANT))
def test_reader_gives_none_without_rows(monkeypatch, name):
    monkeypatch.setattr(trace, 'TRACER', trace.Tracer())
    assert _reader(name)({'steps': STEPS}) is None


def test_window_needs_consecutive_steps(monkeypatch):
    t = _synthetic(monkeypatch, LEAD + STEPS + TAIL)
    assert trace.window(STEPS, TAIL) is not None
    t._rows[LEAD + 3, 0] = 0              # a row of the window lost
    assert trace.window(STEPS, TAIL - 1) is None
    assert trace.window(LEAD + STEPS + TAIL, 0) is None


def test_summary_of_an_interval(monkeypatch):
    """The operator's medians: every phase and host layer over the steps
    from the one given."""
    _synthetic(monkeypatch, 12)
    got = trace.summary(5)
    steps = np.arange(5, 13)
    assert set(got) == {*(f'phase.{p}_ms' for p in PHASE_NS),
                        *trace.HOST_LAYERS}
    assert got['phase.detector_ms'] == pytest.approx(
        np.median([_phase('detector', s) * 1e-6 for s in steps]))
    assert got['host.key_ms'] == pytest.approx(
        np.median([(300 + s) * 1e-6 for s in steps]))


def test_summary_adds_the_replay_updates(monkeypatch):
    """Given the counts read before the steps, the operator's summary adds
    the replay updates a step since then; with no step since, nothing."""
    t = _synthetic(monkeypatch, 12)
    t._host_replay += torch.tensor([40, 8])
    got = trace.summary(5, since=(10, 2))
    assert got['tracker.replay_updates'] == 30 / 6
    assert 'tracker.replay_updates' not in trace.summary(5, since=(40, 8))
    assert 'tracker.replay_updates' not in trace.summary(5)


def test_replay_updates_reader(tracer, monkeypatch):
    """``portbench/metrics/tracker.replay_updates.py``: the counter's
    updates a step over the run's steps (CPU steps here, the plain version
    counting); None before a step and for a program without the
    counter."""
    read = _reader('tracker.replay_updates')
    assert read({'steps': 1}) is None
    ms = MultiStreamTracker(small_cfg(), 2, device='cpu', seed=0)
    img, disp = _frames(4, 2)
    for t in range(4):
        fetch_result(ms.track_raw(img[t], disp[t], [t, t]))()
    updates, steps = trace.replay_counts()
    assert steps == 4
    assert read({'steps': 1}) == updates / 4
    monkeypatch.delattr(trace, 'replay_updates_per_step')
    assert read({'steps': 1}) is None
