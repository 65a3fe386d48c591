"""Steps 5-7 of the tracker's main path (ops/slot_update_cuda.py) on the
CPU, where the op chain runs: the invariant the kernel relies on, and the
replay counter.

- The op chain with its replay cut to the step's largest ``unmatch_len``
  gives the same state and outputs, bit for bit, as with its fixed trip
  count ``replay_bound(cfg)``, over sequences that recover a track after
  every gap of 1 to ``num_frames_retain - 1`` frames: the iterations past
  a slot's ``unmatch_len`` are exact no-ops, so the kernel, which runs
  each slot's own ``unmatch_len`` updates, leaves them out.
- The plain version's count of replay updates, added to the tracer's
  counter, is the sum of ``unmatch_len`` over the recovered slots, with
  one step a call; inside ``trace.unmarked`` nothing is counted.
- The kernel's argument order (``POINTERS``, ``DIMS``) is the CUDA
  source's.
"""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from stereotracking_tpu_torch.models import tracker as tt
from stereotracking_tpu_torch.ops import slot_update_cuda
from stereotracking_tpu_torch.utils import trace
from device_step_cases import recovery_frames

RETAIN = 30           # the flagship's num_frames_retain
CFG = tt.TrackerConfig(num_slots=16, num_dets=16, num_frames_retain=RETAIN)


@pytest.fixture(autouse=True, scope='module')
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batch(frame):
    return tt.add_stream_axis(tt.Detections(
        **{k: torch.from_numpy(v) for k, v in frame.items()}))


def _unmatch_len(state, slot_det):
    recovered = (slot_det >= 0) & ~state.tracked
    return torch.where(recovered, state.miss_count, 0)


@pytest.mark.parametrize('gap', range(1, RETAIN))
def test_replay_cut_to_largest_unmatch_len_is_bit_exact(monkeypatch, gap):
    """Each step twice from the same state: the op chain as the step runs
    it, and with its trip count the step's largest ``unmatch_len``.  The
    track lost for ``gap`` frames is recovered with that ``unmatch_len``,
    and the counter grows by the recovered slots' ``unmatch_len``."""
    frames = recovery_frames(gap + 12, CFG.num_dets, gaps=(gap,), steady=3,
                             seed=gap)
    plain = slot_update_cuda.slot_update_plain
    seen = []

    def cut(state, slot_det, dets, fid, cfg, trips=None):
        unmatch = _unmatch_len(state, slot_det)
        seen.append(unmatch)
        return plain(state, slot_det, dets, fid, cfg,
                     trips=int(unmatch.max()))

    state = tt.init_state(CFG, n_streams=1)
    longest = 0
    for f, frame in enumerate(frames):
        dets = _batch(frame)
        before = trace.replay_counts()
        full, out = tt.step(state, dets, [f], CFG)
        after = trace.replay_counts()
        with monkeypatch.context() as m:
            m.setattr(slot_update_cuda, 'slot_update_plain', cut)
            short, short_out = tt.step(state, dets, [f], CFG)
        for name, a, b in zip((*full._fields, *out._fields),
                              (*full, *out), (*short, *short_out)):
            np.testing.assert_array_equal(a.numpy(), b.numpy(),
                                          err_msg=f'frame {f} {name}')
        assert after[0] - before[0] == int(seen[-1].sum()), f
        assert after[1] - before[1] == 1
        longest = max(longest, int(seen[-1].max()))
        state = full
    assert longest == gap


def test_replay_counter_on_the_cpu():
    """The host counter: one step a call of the main path, nothing inside
    ``unmarked``, zero after ``reset``; ``replay_updates_per_step`` over
    the steps after an earlier reading."""
    frames = recovery_frames(12, CFG.num_dets, gaps=(2,), steady=2, seed=3)
    trace.reset()
    assert trace.replay_counts() == (0, 0)
    assert trace.replay_updates_per_step() is None
    state = tt.init_state(CFG, n_streams=1)
    for f, frame in enumerate(frames):
        state, _ = tt.step(state, _batch(frame), [f], CFG)
    updates, steps = trace.replay_counts()
    assert steps == len(frames) and updates >= 2
    assert trace.replay_updates_per_step() == updates / steps
    mark = trace.replay_counts()
    with trace.unmarked():
        tt.step(state, _batch(frames[0]), [len(frames)], CFG)
    assert trace.replay_counts() == mark
    assert trace.replay_updates_per_step(since=mark) is None
    trace.reset()
    assert trace.replay_counts() == (0, 0)


def test_kernel_argument_order_matches_the_source():
    src = (Path(slot_update_cuda.__file__).resolve().parent.parent / 'csrc'
           / 'slot_update.cu').read_text()

    def enum(name):
        body = re.search(r'enum %s \{(.*?)\};' % name, src, re.S).group(1)
        return [w for w in re.findall(r'\w+', body)]

    assert enum('Ptr') == [p.upper() for p in slot_update_cuda.POINTERS] + \
        ['N_PTRS']
    assert enum('Dim') == [d.upper() for d in slot_update_cuda.DIMS] + \
        ['N_DIMS']
