"""The port's device-resident tracker step against the JAX package, on the
CPU.

- (a) ``linear_assignment_with_limit`` (tensor fast paths + the JV's plain
  version) equals the JAX one exactly on seeded (S, 64, 64) problems: masks,
  exact ties, all-star rows, all-conflicted rows, costs at the limit.
- (b) ``batched_nms`` equals the JAX one exactly on 2048 of 2500
  candidates: two labels, chains of overlapping boxes, tied scores, NaN
  boxes.
- (c) the branch-free ``tracker.step`` equals the JAX ``step``: a track
  lost for ``num_frames_retain - 1`` frames and recovered (the fixed-trip
  smoothing replay runs its whole bound), 3 streams mixing the init and
  main paths, and a stream restarting at frame 0 mid-batch.  Ids, validity
  and integer state exact; float state within the tracker test's
  tolerance.
- (d) ``tracker.step``, ``batched_nms`` and the raw-frame step read no
  tensor back to the host: ``Tensor.__bool__``, ``item``, ``tolist``,
  ``__int__``, ``__index__``, ``__float__`` and ``numpy`` raise, except
  inside the plain versions of the kernels (which run only on the CPU).
- (e) the tracker objects raise on host frame ids that break the order
  ``replay_bound`` relies on (each stream's id 0 or larger than its last).
"""
from functools import partial

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from stereotracking_tpu.models import tracker as jt
from stereotracking_tpu.ops.assignment import \
    linear_assignment_with_limit as j_assign
from stereotracking_tpu.ops.nms import batched_nms as j_nms
from stereotracking_tpu_torch.models import tracker as tt
from stereotracking_tpu_torch.models.detector import DetectorConfig
from stereotracking_tpu_torch.models.mot import MOTConfig, OCSORTDisparity
from stereotracking_tpu_torch.ops import assignment_cuda, depth_cuda, nms_cuda
from stereotracking_tpu_torch.ops.assignment import \
    linear_assignment_with_limit
from stereotracking_tpu_torch.ops.nms import batched_nms
from stereotracking_tpu_torch.parallel.multistream import MultiStreamTracker
from device_step_cases import LIMIT, assignment_cases, nms_case
from test_torch_port_tracker import _frames

RETAIN = 30           # the flagship's num_frames_retain
CFG = jt.TrackerConfig(num_slots=16, num_dets=16, match_iou_thr=0.1,
                       num_frames_retain=RETAIN)
TCFG = tt.TrackerConfig(**CFG._asdict())


@pytest.fixture(autouse=True, scope='module')
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize('case', [c[0] for c in assignment_cases()])
def test_assignment_matches_jax(case):
    _, cost, rm, cm = next(c for c in assignment_cases() if c[0] == case)
    rows, cols = linear_assignment_with_limit(
        torch.from_numpy(cost), torch.from_numpy(rm), torch.from_numpy(cm),
        LIMIT)
    jr, jc = jax.vmap(j_assign, in_axes=(0, 0, 0, None))(
        jnp.asarray(cost), jnp.asarray(rm), jnp.asarray(cm), LIMIT)
    np.testing.assert_array_equal(rows.numpy(), np.asarray(jr))
    np.testing.assert_array_equal(cols.numpy(), np.asarray(jc))
    assert rows.dtype == cols.dtype == torch.int32
    assert (rows >= 0).any() or case == 'at_limit'


@pytest.mark.parametrize('max_out', [300, 2048])
def test_nms_matches_jax(max_out):
    """With max_out 2048 every kept candidate is compared: the keep set
    itself; with 300 the compaction's cap too."""
    boxes, scores, labels = nms_case()
    t = batched_nms(torch.from_numpy(boxes), torch.from_numpy(scores),
                    torch.from_numpy(labels), 0.65, 0.1, 2048, max_out)
    f = jax.jit(partial(j_nms, iou_threshold=0.65, score_threshold=0.1,
                        pre_nms_top_k=2048, max_out=max_out))
    for s in range(boxes.shape[0]):
        j = f(jnp.asarray(boxes[s]), jnp.asarray(scores[s]),
              jnp.asarray(labels[s]))
        for a, b in zip(j, t):
            np.testing.assert_array_equal(b[s].numpy(), np.asarray(a))
    kept = t.valid.sum(1)
    assert (kept > 250).all() and (kept < 0.9 * max_out).any() == (
        max_out == 2048)


def _det(d, torch_side=True):
    if torch_side:
        return tt.Detections(**{k: torch.from_numpy(v) for k, v in d.items()})
    return jt.Detections(**{k: jnp.asarray(v) for k, v in d.items()})


def _check_stream(ts, to, js, jo, s, what):
    """Stream ``s`` of the port's batched (ts, to) against JAX's (js, jo)."""
    np.testing.assert_array_equal(to.ids[s].numpy(), np.asarray(jo.ids),
                                  err_msg=what)
    np.testing.assert_array_equal(to.valid[s].numpy(), np.asarray(jo.valid),
                                  err_msg=what)
    live = np.asarray(js.active)
    for name in jt.TrackState._fields:
        a, b = np.asarray(getattr(js, name)), getattr(ts, name)[s].numpy()
        if a.dtype.kind in 'biu':
            np.testing.assert_array_equal(b, a, err_msg=f'{what} {name}')
        else:
            np.testing.assert_allclose(b[live], a[live], atol=1e-3,
                                       rtol=1e-4, err_msg=f'{what} {name}')


def _lost_and_recovered(n_frames=RETAIN + 4, nd=16):
    """Two objects seen every frame; a third, stationary, seen on frames
    0-3, lost for RETAIN - 1 frames, seen again at the same place."""
    rng = np.random.RandomState(5)
    back = 4 + RETAIN - 1
    out = []
    for f in range(n_frames):
        boxes = np.zeros((nd, 4), np.float32)
        valid = np.zeros(nd, bool)
        k = 0
        for o, (x, y, vx) in enumerate(((40, 60, 3.0), (300, 200, -2.0),
                                        (200, 400, 0.0))):
            if o == 2 and 4 <= f < back:
                continue
            c = np.array([x + vx * f, y]) + rng.normal(0, 0.3, 2)
            boxes[k] = [c[0], c[1], c[0] + 30, c[1] + 24]
            valid[k] = True
            k += 1
        out.append(dict(bboxes=boxes, scores=np.where(valid, 0.9, 0.0).astype(
            np.float32), labels=np.zeros(nd, np.int32),
            scales=np.ones(nd, np.float32),
            depths=np.full(nd, 20.0, np.float32), valid=valid))
    return out, back


def test_replay_bound_full_length_recovery():
    """The track lost for RETAIN - 1 frames is recovered with miss_count ==
    replay_bound: the fixed-trip replay runs every iteration, and the step
    equals JAX's data-dependent loop.  No active track ever carries a
    larger miss_count."""
    assert tt.replay_bound(TCFG) == RETAIN - 1
    frames, back = _lost_and_recovered()
    j_step = jax.jit(partial(jt.step, cfg=CFG))
    js, ts = jt.init_state(CFG), tt.init_state(TCFG, n_streams=1)
    recovered_at_bound = False
    for f, d in enumerate(frames):
        miss = torch.where(ts.active[0], ts.miss_count[0], 0)
        assert int(miss.max()) <= tt.replay_bound(TCFG)
        js, jo = j_step(js, _det(d, False), jnp.int32(f))
        ts, to = tt.step(ts, tt.add_stream_axis(_det(d)), [f], TCFG)
        _check_stream(ts, to, js, jo, 0, f'frame {f}')
        if f == back:
            # the slot that had missed RETAIN - 1 frames is tracked again
            slot = miss == tt.replay_bound(TCFG)
            assert int(slot.sum()) == 1
            recovered_at_bound = bool((ts.tracked[0][slot]
                                       & (ts.miss_count[0][slot] == 0)
                                       & ts.active[0][slot]).all())
    assert recovered_at_bound


def test_streams_mix_init_and_main_paths_and_restart():
    """3 streams in one batched step against 3 JAX runs: stream 0 has no
    valid detection on frames 3-4 (the init path while its tracks live),
    stream 1 restarts at frame id 0 on step 6, stream 2 starts empty and
    sees its first detections on step 5."""
    streams = [_frames(seed=s) for s in range(3)]
    for f in (3, 4):
        streams[0][f] = dict(streams[0][f], valid=np.zeros(16, bool))
    for f in range(5):
        streams[2][f] = dict(streams[2][f], valid=np.zeros(16, bool))
    fids = [[f, f if f < 6 else f - 6, f] for f in range(12)]
    j_step = jax.jit(partial(jt.step, cfg=CFG))
    js = [jt.init_state(CFG) for _ in range(3)]
    ts = tt.init_state(TCFG, n_streams=3)
    paths = set()
    for t in range(12):
        dets = [_det(st[t]) for st in streams]
        batch = tt.Detections(*(torch.stack(x) for x in zip(*dets)))
        use_init = ~ts.active.any(1) | ~batch.valid.any(1)
        paths.add(tuple(use_init.tolist()))
        ts, to = tt.step(ts, batch, torch.tensor(fids[t], dtype=torch.int32),
                         TCFG)
        for s in range(3):
            js[s], jo = j_step(js[s], _det(streams[s][t], False),
                               jnp.int32(fids[t][s]))
            _check_stream(ts, to, js[s], jo, s, f'step {t} stream {s}')
    assert any(len(set(p)) == 2 for p in paths)   # init and main together


class _HostReads:
    """Make the tensor methods that read a value back to the host raise,
    except inside the functions passed to ``allow``."""
    NAMES = ('__bool__', 'item', 'tolist', '__int__', '__index__',
             '__float__', 'numpy')

    def __init__(self, monkeypatch):
        self.inside = 0
        for name in self.NAMES:
            orig = getattr(torch.Tensor, name)
            monkeypatch.setattr(torch.Tensor, name, self._guard(name, orig))

    def _guard(self, name, orig):
        def guarded(t, *a, **k):
            if not self.inside:
                raise AssertionError(f'host read on the device path: '
                                     f'Tensor.{name}')
            return orig(t, *a, **k)
        return guarded

    def allow(self, monkeypatch, module, name):
        orig = getattr(module, name)

        def allowed(*a, **k):
            self.inside += 1
            try:
                return orig(*a, **k)
            finally:
                self.inside -= 1
        monkeypatch.setattr(module, name, allowed)


def test_step_and_nms_read_nothing_back(monkeypatch):
    """The device path of the tracker step, NMS and the whole raw-frame
    step (detector, depth, tracker, the ground-truth depth column) with the
    kernels' plain versions allowed to read (they run on the CPU only)."""
    frames = [_frames(seed=s) for s in range(2)]
    boxes, scores, labels = (torch.from_numpy(x) for x in nms_case(
        streams=2, n=300))
    model = OCSORTDisparity(
        MOTConfig(detector=DetectorConfig(widen_factor=0.25,
                                          pre_nms_top_k=128, max_per_img=32),
                  tracker=tt.TrackerConfig(num_slots=8, num_dets=8)),
        device='cpu', seed=0)
    rng = np.random.RandomState(0)
    img = torch.from_numpy(rng.randint(0, 255, (64, 96, 3), np.uint8))
    disp = torch.from_numpy(rng.randint(16, 1600, (64, 96)).astype(
        np.uint16))
    depth = torch.from_numpy(rng.uniform(1, 200, (64, 96)).astype(
        np.float32))
    fid0 = torch.zeros((), dtype=torch.int32)
    ts = tt.init_state(TCFG, n_streams=2)

    guard = _HostReads(monkeypatch)
    guard.allow(monkeypatch, assignment_cuda, 'jv_assign_plain')
    guard.allow(monkeypatch, nms_cuda, 'nms_keep_plain')
    guard.allow(monkeypatch, depth_cuda, 'box_depths_plain')
    with pytest.raises(AssertionError, match='host read'):
        bool(ts.active.any())
    for f in range(6):
        batch = tt.Detections(*(torch.stack(x) for x in zip(
            *(_det(st[f]) for st in frames))))
        ts, _ = tt.step(ts, batch, torch.full((2,), f, dtype=torch.int32),
                        TCFG)
    batched_nms(boxes, scores, labels, 0.65, 0.1, 256, 100)
    for f in range(2):
        model.track_raw(img, disp, fid0 + f, depth_raw=depth)


def _tiny_mot():
    return MOTConfig(detector=DetectorConfig(widen_factor=0.25,
                                             pre_nms_top_k=128,
                                             max_per_img=32),
                     tracker=tt.TrackerConfig(num_slots=8, num_dets=8))


def _tiny_frames(n_streams):
    rng = np.random.RandomState(1)
    img = torch.from_numpy(rng.randint(0, 255, (n_streams, 64, 96, 3),
                                       np.uint8))
    disp = torch.from_numpy(rng.randint(16, 1600, (n_streams, 64, 96)
                                        ).astype(np.uint16))
    return img, disp


def test_multistream_frame_ids_out_of_order_raise():
    """MultiStreamTracker: a stream's host frame id that neither restarts
    at 0 nor grows raises before the step runs, and leaves the states as
    they were; restarts, gaps, device-tensor ids and ``reset`` pass."""
    ms = MultiStreamTracker(_tiny_mot(), 2, device='cpu', seed=0)
    img, disp = _tiny_frames(2)
    for fids in ([0, 0], [1, 3], [0, 7]):
        ms.track_raw(img, disp, fids)
    before = [t.clone() for t in ms.states]
    for fids in ([1, 7], [2, 6]):          # stream 1 repeats, goes back
        with pytest.raises(ValueError, match='stream 1: frame id'):
            ms.track_raw(img, disp, fids)
    assert all(torch.equal(a, b) for a, b in zip(ms.states, before))
    ms.track_raw(img, disp, torch.tensor([1, 7], dtype=torch.int32))
    ms.track_raw(img, disp, [2, 2])        # unchecked after tensor ids
    with pytest.raises(ValueError, match='stream 0: frame id'):
        ms.track(dict(img_u8=img, disp_u16=disp), [1, 3])
    ms.reset()
    ms.track_raw(img, disp, [5, 5])


def test_one_stream_frame_ids_out_of_order_raise():
    """OCSORTDisparity: the same order for its one stream, in ``track_raw``
    (the raw-frame step that ``inference_mot`` and the eval loop call)."""
    one = OCSORTDisparity(_tiny_mot(), device='cpu', seed=0)
    img, disp = _tiny_frames(1)
    one.track_raw(img[0], disp[0], 4)
    for fid in (4, 3):
        with pytest.raises(ValueError, match='stream 0: frame id'):
            one.track_raw(img[0], disp[0], fid)
    one.track_raw(img[0], disp[0], 0)      # a restart
    one.track_raw(img[0], disp[0], 2)
    one.reset()
    one.track_raw(img[0], disp[0], 1)
