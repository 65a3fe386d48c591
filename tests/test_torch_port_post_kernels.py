"""Models of the NMS and JV kernels' algorithms, on the CPU.

The CUDA kernels (``csrc/nms.cu``, ``csrc/assignment.cu``) run only on the
card; their tests there are in ``tests/test_torch_port_cuda.py``.  Here
numpy models of what they do differently from their plain versions are
held to those plain versions and to the JAX package:

- (a) the NMS kernel's word-level scan: per 64-candidate word, the live
  bits, the diagonal block resolved as a fixed point from the live bits,
  the cut at ``max_keep``, and the kept rows' later words ORed in; on a
  mask whose words left of the diagonal hold garbage (the kernel never
  writes them), held to ``nms_keep_plain`` on ``device_step_cases.
  nms_case`` at several k, with and without the cap, and on boxes where
  nothing suppresses, where everything does, and where chains cross word
  boundaries; and the mask's first pass (an empty intersection of two
  finite boxes decides 0 > thr) held to ``bbox_iou_matrix`` on NaN, inf
  and overflowing boxes;
- (b) the JV kernel's argmin: each lane's first minimum over its
  contiguous columns by float compares, then the lowest lane holding the
  least monotone 32-bit key of those, held to ``np.argmin`` on ties, NaN,
  +-0.0, +-inf and the 1e18 sentinel;
- (c) ``nms_keep_plain``'s cap against the JAX ``batched_nms`` output.
"""
from functools import partial

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from stereotracking_tpu.ops.nms import batched_nms as j_nms
from stereotracking_tpu_torch.ops.assignment_cuda import jv_instance
from stereotracking_tpu_torch.ops.nms_cuda import EPS, nms_keep_plain
from stereotracking_tpu_torch.structures.bbox import bbox_iou_matrix
from device_step_cases import nms_case

WORD = 64
NO_COLUMN = 0xFFFFFFFF


# ---------------------------------------------------------------- (a) NMS

def shifted_candidates(k, streams=2, seed=3):
    """nms_case's first k candidates per stream, class-shifted as
    batched_nms shifts them, with finite flags (scores > 0.2, and one
    candidate forced off)."""
    boxes, scores, labels = nms_case(seed=seed, streams=streams, n=k)
    boxes = torch.from_numpy(boxes)
    span = torch.where(torch.isfinite(boxes), boxes, 0.0).amax(
        dim=(1, 2), keepdim=True) + 1.0
    shifted = boxes + torch.from_numpy(labels).float()[..., None] * span
    finite = torch.from_numpy(scores) > 0.2
    finite[:, min(7, k - 1)] = False
    return shifted, finite


def mask_words(boxes, finite, thr, rng):
    """The kernel's bitmask: per stream, k rows of an even number of
    64-bit words (Python ints), bit b of word w of row i = sup[i, 64 w +
    b]; the words left of the diagonal and the pad word hold random
    garbage, since the kernel writes neither."""
    s, k = finite.shape
    rows = torch.arange(k)
    sup = ((bbox_iou_matrix(boxes, boxes, EPS) > thr)
           & (rows[:, None] < rows[None, :])
           & finite[:, :, None] & finite[:, None, :]).numpy()
    words = -(-k // WORD)
    wst = words + words % 2
    padded = np.zeros((s, k, wst * WORD), bool)
    padded[:, :, :k] = sup
    packed = np.packbits(padded, axis=2, bitorder='little')
    vals = packed.view('<u8')
    garbage = rng.randint(0, 2 ** 63, size=vals.shape, dtype=np.int64)
    left = np.arange(wst)[None, :] < (np.arange(k) // WORD)[:, None]
    left = left | (np.arange(wst)[None, :] >= words)
    vals = np.where(left[None], garbage.view('<u8'), vals)
    return [[list(map(int, r)) for r in stream] for stream in vals.tolist()]


def scan_model(mask, finite, cap):
    """The kernel's scan of one stream: mask (k rows of words), finite
    (k,) bool, cap kept candidates at most -> (k,) bool keep, and the
    largest number of fixed-point passes a word took."""
    k = len(finite)
    words = -(-k // WORD)
    fin = [sum(1 << b for b in range(WORD)
               if w * WORD + b < k and finite[w * WORD + b])
           for w in range(words)]
    removed = [0] * words
    keep = np.zeros(k, bool)
    kept_total, w, most = 0, 0, 0
    while w < words and kept_total < cap:
        live = fin[w] & ~removed[w]
        # the diagonal block: the fixed point of kept = live & ~(OR of the
        # kept rows' diagonal words), from kept = live
        kept, passes = live, 0
        while True:
            passes += 1
            sup = 0
            for b in range(WORD):
                if kept >> b & 1:
                    sup |= mask[w * WORD + b][w]
            nxt = live & ~sup
            if nxt == kept:
                break
            kept = nxt
        most = max(most, passes)
        # the cap: drop the word's last kept candidates past it
        for _ in range(kept_total + bin(kept).count('1') - cap):
            kept &= ~(1 << (kept.bit_length() - 1))
        kept_total += bin(kept).count('1')
        for b in range(WORD):
            if kept >> b & 1:
                keep[w * WORD + b] = True
        if kept_total < cap:
            for lane in range(w + 1, words):
                for b in range(WORD):
                    if kept >> b & 1:
                        removed[lane] |= mask[w * WORD + b][lane]
        w += 1
    return keep, most


def check_scan(boxes, finite, thr, max_keep):
    """The scan model against nms_keep_plain, stream by stream."""
    rng = np.random.RandomState(0)
    mask = mask_words(boxes, finite, thr, rng)
    want = nms_keep_plain(boxes, finite, thr, max_keep).numpy()
    k = finite.shape[1]
    cap = k if max_keep is None else max(0, min(max_keep, k))
    passes = []
    for s in range(finite.shape[0]):
        got, most = scan_model(mask[s], finite[s].numpy(), cap)
        np.testing.assert_array_equal(got, want[s], err_msg=f'stream {s}')
        passes.append(most)
    return want, passes


@pytest.mark.parametrize('max_keep', [None, 300, 37])
@pytest.mark.parametrize('k', [64, 65, 100, 1000, 2048])
def test_scan_model_on_nms_case(k, max_keep):
    boxes, finite = shifted_candidates(k)
    want, _ = check_scan(boxes, finite, 0.5, max_keep)
    kept = want.sum(1)
    assert (kept > 0).all()
    if max_keep is not None:
        assert (kept <= max_keep).all()


def _row_boxes(k, step, width=10.0):
    """Boxes i = [i * step, 0, i * step + width, 10] in one row."""
    x = np.arange(k, dtype=np.float32) * np.float32(step)
    b = np.stack([x, np.zeros(k, np.float32), x + np.float32(width),
                  np.full(k, 10, np.float32)], -1)
    return torch.from_numpy(np.stack([b, b[::-1].copy()]))


@pytest.mark.parametrize('max_keep', [None, 70, 1])
@pytest.mark.parametrize('case', ['none', 'all', 'chain'])
def test_scan_model_synthetic(case, max_keep):
    """Nothing suppresses (disjoint boxes: all kept), everything does
    (equal boxes: only the first finite one kept), and chains (IoU of
    neighbours 8/12 > 0.5, of the next but one 6/14 < 0.5: every other
    box kept, the chain running across the 64-candidate words)."""
    k = 200
    step = {'none': 20.0, 'all': 0.0, 'chain': 2.0}[case]
    boxes = _row_boxes(k, step)
    finite = torch.ones((2, k), dtype=torch.bool)
    finite[1, :3] = False
    want, passes = check_scan(boxes, finite, 0.5, max_keep)
    full = nms_keep_plain(boxes, finite, 0.5).sum(1).tolist()
    assert full == {'none': [200, 197], 'all': [1, 1],
                    'chain': [100, 99]}[case]
    if max_keep is not None:
        assert want.sum(1).tolist() == [min(f, max_keep) for f in full]
    if max_keep is None:
        # one pass where nothing suppresses; bit b of a word-long chain is
        # final after b passes, the last one confirms it: 64
        assert max(passes) == {'none': 1, 'all': 2, 'chain': 64}[case]


def test_scan_model_cap_zero():
    boxes, finite = shifted_candidates(100)
    want, _ = check_scan(boxes, finite, 0.5, 0)
    assert not want.any()


def mask_model(boxes, thr):
    """The kernel's mask decisions for one stream of (k, 4) float32 boxes:
    where both boxes have finite coordinates and areas, pass 1's
    intersection (fmin / fmax, which ignore NaN) and an empty one decides
    0 > thr; every other pair takes the full IoU (bbox_iou_matrix's)."""
    b = boxes.numpy()
    x1, y1, x2, y2 = b.T
    with np.errstate(all='ignore'):
        area = (x2 - x1) * (y2 - y1)
        fast = np.isfinite(b).all(1) & np.isfinite(area)
        w = np.fmax(np.fmin(x2[:, None], x2[None]) -
                    np.fmax(x1[:, None], x1[None]), np.float32(0))
        h = np.fmax(np.fmin(y2[:, None], y2[None]) -
                    np.fmax(y1[:, None], y1[None]), np.float32(0))
        overlap = (w * h) != 0
    full = (bbox_iou_matrix(boxes[None], boxes[None], EPS)[0] > thr).numpy()
    quick = fast[:, None] & fast[None] & ~overlap
    return np.where(quick, np.float32(0) > np.float32(thr), full)


@pytest.mark.parametrize('thr', [0.5, 0.0, -0.25])
def test_mask_model_matches_iou(thr):
    """Pass 1's shortcut decides every pair as bbox_iou_matrix's IoU does:
    overlapping, touching, disjoint and zero-area boxes, NaN and inf
    coordinates, and coordinates near the float32 limit whose difference
    overflows (an intersection of inf * 0)."""
    f32 = np.float32
    big = f32(3e38)
    b = [[0, 0, 10, 10], [5, 5, 15, 15], [10, 0, 20, 10], [30, 30, 30, 40],
         [0, 0, 10, 10], [np.nan, 0, 10, 10], [0, 0, np.inf, 10],
         [-np.inf, 0, np.inf, 10], [-big, 0, big, 0], [-big, 0, big, 5],
         [-big, -big, big, big], [2, 2, 3, 3], [0, 0, 0, 0]]
    rng = np.random.RandomState(0)
    xy = rng.uniform(0, 60, (40, 2))
    b += np.concatenate([xy, xy + rng.uniform(0, 20, (40, 2))], 1).tolist()
    boxes = torch.from_numpy(np.asarray(b, f32))
    full = (bbox_iou_matrix(boxes[None], boxes[None], EPS)[0] > thr).numpy()
    np.testing.assert_array_equal(mask_model(boxes, thr), full)


# ----------------------------------------------------------------- (b) JV

def order_key(x):
    """The kernel's argmin key: NaN 0, -0.0 as +0.0, the numbers in
    ascending order."""
    x = np.asarray(x, np.float32)
    b = np.where(x == 0, np.float32(0), x).view(np.uint32)
    key = np.where(b & 0x80000000, ~b, b | 0x80000000).astype(np.uint32)
    return np.where(np.isnan(x), np.uint32(0), key)


def lane_first(vals):
    """The kernel's First.offer chain over one lane's columns: (value,
    index) of the first minimum, a value winning if it is smaller or NaN
    over a number; (None, -1) for no column."""
    best, col = None, -1
    for c, v in enumerate(vals):
        v = np.float32(v)
        if col < 0 or v < best or (np.isnan(v) and not np.isnan(best)):
            best, col = v, c
    return best, col


def warp_argmin(vals):
    """The kernel's argmin of a C-column row: lane l holds columns l * CPL
    .. l * CPL + CPL - 1; each lane's first minimum (lane_first), then the
    lowest lane holding the least key of those."""
    c = len(vals)
    cpl, _ = jv_instance(1, c)
    keys, cols = [], []
    for lane in range(32):
        best, col = lane_first(vals[lane * cpl:(lane + 1) * cpl])
        keys.append(NO_COLUMN if col < 0 else int(order_key([best])[0]))
        cols.append(lane * cpl + col)
    src = keys.index(min(keys))
    return cols[src]


def _argmin_rows(c, seed):
    rng = np.random.RandomState(seed)
    f32 = np.float32
    specials = np.array([np.nan, -0.0, 0.0, np.inf, -np.inf, 1e18, -1e18,
                         1.0, -1.0, 1e-45, -1e-45], f32)
    rows = []
    for _ in range(40):
        r = rng.choice(specials, c).astype(f32)
        rows.append(r)
        q = (rng.randint(-3, 4, c) / 4.0).astype(f32)   # many equal values
        q[rng.rand(c) < 0.1] = f32(-0.0)
        rows.append(q)
        t = rng.uniform(-1, 1, c).astype(f32)
        t[rng.randint(c)] = np.nan
        t[rng.randint(c)] = np.nan
        rows.append(t)
    rows.append(np.full(c, f32(1e18)))              # all at the sentinel
    rows.append(np.full(c, f32(np.inf)))
    rows.append(np.full(c, f32(np.nan)))
    z = np.zeros(c, f32)
    z[::2] = f32(-0.0)
    rows.append(z)                                  # +-0.0 ties
    return rows


@pytest.mark.parametrize('c', [1, 31, 128, 129, 200, 256, 512, 1000, 1024])
def test_argmin_key_matches_np_argmin(c):
    for r in _argmin_rows(c, seed=c):
        assert warp_argmin(r) == int(np.argmin(r)), r


def test_order_key_is_monotone():
    """Keys order as the floats do, NaN first, +-0.0 equal; +inf's key is
    below NO_COLUMN."""
    f32 = np.float32
    xs = np.array([np.nan, -np.inf, -1e38, -1.0, -1e-45, -0.0, 0.0, 1e-45,
                   1.0, 1e18, 1e38, np.inf], f32)
    k = order_key(xs).astype(np.int64)
    assert k[0] == 0 and (np.diff(k[1:]) >= 0).all()
    assert k[5] == k[6] and (np.diff(k[1:5]) > 0).all() and \
        (np.diff(k[6:]) > 0).all()
    assert k[-1] < NO_COLUMN


@pytest.mark.parametrize('k,c,instance', [
    (64, 128, (4, True)), (64, 256, (8, True)), (64, 512, (16, True)),
    (32, 1024, (32, True)), (64, 1024, (32, False)), (1024, 1024, (32, False)),
    (100, 100, (4, True)), (192, 256, (8, True)), (193, 256, (8, False))])
def test_jv_instance(k, c, instance):
    """Columns per lane cover C; the cost is staged while K * C * 4 <=
    192 KB."""
    assert jv_instance(k, c) == instance


# ------------------------------------------------- (c) NMS cap against JAX

def _top_candidates(boxes, scores, labels, score_thr, k):
    """batched_nms's score-sorted, class-shifted top k (as the port makes
    them) and their finite flags."""
    valid = scores > score_thr
    masked = torch.where(valid, scores, float('-inf'))
    top_scores, top_idx = torch.sort(masked, dim=1, descending=True,
                                     stable=True)
    top_scores, top_idx = top_scores[:, :k], top_idx[:, :k]
    top_boxes = boxes.gather(1, top_idx[..., None].expand(-1, -1, 4))
    top_labels = labels.gather(1, top_idx)
    span = torch.where(torch.isfinite(top_boxes), top_boxes, 0.0).amax(
        dim=(1, 2), keepdim=True) + 1.0
    offs = top_labels.to(torch.float32)[..., None] * span
    return (top_boxes, top_scores, top_labels, top_boxes + offs,
            torch.isfinite(top_scores))


@pytest.mark.parametrize('max_out', [1, 100, 300, 2048])
def test_plain_cap_matches_jax(max_out):
    """nms_keep_plain(..., max_keep=max_out)'s candidates, in order, are
    the JAX batched_nms output rows; the cap keeps min(full, max_out)."""
    boxes, scores, labels = nms_case()
    top_b, top_s, top_l, shifted, finite = _top_candidates(
        *map(torch.from_numpy, (boxes, scores, labels)), 0.1, 2048)
    keep = nms_keep_plain(shifted, finite, 0.65, max_out)
    full = nms_keep_plain(shifted, finite, 0.65)
    assert torch.equal(keep.sum(1), full.sum(1).clamp(max=max_out))
    f = jax.jit(partial(j_nms, iou_threshold=0.65, score_threshold=0.1,
                        pre_nms_top_k=2048, max_out=max_out))
    for s in range(boxes.shape[0]):
        jb, js, jl, jv = (np.asarray(x) for x in f(
            jnp.asarray(boxes[s]), jnp.asarray(scores[s]),
            jnp.asarray(labels[s])))
        idx = torch.nonzero(keep[s]).flatten()
        assert int(jv.sum()) == len(idx)
        np.testing.assert_array_equal(top_b[s, idx].numpy(), jb[jv])
        np.testing.assert_array_equal(top_s[s, idx].numpy(), js[jv])
        np.testing.assert_array_equal(top_l[s, idx].numpy(), jl[jv])
