"""Seeded inputs for the device-step tests: assignment problems and NMS
candidates, made with numpy so that the CPU tests (against the JAX package)
and the card's tests (kernel against plain version) share them.  No JAX
and no torch here."""
import numpy as np

LIMIT = 0.9          # 1 - match_iou_thr of the flagship tracker
K = N = 64           # track slots x detections of the flagship


def assignment_cases(seed=0, streams=4):
    """[(name, cost (S, K, N) float32, row_mask (S, K), col_mask (S, N))]:
    random costs with masks, exact ties, all-star rows, all-conflicted rows
    and costs at the limit."""
    rng = np.random.RandomState(seed)
    shape = (streams, K, N)
    f32 = np.float32
    lim = f32(LIMIT)

    def masks(p_row=0.8, p_col=0.8):
        rm = rng.rand(streams, K) < p_row
        cm = rng.rand(streams, N) < p_col
        if streams > 1:
            rm[0] = False                  # stream 0: an empty tracker
        return rm, cm

    cases = []
    cases.append(('random', rng.uniform(0, 1.2, shape).astype(f32),
                  *masks()))
    # values on a grid of quarters: many exactly equal costs and deltas
    cases.append(('ties', (rng.randint(0, 5, shape) / 4.0).astype(f32),
                  *masks(0.9, 0.9)))
    # every row a private star: one candidate column of its own
    star = np.full(shape, 1.5, f32)
    for s in range(streams):
        perm = rng.permutation(N)
        star[s, np.arange(K), perm[:K]] = rng.uniform(0, 0.8, K)
    cases.append(('all_star', star, *masks(1.0, 1.0)))
    # every pair a candidate: every active row goes through the JV
    cases.append(('all_conflicted', rng.uniform(0, 0.5, shape).astype(f32),
                  *masks(1.0, 1.0)))
    # costs exactly at the limit (never matched) and one ulp below it
    below = np.nextafter(lim, f32(0))
    at = np.where(rng.rand(*shape) < 0.5, lim, below).astype(f32)
    at = np.where(rng.rand(*shape) < 0.2, rng.uniform(0, 0.9, shape), at)
    cases.append(('at_limit', at.astype(f32), *masks(0.9, 0.9)))
    return cases


def nms_case(seed=0, streams=2, n=2500, nan_boxes=True):
    """(boxes (S, n, 4), scores (S, n), labels (S, n)) float32 / int32: two
    labels, chains of boxes each overlapping the next, tied scores, and
    (with ``nan_boxes``) a few NaN boxes with finite scores."""
    rng = np.random.RandomState(seed)
    xy = rng.uniform(0, 1800, (streams, n, 2))
    wh = rng.uniform(10, 60, (streams, n, 2))
    # chains of 8: each box shifted a little from the one before it
    chain = np.arange(n) % 8
    base = np.arange(n) - chain
    xy = xy[:, base] + chain[None, :, None] * rng.uniform(
        2, 6, (streams, n, 1))
    wh = wh[:, base]
    boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    scores = np.round(rng.uniform(0.05, 1.0, (streams, n)), 2).astype(
        np.float32)
    labels = rng.randint(0, 2, (streams, n)).astype(np.int32)
    if nan_boxes:
        idx = rng.choice(n, 5, replace=False)
        boxes[:, idx] = np.nan
    return boxes, scores, labels


def recovery_frames(n_frames, nd, gaps=(), steady=0, crowd=False, seed=0,
                    size=(720, 1280)):
    """One stream's detections for the tracker, a dict of numpy arrays per
    frame (bboxes (nd, 4) xyxy, scores, labels, scales, depths, valid):

    - ``steady`` objects seen on every frame, drifting slowly;
    - for each g in ``gaps`` a still object seen for 4 frames (long enough
      to be confirmed), then lost for g frames and seen again at its place,
      over and over, each from its own first frame: so the tracker
      recovers it with ``unmatch_len`` g;
    - with ``crowd``, 2 * nd objects instead, in two halves seen in turns
      of 10 frames: more live tracks than a bank of nd slots holds.

    Objects sit on a grid of 80 px cells, so no two overlap; one steady or
    crowd object in eight scores 0.5 (tracked, never spawned); rows past
    the visible objects are invalid.  Numpy only, seeded."""
    rng = np.random.RandomState(seed)
    n_obj = 2 * nd if crowd else steady + len(gaps)
    cells = [(80 * (i % (size[1] // 80)) + 20, 80 * (i // (size[1] // 80))
              + 20) for i in range(n_obj)]
    order = rng.permutation(len(cells))
    pos = np.array([cells[i] for i in order], np.float64)
    wh = rng.uniform(18, 40, (n_obj, 2))
    drift = rng.uniform(-0.4, 0.4, (n_obj, 2))
    labels = rng.randint(0, 2, n_obj).astype(np.int32)
    score = np.where(np.arange(n_obj) % 8 == 7, 0.5,
                     rng.uniform(0.75, 0.95, n_obj))
    if not crowd:                       # gap objects: still, spawned
        drift[steady:] = 0.0
        score[steady:] = rng.uniform(0.75, 0.95, len(gaps))
    first = rng.randint(0, 6, n_obj)
    out = []
    for f in range(n_frames):
        seen = []
        for o in range(n_obj):
            if crowd:
                on = (f // 10) % 2 == o % 2
            elif o < steady:
                on = True
            else:
                g = gaps[o - steady]
                on = f >= first[o] and (f - first[o]) % (4 + g) < 4
            if on:
                seen.append(o)
        boxes = np.zeros((nd, 4), np.float32)
        valid = np.zeros(nd, bool)
        scores = np.zeros(nd, np.float32)
        row_labels = np.zeros(nd, np.int32)
        for k, o in enumerate(rng.permutation(seen)[:nd]):
            c = pos[o] + drift[o] * f + rng.normal(0, 0.3, 2)
            boxes[k] = [c[0], c[1], c[0] + wh[o, 0], c[1] + wh[o, 1]]
            scores[k] = score[o]
            row_labels[k] = labels[o]
            valid[k] = True
        depths = rng.uniform(5, 60, nd).astype(np.float32)
        out.append(dict(bboxes=boxes, scores=scores, labels=row_labels,
                        scales=np.clip(depths / 40.0, 1.0, 3.0).astype(
                            np.float32),
                        depths=depths, valid=valid))
    return out


def slot_bank_case(streams, k, nd, gap=0, seed=0, ring=4):
    """A full bank of confirmed tracks after the prediction and the
    assignments, the input of the tracker's steps 5-7
    (ops/slot_update_cuda.py), as numpy arrays: a dict of the state's
    fields (``TrackState`` names, each (streams, k, ...)), ``slot_det``
    (streams, k), the detections' fields (``det_`` + ``Detections`` names,
    (streams, nd, ...)) and ``fid`` (streams,).  Every slot is matched to a
    detection near its box.  ``gap`` 0: every slot was tracked, one Kalman
    update each (a full bank on the main path); ``gap`` g: every slot was
    lost for g frames and is recovered, g replay updates and one update
    each (at g = num_frames_retain - 1, the most a step can do)."""
    rng = np.random.RandomState(seed)
    f32 = np.float32
    lead = (streams, k)
    xy = rng.uniform(0, 1200, lead + (2,))
    wh = rng.uniform(16, 80, lead + (2,))
    box = np.concatenate([xy, xy + wh], -1)

    def moved(b, px):
        """``b`` shifted as a whole by about ``px``, each corner by under
        half a pixel more: upright boxes, as the detector gives them."""
        shift = rng.normal(0, px, b.shape[:-1] + (2,))
        return (b + np.concatenate([shift, shift], -1)
                + rng.uniform(-0.5, 0.5, b.shape)).astype(f32)

    def kalman_state(b, steps):
        """cxcyah mean with small velocities; the covariance of initiate
        after ``steps`` predictions."""
        w, h = b[..., 2] - b[..., 0], b[..., 3] - b[..., 1]
        mean = np.zeros(lead + (8,))
        mean[..., 0] = (b[..., 0] + b[..., 2]) / 2
        mean[..., 1] = (b[..., 1] + b[..., 3]) / 2
        mean[..., 2] = w / h
        mean[..., 3] = h
        mean[..., 4:] = rng.normal(0, 0.5, lead + (4,)) * [1, 1, 0.001, 0.1]
        f = np.eye(8) + np.eye(8, k=4)
        pos, vel = h / 20, h / 160
        one = np.ones_like(h)
        std0 = np.stack([2 * pos, 2 * pos, 1e-2 * one, 2 * pos, 10 * vel,
                         10 * vel, 1e-5 * one, 10 * vel], -1)
        cov = std0[..., :, None] ** 2 * np.eye(8)
        q = np.stack([pos, pos, 1e-2 * one, pos, vel, vel, 1e-5 * one, vel],
                     -1)
        for _ in range(steps):
            cov = f @ cov @ f.T + q[..., :, None] ** 2 * np.eye(8)
        return mean.astype(f32), cov.astype(f32)

    mean, cov = kalman_state(moved(box, 1.0), 3)
    saved_mean, saved_cov = kalman_state(moved(box, 2.0), 6)
    slot_det = np.stack([rng.permutation(nd)[:k] for _ in range(streams)])
    det_box = np.zeros((streams, nd, 4), f32)
    for s in range(streams):
        det_box[s, slot_det[s]] = moved(box[s], 1.0)
    i32 = np.int32
    return dict(
        mean=mean, cov=cov, saved_mean=saved_mean, saved_cov=saved_cov,
        active=np.ones(lead, bool), tentative=np.zeros(lead, bool),
        tracked=np.full(lead, gap == 0),
        hits=rng.randint(3, 60, lead).astype(i32),
        miss_count=np.full(lead, gap, i32),
        obs_count=rng.randint(1, 60, lead).astype(i32),
        last_frame=np.full(lead, 99 - gap, i32),
        labels=rng.randint(0, 2, lead).astype(i32),
        last_bbox=moved(box, 2.0 + gap), velocity=rng.uniform(
            -1, 1, lead + (2,)).astype(f32),
        scores=rng.uniform(0.3, 1, lead).astype(f32),
        scales=rng.uniform(1, 3, lead).astype(f32),
        depths=rng.uniform(5, 60, lead).astype(f32),
        obs_ring=moved(np.repeat(box[..., None, :], ring, -2), 3.0),
        obs_ring_valid=rng.rand(*lead, ring) < 0.8,
        slot_det=slot_det.astype(i32),
        det_bboxes=det_box,
        det_scores=rng.uniform(0.3, 1, (streams, nd)).astype(f32),
        det_labels=rng.randint(0, 2, (streams, nd)).astype(i32),
        det_scales=rng.uniform(1, 3, (streams, nd)).astype(f32),
        det_depths=rng.uniform(5, 60, (streams, nd)).astype(f32),
        det_valid=np.ones((streams, nd), bool),
        fid=np.full(streams, 100, i32))
