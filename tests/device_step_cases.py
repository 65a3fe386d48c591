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
