"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: they need an NVIDIA GPU with nvcc and skip elsewhere.  No
JAX here (the card's machine has none), so run them without the repo's
conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py

Small shapes, full flagship widths (the stage kernels also at YOLOX-nano's
and -tiny's: ``-k yolox``), one stream and S streams per launch; the
tolerances are chip_smoke.py's.
"""
import pytest
import torch

from stereotracking_tpu_torch import _kernels
from stereotracking_tpu_torch.models.detector import (DetectorConfig,
                                                      YOLOXDetector)
from stereotracking_tpu_torch.models.mot import init_weights
from stereotracking_tpu_torch.ops import (depth_cuda, stage1_cuda,
                                          stage2_cuda, stage3_cuda,
                                          stem_cuda)

pytestmark = pytest.mark.cuda
H, W = 96, 160
S = 3


@pytest.fixture(scope='module')
def dev():
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU (CUDA kernels have no CPU mode)')
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device('cuda', 0)


@pytest.fixture(scope='module')
def kw(dev):
    det = YOLOXDetector(DetectorConfig())
    init_weights(det, torch.Generator().manual_seed(0))
    return det.to(dev).eval().backbone.kernel_weights()


@pytest.fixture(scope='module')
def frames(dev):
    """S raw frames (S, 90, 150, 3) uint8 and (S, 90, 150) uint16."""
    g = torch.Generator().manual_seed(1)
    img = torch.randint(0, 256, (S, 90, 150, 3), generator=g,
                        dtype=torch.uint8)
    disp = torch.randint(16, 1600, (S, 90, 150), generator=g,
                         dtype=torch.int32)
    disp[:, ::4] = 65535
    return img.to(dev), disp.to(dev).to(torch.uint16)


def _stem_pair(frames, kw):
    img, disp = frames
    return [(stem_cuda.focus_stem(f, *kw[k], H, W),
             stem_cuda.focus_stem_plain(f, *kw[k], H, W))
            for f, k in ((img, 'stem'), (disp, 'disp_stem'))]


def test_stem_kernel(frames, kw):
    before = _kernels.launch_counts()['stem']
    for k, p in _stem_pair(frames, kw):
        p = p.float()
        assert k.shape == p.shape == (S, H // 2, W // 2, 32)
        # one bf16 ulp, plus float32 reassociation where the sum cancels
        scale = p.abs().max()
        assert ((k.float() - p).abs() <= 2 ** -7 * p.abs()
                + 1e-4 * scale).all()
    assert _kernels.launch_counts()['stem'] == before + 2


def _stem_tol(frame, wk, sb, p, oh, ow):
    """One bf16 ulp after BN + SiLU, plus the float32 reassociation bound
    2 K 2^-24 sum|x w| |scale| of the two sums (K = 36 C)."""
    x = torch.nn.functional.pad(stem_cuda.stem_input(frame, oh, ow),
                                (2, 3, 2, 3))
    c = x.shape[1]
    w6 = stem_cuda.stem_hwio(wk, c)
    mag = torch.nn.functional.conv2d(x.abs(), w6.abs().permute(3, 2, 0, 1),
                                     stride=2).permute(0, 2, 3, 1)
    return 2 ** -7 * p.abs() + 2 * 36 * c * 2 ** -24 * mag * sb[0].abs()


@pytest.mark.parametrize('o', stem_cuda.STEM_WIDTHS)
@pytest.mark.parametrize('size', [(90, 150, 96, 160), (200, 330, 208, 336)])
def test_stem_kernel_widths_ragged(dev, o, size):
    """Every width the kernel is built for, S = 3 frames whose output is
    not a multiple of the 16 x 32 tile (48 x 80, 104 x 168), both
    branches."""
    h, w, oh, ow = size
    g = torch.Generator().manual_seed(o + h)
    img = torch.randint(0, 256, (S, h, w, 3), generator=g,
                        dtype=torch.uint8).to(dev)
    disp = torch.randint(0, 65535, (S, h, w), generator=g, dtype=torch.int32)
    disp[:, ::3] = 65535
    disp = disp.to(dev).to(torch.uint16)
    for frame, c in ((img, 3), (disp, 1)):
        w6 = (torch.randn((6, 6, c, o), generator=g) * 0.05).to(
            torch.bfloat16).float()
        wk = stem_cuda.stem_matrix(w6).to(dev)
        sb = torch.stack([torch.rand((o,), generator=g) + 0.5,
                          torch.randn((o,), generator=g)]).to(dev)
        k = stem_cuda.focus_stem(frame, wk, sb, oh, ow)
        p = stem_cuda.focus_stem_plain(frame, wk, sb, oh, ow).float()
        assert k.shape == p.shape == (S, oh // 2, ow // 2, o)
        tol = _stem_tol(frame, wk, sb, p, oh, ow)
        assert ((k.float() - p).abs() <= tol).all()
        assert torch.equal(k[1:2], stem_cuda.focus_stem(frame[1:2], wk, sb,
                                                        oh, ow))


def _stage_close(k, p):
    assert k.shape == p.shape and k.dtype == torch.bfloat16
    scale = float(p.float().abs().max())
    assert float((k.float() - p.float()).abs().max()) <= 2e-2 * scale + 1e-3


def test_stage_kernels(frames, kw):
    (r, _), (d, _) = _stem_pair(frames, kw)
    y1 = stage1_cuda.stage1_dual(r, d, kw['stage1'], kw['disp_stage1'])
    _stage_close(y1, stage1_cuda.stage1_dual_plain(r, d, kw['stage1'],
                                                   kw['disp_stage1']))
    y2 = stage2_cuda.stage_csp(y1, kw['stage2'])
    _stage_close(y2, stage2_cuda.stage_csp_plain(y1, kw['stage2']))
    # one launch for S streams equals S launches of one stream
    for s in range(S):
        assert torch.equal(y2[s:s + 1],
                           stage2_cuda.stage_csp(y1[s:s + 1], kw['stage2']))


@pytest.mark.parametrize('hw', [(23, 37), (24, 40), (34, 60)])
def test_stage2_kernel_ragged(dev, kw, hw):
    """Stage 2 at full width (64 -> 128, 3 blocks) on S = 3 streams whose
    output is not a multiple of the 10 x 10 tile, counted once per call;
    each stream of the batch equals its own launch."""
    g = torch.Generator().manual_seed(3)
    x = (torch.randn((S, 2 * hw[0], 2 * hw[1], 64), generator=g) * 0.8).to(
        torch.bfloat16).to(dev)
    before = _kernels.launch_counts()['stage2']
    y = stage2_cuda.stage_csp(x, kw['stage2'])
    assert _kernels.launch_counts()['stage2'] == before + 1
    assert y.shape == (S, hw[0], hw[1], 128)
    _stage_close(y, stage2_cuda.stage_csp_plain(x, kw['stage2']))
    for s in range(S):
        assert torch.equal(y[s:s + 1],
                           stage2_cuda.stage_csp(x[s:s + 1], kw['stage2']))


@pytest.mark.parametrize('hw', [(9, 13), (24, 40), (34, 60)])
def test_stage3_kernel(dev, kw, hw):
    """Stage 3 at full width (128 -> 256, 3 blocks) on stage-2-shaped
    inputs, tile edges included (34 x 60 is the 1080p map / 4; 9 x 13 clips
    both launches' tiles, 8 x 16 and 10 x 10), counted under its own
    name."""
    g = torch.Generator().manual_seed(2)
    x = (torch.randn((S, 2 * hw[0], 2 * hw[1], 128), generator=g) * 0.8).to(
        torch.bfloat16).to(dev)
    before = _kernels.launch_counts()
    y = stage3_cuda.stage3_csp(x, kw['stage3'])
    after = _kernels.launch_counts()
    assert after['stage3'] == before['stage3'] + 1
    assert after['stage2'] == before['stage2']
    assert y.shape == (S, hw[0], hw[1], 256)
    _stage_close(y, stage3_cuda.stage3_csp_plain(x, kw['stage3']))
    assert torch.equal(y[1:2], stage3_cuda.stage3_csp(x[1:2], kw['stage3']))


def _random_stage(dims, seed, dev):
    """Seeded random stage weights of ``dims`` (C_in, C_out, mid, nb) on
    ``dev``: bf16 values, BN scales in [0.5, 1.5)."""
    cin, cout, mid, nb = dims
    g = torch.Generator().manual_seed(seed)

    def w(*shape):
        return (torch.randn(shape, generator=g) * 0.1).to(
            torch.bfloat16).float()

    def sb(*shape):          # (..., 2, n): scale, bias
        return torch.stack([torch.rand(shape, generator=g) + 0.5,
                            torch.randn(shape, generator=g) * 0.1], dim=-2)

    wts = stage2_cuda.StageWeights(
        entry_w=w(3, 3, cin, cout), entry_sb=sb(cout),
        ms_w=w(cout, 2 * mid), ms_sb=sb(2 * mid),
        c1_w=w(nb, mid, mid), c1_sb=sb(nb, mid),
        c2_w=w(nb, 3, 3, mid, mid), c2_sb=sb(nb, mid),
        fin_w=w(2 * mid, cout), fin_sb=sb(cout))
    return stage2_cuda.pack_stage(
        stage2_cuda.StageWeights(*(f.to(dev) for f in wts)))


@pytest.mark.parametrize('nb', [1, 3])
@pytest.mark.parametrize('hw', [(23, 37), (34, 60)])
def test_stage_csp_kernel_c32(dev, nb, hw):
    """The stage-2 kernel's C_in = 32 instantiation (widen 0.25: 32 -> 64)
    on S = 3 streams, ragged against its tile; each stream of the batch
    equals its own launch."""
    k = _random_stage((32, 64, 32, nb), 40 + nb, dev)
    g = torch.Generator().manual_seed(nb)
    x = (torch.randn((S, 2 * hw[0], 2 * hw[1], 32), generator=g)).to(
        torch.bfloat16).to(dev)
    before = _kernels.launch_counts()['stage2']
    y = stage2_cuda.stage_csp(x, k)
    assert _kernels.launch_counts()['stage2'] == before + 1
    assert y.shape == (S, hw[0], hw[1], 64)
    _stage_close(y, stage2_cuda.stage_csp_plain(x, k))
    for s in range(S):
        assert torch.equal(y[s:s + 1], stage2_cuda.stage_csp(x[s:s + 1], k))


# YOLOX-nano (widen 0.25) and -tiny (0.375) at deepen 0.33: (stage, C_in)
# the kernels are built for beside the flagship's, stage 1 with its one
# block, stages 2 and 3 with three
YOLOX_WIDTHS = [('stage1', 16), ('stage1', 24), ('stage2', 48),
                ('stage3', 64), ('stage3', 96)]


@pytest.mark.parametrize('stage,c', YOLOX_WIDTHS,
                         ids=[f'{s}_c{c}' for s, c in YOLOX_WIDTHS])
@pytest.mark.parametrize('hw', [(9, 13), (23, 37)])
def test_stage_kernels_at_yolox_widths(dev, stage, c, hw):
    """Each stage kernel at YOLOX-nano's and -tiny's widths on S = 3
    streams whose output is not a multiple of its tiles (6 x 14 for stage
    1, 10 x 10 and 8 x 16 for stages 2 and 3), seeded random weights:
    within the flagship rows' tolerance of the plain version, one launch
    counted under its own name, and each stream of the batch equal to its
    own launch."""
    nb = 1 if stage == 'stage1' else 3
    dims = (c, 2 * c, c, nb)
    g = torch.Generator().manual_seed(c + hw[0])
    x = [(torch.randn((S, 2 * hw[0], 2 * hw[1], c), generator=g)
          * 0.8).to(torch.bfloat16).to(dev) for _ in range(2)]
    if stage == 'stage1':
        ks = [_random_stage(dims, 60 + c + b, dev) for b in range(2)]

        def run(*a):
            return stage1_cuda.stage1_dual(*a, *ks)
        plain = stage1_cuda.stage1_dual_plain(*x, *ks)
    else:
        k = _random_stage(dims, 60 + c, dev)
        x = x[:1]
        fn = (stage2_cuda.stage_csp if stage == 'stage2'
              else stage3_cuda.stage3_csp)

        def run(a):
            return fn(a, k)
        plain = stage2_cuda.stage_csp_plain(x[0], k)
    before = _kernels.launch_counts()
    y = run(*x)
    after = _kernels.launch_counts()
    assert {n: after[n] - before[n] for n in after if after[n] != before[n]
            } == {stage: 1}
    assert y.shape == (S, hw[0], hw[1], 2 * c)
    _stage_close(y, plain)
    for s in range(S):
        assert torch.equal(y[s:s + 1], run(*(a[s:s + 1] for a in x)))


@pytest.mark.parametrize('variant', sorted({stage1_cuda.PRODUCTION,
                                            'r16x16_mma', 'r8x16_mma'}))
@pytest.mark.parametrize('hw', [(9, 15), (23, 37)])
def test_stage1_kernel_ragged(dev, kw, variant, hw):
    """Stage 1's production kernel and both mma.sync variants on S = 3
    stem-shaped inputs whose output is not a multiple of the 14 x 14 or
    6 x 14 tile; each stream of the batch equals its own launch."""
    g = torch.Generator().manual_seed(hw[0])
    r, d = ((torch.randn((S, 2 * hw[0], 2 * hw[1], 32), generator=g)
             * 0.8).to(torch.bfloat16).to(dev) for _ in range(2))
    k1, kd1 = kw['stage1'], kw['disp_stage1']

    def run(a, b):
        if variant == stage1_cuda.PRODUCTION:
            return stage1_cuda.stage1_dual(a, b, k1, kd1)
        return stage1_cuda.stage1_dual_variant(a, b, k1, kd1, variant)

    y = run(r, d)
    assert y.shape == (S, hw[0], hw[1], 64)
    _stage_close(y, stage1_cuda.stage1_dual_plain(r, d, k1, kd1))
    for s in range(S):
        assert torch.equal(y[s:s + 1], run(r[s:s + 1], d[s:s + 1]))


@pytest.mark.parametrize('variant', stage1_cuda.VARIANTS)
def test_stage1_variants(frames, kw, variant):
    (r, _), (d, _) = _stem_pair(frames, kw)
    before = _kernels.launch_counts()['stage1_variants']
    y = stage1_cuda.stage1_dual_variant(r, d, kw['stage1'],
                                        kw['disp_stage1'], variant)
    assert _kernels.launch_counts()['stage1_variants'] == before + 1
    _stage_close(y, stage1_cuda.stage1_dual_plain(r, d, kw['stage1'],
                                                  kw['disp_stage1']))


def _depth_world(dev, frames):
    """S maps with a zero (n = 0) and an all-equal region, and boxes at
    every pyramid level of crop 32, with n = 0, 1 and 2, on the equal
    region, leaving the frame, wider than 800 px, and NaN (invalid)."""
    _, disp_u16 = frames
    disp = torch.nn.functional.pad(
        torch.where(disp_u16.to(torch.int32) == 65535, 0,
                    disp_u16.to(torch.int32)).float() / 16.0, (0, 10, 0, 6))
    disp[:, 60:80, 100:130] = 0.0
    disp[:, 20:40, 60:100] = 25.0
    nan = float('nan')
    boxes = torch.tensor([[3, 4, 40, 30], [10, 10, 150, 90], [-5, 0, 9, 9],
                          [100, 50, 100, 70], [140, 80, 300, 200],
                          [0, 0, 160, 96], [5, 5, 20, 20], [20, 20, 90, 70],
                          [102, 62, 125, 78], [50, 50, 51, 51],
                          [50, 50, 52, 51], [64, 22, 96, 38],
                          [10, 10, 850, 40], [nan, nan, nan, nan],
                          [nan, 10, nan, 40]], dtype=torch.float32)
    boxes = torch.stack([boxes + 3 * s for s in range(S)]).to(dev)
    valid = torch.isfinite(boxes).all(2)
    return disp, boxes, valid


@pytest.mark.parametrize('crop', [32, 96, 128])
def test_depth_kernel(dev, frames, crop):
    """The fused kernel (box scalars, stats, corner vote) against its plain
    composite: integer statistics and the -1 pattern exact; sums within
    rtol 1e-5 (float32 reassociation), depths and scales within rtol 2e-6,
    atol 1e-5 (which holds the vote branch too wherever the three rank
    windows give depths further apart; chip_smoke.py checks the branches
    one by one)."""
    disp, boxes, valid = _depth_world(dev, frames)
    bf = 160.0
    before = _kernels.launch_counts()['depth']
    kd, ksc, ks = depth_cuda.box_depths(disp, boxes, valid, crop, bf)
    assert _kernels.launch_counts()['depth'] == before + 1
    pd, psc, ps = depth_cuda.box_depths_plain(disp, boxes, valid, crop, bf)
    torch.cuda.synchronize()
    assert kd.shape == ksc.shape == (S, boxes.shape[1])
    assert torch.equal(ks[:, :16], ps[:, :16])
    assert torch.allclose(ks[:, 16:], ps[:, 16:], rtol=1e-5, atol=1e-3)
    assert torch.equal(kd == -1, pd == -1)
    assert torch.allclose(kd, pd, rtol=2e-6, atol=1e-5)
    assert torch.allclose(ksc, psc, rtol=2e-6, atol=1e-5)
    ok = kd.reshape(-1) > 0
    assert {0, 1, 2} <= set(ks[:, 0].to(torch.int32).tolist())
    assert int(ok.sum()) >= 6


def test_depth_kernel_strided_boxes(dev, frames):
    """The step hands the kernel views of the detector's slots: boxes and
    flags with a stream stride of their own give the same results."""
    disp, boxes, valid = _depth_world(dev, frames)
    wide_b = torch.zeros((S, 20, 4), device=dev)
    wide_v = torch.zeros((S, 20), dtype=torch.bool, device=dev)
    nb = boxes.shape[1]
    wide_b[:, :nb], wide_v[:, :nb] = boxes, valid
    got = depth_cuda.box_depths(disp, wide_b[:, :nb], wide_v[:, :nb], 32,
                                160.0)
    want = depth_cuda.box_depths(disp, boxes, valid, 32, 160.0)
    for g, w_ in zip(got, want):
        assert torch.equal(g, w_)


def _jv_inputs(dev, streams, seed=2):
    """The JV problems that linear_assignment_with_limit hands the kernel
    for device_step_cases' assignment cases at ``streams`` streams."""
    from device_step_cases import LIMIT, assignment_cases
    from stereotracking_tpu_torch.ops.assignment import jv_problem
    for name, cost, rm, cm in assignment_cases(seed, streams):
        ext, need, _, _ = jv_problem(torch.from_numpy(cost).to(dev),
                                     torch.from_numpy(rm).to(dev),
                                     torch.from_numpy(cm).to(dev), LIMIT)
        yield name, cost, rm, cm, ext, need


@pytest.mark.parametrize('streams', [1, 8])
def test_jv_kernel_exact(dev, streams):
    """The JV kernel against its numpy plain version on the CPU tests'
    cases (masks, exact ties, all-star, all-conflicted, at the limit):
    row2col exact, and the whole assignment equal to the CPU one."""
    from device_step_cases import LIMIT
    from stereotracking_tpu_torch.ops import assignment_cuda
    from stereotracking_tpu_torch.ops.assignment import \
        linear_assignment_with_limit
    for name, cost, rm, cm, ext, need in _jv_inputs(dev, streams):
        before = _kernels.launch_counts()['assignment']
        got = assignment_cuda.jv_assign(ext, need)
        assert _kernels.launch_counts()['assignment'] == before + 1
        want = assignment_cuda.jv_assign_plain(ext.cpu(), need.cpu())
        assert torch.equal(got.cpu(), want), name
        rows, cols = linear_assignment_with_limit(
            torch.from_numpy(cost).to(dev), torch.from_numpy(rm).to(dev),
            torch.from_numpy(cm).to(dev), LIMIT)
        r1, c1 = linear_assignment_with_limit(
            torch.from_numpy(cost), torch.from_numpy(rm),
            torch.from_numpy(cm), LIMIT)
        assert torch.equal(rows.cpu(), r1) and torch.equal(cols.cpu(), c1)


@pytest.mark.parametrize('k', [100, 1000, 2048])
def test_nms_kernel_exact(dev, k):
    """The NMS kernel's keep set against the plain fixed point on the card,
    exactly: chains of overlapping boxes, two labels, NaN boxes and
    non-finite candidates, k not a multiple of 64."""
    from device_step_cases import nms_case
    from stereotracking_tpu_torch.ops import nms_cuda
    boxes, scores, labels = nms_case(seed=3, streams=S, n=k)
    boxes = torch.from_numpy(boxes).to(dev)
    span = torch.where(torch.isfinite(boxes), boxes, 0.0).amax(
        dim=(1, 2), keepdim=True) + 1.0
    shifted = boxes + torch.from_numpy(labels).to(dev).float()[..., None] \
        * span
    finite = torch.from_numpy(scores).to(dev) > 0.2
    finite[:, 7] = False
    before = _kernels.launch_counts()['nms']
    keep = nms_cuda.nms_keep(shifted, finite, 0.5)
    assert _kernels.launch_counts()['nms'] == before + 1
    want = nms_cuda.nms_keep_plain(shifted, finite, 0.5)
    assert torch.equal(keep, want)
    assert 0 < int(keep.sum()) < int(finite.sum())


def _shifted_nms_case(dev, streams, k, seed=4):
    """nms_case's candidates class-shifted as batched_nms shifts them, with
    finite flags (scores > 0.2, candidate 7 or the last forced off)."""
    from device_step_cases import nms_case
    boxes, scores, labels = nms_case(seed=seed, streams=streams, n=k)
    boxes = torch.from_numpy(boxes).to(dev)
    span = torch.where(torch.isfinite(boxes), boxes, 0.0).amax(
        dim=(1, 2), keepdim=True) + 1.0
    shifted = boxes + torch.from_numpy(labels).to(dev).float()[..., None] \
        * span
    finite = torch.from_numpy(scores).to(dev) > 0.2
    finite[:, min(7, k - 1)] = False
    return shifted, finite


@pytest.mark.parametrize('max_keep', [None, 300, 5])
@pytest.mark.parametrize('streams', [1, 8])
@pytest.mark.parametrize('k', [64, 65, 2048])
def test_nms_kernel_word_scan(dev, k, streams, max_keep):
    """The word-level scan with and without its cap against the plain fixed
    point cut at the same cap, exactly; one launch."""
    from stereotracking_tpu_torch.ops import nms_cuda
    shifted, finite = _shifted_nms_case(dev, streams, k)
    before = _kernels.launch_counts()['nms']
    keep = nms_cuda.nms_keep(shifted, finite, 0.5, max_keep)
    assert _kernels.launch_counts()['nms'] == before + 1
    want = nms_cuda.nms_keep_plain(shifted, finite, 0.5, max_keep)
    assert torch.equal(keep, want)
    if max_keep is not None:
        assert int(keep.sum(1).max()) <= max_keep


@pytest.mark.parametrize('max_keep', [None, 70])
@pytest.mark.parametrize('step,full', [(20.0, 2048), (0.0, 1), (2.0, 1024)])
def test_nms_kernel_synthetic(dev, step, full, max_keep):
    """2048 boxes in a row, 10 px wide, ``step`` px apart: disjoint (all
    kept), equal (the first kept), and a chain whose neighbours overlap
    past 0.5 and whose next but one do not (every other box kept, across
    all 32 words)."""
    from stereotracking_tpu_torch.ops import nms_cuda
    k = 2048
    x = torch.arange(k, dtype=torch.float32) * step
    b = torch.stack([x, torch.zeros(k), x + 10, torch.full((k,), 10.0)], -1)
    boxes = b[None].to(dev).contiguous()
    finite = torch.ones((1, k), dtype=torch.bool, device=dev)
    keep = nms_cuda.nms_keep(boxes, finite, 0.5, max_keep)
    want = nms_cuda.nms_keep_plain(boxes, finite, 0.5, max_keep)
    assert torch.equal(keep, want)
    assert int(keep.sum()) == (full if max_keep is None
                               else min(full, max_keep))


def _jv_random(dev, streams, k, c, seed, zeros=False, nans=False):
    """(S, K, C) costs on a grid of quarters (many equal values; with
    ``zeros`` half the zeros -0.0; with ``nans`` ~1% NaN) and random rows
    to assign."""
    import numpy as np
    rng = np.random.RandomState(seed)
    cost = (rng.randint(0, 5, (streams, k, c)) / 4.0).astype(np.float32)
    if zeros:
        cost = np.where(cost == 0, np.float32(0), cost)
        cost[(cost == 0) & (rng.rand(*cost.shape) < 0.5)] = np.float32(-0.0)
    if nans:
        cost[rng.rand(*cost.shape) < 0.01] = np.nan
    need = rng.rand(streams, k) < 0.7
    return (torch.from_numpy(cost).to(dev), torch.from_numpy(need).to(dev))


@pytest.mark.parametrize('k,c', [(64, 128), (64, 256), (51, 131), (32, 1024),
                                 (64, 1024), (256, 1024)])
def test_jv_kernel_instances(dev, k, c):
    """Each template instance (columns per lane 4 / 8 / 32, the cost staged
    in shared memory or read from global memory, C not a multiple of 4 and
    an unaligned stream) against the numpy solver, exactly, at 3 streams."""
    from stereotracking_tpu_torch.ops import assignment_cuda
    cost, need = _jv_random(dev, 3, k, c, seed=k + c)
    before = _kernels.launch_counts()['assignment']
    got = assignment_cuda.jv_assign(cost, need)
    assert _kernels.launch_counts()['assignment'] == before + 1
    want = assignment_cuda.jv_assign_plain(cost.cpu(), need.cpu())
    assert torch.equal(got.cpu(), want), assignment_cuda.jv_instance(k, c)


@pytest.mark.parametrize('k,c', [(64, 128), (64, 1024)])
@pytest.mark.parametrize('what', ['signed_zeros', 'nan'])
def test_jv_kernel_zero_and_nan_ties(dev, what, k, c):
    """Costs with +0.0 and -0.0 ties (equal for np.argmin), or with NaN
    entries (ranked first), through the staged and the global instance."""
    from stereotracking_tpu_torch.ops import assignment_cuda
    cost, need = _jv_random(dev, 4, k, c, seed=7, zeros=what != 'nan',
                            nans=what == 'nan')
    got = assignment_cuda.jv_assign(cost, need)
    want = assignment_cuda.jv_assign_plain(cost.cpu(), need.cpu())
    assert torch.equal(got.cpu(), want)


def _captured_world(dev):
    """A flagship-width model with every stage kernel on, head biases at 3
    (every anchor a candidate), and 6 steps of 8 streams of 96 x 160 raw
    frames."""
    from stereotracking_tpu_torch.models.csp_darknet import StageBackends
    from stereotracking_tpu_torch.models.mot import MOTConfig
    cfg = MOTConfig(backends=StageBackends('cuda', 'cuda', 'cuda', 'cuda'),
                    reuse_det_depth=False)
    det = YOLOXDetector(cfg.detector)
    init_weights(det, torch.Generator().manual_seed(0))
    head = det.bbox_head.head_module
    with torch.no_grad():
        for conv in (*head.multi_level_conv_cls, *head.multi_level_conv_obj):
            conv.bias.fill_(3.0)
    det = det.to(dev).eval()
    g = torch.Generator().manual_seed(5)
    img = torch.randint(0, 256, (6, 8, H, W, 3), generator=g,
                        dtype=torch.uint8)
    disp = torch.randint(16, 1600, (6, 8, H, W), generator=g,
                         dtype=torch.int32)
    disp[:, :, :H // 2] = 65535
    return cfg, det, img.to(dev), disp.to(dev).to(torch.uint16)


def test_captured_step_equals_eager(dev):
    """MultiStreamTracker's graph-replayed step over 6 frames of 8 streams
    against eager predict_frames_batched from the same states: ids and
    validity exact, boxes within 1e-2 px; one graph for the 6 frames; a
    result fetched one step behind is its own step's."""
    from stereotracking_tpu_torch.models.mot import (fetch_result,
                                                     predict_frames_batched,
                                                     preprocess_raw)
    from stereotracking_tpu_torch.models.preprocessor import padded_shape
    from stereotracking_tpu_torch.parallel.multistream import (
        MultiStreamTracker, init_stream_states)
    cfg, det, img, disp = _captured_world(dev)
    ms = MultiStreamTracker(cfg, 8, module=det, device=dev)
    states = init_stream_states(cfg, 8, dev)
    pending = None
    for t in range(6):
        fids = torch.full((8,), t, dtype=torch.int32, device=dev)
        got = ms.track_raw(img[t], disp[t], fids)
        fetch = fetch_result(got)
        inputs = preprocess_raw(img[t], disp[t], *padded_shape(H, W))
        states, want = predict_frames_batched(det, states, inputs, fids, cfg)
        if pending is not None:           # step t - 1, read after step t
            wait, prev = pending
            host = wait()
            for name in ('track_ids', 'track_valid', 'det_valid'):
                assert (getattr(host, name)
                        == getattr(prev, name).cpu().numpy()).all(), name
            assert abs(host.track_bboxes
                       - prev.track_bboxes.cpu().numpy()).max() <= 1e-2
        pending = (fetch, want)
        assert torch.equal(got.track_ids, want.track_ids), t
        assert torch.equal(got.track_valid, want.track_valid), t
        assert torch.equal(got.det_valid, want.det_valid), t
        err = (got.track_bboxes - want.track_bboxes).abs().max()
        assert float(err) <= 1e-2, (t, float(err))
    assert int(want.track_valid.sum()) > 0
    assert ms._step.captures == 1
    for a, b in zip(ms.states, states):
        assert torch.equal(a, b) or a.dtype.is_floating_point


def test_captured_scale_factor_is_an_input(dev):
    """The scale factor is one of the graph's inputs: frames with three
    scale factors replay one graph and equal the eager step with theirs
    (ids and validity exact, boxes within 1e-2 px); a new frame size
    captures anew and the tracker holds only that graph."""
    from stereotracking_tpu_torch.models import tracker as trk
    from stereotracking_tpu_torch.models.mot import (OCSORTDisparity,
                                                     predict_frame_raw)
    from stereotracking_tpu_torch.models.preprocessor import padded_shape
    cfg, det, img, disp = _captured_world(dev)
    one = OCSORTDisparity(cfg, module=det, device=dev)
    state = trk.init_state(cfg.tracker, dev)
    for t, sf in enumerate([(1.0, 1.0), (0.5, 0.5), (0.75, 0.6)]):
        got = one.track_raw(img[t, 0], disp[t, 0], t, scale_factor=sf)
        state, want = predict_frame_raw(det, state, img[t, 0], disp[t, 0], t,
                                        cfg, *padded_shape(H, W), sf)
        for name in ('track_ids', 'track_valid', 'det_valid'):
            assert torch.equal(getattr(got, name), getattr(want, name)), name
        err = (got.det_bboxes - want.det_bboxes).abs().max()
        assert float(err) <= 1e-2, (sf, float(err))
    assert one._step.captures == 1
    small = (img[3, 0, :64, :128].contiguous(),
             disp[3, 0, :64, :128].contiguous())
    one.track_raw(*small, 3)
    assert one._step.captures == 2
    assert one._step._graph.img.shape == (1, 64, 128, 3)


def test_captured_one_stream_with_depth_equals_eager(dev):
    """OCSORTDisparity's replayed step with a ground-truth depth map (its
    own graph key) against the eager predict_frame_raw over 3 frames: ids,
    validity and the ground-truth depth column exact."""
    from stereotracking_tpu_torch.models import tracker as trk
    from stereotracking_tpu_torch.models.mot import (OCSORTDisparity,
                                                     predict_frame_raw)
    from stereotracking_tpu_torch.models.preprocessor import padded_shape
    cfg, det, img, disp = _captured_world(dev)
    depth = torch.rand((3, H, W), generator=torch.Generator().manual_seed(7)
                       ).to(dev) * 80
    one = OCSORTDisparity(cfg, module=det, device=dev)
    state = trk.init_state(cfg.tracker, dev)
    for t in range(3):
        got = one.track_raw(img[t, 0], disp[t, 0], t, depth_raw=depth[t])
        state, want = predict_frame_raw(det, state, img[t, 0], disp[t, 0], t,
                                        cfg, *padded_shape(H, W),
                                        depth_raw=depth[t])
        for name in ('track_ids', 'track_valid', 'track_gt_depths'):
            assert torch.equal(getattr(got, name), getattr(want, name)), name
    assert int((want.track_gt_depths > 0).sum()) > 0
    assert one._step.captures == 1


def test_ransac_pairs_on_the_card_equal_the_cpu(dev):
    """The RANSAC draws (Threefry in int64 tensor arithmetic) on the card
    are the CPU's, bit for bit, for frame ids across the int32 range."""
    from stereotracking_tpu_torch.ops.gmc import ransac_pairs
    fids = torch.tensor([0, 1, 2, 17, 1000, 2 ** 31 - 1], dtype=torch.int32)
    for n in (256, 100):
        assert torch.equal(ransac_pairs(fids.to(dev), 128, n).cpu(),
                           ransac_pairs(fids, 128, n))


def test_captured_cmc_step_equals_eager(dev):
    """The moving-camera config's step (the camera-motion chain in the
    graph) over 4 frames of a panning camera: the replayed track_raw
    against predict_frames_batched with its own CMC state, ids and
    validity exact, the CMC state equal; one capture."""
    from stereotracking_tpu_torch.models.mot import (
        MOTConfig, OCSORTDisparity, init_cmc_state, predict_frames_batched,
        preprocess_raw)
    from stereotracking_tpu_torch.models import tracker as trk
    from stereotracking_tpu_torch.ops.gmc import GMCConfig
    cfg = MOTConfig(detector=DetectorConfig(backbone='single',
                                            widen_factor=0.25),
                    cmc=GMCConfig(size=64))
    det = YOLOXDetector(cfg.detector)
    init_weights(det, torch.Generator().manual_seed(3))
    head = det.bbox_head.head_module
    with torch.no_grad():
        for conv in (*head.multi_level_conv_cls, *head.multi_level_conv_obj):
            conv.bias.fill_(3.0)
    g = torch.Generator().manual_seed(4)
    scene = torch.randint(0, 256, (H + 32, W + 32, 3), generator=g,
                          dtype=torch.uint8)
    img = torch.stack([scene[8 + 2 * t:8 + 2 * t + H, 8 + 3 * t:8 + 3 * t + W]
                       for t in range(4)]).to(dev)
    disp = torch.full((4, H, W), 320, dtype=torch.int32).to(dev).to(
        torch.uint16)
    one = OCSORTDisparity(cfg, module=det, device=dev)
    states = trk.init_state(cfg.tracker, dev, 1)
    cmc = init_cmc_state(cfg.cmc, dev, 1)
    for t in range(4):
        got = one.track_raw(img[t], disp[t], t)
        inputs = preprocess_raw(img[t:t + 1], disp[t:t + 1], H, W)
        states, want = predict_frames_batched(one.module, states, inputs,
                                              [t], cfg, cmc=cmc,
                                              cmc_frame=img[t:t + 1])
        for name in ('track_ids', 'track_valid', 'det_valid'):
            assert torch.equal(getattr(got, name), getattr(want, name)[0])
        assert torch.equal(one.cmc.prev, cmc.prev)
    assert bool(one.cmc.has_prev.all()) and one._step.captures == 1
