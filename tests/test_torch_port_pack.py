"""Host-side weight packing of the stem and stage-2 kernels (CPU).

The stem kernel multiplies an im2col of the preprocessed frame by a (K, O)
bf16 matrix, K = 36 C in (uy, ux, c) order padded to a multiple of 16; the
stage kernels stream their weights as 64 x 64 slices in the order they run
their GEMMs, stage 3's second launch from the first bottleneck's slice on.
The packings and the slice offsets are checked here against what the
kernels assume.
"""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from stereotracking_tpu_torch.ops import stage2_cuda, stem_cuda


def _bf16(a):
    return torch.from_numpy(np.asarray(a, np.float32)).to(
        torch.bfloat16).float()


def _frame(rng, c, s, h, w):
    if c == 3:
        return torch.from_numpy(rng.randint(0, 256, (s, h, w, 3), np.uint8))
    d = rng.randint(0, 65535, (s, h, w)).astype(np.int32)
    d[:, ::5] = 65535
    return torch.from_numpy(d).to(torch.uint16)


def _im2col(x, kp):
    """(S, C, H, W) padded input -> (S, Ho * Wo, kp) in the kernel's K order
    (uy, ux, c), zero columns past 36 C."""
    s, c = x.shape[:2]
    cols = F.unfold(x, 6, stride=2)       # (S, 36 C, L), K in (c, uy, ux)
    cols = cols.reshape(s, c, 36, -1).permute(0, 3, 2, 1).reshape(
        s, -1, 36 * c)
    return F.pad(cols, (0, kp - 36 * c))


@pytest.mark.parametrize('c', [3, 1])
@pytest.mark.parametrize('o', stem_cuda.STEM_WIDTHS)
def test_stem_matrix_times_im2col_is_the_conv(c, o):
    rng = np.random.RandomState(10 * c + o)
    w6 = _bf16(rng.randn(6, 6, c, o) * 0.1)
    wk = stem_cuda.stem_matrix(w6)
    kp = stem_cuda.stem_k(c)
    assert kp == {3: 112, 1: 48}[c]
    assert wk.dtype == torch.bfloat16 and tuple(wk.shape) == (kp, o)
    assert not wk[36 * c:].any()
    assert torch.equal(stem_cuda.stem_hwio(wk, c), w6)

    frame = _frame(rng, c, 2, 30, 44)
    oh, ow = 32, 48
    x = F.pad(stem_cuda.stem_input(frame, oh, ow), (2, 3, 2, 3)).double()
    prod = _im2col(x, kp) @ wk.double()              # (S, L, O)
    # the pre-activation conv of focus_stem_plain, in float64: every
    # product and partial sum of these bf16-exact values is exact
    conv = F.conv2d(x, stem_cuda.stem_hwio(wk, c).double().permute(
        3, 2, 0, 1), stride=2)
    assert tuple(conv.shape) == (2, o, oh // 2, ow // 2)
    assert torch.equal(prod, conv.flatten(2).transpose(1, 2))


DIMS = [(64, 128, 64, 3), (32, 64, 32, 1), (16, 48, 32, 2)]


def _stage_weights(dims, seed):
    cin, cout, mid, nb = dims
    rng = np.random.RandomState(seed)

    def r(*shape):
        return _bf16(rng.randn(*shape))

    return stage2_cuda.StageWeights(
        entry_w=r(3, 3, cin, cout), entry_sb=r(2, cout),
        ms_w=r(cout, 2 * mid), ms_sb=r(2, 2 * mid),
        c1_w=r(nb, mid, mid), c1_sb=r(nb, 2, mid),
        c2_w=r(nb, 3, 3, mid, mid), c2_sb=r(nb, 2, mid),
        fin_w=r(2 * mid, cout), fin_sb=r(2, cout))


def _unpack_stage(k):
    """The ``StageWeights`` that the slice buffer ``k.ws`` and the flat
    scale/bias buffer ``k.sb`` hold (float32)."""
    cin, cout, mid, nb = k.dims
    shapes = ([(9 * cin, cout), (cout, 2 * mid)]
              + [(mid, mid), (9 * mid, mid)] * nb + [(2 * mid, cout)])
    mats, i = [], 0
    for kk, n in shapes:
        kp, np_ = -(-kk // 64), -(-n // 64)
        t = k.ws[i:i + kp * np_].float().reshape(np_, kp, 64, 64)
        mats.append(t.permute(1, 2, 0, 3).reshape(kp * 64, np_ * 64)
                    [:kk, :n])
        i += kp * np_
    assert i == k.ws.shape[0]
    sizes = (2 * cout, 4 * mid, nb * 2 * mid, nb * 2 * mid, 2 * cout)
    e, ms, c1, c2, fin = torch.split(k.sb, sizes)
    return stage2_cuda.StageWeights(
        entry_w=mats[0].reshape(3, 3, cin, cout), entry_sb=e.reshape(2, cout),
        ms_w=mats[1], ms_sb=ms.reshape(2, 2 * mid),
        c1_w=torch.stack(mats[2:-1:2]), c1_sb=c1.reshape(nb, 2, mid),
        c2_w=torch.stack(mats[3:-1:2]).reshape(nb, 3, 3, mid, mid),
        c2_sb=c2.reshape(nb, 2, mid), fin_w=mats[-1],
        fin_sb=fin.reshape(2, cout))


def _gemm_matrices(wts):
    """The chain's (K, N) matrices in the order the kernels run them."""
    cin, cout, mid, nb = wts.dims
    mats = [wts.entry_w.reshape(9 * cin, cout), wts.ms_w]
    for b in range(nb):
        mats += [wts.c1_w[b], wts.c2_w[b].reshape(9 * mid, mid)]
    return mats + [wts.fin_w]


@pytest.mark.parametrize('dims', DIMS)
def test_stage_slices_unpack_to_the_weights(dims):
    wts = _stage_weights(dims, sum(dims))
    k = stage2_cuda.pack_stage(wts)
    assert k.ws.dtype == torch.bfloat16
    assert tuple(k.ws.shape[1:]) == (stage2_cuda.SLICE, stage2_cuda.SLICE)
    back = _unpack_stage(k)
    for name, a, b in zip(wts._fields, back, wts):
        assert a.shape == b.shape and torch.equal(a, b), name


@pytest.mark.parametrize('dims', DIMS)
def test_stage_slices_follow_the_kernel_order(dims):
    """Slice s is the block the kernel multiplies s-th: GEMMs entry,
    main|short, (conv1, conv2) per block, final; N passes of 64 outer, K
    slices of 64 inner; zeros past the matrix."""
    wts =_stage_weights(dims, 7 + sum(dims))
    ws = stage2_cuda.pack_stage(wts).ws.float()
    s = 0
    for m in _gemm_matrices(wts):
        for n0 in range(0, m.shape[1], 64):
            for k0 in range(0, m.shape[0], 64):
                blk = m[k0:k0 + 64, n0:n0 + 64]
                want = torch.zeros(64, 64)
                want[:blk.shape[0], :blk.shape[1]] = blk
                assert torch.equal(ws[s], want), (s, k0, n0)
                s += 1
    assert ws.shape[0] == s


STAGE3_DIMS = (128, 256, 128, 3)


@pytest.mark.parametrize('dims', DIMS + [STAGE3_DIMS])
def test_slice_offsets_count_the_slices_before(dims):
    """Each GEMM starts after the slices of the GEMMs before it; the last
    entry is the stream's length."""
    shapes = stage2_cuda.gemm_shapes(dims)
    offs = stage2_cuda.slice_offsets(dims)
    assert len(offs) == len(shapes) + 1
    for i in range(len(offs)):
        assert offs[i] == sum(-(-k // 64) * -(-n // 64)
                              for k, n in shapes[:i]), i
    assert offs[-1] == stage2_cuda.pack_stage(
        _stage_weights(dims, 1)).ws.shape[0]


def test_stage3_second_launch_starts_at_slice_88():
    """Stage 3's chain part (its second launch) starts after the entry
    conv's 72 slices and main|short's 16, and streams 136 of 224."""
    offs = stage2_cuda.slice_offsets(STAGE3_DIMS)
    assert offs[:3] == [0, 72, 88]
    assert offs[stage2_cuda.CHAIN_GEMM] == 88 and offs[-1] == 224


@pytest.mark.parametrize('dims', DIMS + [STAGE3_DIMS])
def test_unpacking_from_an_offset_gives_the_gemm(dims):
    """The slices from each GEMM's offset to the next one's are that GEMM's
    (K, N) matrix, N passes outer, K slices inner, zeros past it."""
    wts = _stage_weights(dims, 11 + sum(dims))
    ws = stage2_cuda.pack_stage(wts).ws.float()
    offs = stage2_cuda.slice_offsets(dims)
    for i, m in enumerate(_gemm_matrices(wts)):
        k, n = m.shape
        kp, np_ = -(-k // 64), -(-n // 64)
        assert offs[i + 1] - offs[i] == kp * np_
        blocks = ws[offs[i]:offs[i + 1]].reshape(np_, kp, 64, 64)
        full = blocks.permute(1, 2, 0, 3).reshape(kp * 64, np_ * 64)
        assert torch.equal(full[:k, :n], m), i
        assert not full[k:].any() and not full[:, n:].any(), i
