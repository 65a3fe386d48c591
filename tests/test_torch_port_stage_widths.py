"""The stage kernels at YOLOX-nano's and -tiny's widths, on the CPU.

- The port's plain stages 1, 2 and 3 (what the kernels compute, run by
  their wrappers on CPU tensors) at widen 0.25 (C = 16, 32, 64) and 0.375
  (C = 24, 48, 96), deepen 0.33, against ``pallas_stage1_out`` /
  ``pallas_stage2_out`` / ``pallas_stage3_out`` in interpret mode, on the
  JAX stage tests' small folded shapes with seeded numpy activations and
  weights carried by ``utils/convert.flax_to_state_dict``: within 2e-2 of
  the largest magnitude plus 1e-3 with at most 3% of elements more than
  one bf16 ulp off (tests/test_torch_port_kernels.py's tolerance).
- The packed weight slices at C = 24, whose K (24, 216) is not a multiple
  of the kernels' 16-deep step: they unpack to the plain weights, zero
  rows past K.
- ``resolve_stage_backends`` on a CUDA device at widen 0.25, 0.375, 0.75
  and 1.25 (deepen 0.33).
- The shared-memory layout of ``csrc/mma_chain.cuh`` (mirrored here) at
  the new widths: every chunk inside its pixel, ldmatrix rows and
  epilogue stores of 8 pixels in 8 different bank groups, and each
  kernel's shared memory within a block's.
"""
import warnings

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from stereotracking_tpu.models.detector import DetectorConfig as JCfg
from stereotracking_tpu.models.detector import YOLOXDetector as JDet
from stereotracking_tpu.ops.stage1_pallas import pallas_stage1_out
from stereotracking_tpu.ops.stage2_pallas import (pallas_stage2_out,
                                                  pallas_stage3_out,
                                                  unfold_w)
from stereotracking_tpu_torch.apis.builder import resolve_stage_backends
from stereotracking_tpu_torch.models.csp_darknet import (StageBackends,
                                                         backbone_dims)
from stereotracking_tpu_torch.ops import (stage1_cuda, stage2_cuda,
                                          stage3_cuda)
from test_torch_port_bridge import port_detector
from test_torch_port_kernels import _check_stage, _d2s

WIDENS = (0.25, 0.375)


@pytest.fixture(autouse=True, scope='module')
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _variables(wf, seed):
    """Flax YOLOXDetector variables of the shapes its ``init`` gives
    (``jax.eval_shape``: no init is run), drawn with numpy: conv kernels
    normal with std fan_in^-1/2, other biases and BatchNorm's bias and
    mean uniform in [-0.3, 0.3), BatchNorm's scale and variance in
    [0.5, 1.5)."""
    det = JDet(JCfg(widen_factor=wf, deepen_factor=0.33))
    dummy = {'img': jnp.zeros((1, 32, 32, 3)),
             'disp_postp': jnp.zeros((1, 32, 32, 3)),
             'disp_mask': jnp.zeros((1, 32, 32, 1))}
    shapes = jax.eval_shape(lambda: det.init(jax.random.PRNGKey(0), dummy,
                                             train=False))
    rng = np.random.RandomState(seed)

    def draw(path, leaf):
        name = path[-1].key
        if name == 'kernel':
            return (rng.randn(*leaf.shape)
                    * np.prod(leaf.shape[:-1]) ** -0.5).astype(np.float32)
        lo, hi = (0.5, 1.5) if name in ('scale', 'var') else (-0.3, 0.3)
        return rng.uniform(lo, hi, leaf.shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


@pytest.fixture(scope='module')
def nets():
    """{widen: (JAX variables, the port's kernel weights)}, seeded."""
    out = {}
    for i, wf in enumerate(WIDENS):
        v = _variables(wf, 20 + i)
        out[wf] = (v, port_detector(v, widen=wf).backbone.kernel_weights())
    return out


def _bf16(rng, *shape):
    return jnp.asarray(rng.randn(*shape).astype(np.float32) * 0.8,
                       jnp.bfloat16)


def _torch(x):
    return torch.from_numpy(np.asarray(x, np.float32)).to(
        torch.bfloat16)[None]


@pytest.mark.parametrize('wf', WIDENS)
@pytest.mark.parametrize('stage', ['stage1', 'stage2', 'stage3'])
def test_stage_plain_matches_pallas(nets, stage, wf):
    v, kw = nets[wf]
    bp, bs = v['params']['backbone'], v['batch_stats']['backbone']
    _, dims = backbone_dims(0.33, wf)
    rng = np.random.RandomState(int(wf * 1000) + len(stage))
    if stage == 'stage1':
        # the stems' s2d(2) activations, (16, 32, 4 C) as
        # tests/test_stage1_pallas.py cuts them
        c = dims[0][0]
        so, dso = _bf16(rng, 16, 32, 4 * c), _bf16(rng, 16, 32, 4 * c)
        ref = pallas_stage1_out(bp, bs, so, dso, interpret=True)
        out = stage1_cuda.stage1_dual(_torch(_d2s(so)), _torch(_d2s(dso)),
                                      kw['stage1'], kw['disp_stage1'])
        assert kw['stage1'].dims == dims[0] and dims[0][3] == 1
    else:
        # the previous stage's W-folded output, 16 x 16 x 2 C
        i = 1 if stage == 'stage2' else 2
        x = _bf16(rng, 16, 16, 2 * dims[i][0])
        run = pallas_stage2_out if stage == 'stage2' else pallas_stage3_out
        ref = run(bp, bs, x, interpret=True)
        wrap = (stage2_cuda.stage_csp if stage == 'stage2'
                else stage3_cuda.stage3_csp)
        out = wrap(_torch(unfold_w(x)), kw[stage])
        assert kw[stage].dims == dims[i] and dims[i][3] == 3
    assert out.dtype == torch.bfloat16
    _check_stage(out[0], np.asarray(unfold_w(ref), np.float32))


def test_packed_slices_at_c24_unpack_to_the_plain_weights(nets):
    """YOLOX-tiny's stage 1 (C = 24): each GEMM's slices, put back
    together, are its (K, N) weight matrix, zero past K and N; the
    offsets are where each GEMM's slices start."""
    k = nets[0.375][1]['stage1']
    assert k.dims == (24, 48, 24, 1)
    shapes = stage2_cuda.gemm_shapes(k.dims)
    assert shapes == [(216, 48), (48, 48), (24, 24), (216, 24), (48, 48)]
    offs = stage2_cuda.slice_offsets(k.dims)
    assert offs == [0, 4, 5, 6, 10, 11] and k.ws.shape == (11, 64, 64)
    mats = stage2_cuda._gemm_mats(k.wts)
    for (kk, n), m, lo, hi in zip(shapes, mats, offs, offs[1:]):
        kp, np_ = -(-kk // 64), -(-n // 64)
        tiles = k.ws[lo:hi].float().reshape(np_, kp, 64, 64)
        full = tiles.permute(1, 2, 0, 3).reshape(kp * 64, np_ * 64)
        assert torch.equal(full[:kk, :n], m.to(torch.bfloat16).float())
        # the K rows a 16-deep step runs past K (216 -> 224, 24 -> 32)
        assert not full[kk:].any() and not full[:, n:].any()


@pytest.mark.parametrize('widen', [0.25, 0.375, 0.75, 1.25])
def test_resolution_at_yolox_widths(widen):
    """Every stage 'auto' on a CUDA device: the stem, stage-1 and stage-2
    kernels at nano's and tiny's widths, with no warning; stage 3's
    kernel with an explicit 'cuda'.  At -m's and -x's the stem only, the
    builder's warning naming ROADMAP Queue 3 item 1, and an explicit
    stage-1 'cuda' raising."""
    keys = [f'{n}_backend' for n in StageBackends._fields]
    cfg = {'detector': {'backbone': {'widen_factor': widen,
                                     'deepen_factor': 0.33}},
           **dict.fromkeys(keys, 'auto')}
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter('always')
        got = resolve_stage_backends(cfg, 'cuda')
    said = [str(w.message) for w in caught]
    explicit = {**cfg, 'stage3_backend': 'cuda'}
    if widen < 0.5:
        assert got == StageBackends('cuda', 'cuda', 'cuda', 'torch')
        assert not said, said
        assert resolve_stage_backends(explicit, 'cuda') == StageBackends(
            *['cuda'] * 4)
    else:
        assert got == StageBackends('cuda', 'torch', 'torch', 'torch')
        assert [m.split('_backend')[0] for m in said] == ['stage1',
                                                          'stage2']
        assert all('Queue 3 item 1' in m for m in said), said
        with pytest.raises(ValueError, match="stage1_backend='cuda'"):
            resolve_stage_backends({**cfg, 'stage1_backend': 'cuda'},
                                   'cuda')
    # the CPU runs the plain versions at any width
    assert resolve_stage_backends({**cfg, **dict.fromkeys(keys, 'cuda')},
                                  'cpu') == StageBackends(*['cuda'] * 4)


# ---- csrc/mma_chain.cuh's shared-memory layout, mirrored ----------------

GW, PAD, IW, SLICE_BYTES, STAGES, MAX_SMEM = 16, 17, 33, 8192, 2, 232448


def _xor_layout(chans):
    return chans // 8 == 4 or (chans // 8) % 8 == 0


def _pitch(chans):
    nch = chans // 8
    return 16 * (nch if _xor_layout(chans) else nch | 1)


def _swz(chans, p, ch, key):
    nch = chans // 8
    if _xor_layout(chans):
        return p * chans * 2 + ((ch ^ (key & (min(nch, 8) - 1))) << 4)
    return p * _pitch(chans) + (ch << 4)


def _patch_off(cin, py, px, ch):
    if _xor_layout(cin):
        p = py * IW + px
        return _swz(cin, p, ch, p >> 1)
    q = py * IW + ((IW + 1) // 2 + (px >> 1) if px & 1 else px >> 1)
    return _swz(cin, q, ch, 0)


def _a128(b):
    return -(-b // 128) * 128


def _layout(gh, c, extra=0):
    """Bytes of mma_chain.cuh's layout<GH> for C_in = mid = C_out / 2 =
    c (ragged K: the zeroed chunk) plus ``extra``."""
    p = gh * GW
    pm = _pitch(c)
    chain_end = 3 * _a128(p * pm) + _a128((p + 2 * PAD) * pm)
    z = max(chain_end, _a128((2 * gh + 1) * IW * _pitch(c)))
    ring = z + _a128(p * _pitch(2 * c))
    return ring + STAGES * SLICE_BYTES + (128 if c % 16 else 0) + _a128(
        extra)


def _groups(offsets):
    return len({(o // 16) % 8 for o in offsets})


@pytest.mark.parametrize('c', [16, 24, 48, 96])
def test_chain_layout_at_new_widths(c):
    """C = c's buffers (c and 2 c channels a pixel): every chunk inside
    its pixel, no two chunks at one address; 8 consecutive pixels' chunk
    (an ldmatrix's rows, an epilogue's stores) in 8 bank groups, but for
    the flagship's 4-chunk layout (32 channels: 2 pixels a group); the
    entry conv's A rows (columns 2 apart) likewise."""
    for chans in (c, 2 * c):
        nch, pb = chans // 8, _pitch(chans)
        seen = set()
        for p in range(300):
            for ch in range(nch):
                off = _swz(chans, p, ch, p)
                assert p * pb <= off < (p + 1) * pb
                seen.add(off)
        assert len(seen) == 300 * nch
        worst = min(_groups([_swz(chans, p0 + i, ch, p0 + i)
                             for i in range(8)])
                    for p0 in range(64) for ch in range(nch))
        assert worst == (4 if nch == 4 else 8), (chans, worst)
    # the entry conv: 16 x 33 patch rows, lanes lr = 0-7 / 8-15 of each
    # tap, columns 2 lr + dx
    nch = c // 8
    for py in range(3):
        for dx in range(3):
            for half in (0, 8):
                for ch in range(nch):
                    offs = [_patch_off(c, py, 2 * (half + lr) + dx, ch)
                            for lr in range(8)]
                    assert _groups(offs) == 8
    slots = {_patch_off(c, py, px, 0) // _pitch(c)
             for py in range(17) for px in range(IW)}
    assert slots == set(range(17 * IW))


def test_chain_shared_memory_fits():
    """Each kernel's shared memory at the new widths (the figures in
    csrc/stage1.cu, stage2.cu and stage3.cu) within a block's 232,448 B;
    the flagship's unchanged."""
    p16 = 16 * GW
    got = {
        'stage1 C=16': _layout(8, 16, 8 * GW * _pitch(32)),
        'stage1 C=24': _layout(8, 24, 8 * GW * _pitch(48)),
        'stage1 C=32': _layout(8, 32, 8 * GW * _pitch(64)),
        'stage2 C=48': _layout(16, 48),
        'stage2 C=64': _layout(16, 64),
        'stage3 C=64': _layout(16, 64),
        'stage3 C=96 A': _layout(8, 96),
        'stage3 C=96 B': (2 * p16 * _pitch(96)
                          + _a128((p16 + 2 * PAD) * _pitch(96))
                          + STAGES * SLICE_BYTES),
        'stage3 C=128 A': _layout(8, 128),
    }
    assert got == {'stage1 C=16': 59776, 'stage1 C=24': 72192,
                   'stage1 C=32': 85120, 'stage2 C=48': 191616,
                   'stage2 C=64': 221312, 'stage3 C=64': 221312,
                   'stage3 C=96 A': 182272, 'stage3 C=96 B': 183296,
                   'stage3 C=128 A': 225536}
    assert max(got.values()) <= MAX_SMEM
    # two stage-1 blocks share an SM (228 KB, 1 KB reserved per block)
    assert 2 * (got['stage1 C=24'] + 1024) <= 233472
    assert stage1_cuda.MMA_WIDTHS == (16, 24, 32)
    assert stage2_cuda.STAGE_CSP_WIDTHS == (32, 48, 64)
    assert stage3_cuda.STAGE3_WIDTHS == (64, 96, 128)
