"""Work of the detector as the algorithm states it, from the
configuration's layer shapes and the padded frame: the yardstick of
``step.mfu_pct`` and ``kernels.stage_roofline_pct``.

Every convolution counts 2 * Cin * Cout * k^2 * Ho * Wo operations (both
Focus stems take 12 input channels, the disparity's three copies
included); a fused stage kernel's bytes are its inputs read once, its
output written once, in the dtypes it reads and writes (raw uint8 / uint16
frames into the stems, bfloat16 NHWC activations after them), and its
weights once, in bfloat16, with a float32 scale and shift per output
channel.  Nothing here depends on how a kernel does the work.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

# published NVIDIA H100 SXM rates (data sheet, dense, at 700 W)
PEAK_BF16 = 989e12
HBM_BYTES_PER_S = 3.35e12

P5_ARCH = [(64, 128, 3, True, False), (128, 256, 9, True, False),
           (256, 512, 9, True, False), (512, 1024, 3, False, True)]


def widen(c: int, f: float) -> int:
    return math.ceil(c * f / 8) * 8


def make_round(n: int, d: float) -> int:
    return max(round(n * d), 1) if n > 1 else int(n)


def conv(cin: int, cout: int, k: int, ho: int, wo: int) -> int:
    return 2 * cin * cout * k * k * ho * wo


def _convs_csp(cin, cout, n):
    """(cin, cout, k) of a CSP layer's convolutions (expansion 0.5)."""
    mid = cout // 2
    out = [(cin, mid, 1), (cin, mid, 1)]
    for _ in range(n):
        out += [(mid, mid, 1), (mid, mid, 3)]
    return out + [(2 * mid, cout, 1)]


def stage_convs(cin, cout, n, spp=False) -> List[Tuple[int, int, int, int]]:
    """(cin, cout, k, stride) of a backbone stage."""
    out = [(cin, cout, 3, 2)]
    if spp:
        mid = cout // 2
        out += [(cout, mid, 1, 1), (4 * mid, cout, 1, 1)]
    return out + [(a, b, k, 1) for a, b, k in _convs_csp(cout, cout, n)]


def _stage_list(widen_factor, deepen_factor):
    stem = widen(64, widen_factor)
    stages, cin = [], stem
    for _, out, n, _, spp in P5_ARCH:
        cout = widen(out, widen_factor)
        stages.append((cin, cout, make_round(n, deepen_factor), spp))
        cin = cout
    return stem, stages


def _apply(convs, h, w):
    """Operations of a chain of (cin, cout, k, stride) convs from an h x w
    input, and the output size."""
    ops = 0
    for cin, cout, k, s in convs:
        h, w = -(-h // s), -(-w // s)
        ops += conv(cin, cout, k, h, w)
    return ops, h, w


def detector_flops(det: Dict, oh: int, ow: int) -> int:
    """Operations of one frame through the whole detector (dual
    backbone), at the padded size oh x ow."""
    wf, df = det['widen_factor'], det['deepen_factor']
    stem, stages = _stage_list(wf, df)
    h, w = oh // 2, ow // 2
    ops = 2 * conv(12, stem, 3, h, w)                       # both stems
    sizes = []
    for i, (cin, cout, n, spp) in enumerate(stages):
        o, h, w = _apply(stage_convs(cin, cout, n, spp), h, w)
        ops += 2 * o if i == 0 else o                       # dual stage 1
        sizes.append((h, w))
    ch = [widen(c, wf) for c in (256, 512, 1024)]
    (h3, w3), (h4, w4), (h5, w5) = sizes[1:]
    ncsp = make_round(3, df)
    # PAFPN: reduce + top-down CSP, twice; downsample + bottom-up, twice
    ops += conv(ch[2], ch[1], 1, h5, w5)
    ops += _apply([(a, b, k, 1) for a, b, k in
                   _convs_csp(2 * ch[1], ch[1], ncsp)], h4, w4)[0]
    ops += conv(ch[1], ch[0], 1, h4, w4)
    ops += _apply([(a, b, k, 1) for a, b, k in
                   _convs_csp(2 * ch[0], ch[0], ncsp)], h3, w3)[0]
    ops += conv(ch[0], ch[0], 3, h4, w4)
    ops += _apply([(a, b, k, 1) for a, b, k in
                   _convs_csp(2 * ch[0], ch[1], ncsp)], h4, w4)[0]
    ops += conv(ch[1], ch[1], 3, h5, w5)
    ops += _apply([(a, b, k, 1) for a, b, k in
                   _convs_csp(2 * ch[1], ch[2], ncsp)], h5, w5)[0]
    out = widen(256, wf)
    feat = widen(256, wf)
    nc = det['num_classes']
    for c, (h, w) in zip(ch, sizes[1:]):
        ops += conv(c, out, 1, h, w)                        # out conv
        ops += 2 * (conv(out, feat, 3, h, w) + conv(feat, feat, 3, h, w))
        ops += conv(feat, nc, 1, h, w) + conv(feat, 4, 1, h, w) + \
            conv(feat, 1, 1, h, w)
    return ops


def _weight_bytes(convs):
    return sum(2 * a * b * k * k + 8 * b for a, b, k, *_ in convs)


def stage_kernel_work(det: Dict, h: int, w: int, oh: int, ow: int
                      ) -> Dict[str, Tuple[int, int]]:
    """(operations, bytes) per frame of each fused kernel of the dual
    backbone: the image and the disparity stem, stage 1 (both branches and
    their average), stage 2 and stage 3; raw frames h x w, padded oh x ow."""
    wf, df = det['widen_factor'], det['deepen_factor']
    stem, stages = _stage_list(wf, df)
    h2, w2 = oh // 2, ow // 2
    stem_out = h2 * w2 * stem * 2
    stem_w = _weight_bytes([(12, stem, 3)])
    work = {
        'stem': (conv(12, stem, 3, h2, w2), h * w * 3 + stem_out + stem_w),
        'disp_stem': (conv(12, stem, 3, h2, w2),
                      h * w * 2 + stem_out + stem_w),
    }
    hin, win, cin_bytes = h2, w2, 2 * stem_out
    for i, name in enumerate(('stage1', 'stage2', 'stage3')):
        cin, cout, n, spp = stages[i]
        convs = stage_convs(cin, cout, n, spp)
        ops, ho, wo = _apply(convs, hin, win)
        branches = 2 if i == 0 else 1
        out_bytes = ho * wo * cout * 2
        work[name] = (branches * ops,
                      cin_bytes + out_bytes + branches * _weight_bytes(convs))
        hin, win, cin_bytes = ho, wo, out_bytes
    return work


def bound_s(ops: int, nbytes: int) -> float:
    """The least time the card could take: the larger of operations over
    the bf16 tensor-core peak and bytes over HBM bandwidth."""
    return max(ops / PEAK_BF16, nbytes / HBM_BYTES_PER_S)
