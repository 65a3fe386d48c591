"""The yardstick's operation and byte counts against hand counts."""
from __future__ import annotations

from portbench import flops

FLAGSHIP = dict(widen_factor=0.5, deepen_factor=0.33, num_classes=1)


def test_one_conv():
    # 3x3, 64 -> 128 channels, on a 92 x 160 output: 2*64*128*9 per pixel
    assert flops.conv(64, 128, 3, 92, 160) == 2 * 64 * 128 * 9 * 92 * 160


def test_stage2_chain_at_flagship_widths():
    # stage 2 at 736x1280 (input 184x320, output 92x160), C 64 -> 128, 3
    # bottlenecks: 3x3 s2 64->128; CSP 1x1 128->64 twice; 3 x (1x1 64->64,
    # 3x3 64->64); 1x1 128->128
    px = 92 * 160
    per_px = (2 * 64 * 128 * 9 + 2 * (2 * 128 * 64)
              + 3 * (2 * 64 * 64 + 2 * 64 * 64 * 9) + 2 * 128 * 128)
    ops, nbytes = flops.stage_kernel_work(FLAGSHIP, 720, 1280, 736,
                                          1280)['stage2']
    assert ops == per_px * px == 458752 * px
    weights = (64 * 128 * 9 + 2 * 128 * 64 + 3 * (64 * 64 + 64 * 64 * 9)
               + 128 * 128)
    scale_shift = 8 * (128 + 64 + 64 + 3 * (64 + 64) + 128)
    assert nbytes == (184 * 320 * 64 * 2 + px * 128 * 2 + 2 * weights
                      + scale_shift)


def test_stem_reads_raw_frames_and_writes_bf16():
    ops, nbytes = flops.stage_kernel_work(FLAGSHIP, 720, 1280, 736,
                                          1280)['stem']
    assert ops == 2 * 12 * 32 * 9 * 368 * 640
    assert nbytes == 720 * 1280 * 3 + 368 * 640 * 32 * 2 + \
        2 * 12 * 32 * 9 + 8 * 32


def test_bound_is_the_larger_side():
    assert flops.bound_s(989e12, 0) == 1.0
    assert flops.bound_s(0, 3.35e12) == 1.0


def test_detector_counts_both_branches():
    single = flops.detector_flops(FLAGSHIP, 640, 640)
    # the dual backbone adds one stem and one stage 1 to YOLOX-S's
    extra = flops.conv(12, 32, 3, 320, 320) + 73728 * 160 * 160
    assert abs((single - extra) / 1e9 - 26.5) < 0.2
