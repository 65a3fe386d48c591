"""Are the detector's module layers batch-invariant on the card?

    python -m stereotracking_tpu_torch.tools.batch_invariance

Runs the layers that follow the stage-2 kernel when stage 3 is on the
modules (stage 3, stage 4 with SPPF, PAFPN, head) on seeded random stage-2
features of 8 streams at 1080p (136 x 240, channels-last), in float32 (TF32
off) and bf16, with cuDNN's default algorithms, cuDNN's deterministic ones,
and cuDNN off (PyTorch's own convolutions).  For each it prints whether the
outputs of streams 0 and 1 at batch 2 and of stream 0 at batch 8 equal the
same streams run alone, bit for bit, and the milliseconds of one batch-8
pass (host clock around synchronised calls, mean of 5 after warm-up).
Then, in bf16 with the default algorithms, each convolution shape of the
model at each feature size whose batch-2 output differs from its batch-1
output.  A batch-dependent result means that the eval loop's sequential
run (1 stream) and its ``--streams`` run round differently.
"""
from __future__ import annotations

import subprocess
import time

import torch
import torch.nn.functional as F

from ..models.detector import DetectorConfig, YOLOXDetector
from ..models.mot import init_weights
from ..utils.devices import checked_device

MODES = ('default', 'deterministic', 'cudnn off')
SIZES = ((34, 60), (68, 120), (136, 240))      # strides 32, 16, 8 at 1088


def module_layers(det: YOLOXDetector, y2: torch.Tensor):
    """Stage 3, stage 4, PAFPN and head from the stage-2 features."""
    with torch.no_grad():
        y3 = det.backbone.stage3(y2)
        y4 = det.backbone.stage4(y3)
        return sum(det.bbox_head(det.neck((y2, y3, y4))), [])


def run(device='cuda', seed: int = 0):
    dev = checked_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader', '--id=0'],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f'batch invariance on {card}', flush=True)
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    for dt in (torch.float32, torch.bfloat16):
        det = YOLOXDetector(DetectorConfig(), dtype=dt)
        init_weights(det, torch.Generator().manual_seed(seed))
        det.to(dev).eval()
        y2 = torch.randn(8, 136, 240, 128, device=dev, generator=gen).to(
            dt).permute(0, 3, 1, 2)
        for mode in MODES:
            with torch.backends.cudnn.flags(
                    enabled=mode != 'cudnn off',
                    deterministic=mode == 'deterministic', benchmark=False,
                    allow_tf32=False):
                alone = [module_layers(det, y2[s:s + 1]) for s in (0, 1)]
                two = module_layers(det, y2[:2])
                eight = module_layers(det, y2)
                same2 = all(torch.equal(b[s:s + 1], a)
                            for s in (0, 1) for a, b in zip(alone[s], two))
                same8 = all(torch.equal(b[:1], a)
                            for a, b in zip(alone[0], eight))
                diff = max(float((b[:1].float() - a.float()).abs().max())
                           for a, b in zip(alone[0], two))
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(5):
                    module_layers(det, y2)
                torch.cuda.synchronize()
                ms = (time.perf_counter() - t0) / 5 * 1e3
            print(f'{str(dt)[6:]} {mode}: batch 2 == alone {same2}, batch '
                  f'8 == alone {same8}, largest batch-2 difference '
                  f'{diff:.3g}; batch 8 {ms:.2f} ms', flush=True)
    shapes = sorted({(m.in_channels, m.out_channels, m.kernel_size[0],
                      m.stride[0]) for m in det.modules()
                     if isinstance(m, torch.nn.Conv2d)})
    with torch.backends.cudnn.flags(enabled=True, deterministic=False,
                                    benchmark=False):
        for hw in SIZES:
            for cin, cout, k, s in shapes:
                x = torch.randn(2, *hw, cin, device=dev, generator=gen).to(
                    torch.bfloat16).permute(0, 3, 1, 2)
                w = torch.randn(cout, cin, k, k, device=dev,
                                generator=gen).to(torch.bfloat16).contiguous(
                                    memory_format=torch.channels_last)
                if not torch.equal(F.conv2d(x, w, None, s, k // 2)[:1],
                                   F.conv2d(x[:1], w, None, s, k // 2)):
                    print(f'bf16 cuDNN conv varies with the batch: {hw} '
                          f'C_in {cin} C_out {cout} k {k} stride {s}',
                          flush=True)


if __name__ == '__main__':
    run()
