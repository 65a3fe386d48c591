"""Time the flagship stage kernels of a checkout on one NVIDIA GPU, and
digest their outputs.

    python3 stereotracking_tpu_torch/tools/time_stages.py [--root DIR]
        [--streams S] [--iters N]

Imports ``stereotracking_tpu_torch`` from the checkout ``--root`` (by
default the one that holds this script), builds the flagship detector
(YOLOX-S widths) with seeded weights (``models.mot.init_weights``, seed 0)
and runs its stage-1, stage-2 and stage-3 kernels, each on the previous
one's output, from seeded bf16 stem activations of S streams of a
1088x1920 frame (a CPU generator, seed 0, the same in every checkout).
Prints the card's ``nvidia-smi`` name and power limit and one JSON line:
per stage the SHA-256 of the output's bytes and ``<stage>_ms``, the
kernel's wrapper timed with CUDA events over N back-to-back calls after a
warm-up.  Run on two checkouts in turns in one session (parent, change,
change, parent): equal digests mean that a change kept those kernels'
output bits, and the times compare on one card.
"""
import argparse
import hashlib
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--root', default=HERE)
    ap.add_argument('--streams', type=int, default=8)
    ap.add_argument('--iters', type=int, default=20)
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.root))
    import torch
    from stereotracking_tpu_torch.models.detector import (DetectorConfig,
                                                          YOLOXDetector)
    from stereotracking_tpu_torch.models.mot import init_weights
    from stereotracking_tpu_torch.ops import (stage1_cuda, stage2_cuda,
                                              stage3_cuda)
    if not torch.cuda.is_available():
        raise SystemExit('time_stages: needs an NVIDIA GPU')
    dev = torch.device('cuda', 0)
    det = YOLOXDetector(DetectorConfig())
    with torch.no_grad():
        init_weights(det, torch.Generator().manual_seed(0))
    kw = det.to(dev).eval().backbone.kernel_weights()
    g = torch.Generator().manual_seed(0)
    stems = [(torch.randn((args.streams, 544, 960, 32), generator=g)
              * 0.8).to(torch.bfloat16).to(dev) for _ in range(2)]
    calls = {
        'stage1': lambda: stage1_cuda.stage1_dual(*stems, kw['stage1'],
                                                  kw['disp_stage1'])}
    y1 = calls['stage1']()
    calls['stage2'] = lambda: stage2_cuda.stage_csp(y1, kw['stage2'])
    y2 = calls['stage2']()
    calls['stage3'] = lambda: stage3_cuda.stage3_csp(y2, kw['stage3'])
    y3 = calls['stage3']()
    torch.cuda.synchronize()
    out = dict(root=os.path.abspath(args.root), streams=args.streams)
    for name, y in (('stage1', y1), ('stage2', y2), ('stage3', y3)):
        out[name] = hashlib.sha256(
            y.cpu().view(torch.int16).numpy().tobytes()).hexdigest()
        fn = calls[name]
        fn()
        start, end = (torch.cuda.Event(enable_timing=True)
                      for _ in range(2))
        start.record()
        for _ in range(args.iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        out[f'{name}_ms'] = start.elapsed_time(end) / args.iters
    print(subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader', '--id=0'],
        capture_output=True, text=True).stdout.strip())
    print(json.dumps(out))
    return out


if __name__ == '__main__':
    main()
