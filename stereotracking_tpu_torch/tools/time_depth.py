"""Time the per-box depth extraction of a checkout on one NVIDIA GPU.

    python3 stereotracking_tpu_torch/tools/time_depth.py [--root DIR]
        [--streams S] [--iters N]

Imports ``stereotracking_tpu_torch`` from the checkout ``--root`` (by
default the one that holds this script) and runs its
``ops.depth.extract_box_depths_disp`` on the inputs of ``chip_smoke.py``'s
depth phase, taken from the checkout that holds this script: the
preprocessed disparity of S seeded 1080p frames with an all-equal window,
64 boxes per stream (every pyramid level, n = 0, 1 and 2, NaN, out of the
frame, wider than 800 px), and the flagship config's crop, baseline and
focal length.  Two checkouts run one after the other in one session are
so timed by one method on the same inputs.

Prints the card's ``nvidia-smi`` name and power limit and one JSON line:

- ``kernel_ms``: the depth kernel's wrapper, back-to-back calls timed with
  CUDA events.  A checkout whose depth kernel writes the statistics rows
  alone has ``depth_cuda.box_depth_stats``; its box scalars are then
  computed once, outside the timing;
- ``kernel_device_ms``: that kernel's device time in ``torch.profiler``;
- ``extraction_ms``: back-to-back extractions timed with CUDA events;
- ``extraction_host_ms``: the host wall of one synchronised extraction;
- ``extraction_launches``, ``extraction_device_ms``: the kernels that one
  extraction launches (``torch.profiler``) and their summed device time.

The profiler runs after every other timing, since a profiler session slows
the host work of the process after it.
"""
import argparse
import importlib.util
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def load_smoke():
    """chip_smoke.py of the checkout that holds this script."""
    spec = importlib.util.spec_from_file_location(
        'chip_smoke', os.path.join(HERE, 'chip_smoke.py'))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--root', default=HERE)
    ap.add_argument('--streams', type=int, default=8)
    ap.add_argument('--iters', type=int, default=100)
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit('time_depth: needs an NVIDIA GPU')
    from stereotracking_tpu_torch.apis.builder import build_mot_config
    from stereotracking_tpu_torch.models.preprocessor import padded_shape
    from stereotracking_tpu_torch.ops import depth_cuda as dc
    from stereotracking_tpu_torch.ops.depth import extract_box_depths_disp
    from stereotracking_tpu_torch.tools.probe_stage1_variants import cuda_ms
    smoke = load_smoke()
    device = torch.device('cuda', 0)
    card = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader', '--id=0'],
        capture_output=True, text=True, check=True).stdout.strip()
    cfg = build_mot_config(smoke.flagship_cfg()['model'], device)
    frames = [smoke.make_frames(1, smoke.FRAME_H, smoke.FRAME_W, 100 + s)[0]
              for s in range(args.streams)]
    img, disp_u16 = smoke.to_card(frames, device)
    oh, ow = padded_shape(*img.shape[1:3])
    disp, boxes, valid = smoke.depth_inputs(img, disp_u16, oh, ow, device)
    crop = cfg.depth_crop
    bf = float(cfg.baseline) * float(cfg.focal_length)

    if hasattr(dc, 'box_depths'):
        def kernel():
            dc.box_depths(disp, boxes, valid, crop, bf)
    else:
        scal = dc.box_scalars(boxes, crop, dc.depth_rmin(bf), oh, ow)

        def kernel():
            dc.box_depth_stats(disp, scal, crop, bf)

    def extraction():
        extract_box_depths_disp(disp, boxes, valid, cfg.baseline,
                                cfg.focal_length, crop)

    r = dict(root=root, streams=args.streams, boxes=int(valid.numel()),
             kernel_ms=cuda_ms(kernel, args.iters),
             extraction_ms=cuda_ms(extraction, args.iters))
    t0 = time.perf_counter()
    for _ in range(args.iters):
        extraction()
        torch.cuda.synchronize()
    r['extraction_host_ms'] = (time.perf_counter() - t0) * 1e3 / args.iters
    r['kernel_device_ms'] = smoke.device_ms(kernel, 'box_depth', args.iters)
    ks = smoke.device_kernels(extraction, 1)
    r['extraction_launches'] = len(ks)
    r['extraction_device_ms'] = sum(t for _, t in ks) / 1e3
    print(card)
    print(json.dumps(r))


if __name__ == '__main__':
    main()
