"""Check and time the slot-update kernel on one NVIDIA GPU.

    python3 stereotracking_tpu_torch/tools/time_slot_update.py [--iters N]

Builds the kernel library, prints ``slot_update.cu``'s ptxas lines
(registers, shared memory, spills), then runs ``chip_smoke.
check_slot_update`` at 8 and 16 streams of 64 slots: a full bank of
matched tracks, all tracked (``main``, one Kalman update a slot) and all
recovered after ``num_frames_retain - 1`` frames (``worst``), each held to
the plain version, with the kernel's time as a CUDA-graph node and
eagerly (CUDA events) and its device time (``torch.profiler``), the plain
op chain's time in one CUDA graph and the bound.  Prints the card's
``nvidia-smi`` name and power limit and one JSON line.
"""
import argparse
import importlib.util
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--iters', type=int, default=100)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit('time_slot_update: needs an NVIDIA GPU')
    sys.path.insert(0, HERE)
    spec = importlib.util.spec_from_file_location(
        'chip_smoke', os.path.join(HERE, 'chip_smoke.py'))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    from stereotracking_tpu_torch import _kernels
    _kernels.library()
    for line in _kernels.ptxas_usage(['slot_update.cu'])['slot_update.cu']:
        print(f'ptxas slot_update.cu: {line}', flush=True)
    card = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader', '--id=0'],
        capture_output=True, text=True, check=True).stdout.strip()
    device = torch.device('cuda', 0)
    rows = {}
    for n in (8, 16):
        row, calls = smoke.check_slot_update(device, n, iters=args.iters)
        for what, fn in calls.items():
            at = row if what == 'main' else row[what]
            at['device_ms'] = smoke.device_ms(
                fn, 'ocsort_slot_update_kernel', args.iters)
            print(f'slot_update x{n} {what}: kernel device time '
                  f'(torch.profiler) {at["device_ms"]:.4f} ms', flush=True)
        rows[f'streams{n}'] = row
    print(card)
    print(json.dumps(dict(slot_update=rows, card=card)))


if __name__ == '__main__':
    main()
