"""Readings of the numbers that decide ``correct``, for setting their
limits: the program's on many seeds, the control's (the reference one
precision step down, in the program's place) on a few, and, on request,
the program's with a fault planted (faults.py), at the cell's own sizes,
in one process.

    python3 portbench/calibrate.py --workload <name> --seeds 1,2,... \
        --control-seeds 7,8,9 [--faults nms_none,... --fault-seeds 4,5,6] \
        [--seconds 2] [--out readings.json]

``--faults`` also takes the harness's other systems: ``control_tf32``
(the reference with the kernels' layers in bfloat16, as the program runs
them, and the rest in TF32), ``program_tf32`` and ``program_tf32_conv``
(the program with TF32 switched on in cuBLAS and cuDNN, or in cuDNN
alone).

Prints one JSON line per run and, at the end, each number's largest
program reading and smallest control reading (and each fault's).  Needs
a CUDA card.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from portbench import check, faults, harness  # noqa: E402


def one_run(bench: Path, workload: str, seed: int, seconds: float,
            device: str, kind: str) -> dict:
    """``kind``: a system of the harness ('program', 'control', ...) or a
    fault of faults.py."""
    if kind in faults.NMS_FAULTS:
        with faults.nms_fault(kind):
            return harness.run_cell(bench, workload, seed, seconds, False,
                                    device)
    if kind in faults.SYSTEM_FAULTS:
        return harness.run_cell(bench, workload, seed, seconds, False,
                                device,
                                wrap=lambda s: faults.Broken(s, kind))
    return harness.run_cell(bench, workload, seed, seconds, False, device,
                            system=kind)


def readings(bench: Path, workload: str, seeds, control_seeds,
             seconds: float, device: str = 'cuda', fault_names=(),
             fault_seeds=()) -> dict:
    plan = [('program', seeds), ('control', control_seeds)] + \
        [(f, fault_seeds) for f in fault_names]
    out = {kind: {} for kind, _ in plan}
    for kind, ss in plan:
        for s in ss:
            r = one_run(bench, workload, s, seconds, device, kind)
            vals = r['readings']
            out[kind][str(s)] = vals
            print(json.dumps({'system': kind, 'seed': s,
                              'correct': r['correct'], 'checks': vals,
                              'metrics': r['metrics']}), flush=True)
    summary = {}
    for n in check.NUMBERS:
        prog = [v[n] for v in out['program'].values()]
        row = {'program_max': max(prog) if prog else None}
        for kind, _ in plan[1:]:
            vals = [v[n] for v in out[kind].values()]
            row[f'{kind}_min'] = min(vals) if vals else None
        summary[n] = row
    out['summary'] = summary
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    p.add_argument('--workload', required=True)
    p.add_argument('--seeds', required=True)
    p.add_argument('--control-seeds', default='')
    p.add_argument('--faults', default='')
    p.add_argument('--fault-seeds', default='')
    p.add_argument('--seconds', type=float, default=2.0)
    p.add_argument('--out')
    args = p.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print('calibrate needs a CUDA card', file=sys.stderr)
        return 1
    seeds, control_seeds, fault_seeds = (
        [int(x) for x in s.split(',') if x] for s in
        (args.seeds, args.control_seeds, args.fault_seeds))
    out = readings(Path('BENCHMARK.json').resolve(), args.workload, seeds,
                   control_seeds, args.seconds, 'cuda',
                   [f for f in args.faults.split(',') if f], fault_seeds)
    print(json.dumps(out['summary']), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(out, indent=1))
    return 0


if __name__ == '__main__':
    sys.exit(main())
