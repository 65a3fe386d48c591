"""Run one cell of the port's benchmark once and print its result line.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

Run from the root of a checkout that holds ``BENCHMARK.json``.  Needs a
CUDA card (and as many as the cell asks for): without one it exits 1 and
prints no result.  The last line of standard output is the result's JSON
object; the numbers that decided ``correct`` close standard error.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from portbench import harness  # noqa: E402


def main(argv=None) -> int:
    since_start = harness.setup_clock()
    p = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    p.add_argument('--workload', required=True)
    p.add_argument('--seed', type=int, required=True)
    p.add_argument('--seconds', type=float, required=True)
    p.add_argument('--trace', type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    bench = Path('BENCHMARK.json').resolve()
    if not bench.is_file():
        print(f'no {bench}', file=sys.stderr)
        return 1
    chips = next((w.get('chips', 1) for w in json.loads(
        bench.read_text())['workloads'] if w['name'] == args.workload), 1)

    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f'{args.workload} needs {chips} CUDA card(s); torch sees '
              f'{torch.cuda.device_count() if torch.cuda.is_available() else 0}',
              file=sys.stderr)
        return 1
    try:
        import stereotracking_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f'the program is not in this checkout: {e}', file=sys.stderr)
        return 1
    print(f'card: {power_limit()}', file=sys.stderr)
    result = harness.run_cell(bench, args.workload, args.seed, args.seconds,
                              bool(args.trace), 'cuda', since_start)
    found = harness.forbidden_modules()
    if found:
        print(f'modules of the JAX package or JAX were loaded: {found}',
              file=sys.stderr)
        return 1
    for name, row in result['checks'].items():
        print(f'check {name} {row["value"]!r} limit {row["limit"]!r}',
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


def power_limit() -> str:
    """The card's name and power limit, as nvidia-smi reads them."""
    try:
        out = subprocess.run(
            ['nvidia-smi', '--query-gpu=name,power.limit',
             '--format=csv,noheader'], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f'nvidia-smi failed: {e}'


if __name__ == '__main__':
    sys.exit(main())
