"""Each cell runs on the CPU at a small frame size and gives the result
object of the contract; ``run.py`` refuses to run without a card."""
from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest

from conftest import REPO
from portbench import harness

WORKLOADS = [w['name'] for w in json.loads(
    (REPO / 'BENCHMARK.json').read_text())['workloads']]


@pytest.mark.parametrize('workload', WORKLOADS)
def test_cell_runs_on_cpu(tiny_bench, bench, workload):
    r = harness.run_cell(tiny_bench, workload, 2 ** 31 + 17, 0.1, False,
                         'cpu')
    assert list(r)[:5] == ['correct', 'attempted', 'failed', 'metrics',
                           'device']
    assert list(r)[-1] == 'checks'
    assert set(r['device']) >= {'platform', 'kind', 'count',
                                'memory_peak_bytes'}
    want = {m['name'] for m in bench['end_to_end']
            if workload in m.get('workloads', [workload])}
    assert set(r['metrics']) == want
    assert r['attempted'] == 2 * 8 and r['failed'] == 0
    assert r['checks'] and all(set(v) == {'value', 'limit'}
                               for v in r['checks'].values())
    json.loads(json.dumps(r))


def _run_py(cwd, env=None):
    return subprocess.run(
        [sys.executable, 'portbench/run.py', '--workload', WORKLOADS[0],
         '--seed', '1', '--seconds', '1', '--trace', '0'], cwd=cwd,
        capture_output=True, text=True, timeout=300,
        env=dict(os.environ, **(env or {})))


def test_no_card_no_result():
    p = _run_py(REPO, {'CUDA_VISIBLE_DEVICES': ''})
    assert p.returncode != 0 and p.stdout == ''


def test_benchmark_alone_fails(tmp_path):
    (tmp_path / 'portbench').mkdir()
    subprocess.run(['cp', '-r', str(REPO / 'portbench'), str(tmp_path)],
                   check=True)
    (tmp_path / 'BENCHMARK.json').write_text(
        (REPO / 'BENCHMARK.json').read_text())
    p = _run_py(tmp_path)
    assert p.returncode != 0 and p.stdout == ''
