"""Shared set-up of the benchmark's own tests: a copy of the benchmark with
every cell cut to a CPU size (2 streams of 192x320, the configuration's
input scale cut to match), in a temporary directory."""
from __future__ import annotations

import json
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(REPO))

TINY_HW = [192, 320]
TINY = dict(streams=2, source_hw=TINY_HW, ring=4, min_steps=8)


def tiny_root(tmp: Path) -> Path:
    """BENCHMARK.json and its configuration and traffic files, cut to the
    CPU size, under ``tmp``; limits and readers are the benchmark's own."""
    bench = json.loads((REPO / 'BENCHMARK.json').read_text())
    for kind in ('configs', 'traffic'):
        (tmp / 'portbench' / kind).mkdir(parents=True, exist_ok=True)
    for c in bench['configs']:
        cfg = json.loads((REPO / c['file']).read_text())
        cfg['img_scale'] = TINY_HW
        (tmp / c['file']).write_text(json.dumps(cfg))
    for w in bench['workloads']:
        src = REPO / 'portbench' / 'traffic' / f'{w["traffic"]}.json'
        t = json.loads(src.read_text())
        t.update(TINY)
        (tmp / 'portbench' / 'traffic' / src.name).write_text(json.dumps(t))
    (tmp / 'BENCHMARK.json').write_text(json.dumps(bench))
    return tmp / 'BENCHMARK.json'


@pytest.fixture(scope='session')
def tiny_bench(tmp_path_factory) -> Path:
    return tiny_root(tmp_path_factory.mktemp('tiny'))


@pytest.fixture(scope='session')
def bench() -> dict:
    return json.loads((REPO / 'BENCHMARK.json').read_text())
