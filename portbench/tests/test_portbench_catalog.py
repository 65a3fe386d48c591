"""The harness finds every configuration, traffic mix, metric reader and
limits file by the names in BENCHMARK.json, holds no list of them in its
code, and runs a cell made of new files alone."""
from __future__ import annotations

import json
import shutil

from conftest import REPO, TINY, TINY_HW, tiny_root
from portbench import harness

CODE = ('harness.py', 'run.py', 'check.py', 'tracelib.py', 'frames.py',
        'weights.py', 'flops.py', 'calibrate.py')


def test_every_name_resolves(bench):
    root = REPO
    for w in bench['workloads']:
        cell = harness.load_cell(root / 'BENCHMARK.json', w['name'])
        assert cell.limits, f'{w["name"]}: no limits file'
        names = [m['name'] for m in cell.end_to_end]
        assert 'setup_s' in names and len(names) >= 2, names
        assert cell.per_layer, w['name']
        for m in cell.end_to_end + cell.per_layer:
            assert callable(harness.metric_reader(root, m['name']))


def test_code_names_no_cell_mix_or_metric(bench):
    names = [w['name'] for w in bench['workloads']]
    names += [w['traffic'] for w in bench['workloads']]
    names += [c['name'] for c in bench['configs']]
    names += [m['name'] for m in bench['end_to_end'] + bench['per_layer']]
    for f in CODE:
        text = (REPO / 'portbench' / f).read_text()
        for n in names:
            assert f"'{n}'" not in text and f'"{n}"' not in text, (f, n)


def test_new_cell_of_files_alone_runs(tmp_path):
    bench_path = tiny_root(tmp_path)
    bench = json.loads(bench_path.read_text())
    base = bench['workloads'][0]
    pb = tmp_path / 'portbench'
    cfg = json.loads((REPO / bench['configs'][0]['file']).read_text())
    cfg['img_scale'] = TINY_HW
    (pb / 'configs' / 'throwaway.json').write_text(json.dumps(cfg))
    (pb / 'traffic' / 'throwaway_mix.json').write_text(json.dumps(
        dict(TINY, streams=1)))
    (pb / 'metrics').mkdir()
    (pb / 'metrics' / 'throwaway.steps.py').write_text(
        'def read(rec):\n    return rec["steps"]\n')
    (pb / 'limits').mkdir()
    shutil.copy(REPO / 'portbench' / 'limits' / f'{base["name"]}.json',
                pb / 'limits' / 'throwaway.cell.json')
    bench['configs'].append(dict(bench['configs'][0], name='throwaway',
                                 file='portbench/configs/throwaway.json'))
    bench['workloads'].append(dict(base, name='throwaway.cell',
                                   config='throwaway',
                                   traffic='throwaway_mix'))
    bench['per_layer'].append(dict(name='throwaway.steps', unit='steps',
                                   better='higher', source='host_clock',
                                   layer='host loop', moves='pairs_per_s',
                                   workloads=['throwaway.cell']))
    bench_path.write_text(json.dumps(bench))
    r = harness.run_cell(bench_path, 'throwaway.cell', 5, 0.1, True, 'cpu')
    assert r['attempted'] == r['metrics']['throwaway.steps']['value'] >= 8
    assert 'host.call_ms' in r['metrics']
