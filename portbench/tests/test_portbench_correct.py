"""``correct`` holds for a sound run and fails for the control and for a
timed path broken underneath, at the CPU size; the control on the card at
the cells' own sizes (marked ``cuda``)."""
from __future__ import annotations

import json

import pytest
import torch

from conftest import REPO
from portbench import faults, harness
from portbench.reference import model as md

WORKLOADS = [w['name'] for w in json.loads(
    (REPO / 'BENCHMARK.json').read_text())['workloads']]
SEED = 2 ** 31 + 5


def _classes(workload: str) -> int:
    cell = harness.load_cell(REPO / 'BENCHMARK.json', workload)
    return md.detector_config(cell.config['model']).num_classes


# a class-agnostic NMS is the class-aware one where there is one class
NMS_CASES = [(w, f) for w in WORKLOADS for f in faults.NMS_FAULTS
             if f != 'nms_class_agnostic' or _classes(w) > 1]


def test_sound_run_is_correct(tiny_bench):
    r = harness.run_cell(tiny_bench, WORKLOADS[0], SEED, 0.1, False, 'cpu')
    assert r['correct'], r['checks']


def test_control_is_not_correct(tiny_bench):
    r = harness.run_cell(tiny_bench, WORKLOADS[0], SEED, 0.1, False, 'cpu',
                         system='control')
    assert not r['correct'], r['checks']


@pytest.mark.parametrize('fault', faults.SYSTEM_FAULTS)
def test_fault_is_not_correct(tiny_bench, fault):
    r = harness.run_cell(tiny_bench, WORKLOADS[0], SEED, 0.1, False, 'cpu',
                         wrap=lambda s: faults.Broken(s, fault))
    assert not r['correct'], (fault, r['checks'])


@pytest.mark.parametrize('workload,fault', NMS_CASES)
def test_nms_fault_is_not_correct(tiny_bench, workload, fault):
    with faults.nms_fault(fault):
        r = harness.run_cell(tiny_bench, workload, SEED, 0.1, False, 'cpu')
    assert not r['correct'], (fault, r['checks'])


@pytest.mark.cuda
@pytest.mark.parametrize('workload', WORKLOADS)
def test_control_on_card(workload):
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card: the control at the cell\'s own size')
    for seed in (3000000101, 3000000102, 3000000103):
        r = harness.run_cell(REPO / 'BENCHMARK.json', workload, seed, 1.0,
                             False, 'cuda', system='control')
        assert not r['correct'], (workload, seed, r['checks'])
