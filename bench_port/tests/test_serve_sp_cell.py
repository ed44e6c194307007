"""The SP-GS cell ``spgs_dnerf_800.serve_sp`` at the toy size on the CPU,
added to a benchmark without it from its own files and entries alone, as
``test_bench_port_harness.py::test_a_cell_added_from_files_alone`` adds
one: its configuration, mix, entry and readers are new files, and
``BENCHMARK.json`` gains entries and list members only.

    python -m pytest bench_port/tests -q
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

import pytest
import torch

HERE = Path(__file__).resolve().parent
CHECKOUT = HERE.parents[1]
sys.path.insert(0, str(CHECKOUT))

from bench_port import control_sp, harness  # noqa: E402
from bench_port.tests import toy  # noqa: E402

CELL = 'spgs_dnerf_800.serve_sp'
CONFIG = 'spgs_dnerf_800'
NEW_METRICS = ('serve.net_launches', 'serve.deform_device_ms',
               'serve.sp_deform_roofline')
SEED = 2 ** 31 + 91


def without_cell(spec: dict) -> dict:
    """The benchmark as it was before the cell: its configuration, cell,
    list members and metrics taken out."""
    spec = json.loads(json.dumps(spec))
    spec['configs'] = [c for c in spec['configs'] if c['name'] != CONFIG]
    spec['workloads'] = [w for w in spec['workloads'] if w['name'] != CELL]
    spec['per_layer'] = [m for m in spec['per_layer']
                         if m['name'] not in NEW_METRICS]
    for m in spec['end_to_end'] + spec['per_layer']:
        if CELL in m.get('workloads', []):
            m['workloads'].remove(CELL)
    return spec


def additions(full: dict, before: dict) -> dict:
    """What the cell adds: whole entries, and the metrics whose lists it
    joins."""
    old = {k: {e['name'] for e in before[k]}
           for k in ('configs', 'workloads', 'per_layer')}
    new = {k: [e for e in full[k] if e['name'] not in old[k]]
           for k in old}
    new['joins'] = [m['name'] for m in full['end_to_end'] + full['per_layer']
                    if CELL in m.get('workloads', [])
                    and m['name'] not in NEW_METRICS]
    return new


@pytest.fixture(scope='module')
def toy_spec(tmp_path_factory):
    torch.set_num_threads(2)
    tmp = tmp_path_factory.mktemp('toy_sp')
    path = toy.make(tmp)
    full = json.loads(path.read_text())
    before = without_cell(full)
    path.write_text(json.dumps(before))
    with pytest.raises(KeyError):
        harness.find_cell(harness.load_spec(path), CELL)
    add = additions(full, before)
    spec = json.loads(json.dumps(before))
    for key in ('configs', 'workloads', 'per_layer'):
        spec[key] += add[key]
    for m in spec['end_to_end'] + spec['per_layer']:
        if m['name'] in add['joins']:
            m['workloads'].append(CELL)
    assert spec == full
    path.write_text(json.dumps(spec))
    return harness.load_spec(path)


def toy_run(spec, trace=False, fault=''):
    run = harness.Run(harness.find_cell(spec, CELL), SEED, 1.0, trace,
                      torch.device('cpu'), fault=fault)
    return harness.execute(run)


def test_the_cell_runs_untraced(toy_spec):
    res = toy_run(toy_spec)
    assert res['correct'] is True, res['checks']
    assert set(res['metrics']) == {'serve_fps', 'setup_s'}


def test_the_cell_runs_traced(toy_spec):
    res = toy_run(toy_spec, trace=True)
    assert res['correct'] is True, res['checks']
    cell = harness.find_cell(toy_spec, CELL)
    assert set(res['metrics']) <= {m['name'] for m in cell.per_layer}
    # on the CPU the sp stage runs eagerly: its warp net's span is entered
    # and launches no kernel; no device operation is timed
    assert res['metrics']['serve.net_launches']['value'] == 0.0
    assert res['metrics']['serve.deform_graph_share']['value'] == 0.0
    assert 'serve.deform_device_ms' not in res['metrics']
    assert 'serve.fk_launches' not in {m['name'] for m in cell.per_layer}


@pytest.mark.parametrize('fault', control_sp.FAULTS)
def test_the_faults_fail_correct(toy_spec, fault):
    res = toy_run(toy_spec, fault=fault)
    assert res['correct'] is False, res['checks']


def test_the_control_reads_far_above_the_program(toy_spec):
    """The control (the reference in TF32) against the program's own gap
    on the same seed, and judged by the harness's comparison. At this toy
    size (64 px, 1,500 live Gaussians) the control's gap lies near the
    cell's limit, not over it as at the cell's own sizes: that reading is
    the card's (``control_sp.py``)."""
    cell = harness.find_cell(toy_spec, CELL)
    reading = control_sp.control_serve_sp(cell, SEED, torch.device('cpu'))
    served = toy_run(toy_spec)['checks']['image_rmse']['value']
    assert reading['image_rmse'] > 100 * served, (reading, served)
    assert reading['correct'] == (reading['image_rmse']
                                  <= cell.limits['image_rmse'])
