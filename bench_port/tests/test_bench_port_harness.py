"""CPU tests of the benchmark: the spec against its contract, every file
found by name, each cell's code path at a toy size with the contract's last
line, the import check by whole top-level names, the reference against the
port, the control and the planted faults failing ``correct``, and a cell
added from new files alone.

    python -m pytest bench_port/tests -q

The cells' toy copies (``toy.py``) run the port's plain versions on the
CPU; no test here needs a card.
"""
from __future__ import annotations

import ast
import json
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

HERE = Path(__file__).resolve().parent
BENCH = HERE.parent
CHECKOUT = BENCH.parent
sys.path.insert(0, str(CHECKOUT))

from bench_port import control, harness  # noqa: E402
from bench_port.tests import toy  # noqa: E402

SPEC = json.loads((CHECKOUT / 'BENCHMARK.json').read_text())
CELLS = [w['name'] for w in SPEC['workloads']]
NAME = re.compile(r'^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$')
UNIT = re.compile(r'^[A-Za-z0-9_/%.-]{1,16}$')
SEED = 2 ** 31 + 77


@pytest.fixture(scope='module')
def toy_spec(tmp_path_factory):
    torch.set_num_threads(2)
    return harness.load_spec(toy.make(tmp_path_factory.mktemp('toy')))


def toy_run(spec, cell, trace=False, fault='', seconds=1.0):
    run = harness.Run(harness.find_cell(spec, cell), SEED, seconds, trace,
                      torch.device('cpu'), fault=fault)
    return harness.execute(run)


def test_spec_keeps_the_contract():
    assert set(SPEC) == {'command', 'paths', 'run_seconds', 'configs',
                         'workloads', 'end_to_end', 'per_layer'}
    assert SPEC['paths'] == ['bench_port']
    assert 1 <= SPEC['run_seconds'] <= 51
    names = [c['name'] for c in SPEC['configs']]
    used = {w['config'] for w in SPEC['workloads']}
    assert set(names) == used
    for c in SPEC['configs']:
        assert set(c) == {'name', 'source', 'file', 'reduced', 'why'}
        assert c['file'].startswith('bench_port/')
        assert (CHECKOUT / c['file']).exists()
        assert all(NAME.match(k) for k in c['reduced'])
    pairs = {(w['config'], w['traffic']) for w in SPEC['workloads']}
    assert len(pairs) == len(SPEC['workloads'])
    for w in SPEC['workloads']:
        assert w['chips'] == 1 and len(w['why']) <= 200
    metrics = SPEC['end_to_end'] + SPEC['per_layer']
    assert len({m['name'] for m in metrics}) == len(metrics)
    for m in metrics:
        assert NAME.match(m['name']) and UNIT.match(m['unit'])
        assert m['better'] in ('lower', 'higher')
        assert all(c in CELLS for c in m.get('workloads', CELLS))
    for m in SPEC['end_to_end']:
        assert m['source'] in ('host_clock', 'device_trace')
        assert 0.01 <= m['bound'] <= 0.25
    assert 'setup_s' in {m['name'] for m in SPEC['end_to_end']}
    e2e = {m['name'] for m in SPEC['end_to_end']}
    for cell in CELLS:
        mine = lambda m: cell in m.get('workloads', CELLS)
        reported = {m['name'] for m in SPEC['end_to_end'] if mine(m)}
        assert 'setup_s' in reported and len(reported) >= 2
        layer = [m for m in SPEC['per_layer'] if mine(m)]
        assert layer and all(m['moves'] in reported for m in layer)
        assert all(m['moves'] in e2e for m in layer)
    assert len(json.dumps(SPEC)) < 64 * 1024


def test_every_file_is_found_by_name():
    spec = harness.load_spec()
    layers = {}
    for cell in CELLS:
        c = harness.find_cell(spec, cell)
        assert (BENCH / 'entries' / f"{c.traffic['entry']}.py").is_file()
        assert c.cfg['model']['net']['width'] == 256
    for m in SPEC['per_layer']:
        mod = harness.load_metric(m['name'])
        assert (mod.UNIT, mod.LAYER, mod.MOVES) == (
            m['unit'], m['layer'], m['moves'])
        layers.setdefault(m['layer'], set()).add(m['name'])
    assert all('\n' not in k and len(k) <= 200 for k in layers)


@pytest.mark.parametrize('trace', [False, True], ids=['trace0', 'trace1'])
@pytest.mark.parametrize('cell', CELLS)
def test_cell_runs_at_toy_size(toy_spec, cell, trace):
    res = toy_run(toy_spec, cell, trace)
    assert list(res)[:5] == ['correct', 'attempted', 'failed', 'metrics',
                             'device']
    assert list(res)[-1] == 'checks'
    assert res['correct'] is True, res['checks']
    assert res['attempted'] > 0 and res['failed'] == 0
    c = harness.find_cell(toy_spec, cell)
    if trace:
        assert 'busy_s' in res['device'] and 'breakdown' in res
        assert set(res['metrics']) <= {m['name'] for m in c.per_layer}
    else:
        assert set(res['metrics']) == {m['name'] for m in c.end_to_end}
    json.dumps(res)


def test_forbidden_modules_compare_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, 'sk_gs_tpu_torch_lookalike', sys)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, 'sk_gs_tpu.render', sys)
    monkeypatch.setitem(sys.modules, 'jaxlib', sys)
    assert harness.forbidden_modules() == ['jaxlib', 'sk_gs_tpu.render']


def test_a_toy_run_loads_no_jax():
    code = (
        'import sys, torch, tempfile, pathlib\n'
        f'sys.path.insert(0, {str(CHECKOUT)!r})\n'
        'from bench_port import harness\n'
        'from bench_port.tests import toy\n'
        'spec = harness.load_spec(toy.make(pathlib.Path(tempfile.mkdtemp())))\n'
        "run = harness.Run(harness.find_cell(spec, 'dnerf_800.serve'), 3, "
        "0.5, False, torch.device('cpu'))\n"
        'harness.execute(run)\n'
        'print(harness.forbidden_modules())\n')
    out = subprocess.run([sys.executable, '-c', code], capture_output=True,
                         text=True, timeout=600, check=True)
    assert out.stdout.strip().splitlines()[-1] == '[]'


def test_reference_imports_nothing_of_the_program():
    for path in (BENCH / 'reference').glob('*.py'):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or '']
            for n in names:
                assert n.split('.')[0] not in ('sk_gs_tpu_torch', 'sk_gs_tpu',
                                               'jax', 'jaxlib', 'flax'), path


def test_run_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip('a card is present: run.py would run the cell')
    out = subprocess.run(
        [sys.executable, str(BENCH / 'run.py'), '--workload', CELLS[0],
         '--seed', '1', '--seconds', '1', '--trace', '0'],
        capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ''


@pytest.mark.parametrize('cell', CELLS)
def test_control_fails_the_check(toy_spec, cell):
    c = harness.find_cell(toy_spec, cell)
    reading = control.control_serve(c, SEED, torch.device('cpu'))
    assert any(reading[k] > lim for k, lim in c.limits.items()), reading
    assert reading['correct'] is False, reading


@pytest.mark.parametrize('cell,fault', [
    (cell, fault) for cell in CELLS for fault in control.FAULTS])
def test_faults_fail_correct(toy_spec, cell, fault):
    res = toy_run(toy_spec, cell, fault=fault)
    assert res['correct'] is False, res['checks']


def test_a_cell_added_from_files_alone(tmp_path):
    spec_path = toy.make(tmp_path)
    spec = json.loads(spec_path.read_text())
    root = tmp_path / 'toy'
    cfg = json.loads((root / 'configs' / 'dnerf_800.json').read_text())
    cfg['scene']['image_size'] = 48
    (root / 'configs' / 'dnerf_48.json').write_text(json.dumps(cfg))
    mix = json.loads((root / 'traffic' / 'serve.json').read_text())
    mix['check_requests'] = 2
    (root / 'traffic' / 'serve_two_checked.json').write_text(json.dumps(mix))
    (root / 'metrics' / 'serve.profiled_requests.py').write_text(
        "UNIT = 'count'\nLAYER = 'request loop'\nMOVES = 'serve_fps'\n\n\n"
        'def read(r):\n    return float(r.units) if r.units else None\n')
    spec['configs'].append({'name': 'dnerf_48', 'source': 'a test',
                            'file': 'toy/configs/dnerf_48.json',
                            'reduced': [], 'why': 'a test'})
    spec['workloads'].append({'name': 'dnerf_48.serve_two_checked',
                              'config': 'dnerf_48',
                              'traffic': 'serve_two_checked', 'chips': 1,
                              'why': 'a test'})
    for m in spec['end_to_end']:
        if 'workloads' in m and 'dnerf_800.serve' in m['workloads']:
            m['workloads'].append('dnerf_48.serve_two_checked')
    spec['per_layer'].append({'name': 'serve.profiled_requests',
                              'unit': 'count', 'better': 'higher',
                              'source': 'program_counter',
                              'layer': 'request loop', 'moves': 'serve_fps',
                              'workloads': ['dnerf_48.serve_two_checked']})
    spec_path.write_text(json.dumps(spec))
    loaded = harness.load_spec(spec_path)
    res = toy_run(loaded, 'dnerf_48.serve_two_checked', trace=True)
    assert res['correct'] is True
    assert res['metrics']['serve.profiled_requests']['value'] > 0
    res = toy_run(loaded, 'dnerf_48.serve_two_checked')
    assert set(res['metrics']) == {'serve_fps', 'setup_s'}
