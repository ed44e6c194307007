"""The benchmark's general part: it finds a cell's configuration, traffic
mix and per-layer metrics by the names in ``BENCHMARK.json``, runs the
traffic's entry (``entries/<entry>.py``), and assembles the result line.

Everything that belongs to one configuration, mix, entry or metric is a
file of its own: ``configs/<config>.json``, ``traffic/<mix>.json``,
``entries/<entry>.py`` (which exports ``run(run)``) and
``metrics/<metric>.py`` (which exports ``UNIT``, ``LAYER``, ``MOVES`` and
``read(reading)``, returning None when it finds nothing to read). A later
cell adds files and entries; nothing here names a cell or an entry.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
import os
import sys
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional

HERE = Path(__file__).resolve().parent
CHECKOUT = HERE.parent
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'sk_gs_tpu')


def process_age_s() -> float:
    """Seconds since this process started (``/proc/self/stat``'s start
    time against the uptime)."""
    with open('/proc/self/stat') as f:
        fields = f.read().rsplit(')', 1)[1].split()
    start = int(fields[19]) / os.sysconf('SC_CLK_TCK')
    with open('/proc/uptime') as f:
        up = float(f.read().split()[0])
    return up - start


def load_spec(path: Optional[Path] = None) -> Dict:
    path = Path(path) if path else CHECKOUT / 'BENCHMARK.json'
    with open(path) as f:
        spec = json.load(f)
    spec['_base'] = str(path.parent)
    return spec


@dataclass
class Cell:
    """One workload with its configuration, traffic and metrics."""
    name: str
    cfg: Dict
    traffic: Dict
    end_to_end: List[Dict]
    per_layer: List[Dict]
    chips: int = 1
    limits: Dict = field(default_factory=dict)
    root: Path = HERE


def find_cell(spec: Dict, workload: str) -> Cell:
    """The cell named ``workload``: its configuration file, its traffic
    mix (``traffic/<name>.json`` beside the configurations' folder) and the
    metrics that list it or list no cells."""
    base = Path(spec['_base'])
    cells = {w['name']: w for w in spec['workloads']}
    if workload not in cells:
        raise KeyError(f'no workload {workload!r} in BENCHMARK.json')
    w = cells[workload]
    conf = {c['name']: c for c in spec['configs']}[w['config']]
    with open(base / conf['file']) as f:
        cfg = json.load(f)
    traffic_dir = (base / conf['file']).parent.parent / 'traffic'
    with open(traffic_dir / f"{w['traffic']}.json") as f:
        traffic = json.load(f)
    if not (HERE / 'entries' / f"{traffic['entry']}.py").is_file():
        raise ValueError(f"unknown entry {traffic['entry']!r}")

    def mine(m):
        return workload in m['workloads'] if 'workloads' in m else True

    e2e = [m for m in spec['end_to_end'] if mine(m)]
    per = [m for m in spec['per_layer'] if mine(m)]
    return Cell(workload, cfg, traffic, e2e, per, w.get('chips', 1),
                traffic.get('limits', {}), traffic_dir.parent)


def load_metric(name: str, metrics_dir: Path = HERE / 'metrics'):
    """The reader module ``metrics/<name>.py`` (named by the metric's name,
    dots and all)."""
    path = metrics_dir / f'{name}.py'
    spec = importlib.util.spec_from_file_location(
        'bench_port_metric_' + name.replace('.', '_'), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name, compared whole, is JAX's or the
    JAX package's."""
    return sorted({m for m in list(sys.modules)
                   if m.split('.')[0] in FORBIDDEN})


@dataclass
class Run:
    """What an entry needs: the cell, the run's arguments and where the
    result goes."""
    cell: Cell
    seed: int
    seconds: float
    trace: bool
    device: object
    flat_warmup: bool = True
    fault: str = ''
    detail: Dict = field(default_factory=dict)

    @property
    def metrics_dir(self) -> Path:
        return self.cell.root / 'metrics'


def e2e_metrics(run: Run, values: Dict[str, float]) -> Dict:
    """The cell's end-to-end metrics from what the entry measured."""
    out = {}
    for m in run.cell.end_to_end:
        if m['name'] in values:
            out[m['name']] = {'value': values[m['name']], 'unit': m['unit']}
    return out


def layer_metrics(run: Run, reading) -> Dict:
    """Each per-layer metric of the cell read by its own module; a reader
    that finds nothing leaves its metric out."""
    out = {}
    for m in run.cell.per_layer:
        mod = load_metric(m['name'], run.metrics_dir)
        value = mod.read(reading)
        if value is not None:
            out[m['name']] = {'value': value, 'unit': m['unit']}
    return out


def device_info(device) -> Dict:
    import torch
    if device.type != 'cuda':
        return {'platform': 'cpu', 'kind': 'cpu', 'count': 1,
                'memory_peak_bytes': 0}
    return {'platform': 'gpu', 'kind': torch.cuda.get_device_name(device),
            'count': 1,
            'memory_peak_bytes': int(torch.cuda.max_memory_allocated(device))}


def checks_ok(checks: Dict) -> bool:
    return all(c['value'] <= c['limit'] for c in checks.values())


def execute(run: Run) -> Dict:
    """Run the cell's entry; returns the result object of the last line
    (``checks`` last)."""
    entry = importlib.import_module(
        f"bench_port.entries.{run.cell.traffic['entry']}")
    res = entry.run(run)
    checks = res.pop('checks')
    out = {'correct': bool(res.pop('correct')) and checks_ok(checks),
           'attempted': res.pop('attempted'), 'failed': res.pop('failed'),
           'metrics': res.pop('metrics'), 'device': res.pop('device')}
    if 'breakdown' in res:
        out['breakdown'] = res.pop('breakdown')
    run.detail.update(res)
    out['checks'] = checks
    return out
