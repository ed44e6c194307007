"""A toy copy of the benchmark for the CPU tests: the cells' configurations
cut to a few thousand Gaussians at 64 px, the traffic mixes and metric
readers copied, in a folder of its own with its own ``BENCHMARK.json``."""
from __future__ import annotations

import json
import shutil
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
CHECKOUT = HERE.parent
TOY = {'capacity': 2048, 'num_superpoints': 32, 'n_alive': 1500,
       'image_size': 64, 'pair_capacity': 1 << 16, 'test_views': 4,
       'num_frames': 8, 'check_pool': 10}


def toy_config(cfg: dict) -> dict:
    cfg = json.loads(json.dumps(cfg))
    cfg['model']['capacity'] = TOY['capacity']
    cfg['model']['num_superpoints'] = TOY['num_superpoints']
    cfg['bench']['n_alive'] = TOY['n_alive']
    cfg['raster']['pair_capacity'] = TOY['pair_capacity']
    sc = cfg['scene']
    sc['image_size'] = TOY['image_size']
    sc['num_frames'] = TOY['num_frames']
    if sc['layout'] == 'dnerf':
        sc['test_views'] = TOY['test_views']
    else:
        sc['test_frames'] = [0, 4]
    return cfg


def make(tmp: Path, spec_path: Path = CHECKOUT / 'BENCHMARK.json') -> Path:
    """The toy benchmark under ``tmp``; returns its ``BENCHMARK.json``."""
    spec = json.loads(spec_path.read_text())
    root = tmp / 'toy'
    for sub in ('traffic', 'metrics'):
        shutil.copytree(HERE / sub, root / sub, dirs_exist_ok=True)
    for mix in (root / 'traffic').glob('*.json'):
        m = json.loads(mix.read_text())
        if 'check_pool' in m:
            m['check_pool'] = TOY['check_pool']
            mix.write_text(json.dumps(m))
    (root / 'configs').mkdir(parents=True, exist_ok=True)
    for c in spec['configs']:
        cfg = json.loads((CHECKOUT / c['file']).read_text())
        out = root / 'configs' / Path(c['file']).name
        out.write_text(json.dumps(toy_config(cfg)))
        c['file'] = str(out.relative_to(tmp))
    path = tmp / 'BENCHMARK.json'
    path.write_text(json.dumps(spec))
    return path
