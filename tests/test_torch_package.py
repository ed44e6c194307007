"""The port stands alone: it loads no JAX, nothing of sk_gs_tpu nor the
JAX package's root ``viewer``, and neither Pillow nor PyYAML (the card's
machine has neither), its
entry points default to the card and refuse to run on the CPU unasked, and
chip_smoke.py fails (printing no result) where there is no card or no port
beside it. The one-device trainer, the evaluation, the models and the
renderer know nothing of the device mesh."""
import ast
import inspect
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from sk_gs_tpu_torch import cuda_build, resolve_device
from sk_gs_tpu_torch.framework.trainer import SKGSTrainer
from sk_gs_tpu_torch.render.tile_kernel import (KERNELS, tile_blend_bwd,
                                                tile_blend_fwd)

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = re.compile(
    r'^\s*(import|from)\s+(jax|sk_gs_tpu|PIL|yaml|viewer)\b', re.M)

_IMPORT_ALL = r"""
import importlib, json, pkgutil, sys
import sk_gs_tpu_torch
names = [m.name for m in pkgutil.walk_packages(sk_gs_tpu_torch.__path__,
                                               'sk_gs_tpu_torch.')]
for name in names:
    importlib.import_module(name)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m.split('.')[0] in ('jax', 'jaxlib', 'sk_gs_tpu', 'PIL',
                                    'yaml', 'viewer'))
print(json.dumps({'modules': names, 'bad': bad}))
"""


def test_no_jax_imports_in_sources():
    files = sorted((ROOT / 'sk_gs_tpu_torch').rglob('*.py'))
    files.append(ROOT / 'chip_smoke.py')
    assert len(files) > 20
    for f in files:
        assert not FORBIDDEN.search(f.read_text()), f


def test_importing_every_module_loads_no_jax():
    out = subprocess.run([sys.executable, '-c', _IMPORT_ALL], cwd=ROOT,
                         capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    for name in ('framework.evaluate', 'framework.trainer', 'data.synthetic',
                 'models.optim', 'ops.knn', 'models.deform', 'data.dnerf',
                 'data.wim', 'data.zju', 'data.colmap', 'utils.png',
                 'utils.resize', 'utils.jpeg', 'framework.registry',
                 'framework.lr_schedules', 'cli.viewer', 'parallel.mesh',
                 'parallel.collectives', 'parallel.sharded_render',
                 'parallel.trainer'):
        assert 'sk_gs_tpu_torch.' + name in res['modules']
    assert res['bad'] == []


def imported_modules(path: Path) -> set:
    """The absolute names of the modules that ``path``, a module of
    sk_gs_tpu_torch, imports from."""
    package = '.'.join(path.relative_to(ROOT).with_suffix('').parts[:-1])
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            base = package.split('.')
            base = base[:len(base) - node.level + 1] if node.level else []
            name = '.'.join(base + ([node.module] if node.module else []))
            names.add(name)
            names.update(f'{name}.{a.name}' for a in node.names)
    return names


def test_one_device_modules_know_no_mesh():
    port = ROOT / 'sk_gs_tpu_torch'
    files = [port / 'framework' / 'trainer.py',
             port / 'framework' / 'evaluate.py',
             *sorted((port / 'models').rglob('*.py')),
             *sorted((port / 'render').rglob('*.py'))]
    assert len(files) > 10
    for f in files:
        names = imported_modules(f)
        assert not any(n == 'sk_gs_tpu_torch.parallel' or n.startswith(
            'sk_gs_tpu_torch.parallel.') for n in names), f
    # the relative imports, which the check above reads, are resolved
    assert 'sk_gs_tpu_torch.render.render' in imported_modules(files[0])
    assert {'sk_gs_tpu_torch.parallel.collectives',
            'sk_gs_tpu_torch.framework.trainer'} <= imported_modules(
        port / 'parallel' / 'trainer.py')
    assert 'mesh' not in inspect.signature(SKGSTrainer.__init__).parameters


def test_entry_points_refuse_cpu_fallback(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='cuda'):
        resolve_device('cuda')
    from sk_gs_tpu_torch import convert
    from sk_gs_tpu_torch.framework.presets import synthetic_fullscale
    cfg, rcfg, _ = synthetic_fullscale()
    with pytest.raises(RuntimeError, match='cuda'):
        convert.model_from_flat({'params/xyz': np.zeros((1, 3))}, cfg, rcfg)
    assert resolve_device('cpu') == torch.device('cpu')


def test_kernel_wrapper_launches_only_on_cuda():
    geo = torch.zeros(5, 6)
    col = torch.zeros(5, 3)
    ints = torch.zeros(4, dtype=torch.int32)
    tiles = torch.zeros(4, 256, 3)
    alpha = torch.zeros(4, 256)
    from sk_gs_tpu_torch.render.settings import RasterConfig
    cfg = RasterConfig(image_width=32, image_height=32)
    before = (tile_blend_fwd.launches, tile_blend_bwd.launches)
    with pytest.raises(ValueError, match='CUDA'):
        tile_blend_fwd.launch(geo, col, ints, ints, ints, cfg)
    with pytest.raises(ValueError, match='CUDA'):
        tile_blend_bwd.launch(geo, col, ints, ints, ints, tiles, alpha, tiles,
                              alpha, cfg)
    assert (tile_blend_fwd.launches, tile_blend_bwd.launches) == before
    assert [k.name for k in KERNELS] == ['tile_blend_fwd', 'tile_blend_bwd',
                                         'chunk_blend_fwd', 'chunk_blend_bwd']
    for kernel, tpu_fn in zip(KERNELS, ('def _fwd_kernel_tile',
                                        'def _bwd_kernel_tile',
                                        'def _fwd_kernel(',
                                        'def _bwd_kernel(')):
        assert kernel.source == f'sk_gs_tpu_torch/csrc/{kernel.name}.cu'
        assert (ROOT / kernel.source).is_file()
        assert kernel.library.source == ROOT / kernel.source
        path, line = kernel.replaces.split(':')
        assert tpu_fn in (ROOT / path).read_text().splitlines()[int(line) - 1]


def test_missing_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(shutil, 'which', lambda name: None)
    monkeypatch.setenv('CUDA_HOME', str(tmp_path))
    with pytest.raises(RuntimeError, match='nvcc'):
        cuda_build.nvcc_path()


def test_chip_smoke_fails_without_card_or_port(tmp_path):
    out = subprocess.run([sys.executable, 'chip_smoke.py'], cwd=ROOT,
                         capture_output=True, text=True, timeout=240)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    shutil.copy(ROOT / 'chip_smoke.py', tmp_path / 'chip_smoke.py')
    out = subprocess.run([sys.executable, 'chip_smoke.py'], cwd=tmp_path,
                         capture_output=True, text=True, timeout=240)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
