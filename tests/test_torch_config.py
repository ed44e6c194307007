"""Port parity, configs: the port's YAML reader and writer against
``yaml.safe_load`` on every file of ``configs/``, ``make_config``
(``__base__``, ``__replace__``, ``--set``) against the JAX package's, and
``build_model_cfg`` field by field against ``train.build_model_cfg`` for
every config (a stand-in scene meta). The port reads YAML without PyYAML and
writes PNGs without Pillow: neither is on the card's machine, and no module
of the port imports them."""
import json
import math
import re
import subprocess
import sys
import types
from pathlib import Path

import pytest
import yaml

from sk_gs_tpu.framework import config as jconfig
from sk_gs_tpu_torch.framework import build, config, yamlio
from sk_gs_tpu_torch.framework.presets import synthetic_fullscale

ROOT = Path(__file__).resolve().parents[1]
CONFIGS = sorted(str(p.relative_to(ROOT))
                 for p in (ROOT / 'configs').rglob('*.yaml'))
FORBIDDEN = re.compile(r'^\s*(import|from)\s+(yaml|PIL)\b', re.M)
META = types.SimpleNamespace(num_frames=24)


def _as_dict(x):
    if hasattr(x, '_asdict'):
        return {k: _as_dict(v) for k, v in x._asdict().items()}
    return x


def test_configs_are_all_there():
    assert len(CONFIGS) == 40


@pytest.mark.parametrize('path', CONFIGS)
def test_reader_matches_safe_load(path):
    text = (ROOT / path).read_text()
    assert yamlio.loads(text) == yaml.safe_load(text)


@pytest.mark.parametrize('path', CONFIGS)
def test_make_config_and_build_match_jax(path):
    """The merged config equals the JAX package's, ``save_config`` writes
    it so that both readers read it back equal, and ``build_model_cfg``
    gives the JAX package's fields (``use_pallas`` 'auto' is the port's
    ``use_kernel`` True: the kernel on CUDA tensors, the plain version on
    CPU tensors)."""
    from train import build_model_cfg
    cfg = config.make_config(str(ROOT / path))
    assert cfg == jconfig.make_config(str(ROOT / path))
    text = yamlio.dumps(cfg)
    assert yaml.safe_load(text) == cfg
    assert yamlio.loads(text) == cfg
    # the JAX package's save_config writes block sequences
    assert yamlio.loads(yaml.safe_dump(cfg, sort_keys=False)) == cfg
    got, got_r = build.build_model_cfg(cfg, META, (64, 48))
    ref, ref_r = build_model_cfg(cfg, META, (64, 48))
    assert _as_dict(got) == _as_dict(ref)
    ref_r = ref_r._asdict()
    got_r = got_r._asdict()
    setting = cfg['raster'].get('use_pallas', 'auto')
    # 'auto' is False for JAX on the CPU
    assert ref_r.pop('use_pallas') == (setting is True)
    assert got_r.pop('use_kernel') == (setting in ('auto', True))
    assert got_r.pop('schedule') == 'tile'
    assert got_r == ref_r


def test_save_config_round_trip(tmp_path):
    cfg = config.make_config(str(ROOT / 'configs/synthetic_smoke.yaml'),
                             ['model.test_time_interpolate=true',
                              'dataset.scene=\'377\'', 'train.lr=1e-5'])
    config.save_config(cfg, tmp_path / 'a' / 'config.yaml')
    back = config.make_config(str(tmp_path / 'a' / 'config.yaml'))
    assert back == cfg
    assert cfg['train']['lr'] == 1e-5 and cfg['dataset']['scene'] == '377'


@pytest.mark.parametrize('overrides', [
    ['train.lr=2e-3', 'model.net.depth=4'],
    ['dataset.scene=hook', 'model.canonical_replace_steps=[100, 200]'],
    ['loss.image={"method": "mse", "lambda": 1}', 'train.seed=3',
     'new.key.deep=yes', 'train.sampler=null'],
])
def test_overrides_match_jax(overrides):
    path = str(ROOT / 'configs/synthetic_fullscale.yaml')
    assert config.make_config(path, overrides) == \
        jconfig.make_config(path, overrides)


@pytest.mark.parametrize('text', [
    '1e-3', '1.0e-3', '1.0e3', '0755', '0x1F', '-0', '1_000', '.5', '-.inf',
    'yes', 'Off', '~', '"a\\tb"', "'it''s'", '[1, [2, 3], {a: b}]',
    '{method: l1, lambda: 0.8}', 'a: 1\nb:\n  - x\n  - y: 2\n    z: 3\nc: []',
    'http://x', 'k: "v # not comment" # comment', 'a:\n- 1\n- 2\nb: 3'])
def test_scalars_and_blocks(text):
    """Plain scalars resolve as YAML 1.1 does (a float needs its dot)."""
    assert yamlio.loads(text) == yaml.safe_load(text)
    assert config.parse_value(text) == jconfig.parse_value(text)


def test_writer_reads_back():
    values = [1e-05, 0.001, 1e20, 3.0, -2.5e-7, 1e16, math.inf, 'yes', '377',
              '', 'a b', 'x: y', '#c', None, True, [1, '2', {'a': [True]}],
              {'q': {}}, 'é\t']
    cfg = {'k': {f'v{i}': v for i, v in enumerate(values)}}
    text = yamlio.dumps(cfg)
    assert yaml.safe_load(text) == cfg
    assert yamlio.loads(text) == cfg


def test_fullscale_preset_matches_its_yaml():
    cfg = config.make_config(str(ROOT / 'configs/synthetic_fullscale.yaml'))
    got, got_r = build.build_model_cfg(cfg, types.SimpleNamespace(
        num_frames=48), (400, 400))
    ref, ref_r, train = synthetic_fullscale()
    assert got == ref and got_r == ref_r
    assert build.trainer_options(cfg) == {
        'seed': train.seed, 'clip_norm': train.clip_norm, 'batch_views': 1,
        'optimizer': train.optimizer}


def test_refused_knobs():
    # bf16 is the nets' compute dtype, as the JAX package builds it
    from train import build_model_cfg
    cfg = config.make_config(str(ROOT / 'configs/synthetic_smoke.yaml'),
                             ['train.precision=bf16'])
    got, _ = build.build_model_cfg(cfg, META, (48, 48))
    ref, _ = build_model_cfg(cfg, META, (48, 48))
    assert got.net.compute_dtype == got.sk_net.compute_dtype == 'bfloat16'
    assert _as_dict(got) == _as_dict(ref)
    # a mesh's gs axis is refused; its view axis needs as many processes
    # (tests/test_torch_cli_parallel.py launches them)
    cfg = config.make_config(str(ROOT / 'configs/synthetic_smoke.yaml'),
                             ['train.parallel={"n_view": 1, "n_gs": 2}'])
    with pytest.raises(NotImplementedError, match='parallel'):
        build.trainer_options(cfg)
    cfg = config.make_config(str(ROOT / 'configs/synthetic_smoke.yaml'),
                             ['train.parallel={"n_view": 2, "n_gs": 1}'])
    with pytest.raises(ValueError, match='parallel 2x1 needs 2 processes'):
        build.trainer_options(cfg)
    # every dataset kind of the JAX package loads; another kind raises,
    # and a missing dataset is not replaced by anything
    cfg = config.make_config(str(ROOT / 'configs/d_nerf.yaml'),
                             ['dataset.kind=nerf'])
    with pytest.raises(NotImplementedError, match='kind nerf'):
        build.build_scene(cfg, 'cpu')
    cfg = config.make_config(str(ROOT / 'configs/d_nerf.yaml'),
                             ['dataset.root=/nonexistent'])
    with pytest.raises(FileNotFoundError):
        build.build_scene(cfg, 'cpu')
    cfg = config.make_config(str(ROOT / 'configs/synthetic_smoke.yaml'),
                             ['train.capacity_buckets=true'])
    assert build.trainer_options(cfg)['batch_views'] == 1


def test_no_yaml_or_pil_in_the_port():
    files = sorted((ROOT / 'sk_gs_tpu_torch').rglob('*.py'))
    files.append(ROOT / 'chip_smoke.py')
    for f in files:
        assert not FORBIDDEN.search(f.read_text()), f
    code = ('import importlib, json, pkgutil, sys, sk_gs_tpu_torch\n'
            'for m in pkgutil.walk_packages(sk_gs_tpu_torch.__path__, '
            '"sk_gs_tpu_torch."): importlib.import_module(m.name)\n'
            'import chip_smoke\n'
            'print(json.dumps(sorted(m for m in sys.modules '
            'if m.split(".")[0] in ("yaml", "PIL", "jax", "sk_gs_tpu"))))')
    out = subprocess.run([sys.executable, '-c', code], cwd=ROOT,
                         capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []
