"""Every config of ``configs/`` trains in the port: each YAML (none sets a
``train.parallel`` mesh of more than one device, the one setting the port
refuses) keeps its own model, loss and train knobs (``is_blender``, the
loss weights, the optimizer, the views a step, the precision, the
schedule) and is given ``configs/synthetic_smoke.yaml``'s dataset and
widths through ``--set`` overrides. One port step at the config's first
``init`` step, from ``init_model`` on the smoke run's point cloud, and one
at its first ``sp`` step, from a random sp-stage model
(``framework.random_model``), each raise nothing and give a finite loss,
with the config's regularizers among its losses (the two ablations'
``re_pos`` and ``sp_arap_t`` / ``sp_arap_ct``).
"""
import math
from pathlib import Path

import pytest

from sk_gs_tpu_torch import convert
from sk_gs_tpu_torch.framework import build, config
from sk_gs_tpu_torch.framework.random_model import random_model_flat
from sk_gs_tpu_torch.framework.trainer import SKGSTrainer
from sk_gs_tpu_torch.models.gaussian_splatting import init_from_pcd
from sk_gs_tpu_torch.models.losses import LossWeights
from sk_gs_tpu_torch.models.sk_gs import init_model
from tests.test_torch_cli import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
CONFIGS = sorted(str(p.relative_to(ROOT))
                 for p in (ROOT / 'configs').rglob('*.yaml'))
SMOKE = config.make_config(str(ROOT / 'configs/synthetic_smoke.yaml'))
# synthetic_smoke's dataset and widths
WIDTHS = {'model.capacity': SMOKE['model']['capacity'],
          'model.num_superpoints': SMOKE['model']['num_superpoints'],
          'model.net.depth': SMOKE['model']['net']['depth'],
          'model.net.width': SMOKE['model']['net']['width'],
          'raster.pair_capacity': SMOKE['raster']['pair_capacity'],
          'raster.chunk': SMOKE['raster']['chunk'],
          'train.num_init_points': SMOKE['train']['num_init_points']}


def smoke_sized(path: str, root: Path) -> dict:
    ds = SMOKE['dataset']
    sets = [f'dataset.{k}={ds[k]}' for k in
            ('kind', 'num_frames', 'image_size', 'num_links',
             'gauss_per_link', 'background')]
    sets += [f'{k}={v}' for k, v in WIDTHS.items()]
    sets.append(f'dataset.root={root}')
    return config.make_config(str(ROOT / path), sets)


def test_no_config_needs_a_mesh():
    assert len(CONFIGS) == 40
    for path in CONFIGS:
        par = config.make_config(str(ROOT / path))['train'].get(
            'parallel') or {}
        assert int(par.get('n_view', 1)) * int(par.get('n_gs', 1)) == 1, path


@pytest.fixture(scope='module')
def data_root(tmp_path_factory):
    """One dataset root for every config: the smoke scene renders once and
    the other configs read its cached frames."""
    return tmp_path_factory.mktemp('data')


@pytest.mark.parametrize('path', CONFIGS)
def test_config_trains_an_init_and_an_sp_step(path, data_root):
    cfg = smoke_sized(path, data_root)
    scene, meta, eval_scene, pcd = build.build_scene(cfg, 'cpu')
    skcfg, rcfg = build.build_model_cfg(cfg, meta, scene.image_size)
    opts = build.trainer_options(cfg)
    loss = LossWeights(cfg.get('loss', {}))
    pts, cols = build.initial_point_cloud(cfg, pcd)
    stages = skcfg.stages
    init_step = (stages['init'][0] if stages['init'][2] else
                 stages['init_fix'][0]) + 1
    model = init_model(skcfg, rcfg, init_from_pcd(pts, cols, skcfg.gauss,
                                                  device='cpu'),
                       meta.train_times, seed=opts['seed'], device='cpu')
    tr = SKGSTrainer(skcfg, rcfg, scene, meta, model, loss_weights=loss,
                     sampler=build.build_sampler(cfg, scene, skcfg),
                     pcd=(pts, cols), device='cpu', **opts)
    assert tr.family(skcfg.stage_at(init_step)) == 'init'
    m = tr.train_step(init_step)
    assert math.isfinite(float(m['loss'])), (path, 'init', m)
    for name in ('elastic', 'acc', 'arap', 'arap_p'):
        assert (name in m) == loss.ever_nonzero(name), name

    sp_step = stages['sp'][0] + 1
    model = convert.model_from_flat(
        random_model_flat(skcfg, opts['seed'], n_alive=300, sp_stage=True),
        skcfg, rcfg, device='cpu', trainable=True)
    tr = SKGSTrainer(skcfg, rcfg, scene, meta, model, loss_weights=loss,
                     sampler=build.build_sampler(cfg, scene, skcfg),
                     sp_initialized=True, reinit_done=True, device='cpu',
                     **opts)
    assert skcfg.stage_at(sp_step) == 'sp'
    m = tr.train_step(sp_step)
    assert math.isfinite(float(m['loss'])), (path, 'sp', m)
    assert int(m['n_bad_grad']) == 0
    for name in ('elastic', 'acc', 'arap', 're_pos', 'jp_dist'):
        assert (name in m) == loss.ever_nonzero(name), name
    assert ('sp_arap_t' in m) == (loss.ever_nonzero('sp_arap_t')
                                  or loss.ever_nonzero('sp_arap_ct'))
