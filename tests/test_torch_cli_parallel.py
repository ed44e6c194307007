"""The port's ``cli.train`` over two processes: 2 gloo ranks on the CPU
(``train.parallel: {n_view: 2}``, one view each) train
configs/synthetic_smoke.yaml through step 125 (the superpoint
initialisation, the restart, the sp events, the skeleton initialisation,
``sk_init`` and ``sk`` steps) to the ``last.npz`` of one process at
``train.batch_views`` 2, within tests/test_torch_train.py's parameter bars
(on the CPU the two runs add the same numbers in the same order, so they
agree bit for bit). Only rank 0 writes: each rank is given its own
``output_dir`` and rank 1's stays empty; rank 0 alone writes the cached
synthetic scene, which rank 1 reads. NCCL with more ranks than cards
raises with its message.

The ``gs`` axis: 2 gloo ranks at ``train.parallel: {n_view: 1, n_gs: 2}``
and ``raster.tile_h=8`` (the smoke config's 48 pixels are 3 tile rows at
16, which do not split into 2 bands: there the trainer raises) train
through step 45 (the superpoint initialisation, the restart, ``sp_fix``)
to the ``last.npz`` of one process at tile_h 8: the ranks sum each
step's terms in another order, so Adam's steps part by rounding where a
gradient is near 0 (the twin-run rule of ``chip_smoke.py``'s
``cli_train_parallel``: each parameter within 2 lr a step plus 1e-5 of
its leaf), and every integer state (the alive slots, the superpoints,
the statistics' counts) is equal."""
from pathlib import Path

import numpy as np
import pytest

from sk_gs_tpu_torch import convert
from sk_gs_tpu_torch.cli import train as cli_train
from sk_gs_tpu_torch.framework import build
from sk_gs_tpu_torch.framework.checkpoint import load
from sk_gs_tpu_torch.framework.config import make_config
from sk_gs_tpu_torch.framework.trainer import SKGSTrainer
from tests.test_torch_cli import CONFIG
from test_torch_mesh import one_torch_thread  # noqa: F401
from test_torch_mesh import rank_main, run_ranks

STEPS = 125
GS_STEPS = 45
GS_SETS = ('train.parallel={"n_view": 1, "n_gs": 2}', 'raster.tile_h=8')


def train_argv(out: Path, data: Path, *sets, device='cpu'):
    return ['-c', CONFIG, '--device', device, '--steps', str(STEPS),
            '--set', f'output_dir={out}', f'dataset.root={data}',
            'train.batch_views=2', *sets]


def gs_argv(out: Path, data: Path, *sets):
    return ['-c', CONFIG, '--device', 'cpu', '--steps', str(GS_STEPS),
            '--set', f'output_dir={out}', f'dataset.root={data}', *sets]


def case_train_gs(tmp, rank):
    """The smoke config at 16-pixel tiles on the 1 x 2 mesh (refused), then
    at tile_h 8."""
    tmp = Path(tmp)
    refused = ''
    try:
        cli_train.main(gs_argv(tmp / f'refused{rank}', tmp / 'data',
                               GS_SETS[0]))
    except ValueError as e:
        refused = str(e)
    cli_train.main(gs_argv(tmp / f'rank{rank}', tmp / 'data', *GS_SETS))
    return {'refused': np.array(refused)}


def case_train(tmp, rank):
    tmp = Path(tmp)
    cli_train.main(train_argv(tmp / f'rank{rank}', tmp / 'data',
                              'train.parallel={"n_view": 2, "n_gs": 1}'))
    return {}


@pytest.fixture(scope='module')
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp('cli_parallel')
    run_ranks(__file__, 'train', 2, tmp)
    one = tmp_path_factory.mktemp('cli_one')
    cli_train.main(train_argv(one, one / 'data'))
    return tmp, one


def test_two_ranks_train_as_one_process(runs):
    tmp, one = runs
    got = load(tmp / 'rank0' / 'synthetic_smoke' / 'checkpoints' /
               'last.npz')
    ref = load(one / 'synthetic_smoke' / 'checkpoints' / 'last.npz')
    assert set(got) == set(ref)
    for k, r in ref.items():
        g = got[k]
        if k.startswith('state/model/params/'):
            # tests/test_torch_train.py's bound for a parameter that moved
            scale = float(np.abs(r).max()) if r.size else 0.0
            np.testing.assert_allclose(g, r, rtol=0, atol=1e-5 * scale,
                                       err_msg=k)
        else:
            np.testing.assert_array_equal(g, r, err_msg=k)


def test_only_rank_zero_writes(runs):
    tmp, _ = runs
    out = tmp / 'rank0' / 'synthetic_smoke'
    for name in ('config.yaml', 'metrics.jsonl', 'results.json',
                 'last.ply', 'checkpoints/last.npz', 'checkpoints/init.npz',
                 'checkpoints/sk_init.npz', 'checkpoints/checkpoint_00000100.npz'):
        assert (out / name).exists(), name
    assert not (tmp / 'rank1').exists()
    assert (tmp / 'data').is_dir()


def lr_sums(run: Path, ckpt: dict) -> dict:
    """Each leaf's learning rates summed over steps 1..GS_STEPS of the run
    in ``run`` (its written config; ``ckpt`` one of its checkpoints)."""
    cfg = make_config(str(run / 'config.yaml'))
    scene, meta, _, _ = build.build_scene(cfg, 'cpu')
    skcfg, rcfg = build.build_model_cfg(cfg, meta, scene.image_size)
    tr = SKGSTrainer(skcfg, rcfg, scene, meta, convert.model_from_flat(
        ckpt, skcfg, rcfg, device='cpu', trainable=True), device='cpu')
    out = {}
    for step in range(1, GS_STEPS + 1):
        for k, v in tr.lr_trees(step).items():
            out[k] = out.get(k, 0.0) + v
    return out


def test_gs_axis_raises(tmp_path):
    """The ``gs`` axis: refused where the tile rows do not split into its
    bands, and at tile_h 8 two ranks train as one process."""
    ranks = run_ranks(__file__, 'train_gs', 2, tmp_path)
    for r in ranks:
        assert str(r['refused']) == \
            'grid_h 3 not divisible by mesh gs axis 2 (pad image height)'
    one = tmp_path / 'one'
    cli_train.main(gs_argv(one, tmp_path / 'data_one', GS_SETS[1]))
    exp = 'synthetic_smoke'
    got = load(tmp_path / 'rank0' / exp / 'checkpoints' / 'last.npz')
    ref = load(one / exp / 'checkpoints' / 'last.npz')
    assert set(got) == set(ref)
    lrs = lr_sums(one / exp, ref)
    for k, r in ref.items():
        g = got[k]
        if k.startswith('state/model/params/'):
            bar = 2 * lrs[k[len('state/model/params/'):]] \
                + 1e-5 * float(np.abs(r).max())
            assert float(np.abs(g - r).max()) <= bar, k
        elif r.dtype.kind in 'biu':
            np.testing.assert_array_equal(g, r, err_msg=k)
    for name in ('config.yaml', 'metrics.jsonl', 'results.json', 'last.ply',
                 'checkpoints/init.npz', 'checkpoints/last.npz'):
        assert (tmp_path / 'rank0' / exp / name).exists(), name
    assert not (tmp_path / 'rank1').exists()


def test_nccl_with_more_ranks_than_cards_raises(tmp_path, monkeypatch):
    for k, v in (('MASTER_ADDR', '127.0.0.1'), ('WORLD_SIZE', '2'),
                 ('RANK', '0')):
        monkeypatch.setenv(k, v)
    monkeypatch.delenv('LOCAL_WORLD_SIZE', raising=False)
    with pytest.raises(ValueError, match="use backend 'gloo'"):
        cli_train.main(train_argv(tmp_path, tmp_path / 'data',
                                  '--dist-backend', 'nccl'))


if __name__ == '__main__':
    rank_main({'train': case_train, 'train_gs': case_train_gs})
