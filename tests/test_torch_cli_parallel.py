"""The port's ``cli.train`` over two processes: 2 gloo ranks on the CPU
(``train.parallel: {n_view: 2}``, one view each) train
configs/synthetic_smoke.yaml through step 125 (the superpoint
initialisation, the restart, the sp events, the skeleton initialisation,
``sk_init`` and ``sk`` steps) to the ``last.npz`` of one process at
``train.batch_views`` 2, within tests/test_torch_train.py's parameter bars
(on the CPU the two runs add the same numbers in the same order, so they
agree bit for bit). Only rank 0 writes: each rank is given its own
``output_dir`` and rank 1's stays empty; rank 0 alone writes the cached
synthetic scene, which rank 1 reads. A mesh's ``gs`` axis and NCCL with
more ranks than cards each raise with their message."""
from pathlib import Path

import numpy as np
import pytest

from sk_gs_tpu_torch.cli import train as cli_train
from sk_gs_tpu_torch.framework.checkpoint import load
from tests.test_torch_cli import CONFIG
from test_torch_mesh import one_torch_thread  # noqa: F401
from test_torch_mesh import rank_main, run_ranks

STEPS = 125


def train_argv(out: Path, data: Path, *sets, device='cpu'):
    return ['-c', CONFIG, '--device', device, '--steps', str(STEPS),
            '--set', f'output_dir={out}', f'dataset.root={data}',
            'train.batch_views=2', *sets]


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


def test_gs_axis_raises(tmp_path):
    with pytest.raises(NotImplementedError, match='ROADMAP.md 1.3'):
        cli_train.main(train_argv(tmp_path, tmp_path / 'data',
                                  'train.parallel={"n_view": 1, "n_gs": 2}'))


def test_nccl_with_more_ranks_than_cards_raises(tmp_path, monkeypatch):
    for k, v in (('MASTER_ADDR', '127.0.0.1'), ('WORLD_SIZE', '2'),
                 ('RANK', '0')):
        monkeypatch.setenv(k, v)
    monkeypatch.delenv('LOCAL_WORLD_SIZE', raising=False)
    with pytest.raises(ValueError, match="use backend 'gloo'"):
        cli_train.main(train_argv(tmp_path, tmp_path / 'data',
                                  '--dist-backend', 'nccl'))


if __name__ == '__main__':
    rank_main({'train': case_train})
