"""Port parity, the device mesh (``sk_gs_tpu_torch/parallel/mesh.py`` and
``collectives.py``): ``init_distributed``'s env rules and errors against
the JAX function's decisions on the same env, and gloo runs of real
processes on the CPU: ``make_mesh`` at (2, 1) and (1, 2) over 2 ranks and
(2, 2) over 4, its axis groups, and each collective's value and gradient
against the same computation in one process.

The ranks are this file run as a script (``run_ranks``), one process each
with ``MASTER_ADDR`` / ``WORLD_SIZE`` / ``RANK`` in its env, as
tests/test_multihost.py launches its workers; they import no JAX, run on
one torch thread and write ``<case>_rank<r>.npz`` for the parent to
compare. Other port test files launch their ranks with ``run_ranks`` too.
"""
import os
import socket
import subprocess
import sys
import time
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

from sk_gs_tpu_torch.parallel import collectives as coll
from sk_gs_tpu_torch.parallel import mesh as tmesh

REPO = Path(__file__).resolve().parent.parent
RANK_TIMEOUT = 300


def free_port() -> int:
    s = socket.socket()
    s.bind(('127.0.0.1', 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.fixture(scope='module', autouse=True)
def one_torch_thread():
    """One torch thread for the module: the port's CPU runs are thousands
    of small ops, which gain nothing from more threads, and beside the
    other test workers their threads stall each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def run_ranks(script, case: str, world: int, tmp: Path, *args,
              timeout: float = RANK_TIMEOUT):
    """Run ``python script case tmp args...`` as ``world`` gloo ranks;
    when a rank fails the others are stopped, and the failure raises with
    its output. Returns each rank's ``<case>_rank<r>.npz`` loaded."""
    port = free_port()
    procs, logs = [], []
    for rank in range(world):
        env = dict(os.environ, MASTER_ADDR='127.0.0.1', MASTER_PORT=str(port),
                   WORLD_SIZE=str(world), RANK=str(rank),
                   PYTHONPATH=str(REPO), OMP_NUM_THREADS='1')
        log = open(tmp / f'{case}_rank{rank}.log', 'w+')
        logs.append(log)
        procs.append(subprocess.Popen(
            [sys.executable, str(script), case, str(tmp), *map(str, args)],
            env=env, cwd=str(REPO), stdout=log, stderr=subprocess.STDOUT))
    try:
        deadline = time.monotonic() + timeout
        while any(p.poll() is None for p in procs):
            if any(p.poll() not in (None, 0) for p in procs) or \
                    time.monotonic() > deadline:
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        outs = []
        for log in logs:
            log.seek(0)
            outs.append(log.read())
            log.close()
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f'rank {rank} failed:\n{out}'
    return [dict(np.load(tmp / f'{case}_rank{r}.npz')) for r in range(world)]


def rank_main(cases):
    """The body of a rank process: one torch thread, the process group from
    the env, ``cases[argv[1]](tmp, rank, *argv[3:])`` -> a dict of arrays
    written to ``<case>_rank<r>.npz``."""
    torch.set_num_threads(1)
    case, tmp = sys.argv[1], Path(sys.argv[2])
    info = tmesh.init_distributed(backend='gloo')
    out = cases[case](tmp, info['process_index'], *sys.argv[3:])
    np.savez(tmp / f"{case}_rank{info['process_index']}.npz", **out)
    if dist.is_initialized():
        dist.destroy_process_group()


# ---------------------------------------------------------- init_distributed

ENV_NAMES = ('MASTER_ADDR', 'MASTER_PORT', 'WORLD_SIZE', 'RANK',
             'LOCAL_WORLD_SIZE', 'JAX_COORDINATOR_ADDRESS',
             'JAX_NUM_PROCESSES', 'JAX_PROCESS_ID')

# (env, explicit arguments)
INIT_CASES = {
    'no_env': ({}, {}),
    'stale_master_addr': ({'MASTER_ADDR': 'h0'}, {}),
    'stale_with_world_1': ({'MASTER_ADDR': 'h0', 'WORLD_SIZE': '1',
                            'RANK': '0'}, {}),
    'env_launch': ({'MASTER_ADDR': 'h0', 'MASTER_PORT': '2345',
                    'WORLD_SIZE': '2', 'RANK': '1'}, {}),
    'env_default_port': ({'MASTER_ADDR': 'h1', 'WORLD_SIZE': '4',
                          'RANK': '3'}, {}),
    'explicit_alone': ({}, {'coordinator': 'h2:7'}),
    'explicit_world_1': ({}, {'coordinator': 'h2:7', 'num_processes': 1}),
    'explicit_launch': ({}, {'coordinator': 'h2:7', 'num_processes': 2,
                             'process_id': 0}),
    'explicit_over_env': ({'MASTER_ADDR': 'h0', 'WORLD_SIZE': '2',
                           'RANK': '1'}, {'coordinator': 'h3:9'}),
    'args_over_env': ({'MASTER_ADDR': 'h0', 'WORLD_SIZE': '2', 'RANK': '1'},
                      {'num_processes': 3, 'process_id': 2}),
}


def decision(fn) -> str:
    """'error', 'warn' or 'quiet': what ``fn()`` does."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter('always')
        try:
            fn()
        except ValueError:
            return 'error'
    return 'warn' if caught else 'quiet'


@pytest.mark.parametrize('case', sorted(INIT_CASES))
def test_init_distributed_decides_as_jax(case, monkeypatch):
    import jax
    from sk_gs_tpu.parallel import mesh as jmesh
    env, kw = INIT_CASES[case]
    for name in ENV_NAMES:
        monkeypatch.delenv(name, raising=False)
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    calls = {'jax': [], 'port': []}
    monkeypatch.setattr(jmesh, '_DIST_INITIALIZED', False)
    monkeypatch.setattr(jax.distributed, 'initialize', lambda **a: calls[
        'jax'].append((a['coordinator_address'], a['num_processes'],
                       a['process_id'])))
    monkeypatch.setattr(dist, 'is_initialized', lambda: False)
    monkeypatch.setattr(dist, 'init_process_group', lambda backend, **a:
                        calls['port'].append((
                            a['init_method'][len('tcp://'):],
                            a['world_size'], a['rank'])))
    got_j = decision(lambda: jmesh.init_distributed(**kw))
    got_t = decision(lambda: tmesh.init_distributed(backend='gloo', **kw))
    assert got_t == got_j
    assert calls['port'] == calls['jax']


def test_nccl_with_more_ranks_than_cards_names_gloo(monkeypatch):
    monkeypatch.setenv('MASTER_ADDR', 'h0')
    monkeypatch.setenv('LOCAL_WORLD_SIZE', '2')
    monkeypatch.setattr(dist, 'is_initialized', lambda: False)
    monkeypatch.setattr(torch.cuda, 'device_count', lambda: 1)
    monkeypatch.setattr(dist, 'init_process_group', lambda *a, **k: None)
    with pytest.raises(ValueError, match="backend 'gloo'"):
        tmesh.init_distributed(num_processes=2, process_id=0,
                               backend='nccl')


def test_one_process_mesh_and_its_errors():
    m = tmesh.make_mesh()
    assert (m.shape, m.axis_index('view'), m.axis_index('gs')) == (
        {'view': 1, 'gs': 1}, 0, 0)
    assert m.group('gs') is None and coll.group_size(m.group('view')) == 1
    x = torch.arange(6.0).reshape(3, 2)
    assert torch.equal(tmesh.shard_rows(x, m, 'gs'), x)
    with pytest.raises(ValueError, match='1x2 != 1 devices'):
        tmesh.make_mesh(n_view=1, n_gs=2)
    with pytest.raises(ValueError, match='mesh axis'):
        m.axis_size('batch')


# ---------------------------------------------------------- rank processes

def _rank_draw(rank: int, shape, salt: int = 0) -> np.ndarray:
    return np.random.default_rng(100 * salt + rank).normal(
        size=shape).astype(np.float32)


def case_mesh(tmp, rank, n_view, n_gs):
    """The mesh's coordinates and each axis group's sum of the ranks."""
    m = tmesh.make_mesh(int(n_view), int(n_gs))
    me = torch.tensor([float(m.rank)])
    out = {'index': np.array([m.axis_index('view'), m.axis_index('gs')])}
    for axis in tmesh.AXES:
        g = m.group(axis)
        out[f'{axis}_ranks'] = np.array(m.axis_ranks(axis))
        out[f'{axis}_sum'] = coll.psum(me, g).numpy()
        out[f'{axis}_gathered'] = coll.all_gather(me, g).numpy()
        out[f'{axis}_shard'] = tmesh.shard_rows(
            torch.arange(4 * m.axis_size(axis)), m, axis).numpy()
    return out


def case_collectives(tmp, rank):
    """Each collective on the whole group: values, and the gradients of
    sum(w_r * out) on every rank r with w_r drawn from r."""
    world = dist.get_world_size()
    out = {}
    x = torch.from_numpy(_rank_draw(rank, (3, 2))).requires_grad_(True)
    y = coll.all_gather(x, dist.group.WORLD, dim=1)            # [3, 2 D]
    w = torch.from_numpy(_rank_draw(rank, tuple(y.shape), salt=1))
    (w * y).sum().backward()
    out['gather'], out['gather_grad'] = y.detach().numpy(), x.grad.numpy()
    z = torch.from_numpy(_rank_draw(rank, (world, 2, 3), salt=2)
                         ).requires_grad_(True)
    a = coll.all_to_all(z, dist.group.WORLD)
    w = torch.from_numpy(_rank_draw(rank, tuple(a.shape), salt=3))
    (w * a).sum().backward()
    out['a2a'], out['a2a_grad'] = a.detach().numpy(), z.grad.numpy()
    v = torch.from_numpy(_rank_draw(rank, (5,), salt=4))
    out['psum'] = coll.psum(v, dist.group.WORLD).numpy()
    out['pmax'] = coll.pmax(v, dist.group.WORLD).numpy()
    state = [torch.from_numpy(_rank_draw(rank, (4,), salt=5)),
             torch.full((3,), rank, dtype=torch.int32),
             torch.tensor([rank % 2 == 0, True])]
    out['drift'] = np.array(coll.broadcast_from(state, dist.group.WORLD, 1))
    for i, t in enumerate(state):
        out[f'state_{i}'] = t.numpy()
    return out


CASES = {'mesh': case_mesh, 'collectives': case_collectives}


@pytest.fixture(scope='module')
def two_ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp('mesh2')
    return {(v, g): run_ranks(__file__, 'mesh', 2, tmp, v, g)
            for v, g in ((2, 1), (1, 2))}


@pytest.fixture(scope='module')
def four_ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp('mesh4')
    return (run_ranks(__file__, 'mesh', 4, tmp, 2, 2),
            run_ranks(__file__, 'collectives', 4, tmp))


def check_mesh(outs, n_view, n_gs):
    for r, o in enumerate(outs):
        v, g = r // n_gs, r % n_gs
        assert tuple(o['index']) == (v, g)
        cols = [i * n_gs + g for i in range(n_view)]
        rows = [v * n_gs + j for j in range(n_gs)]
        for axis, ranks, i in (('view', cols, v), ('gs', rows, g)):
            np.testing.assert_array_equal(o[f'{axis}_ranks'], ranks)
            assert o[f'{axis}_sum'][0] == sum(ranks)
            np.testing.assert_array_equal(o[f'{axis}_gathered'], ranks)
            np.testing.assert_array_equal(o[f'{axis}_shard'],
                                          np.arange(4 * i, 4 * i + 4))


@pytest.mark.parametrize('shape', [(2, 1), (1, 2)])
def test_two_rank_mesh_groups(two_ranks, shape):
    check_mesh(two_ranks[shape], *shape)


def test_four_rank_mesh_groups(four_ranks):
    check_mesh(four_ranks[0], 2, 2)


def test_collectives_match_one_process(four_ranks):
    outs, world = four_ranks[1], 4
    xs = [_rank_draw(r, (3, 2)) for r in range(world)]
    gathered = np.concatenate(xs, axis=1)
    ws = [_rank_draw(r, gathered.shape, salt=1) for r in range(world)]
    zs = [_rank_draw(r, (world, 2, 3), salt=2) for r in range(world)]
    a2a = [np.stack([zs[s][r] for s in range(world)]) for r in range(world)]
    wz = [_rank_draw(r, (world, 2, 3), salt=3) for r in range(world)]
    vs = np.stack([_rank_draw(r, (5,), salt=4) for r in range(world)])
    for r, o in enumerate(outs):
        np.testing.assert_array_equal(o['gather'], gathered)
        np.testing.assert_allclose(
            o['gather_grad'], sum(ws)[:, 2 * r:2 * r + 2], rtol=1e-6)
        np.testing.assert_array_equal(o['a2a'], a2a[r])
        # block d of rank r's input went to rank d's block r
        np.testing.assert_array_equal(
            o['a2a_grad'], np.stack([wz[d][r] for d in range(world)]))
        np.testing.assert_allclose(o['psum'], vs.sum(0), rtol=1e-6)
        np.testing.assert_array_equal(o['pmax'], vs.max(0))
        np.testing.assert_array_equal(o['state_0'], _rank_draw(1, (4,), 5))
        np.testing.assert_array_equal(o['state_1'], np.ones(3, np.int32))
        np.testing.assert_array_equal(o['state_2'], [False, True])
        want = 0.0 if r == 1 else max(
            np.abs(_rank_draw(r, (4,), 5) - _rank_draw(1, (4,), 5)).max(),
            abs(r - 1), float(r % 2 == 0))
        assert float(o['drift']) == pytest.approx(want)


if __name__ == '__main__':
    rank_main(CASES)
