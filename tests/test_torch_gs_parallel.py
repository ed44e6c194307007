"""Port parity, the trainer's ``gs`` mesh axis: gloo ranks on the CPU, each
computing its contiguous half of the capacity and a band of the image
(``MeshTrainer(mesh=make_mesh(n_view, 2))``), against the port's
one-process step at the same ``batch_views``, which
tests/test_torch_train_options.py and test_torch_regularizers.py hold
against the JAX step. One step from one state for each case: on a 1 x 2
mesh at ``batch_views`` 1 the ``init`` family on the chunk schedule, ``sp``
on a rebuilt smooth-loss KNN, ``sk_init`` and ``sk`` with SGD, ``sk`` with
Adam, and one case of each of ``sp`` and ``init`` with every loss that
takes a slice, gathers or runs replicated switched on (``re_pos``,
``jp_dist``, ``sp_arap_t`` / ``sp_arap_ct``, the guided losses' gate open;
``arap_p``, ``elastic``, ``acc``, ``arap``; ``c_net`` in both); on a 2 x 2
mesh at ``batch_views`` 2 the ``sp`` and ``sk`` families. The image is 64
x 48 at tile_h 8 (6 tile rows, 3 a band); targets are RGBA over 'random'
backgrounds and the warp net is not ``is_blender``, as in
tests/test_torch_view_parallel.py, whose bars hold here (``close_step``);
every rank's metrics, gradients and state are equal to the last bit. One
event step under the mesh (the smooth-loss KNN rebuilt before it, a
densification after it): each sync found the replicas equal (drift 0),
and they are equal after it.

JAX parity: the port's ``slice_model_gs`` against the JAX function's, row
for row, on a converted model; and one anchor, the port's 1 x 2 ``sk`` step
(SGD) against the JAX trainer's own step on a (1, 2) CPU mesh, on
tests/test_torch_slice.py's tiny model.
"""
import pickle
from pathlib import Path

import numpy as np
import pytest
import torch

from sk_gs_tpu_torch import convert
from sk_gs_tpu_torch.framework.trainer import SKGSTrainer
from sk_gs_tpu_torch.models.losses import LossWeights
from sk_gs_tpu_torch.ops.knn import live_knn_index
from sk_gs_tpu_torch.parallel import make_mesh
from sk_gs_tpu_torch.parallel.trainer import (PER_POINT_FIELDS,
                                              PER_POINT_PARAMS, MeshTrainer,
                                              slice_model_gs)
from test_torch_mesh import one_torch_thread  # noqa: F401
from test_torch_mesh import rank_main, run_ranks
from test_torch_view_parallel import (close_step, leaf_names, small_setup,
                                      start_model)

# (family, optimizer, step, losses switched on besides the preset's)
SP_ALL = {'re_pos': 0.1, 'jp_dist': 0.1, 'sp_arap_t': 0.1,
          'sp_arap_ct': 0.1}
INIT_ALL = {'arap_p': 0.1, 'elastic': 0.1, 'acc': 0.1, 'arap': 0.1}
CASES_1X2 = (('init', 'sgd', 5, {}), ('sp', 'sgd', 15, {}),
             ('sk_init', 'sgd', 35, {}), ('sk', 'sgd', 45, {}),
             ('sk', 'adam', 45, {}), ('sp', 'sgd', 15, SP_ALL),
             ('init', 'sgd', 5, INIT_ALL))
CASES_2X2 = (('sp', 'sgd', 15, {}), ('sk', 'sgd', 45, {}))
IDS_1X2 = ['init-chunk', 'sp', 'sk_init', 'sk', 'sk-adam', 'sp-all',
           'init-all']
EVENT_STEP = 15


def gs_setup(family: str, extra: dict):
    """tests/test_torch_view_parallel.py's setup at tile_h 8, the init
    family on the chunk schedule; with ``extra`` losses the guided
    losses' gate open."""
    cfg, rcfg, train, scene, meta = small_setup()
    rcfg = rcfg._replace(tile_h=8)
    if family == 'init':
        rcfg = rcfg._replace(schedule='chunk')
    if extra:
        cfg = cfg._replace(guided_step_start=0)
    return cfg, rcfg, scene, meta, LossWeights({**train.loss, **extra})


def make_trainer(family, optimizer, extra, batch_views, mesh=None):
    cfg, rcfg, scene, meta, loss = gs_setup(family, extra)
    model = start_model(cfg, rcfg, meta, family)
    knn = live_knn_index(model.params['xyz'].detach(), model.alive,
                         SKGSTrainer.gs_knn_num) if family == 'sp' else None
    cls, kw = (SKGSTrainer, {}) if mesh is None else \
        (MeshTrainer, {'mesh': mesh})
    return cls(cfg, rcfg, scene, meta, model, loss,
               batch_views=batch_views, optimizer=optimizer,
               gs_knn_index=knn, sp_initialized=True, reinit_done=True,
               skeleton_initialized=family in ('sk_init', 'sk'),
               device='cpu', **kw)


def one_step(family, optimizer, step, extra, batch_views, mesh=None):
    """A fresh trainer's step ``step``: {metric/..., grad/..., state/...}
    as numpy arrays."""
    tr = make_trainer(family, optimizer, extra, batch_views, mesh)
    assert tr.family(tr.cfg.stage_at(step)) == family
    metrics = tr.train_step(step)
    out = {f'metric/{k}': v.cpu().numpy() for k, v in metrics.items()}
    out.update({f'grad/{k}': p.grad.cpu().numpy()
                for k, p in tr.model.leaves().items()})
    out.update({f'state/{k}': v for k, v in
                convert.model_to_flat(tr.model).items()})
    out['lrs'] = np.array([tr.lr_trees(step)[k] for k in tr.model.leaves()])
    return out


def event_step(mesh):
    """An ``sp`` step whose trainer rebuilds the smooth-loss KNN before it
    and densifies after it: the syncs' drifts and the state after it."""
    tr = make_trainer('sp', 'adam', {}, mesh.axis_size('view'), mesh)
    tr.gs_knn_update_interval = (5, 10)
    tr.cfg = tr.cfg._replace(gauss=tr.cfg.gauss._replace(
        densify_interval=(5, 0, 100)))
    tr.train_step(EVENT_STEP)
    out = {f'state/{k}': v for k, v in
           convert.model_to_flat(tr.model).items()}
    out['knn'] = tr.gs_knn_index.numpy()
    out['events'] = np.array(sorted(tr.replica_drift))
    out['drift'] = np.array([tr.replica_drift[k]
                             for k in sorted(tr.replica_drift)])
    out['n_alive'] = tr.model.alive.sum().numpy()
    return out


def case_steps(tmp, rank, shape):
    n_view, n_gs = map(int, shape.split('x'))
    mesh = make_mesh(n_view, n_gs)
    cases = CASES_1X2 if n_view == 1 else CASES_2X2
    out = {}
    for i, case in enumerate(cases):
        out.update({f'{i}/{k}': v for k, v in
                    one_step(*case, n_view, mesh).items()})
    if n_view == 1:
        out.update({f'event/{k}': v for k, v in event_step(mesh).items()})
    return out


@pytest.fixture(scope='module')
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp('gs_parallel')
    return {'1x2': (run_ranks(__file__, 'steps', 2, tmp, '1x2'),
                    [one_step(*c, 1) for c in CASES_1X2]),
            '2x2': (run_ranks(__file__, 'steps', 4, tmp, '2x2'),
                    [one_step(*c, 2) for c in CASES_2X2])}


def check_case(runs, shape, case):
    ranks, one = runs[shape]
    ref = one[case]
    got = {k[len(f'{case}/'):]: v for k, v in ranks[0].items()
           if k.startswith(f'{case}/')}
    assert set(got) == set(ref)
    close_step(got, ref, leaf_names(ref))
    assert float(ref['metric/loss']) > 0
    assert max(np.abs(ref['grad/' + n]).max() for n in leaf_names(ref)) > 0
    assert not ref['metric/overflow'] and not got['metric/overflow']


@pytest.mark.parametrize('case', range(len(CASES_1X2)), ids=IDS_1X2)
def test_one_by_two_step_as_one_process(runs, case):
    check_case(runs, '1x2', case)


@pytest.mark.parametrize('case', range(len(CASES_2X2)), ids=['sp', 'sk'])
def test_two_by_two_step_as_one_process(runs, case):
    check_case(runs, '2x2', case)


@pytest.mark.parametrize('shape', ['1x2', '2x2'])
def test_replicas_are_equal(runs, shape):
    ranks, _ = runs[shape]
    for r in ranks[1:]:
        assert set(r) == set(ranks[0])
        for k in ranks[0]:
            np.testing.assert_array_equal(r[k], ranks[0][k], err_msg=k)


def test_event_step_syncs_equal_replicas(runs):
    ranks, _ = runs['1x2']
    r0 = ranks[0]
    assert list(r0['event/events']) == ['adaptive_control', 'update_gs_knn']
    for r in ranks:
        assert np.all(r['event/drift'] == 0)
    assert r0['event/knn'].any()
    assert int(r0['event/n_alive']) > 400       # the densification cloned


# ---------------------------------------------------------------- JAX parity

def test_slice_model_gs_matches_jax(tmp_path):
    import jax.numpy as jnp
    from sk_gs_tpu.framework import trainer as jtrainer
    from tests.test_torch_slice import port_model, tiny_jax_model
    cfg, rcfg, model = tiny_jax_model()
    tmodel = port_model(cfg, rcfg, model, tmp_path)
    n = tmodel.alive.shape[0]
    for n_gs in (2, 4):
        for i in range(n_gs):
            ref = jtrainer.slice_model_gs(model, jnp.asarray(i), n_gs)
            got = slice_model_gs(tmodel, i, n_gs)
            for k in tmodel.params:
                r = np.asarray(ref.params[k])
                g = got.params[k].detach().numpy()
                assert g.shape == r.shape, k
                np.testing.assert_array_equal(g, r, err_msg=k)
                if k in PER_POINT_PARAMS:
                    assert g.shape[0] == n // n_gs, k
            for k in PER_POINT_FIELDS:
                np.testing.assert_array_equal(
                    getattr(got, k).numpy(), np.asarray(getattr(ref, k)),
                    err_msg=k)
            assert got.sp_alive is tmodel.sp_alive


def test_slice_gradients_reach_the_full_leaf(tmp_path):
    """A loss on a slice's rows gives the full leaf that gradient on the
    slice and zeros off it, as JAX's dynamic_slice transposes."""
    from tests.test_torch_slice import port_model, tiny_jax_model
    cfg, rcfg, model = tiny_jax_model()
    tmodel = port_model(cfg, rcfg, model, tmp_path)
    for p in tmodel.params.values():
        p.requires_grad_(True)
    part = slice_model_gs(tmodel, 1, 2)
    (part.params['xyz'] ** 2).sum().backward()
    g = tmodel.params['xyz'].grad
    n = g.shape[0] // 2
    assert torch.equal(g[:n], torch.zeros_like(g[:n]))
    assert torch.equal(g[n:], 2 * tmodel.params['xyz'].detach()[n:])


def case_jax_anchor(tmp, rank):
    """The port's ``sk`` step over a 1 x 2 mesh on the JAX tiny model."""
    tmp = Path(tmp)
    with open(tmp / 'cfgs.pkl', 'rb') as f:
        cfg, rcfg, step = pickle.load(f)
    scene, meta = torch.load(tmp / 'scene.pt', weights_only=False)
    model = convert.model_from_flat(convert.load_npz(tmp / 'model.npz'),
                                    cfg, rcfg, device='cpu', trainable=True)
    tr = MeshTrainer(cfg, rcfg, scene, meta, model, LossWeights(
        {'image': {'method': 'l1', 'lambda': 0.8}, 'ssim': 0.2}),
        optimizer='sgd', mesh=make_mesh(1, 2), skeleton_initialized=True,
        device='cpu')
    metrics = tr.train_step(step)
    out = {f'metric/{k}': v.numpy() for k, v in metrics.items()}
    out.update({f'state/{k}': v for k, v in
                convert.model_to_flat(tr.model).items()})
    out['names'] = np.array(list(tr.model.leaves()))
    return out


def test_one_by_two_sk_step_matches_jax_mesh(tmp_path):
    """The port's 1 x 2 step against the JAX trainer's on a (1, 2) CPU mesh
    (its XLA blend: faster to compile). ``n_vis``, ``dxyz_max`` and
    ``num_pairs`` are left out: the JAX mesh step reports one chip's
    slice for the first two and 0 pairs (ROADMAP.md §3, departures)."""
    import jax
    from jax.sharding import Mesh
    from sk_gs_tpu.data import synthetic as jsynth
    from sk_gs_tpu.framework.checkpoint import _flatten, save_pytree
    from sk_gs_tpu.framework.trainer import SKGSTrainer as JaxTrainer
    from sk_gs_tpu.models import losses as jlosses
    from sk_gs_tpu_torch.data.base import SceneMeta
    from sk_gs_tpu_torch.models import sk_gs as tsk_gs
    from tests.test_torch_render import port_cfg
    from tests.test_torch_slice import tiny_jax_model, to_port_cfg_fields
    from tests.test_torch_train import LOSS, SCENE, port_scene
    cfg, rcfg, model = tiny_jax_model()
    rcfg = rcfg._replace(use_pallas=False, tile_h=8)
    scene, meta, _ = jsynth.make_synthetic_scene(chunk=256, use_pallas=False,
                                                 **SCENE)
    mesh = Mesh(np.asarray(jax.devices()[:2]).reshape(1, 2),
                ('view', 'gs'))
    jt = JaxTrainer(cfg, rcfg, scene, meta, model,
                    loss_weights=jlosses.LossWeights(LOSS),
                    optimizer='sgd', mesh=mesh)
    jt.state.skeleton_initialized = True
    step = cfg.stages['sk'][0] + 1
    save_pytree({'state': {'model': model}}, tmp_path / 'model.npz')
    with open(tmp_path / 'cfgs.pkl', 'wb') as f:
        pickle.dump((tsk_gs.SKGSConfig(**to_port_cfg_fields(cfg)),
                     port_cfg(rcfg), step), f)
    torch.save((port_scene(scene),
                SceneMeta(background_type=meta.background_type,
                          background=meta.background)),
               tmp_path / 'scene.pt')
    p0 = {k: np.array(v) for k, v in _flatten(model).items()}
    jm = {k: np.asarray(v) for k, v in jt.train_step(step).items()}
    jflat = _flatten(jt.state.model)
    r0, r1 = run_ranks(__file__, 'jax_anchor', 2, tmp_path)
    for k in ('loss', 'rgb', 'ssim', 'psnr'):
        np.testing.assert_allclose(r0[f'metric/{k}'], jm[k], rtol=2e-4,
                                   err_msg=k)
    for k in ('overflow', 'n_bad_grad'):
        assert int(r0[f'metric/{k}']) == int(jm[k]), k
    for name in r0['names']:
        got, ref = r0['state/params/' + name], np.asarray(
            jflat['params/' + name])
        # SGD's first step moves a leaf by lr times its gradient: the
        # gradient bar (3e-4 of the leaf's max) on the step
        step_max = np.abs(ref - p0['params/' + name]).max()
        assert np.abs(got - ref).max() <= \
            1e-5 * np.abs(ref).max() + 3e-4 * step_max, name
        np.testing.assert_array_equal(got, r1['state/params/' + name])
    for name in ('max_radii2d', 'denom'):
        np.testing.assert_array_equal(r0['state/' + name], jflat[name],
                                      err_msg=name)
    np.testing.assert_allclose(r0['state/sk_cache'], jflat['sk_cache'],
                               atol=1e-5)


if __name__ == '__main__':
    rank_main({'steps': case_steps, 'jax_anchor': case_jax_anchor})
