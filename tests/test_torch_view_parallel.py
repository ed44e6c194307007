"""Port parity, the trainer's ``view`` mesh axis: 2 gloo ranks on the CPU,
one view each (``SKGSTrainer(mesh=make_mesh(2, 1), batch_views=2)``),
against the port's one-process ``batch_views`` 2 step, which
tests/test_torch_train_options.py and test_torch_regularizers.py hold
against the JAX ``batch_views`` step. One step from one state for each
family, ``init``, ``sp``, ``sk_init`` and ``sk``, with SGD (the update is
then proportional to the gradient: tests/test_parallel_train.py), and one
``sk`` step with Adam; the scene's targets are RGBA over 'random'
backgrounds and the warp net is not ``is_blender``, so every view draws a
background and (init, sp) a time noise, each rank all of them in the
one-process order. Bars (tests/test_torch_train.py's): metrics rtol 2e-4,
gradients 3e-4 of each leaf's max, parameters within 1e-5 of the leaf plus
1% of its step where the gradient exceeds 1e-3 of its max and 2 lr
elsewhere, the statistics, caches, ``p2sp`` and joint cost as there; and
the two replicas equal to the last bit.

One JAX anchor: the port's 2-rank ``sk`` step (SGD) against the JAX
trainer's own step on a (2, 1) CPU mesh, on test_torch_train.py's tiny
model and scene.
"""
import dataclasses
import pickle
from pathlib import Path

import numpy as np
import pytest
import torch

from sk_gs_tpu_torch import convert
from sk_gs_tpu_torch.data.synthetic import make_synthetic_scene
from sk_gs_tpu_torch.framework.presets import synthetic_fullscale
from sk_gs_tpu_torch.framework.random_model import random_model_flat
from sk_gs_tpu_torch.framework.trainer import SKGSTrainer
from sk_gs_tpu_torch.models.gaussian_splatting import init_from_pcd
from sk_gs_tpu_torch.models.losses import LossWeights
from sk_gs_tpu_torch.models.sk_gs import init_model
from sk_gs_tpu_torch.parallel import make_mesh
from test_torch_mesh import one_torch_thread  # noqa: F401
from test_torch_mesh import rank_main, run_ranks

# (family, optimizer, step) of each case; the schedule below puts the
# steps inside their stages, with no event before or after them
CASES = (('init', 'sgd', 5), ('sp', 'sgd', 15), ('sk_init', 'sgd', 35),
         ('sk', 'sgd', 45), ('sk', 'adam', 45))
SCHEDULE = (('static', 0), ('init_fix', 0), ('init', 10), ('sp_fix', 0),
            ('sp', 20), ('sk_init', 10), ('sk_fix', 0), ('sk', 100))
STATS = ('max_radii2d', 'denom', 'sp_cache', 'sk_cache', 'p2sp',
         'joint_cost')


def small_setup(device='cpu'):
    """The preset cut to 512 slots, 16 superpoints, 2 x 32 nets that are
    not ``is_blender``, 6 frames at 64 x 48, RGBA targets over 'random'."""
    cfg, rcfg, train = synthetic_fullscale()
    cfg = cfg._replace(
        gauss=cfg.gauss._replace(capacity=512), num_superpoints=16,
        num_frames=6, train_schedule=SCHEDULE, init_sampling_step=10 ** 6,
        joint_update_interval=(1000, 12, 1000), canonical_replace_steps=(),
        net=cfg.net._replace(depth=2, width=32, is_blender=False),
        sk_net=cfg.sk_net._replace(width=32, depth=2, skips=(1,)))
    rcfg = rcfg._replace(image_width=64, image_height=48,
                         pair_capacity=2 ** 14)
    scene, meta, _ = make_synthetic_scene(
        seed=0, num_links=3, gauss_per_link=40, num_frames=6, h=48, w=64,
        pair_capacity=2 ** 14, device=device)
    rgb = scene.images
    alpha = 0.1 + 0.9 * (rgb.mean(-1, keepdim=True) < 0.98).float()
    scene = scene._replace(images=torch.cat([rgb, alpha], -1))
    meta = dataclasses.replace(meta, background_type='random')
    return cfg, rcfg, train, scene, meta


def start_model(cfg, rcfg, meta, family: str, device='cpu'):
    if family == 'init':
        rng = np.random.default_rng(0)
        pts = rng.uniform(-0.8, 0.8, size=(200, 3)).astype(np.float32)
        cols = rng.uniform(size=(200, 3)).astype(np.float32)
        base = init_from_pcd(pts, cols, cfg.gauss, device=device)
        return init_model(cfg, rcfg, base, meta.train_times, seed=0,
                          device=device)
    flat = random_model_flat(cfg, 1, n_alive=400, log_scale_mean=-3.0,
                             sp_stage=True)
    return convert.model_from_flat(flat, cfg, rcfg, device=device,
                                   trainable=True)


def one_step(family, optimizer, step, mesh=None, device='cpu'):
    """A fresh trainer's step ``step``: {metric/..., grad/..., state/...}
    as numpy arrays."""
    cfg, rcfg, train, scene, meta = small_setup(device)
    model = start_model(cfg, rcfg, meta, family, device)
    tr = SKGSTrainer(cfg, rcfg, scene, meta, model, LossWeights(train.loss),
                     batch_views=2, optimizer=optimizer, mesh=mesh,
                     sp_initialized=True, reinit_done=True,
                     skeleton_initialized=family in ('sk_init', 'sk'),
                     device=device)
    assert tr.family(cfg.stage_at(step)) == family
    metrics = tr.train_step(step)
    out = {f'metric/{k}': v.cpu().numpy() for k, v in metrics.items()}
    out.update({f'grad/{k}': p.grad.cpu().numpy()
                for k, p in tr.model.leaves().items()})
    out.update({f'state/{k}': v for k, v in
                convert.model_to_flat(tr.model).items()})
    out['lrs'] = np.array([tr.lr_trees(step)[k] for k in tr.model.leaves()])
    return out


def case_steps(tmp, rank, device='cpu'):
    mesh = make_mesh(2, 1)
    out = {}
    for i, case in enumerate(CASES):
        out.update({f'{i}/{k}': v for k, v in
                    one_step(*case, mesh=mesh, device=device).items()})
    return out


@pytest.fixture(scope='module')
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp('view_parallel')
    ranks = run_ranks(__file__, 'steps', 2, tmp)
    return [one_step(*case) for case in CASES], ranks


def close_step(got, ref, leaves):
    """``got`` against ``ref`` (one step's dicts) within the bars."""
    for k, r in ref.items():
        if k.startswith('metric/'):
            if r.dtype.kind in 'biu':
                np.testing.assert_array_equal(got[k], r, err_msg=k)
            else:
                np.testing.assert_allclose(got[k], r, rtol=2e-4, err_msg=k)
    lrs = dict(zip(leaves, ref['lrs']))
    for name in leaves:
        g, r = got['grad/' + name], ref['grad/' + name]
        scale = np.abs(r).max()
        assert np.abs(g - r).max() <= 3e-4 * scale, name
        p, q = got['state/params/' + name], ref['state/params/' + name]
        big = np.abs(r) > 1e-3 * scale
        err = np.abs(p - q)
        lr = lrs[name]
        assert err[big].max(initial=0.0) <= \
            1e-5 * np.abs(q).max() + 0.01 * lr, name
        assert err.max() <= 2 * lr + 1e-5 * np.abs(q).max(), name
    for name in STATS:
        g, r = got['state/' + name], ref['state/' + name]
        if name in ('max_radii2d', 'denom', 'p2sp'):
            np.testing.assert_array_equal(g, r, err_msg=name)
        else:
            np.testing.assert_allclose(g, r, atol=1e-5 * (np.abs(r).max()
                                                         + 1e-30),
                                       err_msg=name)
    r = ref['state/xyz_grad_accum']
    assert np.abs(got['state/xyz_grad_accum'] - r).max() <= \
        1e-3 * np.abs(r).max()


def leaf_names(step: dict):
    return [k[len('grad/'):] for k in step if k.startswith('grad/')]


@pytest.mark.parametrize('case', range(len(CASES)),
                         ids=['-'.join(map(str, c[:2])) for c in CASES])
def test_two_ranks_step_as_one_process(runs, case):
    one, ranks = runs
    ref = one[case]
    got = {k[len(f'{case}/'):]: v for k, v in ranks[0].items()
           if k.startswith(f'{case}/')}
    assert set(got) == set(ref)
    close_step(got, ref, leaf_names(ref))
    assert float(ref['metric/loss']) > 0
    assert max(np.abs(ref['grad/' + n]).max() for n in leaf_names(ref)) > 0


def test_replicas_are_equal(runs):
    _, (r0, r1) = runs
    assert set(r0) == set(r1)
    for k in r0:
        if '/state/' in k or '/metric/' in k or '/grad/' in k:
            np.testing.assert_array_equal(r0[k], r1[k], err_msg=k)


# ---------------------------------------------------------------- JAX anchor

def case_jax_anchor(tmp, rank):
    """The port's ``sk`` step over 2 ranks on the JAX tiny model."""
    tmp = Path(tmp)
    with open(tmp / 'cfgs.pkl', 'rb') as f:
        cfg, rcfg, step = pickle.load(f)
    scene, meta = torch.load(tmp / 'scene.pt', weights_only=False)
    model = convert.model_from_flat(convert.load_npz(tmp / 'model.npz'),
                                    cfg, rcfg, device='cpu', trainable=True)
    tr = SKGSTrainer(cfg, rcfg, scene, meta, model, LossWeights(
        {'image': {'method': 'l1', 'lambda': 0.8}, 'ssim': 0.2}),
        batch_views=2, optimizer='sgd', mesh=make_mesh(2, 1),
        skeleton_initialized=True, device='cpu')
    metrics = tr.train_step(step)
    out = {f'metric/{k}': v.numpy() for k, v in metrics.items()}
    out.update({f'state/{k}': v for k, v in
                convert.model_to_flat(tr.model).items()})
    out['lrs'] = np.array([tr.lr_trees(step)[k] for k in tr.model.leaves()])
    out['names'] = np.array(list(tr.model.leaves()))
    return out


@pytest.mark.slow
def test_two_ranks_sk_step_matches_jax_mesh(tmp_path):
    """(~45 s alone on the CPU, most of it the JAX mesh step's compile:
    marked slow)"""
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
    rcfg = rcfg._replace(use_pallas=False)
    scene, meta, _ = jsynth.make_synthetic_scene(chunk=256, use_pallas=False,
                                                 **SCENE)
    mesh = Mesh(np.asarray(jax.devices()[:2]).reshape(2, 1),
                ('view', 'gs'))
    jt = JaxTrainer(cfg, rcfg, scene, meta, model,
                    loss_weights=jlosses.LossWeights(LOSS), batch_views=2,
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
    # (num_pairs is not compared: the JAX mesh step renders through the
    # exchange path, which reports 0 pairs)
    for k in ('n_vis', 'overflow', 'n_bad_grad'):
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
