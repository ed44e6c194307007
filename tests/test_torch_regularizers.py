"""Port parity, the motion regularizers and the time noise:
sk_gs_tpu_torch.models.regularizers against sk_gs_tpu.models.regularizers,
``superpoints.get_superpoint_features``, ``sk_gs.smooth_scale`` and the
noisy time of ``init_stage``, on the same numpy inputs made from a seed;
and one ``init``-family step with every init regularizer on (``elastic``,
``acc``, ``arap``, ``arap_p``) and one ``sp``-family step with every sp
regularizer on (those three and ``re_pos``, ``jp_dist``, ``sp_arap_t``,
``sp_arap_ct``), both of a net that is not ``is_blender`` (the time noise
live) and the sp step at ``batch_views`` 3, the port's trainer against the
JAX trainer as test_torch_train_options.py holds them (its bars, its
handed draws: the time noise, the init family's random rows and the times
of ``elastic`` and ``arap``).

Tolerances: each function's value and its gradients (by ``jax.grad`` and
autograd, with respect to every input that carries one) within 1e-5 of the
reference's magnitude; ``smooth_scale`` exactly (the same float64 host
arithmetic). The Procrustes rotations carry no gradient on either side: on
a node whose neighbours sit symmetrically about it (a cross of six edges
of one length, so S = c I has one singular value three times) the loss and
its gradients stay finite, and the port's rotation has no autograd
history, so the SVD's backward is never reached.
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sk_gs_tpu.models import regularizers as jreg
from sk_gs_tpu.models import sk_gs as jsk_gs
from sk_gs_tpu.models import superpoints as jsp
from sk_gs_tpu.models.deform import DeformNetConfig, deform_net_init
from sk_gs_tpu.framework.checkpoint import _flatten, save_pytree
from sk_gs_tpu_torch import convert
from sk_gs_tpu_torch.data.base import SceneMeta
from sk_gs_tpu_torch.framework import trainer as ttrainer
from sk_gs_tpu_torch.models import losses as tlosses
from sk_gs_tpu_torch.models import regularizers as treg
from sk_gs_tpu_torch.models import deform as tdeform
from sk_gs_tpu_torch.models import sk_gs as tsk_gs
from sk_gs_tpu_torch.models import superpoints as tsp
from tests.test_torch_cli import one_torch_thread  # noqa: F401
from tests.test_torch_render import to_np
from tests.test_torch_slice import tiny_cfg, to_port_cfg_fields
from tests.test_torch_render import port_cfg
from tests.test_torch_train import port_scene
from tests.test_torch_train_options import (IMAGE, INIT_STEP, NOISE,
                                            SP_STEP, check_steps, init_start,
                                            jax_rcfg, options_cfg, run_pair,
                                            scene, sp_start)  # noqa: F401

TOL = 1e-5


def close(got, ref, name, tol=TOL):
    got, ref = to_np(got) if torch.is_tensor(got) else np.asarray(got), \
        np.asarray(ref)
    assert np.isfinite(got).all() and np.isfinite(ref).all(), name
    scale = max(float(np.abs(ref).max()), 1e-12)
    err = float(np.abs(got - ref).max())
    assert err <= tol * scale, f'{name}: {err} > {tol} x {scale}'


def both(jfn, tfn, arrays, grad_of):
    """The value of ``jfn`` and ``tfn`` on the same numpy ``arrays`` and
    their gradients with respect to the arrays named in ``grad_of``."""
    names = list(arrays)
    jargs = [jnp.asarray(arrays[n]) for n in names]
    argnums = tuple(names.index(n) for n in grad_of)
    jval, jgrads = jax.value_and_grad(jfn, argnums=argnums)(*jargs)
    targs = [torch.tensor(arrays[n], requires_grad=n in grad_of)
             for n in names]
    tval = tfn(*targs)
    tgrads = torch.autograd.grad(tval, [targs[i] for i in argnums])
    return (tval, jval), dict(zip(grad_of, zip(tgrads, jgrads)))


def check(values, grads):
    close(values[0], values[1], 'value')
    for name, (got, ref) in grads.items():
        assert np.abs(np.asarray(ref)).max() > 0, name
        close(got, ref, name)


def nodes(rng, m=40):
    """A node set (edges about as long as arap's 0.1 radius) and two more
    frames of it, each moved by a small random warp."""
    p0 = rng.uniform(-0.15, 0.15, size=(m, 3)).astype(np.float32)
    p1 = p0 + 0.01 * rng.normal(size=(m, 3)).astype(np.float32)
    p2 = p1 + 0.01 * rng.normal(size=(m, 3)).astype(np.float32)
    return p0, p1, p2


# ---------------------------------------------------------------- ARAP


@pytest.mark.parametrize('m,k', [(40, 10), (6, 10)])
def test_arap_connectivity_matches_jax(rng, m, k):
    """The graph, its weights and their gradient; M = 6 clamps K to 5 and
    leaves the dead node's row and column out."""
    p0, _, _ = nodes(rng, m)
    mask = np.ones(m, bool)
    mask[3] = False
    ref = jreg.arap_connectivity(jnp.asarray(p0), jnp.asarray(mask), k=k)
    got = treg.arap_connectivity(torch.from_numpy(p0),
                                 torch.from_numpy(mask), k=k)
    np.testing.assert_array_equal(to_np(got[0]), np.asarray(ref[0]))
    np.testing.assert_array_equal(to_np(got[2]), np.asarray(ref[2]))
    close(got[1], ref[1], 'weights')
    assert got[0].shape == (m, min(k, m - 1))
    assert not to_np(got[2])[3].any() and to_np(got[2])[~mask].sum() == 0
    if m > k:   # the radius keeps some edges past the first 3, not all
        assert 3 * (m - 1) < to_np(got[2]).sum() < k * (m - 1)
    lin = np.random.default_rng(1).normal(size=ref[1].shape).astype(
        np.float32)
    jfn = lambda p: jnp.sum(jreg.arap_connectivity(
        p, jnp.asarray(mask), k=k)[1] * lin)
    tfn = lambda p: torch.sum(treg.arap_connectivity(
        p, torch.from_numpy(mask), k=k)[1] * torch.from_numpy(lin))
    check(*both(jfn, tfn, {'p': p0}, ['p']))


def test_arap_error_matches_jax(rng):
    p0, p1, p2 = nodes(rng)
    mask = np.ones(len(p0), bool)
    mask[::7] = False
    seq = np.stack([p0, p1, p2])

    def jfn(s):
        idx, w, _ = jreg.arap_connectivity(s[0], jnp.asarray(mask))
        return jreg.arap_error(s, idx, w)

    def tfn(s):
        idx, w, _ = treg.arap_connectivity(s[0], torch.from_numpy(mask))
        return treg.arap_error(s, idx, w)

    check(*both(jfn, tfn, {'seq': seq}, ['seq']))


def test_procrustes_rotations_match_jax(rng):
    s = rng.normal(size=(30, 3, 3)).astype(np.float32)
    ref = jreg._procrustes_rotations(jnp.asarray(s))
    got = treg._procrustes_rotations(torch.from_numpy(s))
    close(got, ref, 'R')
    r = to_np(got)
    np.testing.assert_allclose(r @ np.swapaxes(r, 1, 2),
                               np.broadcast_to(np.eye(3), r.shape),
                               atol=1e-5)
    np.testing.assert_allclose(np.linalg.det(r), 1.0, atol=1e-5)


def test_arap_repeated_singular_values_have_no_svd_gradient():
    """Node 0 at the origin, its six neighbours a cross of one length:
    at the first frame S = sum w e0 e0^T = c I, one singular value three
    times, and the trajectory is rigid (frame 1 = frame 0 turned)."""
    cross = np.concatenate([np.eye(3), -np.eye(3)]).astype(np.float32) * 0.05
    p0 = np.concatenate([np.zeros((1, 3), np.float32), cross])
    turn = np.asarray([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]],
                      np.float32)
    seq = np.stack([p0, p0 @ turn.T])
    mask = np.ones(7, bool)
    idx, w, _ = treg.arap_connectivity(torch.from_numpy(seq[0]),
                                       torch.from_numpy(mask), k=6)
    e0 = torch.from_numpy(seq[0])[:, None] - torch.from_numpy(seq[0])[idx]
    S = torch.einsum('mk,mki,mkj->mij', w, e0, e0)
    sv = torch.linalg.svdvals(S[0])
    np.testing.assert_allclose(to_np(sv), to_np(sv[0]).repeat(3), rtol=1e-5)

    def jfn(s):
        i, ww, _ = jreg.arap_connectivity(s[0], jnp.asarray(mask), k=6)
        return jreg.arap_error(s, i, ww)

    def tfn(s):
        i, ww, _ = treg.arap_connectivity(s[0], torch.from_numpy(mask), k=6)
        return treg.arap_error(s, i, ww)

    values, grads = both(jfn, tfn, {'seq': seq}, ['seq'])
    assert np.isfinite(to_np(values[0])) and float(values[0].detach()) < 1e-8
    for got, ref in grads.values():
        assert np.isfinite(to_np(got)).all() and np.isfinite(ref).all()
        np.testing.assert_allclose(to_np(got), np.asarray(ref), atol=1e-6)
    # the rotation carries no autograd history: nothing reaches the SVD
    s = torch.tensor(seq, requires_grad=True)
    et = s[1][:, None] - s[1][idx]
    R = treg._best_fit_rotations(s[0][:, None] - s[0][idx], et, w)
    assert R.grad_fn is None and not R.requires_grad
    np.testing.assert_allclose(to_np(R[0]), turn, atol=1e-5)


# ---------------------------------------------------------------- the others


def test_elastic_loss_matches_jax(rng):
    m, t = 30, 8
    traj = (rng.uniform(-0.3, 0.3, size=(m, 1, 3))
            + 0.02 * rng.normal(size=(m, t, 3))).astype(np.float32)
    idx = np.stack([rng.permutation(m)[:2] for _ in range(m)]).astype(
        np.int32)
    w = rng.uniform(0.1, 1.0, size=(m, 2)).astype(np.float32)
    check(*both(lambda x, ww: jreg.elastic_loss(x, jnp.asarray(idx), ww),
                lambda x, ww: treg.elastic_loss(x, torch.from_numpy(idx), ww),
                {'traj': traj, 'w': w}, ['traj', 'w']))


def test_acc_loss_matches_jax(rng):
    m = 30
    n3 = (rng.uniform(-0.3, 0.3, size=(m, 1, 3))
          + 0.02 * rng.normal(size=(m, 3, 3))).astype(np.float32)
    mask = (rng.uniform(size=m) > 0.2).astype(np.float32)
    check(*both(lambda x: jreg.acc_loss(x, jnp.asarray(mask)),
                lambda x: treg.acc_loss(x, torch.from_numpy(mask)),
                {'n3': n3}, ['n3']))


def test_points_arap_loss_matches_jax(rng):
    n, k = 60, 5
    pc = rng.uniform(-0.5, 0.5, size=(n, 3)).astype(np.float32)
    pt = pc + 0.05 * rng.normal(size=(n, 3)).astype(np.float32)
    idx = rng.integers(0, n, size=(n, k)).astype(np.int32)
    mask = rng.uniform(size=n) > 0.3
    check(*both(
        lambda a, b: jreg.points_arap_loss(a, b, jnp.asarray(idx),
                                           jnp.asarray(mask)),
        lambda a, b: treg.points_arap_loss(a, b, torch.from_numpy(idx),
                                           torch.from_numpy(mask)),
        {'pc': pc, 'pt': pt}, ['pc', 'pt']))


def test_get_superpoint_features_matches_jax(rng):
    """The LBS-weighted mean of the Gaussians on each superpoint; superpoint
    7 has no Gaussian (its weight sum clamps at 1e-5)."""
    n, k, m = 200, 5, 16
    value = rng.normal(size=(n, 3)).astype(np.float32)
    nb = rng.integers(0, m - 1, size=(n, k))
    nb[nb == 7] = 8
    nb = nb.astype(np.int32)
    g = rng.uniform(size=(n, k)).astype(np.float32)
    g /= g.sum(-1, keepdims=True)
    check(*both(
        lambda v, gg: jnp.sum(jsp.get_superpoint_features(
            v, jnp.asarray(nb), gg, m) ** 2),
        lambda v, gg: torch.sum(tsp.get_superpoint_features(
            v, torch.from_numpy(nb), gg, m) ** 2),
        {'value': value, 'g': g}, ['value', 'g']))
    got = tsp.get_superpoint_features(torch.from_numpy(value),
                                      torch.from_numpy(nb),
                                      torch.from_numpy(g), m)
    close(got, jsp.get_superpoint_features(jnp.asarray(value),
                                           jnp.asarray(nb), jnp.asarray(g),
                                           m), 'features')
    assert not to_np(got)[7].any()


# ---------------------------------------------------------------- time noise


def test_smooth_scale_matches_jax():
    """The anneal, exactly, on both sides of the sp_fix start (where the
    count restarts) and past annealing_steps."""
    jcfg = tiny_cfg()._replace(f_s=0.1, annealing_steps=500)
    tcfg = tsk_gs.SKGSConfig(**to_port_cfg_fields(jcfg))
    b = jcfg.stages['sp_fix'][0]
    steps = [0, 1, 2, 250, 499, 500, 501, b - 1, b, b + 1, b + 250, b + 500,
             b + 501, 40_000]
    for step in steps:
        assert tsk_gs.smooth_scale(tcfg, step) == \
            jsk_gs.smooth_scale(jcfg, step), step
    assert tsk_gs.smooth_scale(tcfg, b) < tsk_gs.smooth_scale(tcfg, b + 1)
    assert tsk_gs.smooth_scale(tcfg, b + 500) < 1e-12
    assert tsk_gs.smooth_scale(tcfg._replace(f_s=0.0), 5) < 1e-15


@pytest.mark.parametrize('is_blender', [False, True])
def test_time_noise_matches_jax(rng, is_blender):
    """``init_stage`` at t + n dt s with the JAX key's normal n handed to
    the port; a blender net ignores the noise on both sides."""
    cfg = DeformNetConfig(depth=2, width=32, is_blender=is_blender)
    params = deform_net_init(jax.random.PRNGKey(2), cfg)
    params['warp'] = {'w': jnp.asarray(0.1 * rng.normal(
        size=params['warp']['w'].shape).astype(np.float32)),
        'b': params['warp']['b']}
    jcfg = tiny_cfg()._replace(net=cfg, num_frames=10)
    tcfg = tsk_gs.SKGSConfig(**to_port_cfg_fields(jcfg))
    net = convert.deform_net_from_flat(_flatten(params, 'n/'),
                                       tdeform.DeformNetConfig(*cfg), 'n/',
                                       device='cpu')
    x = rng.uniform(-0.5, 0.5, size=(50, 3)).astype(np.float32)
    key = jax.random.PRNGKey(9)
    noise = np.asarray(jax.random.normal(key, ()))
    t = np.float32(0.37)
    scale = 0.08
    ref = jsk_gs.init_stage(jcfg, {'sp_deform': params}, jnp.asarray(x),
                            jnp.asarray(t), key=key, noise_scale=scale)
    model = types.SimpleNamespace(sp_deform=net, canonical=None)
    got = tsk_gs.init_stage(tcfg, model, torch.from_numpy(x),
                            torch.tensor(t), noise=torch.tensor(noise),
                            noise_scale=scale)
    close(got.d_xyz, ref.d_xyz, 'd_xyz')
    plain = tsk_gs.init_stage(tcfg, model, torch.from_numpy(x),
                              torch.tensor(t))
    moved = float(np.abs(to_np(got.d_xyz) - to_np(plain.d_xyz)).max())
    assert (moved > 1e-4) == (not is_blender)
    assert tsk_gs.noisy_time(tcfg, torch.tensor(t), torch.tensor(noise),
                             0.0) == torch.tensor(t)


# ---------------------------------------------------------------- the steps

MOTION = {'elastic': 0.1, 'acc': 0.1, 'arap': 0.1}
SP_EXTRAS = {'re_pos': 0.5, 'jp_dist': 0.5, 'sp_arap_t': 0.01,
             'sp_arap_ct': 0.01}


@pytest.fixture(scope='module')
def regularized_runs(scene, tmp_path_factory):
    """An init step and an sp step of a net that is not is_blender with
    every regularizer of its family on, the time noise live and handed to
    both packages; the sp step at batch_views 3. One JAX compilation a
    family covers the regularizers, the noise and the merge of K views."""
    cfg = options_cfg(net=tiny_cfg().net._replace(is_blender=False))
    sc, meta = scene
    tmp = tmp_path_factory.mktemp('reg')
    rng = np.random.default_rng(5)
    draws = {n: rng.uniform(size=n).astype(np.float32)
             for n in (cfg.gauss.capacity, 8, 2)}
    init = run_pair(cfg, init_start(cfg, meta), sc, meta,
                    {**IMAGE, **MOTION, 'arap_p': 1.0, 'c_net': 1.0},
                    [INIT_STEP], tmp, draws=draws, noise=NOISE)
    sp = run_pair(cfg, sp_start(cfg, meta, tmp), sc, meta,
                  {**IMAGE, **MOTION, **SP_EXTRAS, 'sparse': 0.1,
                   'joint': 1.0, 'joint_all': 1.0}, [SP_STEP], tmp,
                  draws=draws, noise=NOISE, batch_views=3,
                  flags=('sp_initialized', 'reinit_done'))
    return {'init': init, 'sp': sp}


def test_init_regularizers_step_matches_jax(regularized_runs):
    runs, jflat, tflat, tt, _ = regularized_runs['init']
    check_steps(runs, jflat, tflat, scale_of={'rotation': 'xyz'},
                losses=(*MOTION, 'arap_p', 'c_net'))
    # the warp net's trajectories carry the motion losses' gradient
    assert np.abs(runs[0]['tgrads']['sp_deform/warp/w']).max() > 0


def test_sp_regularizers_step_matches_jax(regularized_runs):
    runs, jflat, tflat, tt, _ = regularized_runs['sp']
    check_steps(runs, jflat, tflat, losses=(*MOTION, *SP_EXTRAS, 'sparse',
                                            'joint', 'joint_all'))
    assert SP_STEP >= tt.cfg.joint_update_interval[1]   # jp_dist on
    assert np.abs(runs[0]['tgrads']['joint_pos']).max() > 0


def test_batch_views_merge_matches_jax(regularized_runs):
    """Three views merged: their statistics (a Gaussian all three saw
    counts 3), the cache rows of their frames and the mean of their joint
    costs, as the JAX step merges them."""
    _, jflat, tflat, tt, _ = regularized_runs['sp']
    assert tt.batch_views == 3 and tflat['denom'].max() == 3.0
    for name in ('sp_cache', 'joint_cost'):
        np.testing.assert_allclose(
            tflat[name], jflat[name], atol=1e-5 * np.abs(jflat[name]).max(),
            err_msg=name)
    assert np.abs(tflat['sp_cache']).max() > 0


@pytest.mark.parametrize('family,views', [('init', 1), ('sp', 3)])
def test_time_noise_step_matches_jax(regularized_runs, family, views):
    """The steps above warp at a noisy time: one draw a view, at the
    anneal's scale of the step (~0.1 here)."""
    runs, _, _, tt, _ = regularized_runs[family]
    assert not tt.cfg.net.is_blender
    assert tt.noise_draws == [NOISE] * views
    step = INIT_STEP if family == 'init' else SP_STEP
    assert tsk_gs.smooth_scale(tt.cfg, step) > 0.09


def test_jp_dist_is_gated_before_the_joint_losses(scene, tmp_path):
    """Before joint_update_interval[1] jp_dist weighs 0 (its gradient with
    it: joint_pos gets none) and the other sp regularizers do not."""
    cfg = options_cfg()
    tcfg = tsk_gs.SKGSConfig(**to_port_cfg_fields(cfg))
    sc, meta = scene
    save_pytree({'state': {'model': sp_start(cfg, meta, tmp_path)}},
                tmp_path / 'sp_model.npz')
    model = convert.model_from_flat(
        convert.load_npz(tmp_path / 'sp_model.npz'), tcfg,
        port_cfg(jax_rcfg()), device='cpu', trainable=True)
    tt = ttrainer.SKGSTrainer(tcfg, model.rcfg, port_scene(sc),
                              SceneMeta(background=meta.background), model,
                              tlosses.LossWeights({**IMAGE, **SP_EXTRAS}),
                              sp_initialized=True, reinit_done=True,
                              device='cpu')
    m = tt.train_step(SP_STEP - 2)
    assert float(m['jp_dist']) == 0.0
    assert float(m['re_pos']) > 0 and float(m['sp_arap_t']) > 0
    assert not tt.model.params['joint_pos'].grad.abs().max()


def test_reg_net_rounding_pins_the_float64_twin():
    """``chip_smoke.reg_net_rounding`` (the card-vs-CPU bar of the init
    regularizers' warp net) on the CPU, at its case's small start and its
    first step, with the step's own draws: its float32 gradients are the
    trainer's own (``motion_reg_losses`` on the model's net), bit for
    bit; its float64 twin makes the same discrete choices and agrees with
    the port's float32 gradients within the rounding it reports, which is
    above zero on the warp head and under 1e-2 of each leaf's max (the
    warp bias's against the warp weight's, as the chip run scales it)."""
    import chip_smoke as cs
    from sk_gs_tpu_torch.data.synthetic import make_synthetic_scene
    family, steps, options, extra, change, cfg, rcfg, train = \
        cs.option_setup(0, 'init_regularizers')
    model, flags = cs.small_start(0, family, 'cpu', cfg, rcfg, train,
                                  change['warp_head'])
    sc, meta, _ = make_synthetic_scene(
        seed=0, num_links=3, gauss_per_link=60, num_frames=6, h=80, w=96,
        pair_capacity=2 ** 15, device='cpu')
    tr = ttrainer.SKGSTrainer(cfg, rcfg, sc, meta, model,
                              tlosses.LossWeights({**train.loss, **extra}),
                              seed=0, device='cpu', **flags, **options)
    draws = tr.regularizer_draws(family)
    t, step = sc.times[2], steps[0]
    rep = cs.reg_net_rounding(tr, family, t, draws, step)
    out = tr.motion_reg_losses(family, t, draws, step)
    leaves = {k: p for k, p in tr.model.leaves().items()
              if k.startswith('sp_deform/')}
    got = torch.autograd.grad(out['elastic'] + out['arap'],
                              list(leaves.values()), allow_unused=True)
    assert rep['choices_equal']
    assert set(rep['rounding']) == set(leaves)
    for (name, p), g in zip(leaves.items(), got):
        g = torch.zeros_like(p) if g is None else g
        g = g.to(torch.float64)
        assert torch.equal(rep['g32'][name], g), name
        err = float((g - rep['g64'][name]).abs().max())
        assert err <= rep['rounding'][name], name
        # the warp bias's gradient is large terms cancelling: held against
        # the warp weight's scale, as the chip run holds it
        scale = 'sp_deform/warp/w' if name == 'sp_deform/warp/b' else name
        top = float(rep['g64'][scale].abs().max())
        assert rep['rounding'][name] <= 1e-2 * top, name
    assert rep['rounding']['sp_deform/warp/w'] > 0
