"""Port parity, the skeleton initialisation and the ``sk_init`` family: the
port's ``sk_gs_ops.init_skeleton`` against the JAX package's, piece by
piece, and the port's ``SKGSTrainer`` against the JAX trainer's
``train_step`` across the sp -> sk transition (Pallas in interpret mode,
chunk 256, as tests/test_torch_sp.py runs it).

The JAX package draws each loop iteration's frame from its key; the port
takes the frame ids as a tensor. The tests compute the JAX draws from the
key (``jax_tids``: ``init_skeleton`` splits its key in two, each loop
splits its half into one key an iteration and draws
``randint(k, (), 0, T)``; the trainer first splits its state key,
``trainer.py:1113``) and feed them to the port.

Each piece starts from the JAX state before it, converted. Tolerances:
``sp_cache``, ``sp_weights``, ``joint_cost``, ``joints`` and ``global_tr``
within 1e-5 of their max; ``sp_knn``, ``p2sp``, ``joint_parents`` and
``joint_root`` exactly (the MST's cost matrix is checked to have no two
entries closer than the frameworks' difference); the Adam-updated leaves
(``joint_pos``, the distilled skeleton net, ``joints``, ``global_tr``,
``sp_W``) by test_torch_train.py's parameter rule, per iteration: where
the gradient exceeds 1e-3 of its leaf's max at every iteration, 1e-5 of the
leaf plus 1% of the Adam steps; elsewhere 2 lr an iteration, since Adam
moves an entry whose gradient is near zero by about +-lr whichever way
rounding tips it. The trainer's steps are held as test_torch_sp.py holds
them (``check_step``), each from the JAX state before it.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sk_gs_tpu.framework import trainer as jtrainer
from sk_gs_tpu.framework.checkpoint import _flatten
from sk_gs_tpu.models import gaussian_splatting as jgs
from sk_gs_tpu.models import losses as jlosses
from sk_gs_tpu.models import sk_gs as jsk_gs
from sk_gs_tpu.models import sk_gs_ops as jops
from sk_gs_tpu_torch import convert
from sk_gs_tpu_torch.models import optim as toptim
from sk_gs_tpu_torch.models import sk_gs as tsk_gs
from sk_gs_tpu_torch.models import sk_gs_ops as tops
from tests.test_torch_cli import one_torch_thread  # noqa: F401
from tests.test_torch_init import jax_rcfg
from tests.test_torch_render import port_cfg, to_np
from tests.test_torch_slice import FRAMES, tiny_cfg, to_port_cfg_fields
from tests.test_torch_sp import (LOSS, check_step, point_cloud,
                                 port_trainer, spy_weights)
from tests.test_torch_sp import jax_scene, tile_interpret  # noqa: F401
from tests.test_torch_train import close_rel

N_ITERS = 8
LR = tops.INIT_LR


def sk_cfg(warp_method='LBS', sk_init_steps=2):
    """tiny_cfg (256 slots, M = 16) on a schedule of one init step, one
    sp_fix step, one sp step, ``sk_init_steps`` sk_init steps and sk; the
    initialisation's loops cut to ``N_ITERS`` iterations."""
    return tiny_cfg()._replace(
        train_schedule=(('static', 0), ('init_fix', 0), ('init', 1),
                        ('sp_fix', 1), ('sp', 1), ('sk_init', sk_init_steps),
                        ('sk_fix', 0), ('sk', 10)),
        warp_method=warp_method, init_sampling_step=1,
        joint_init_steps=N_ITERS)


def sp_model(cfg, seed=0):
    """A JAX model inside the sp stages: the point cloud's Gaussians,
    superpoints at 16 of them (two dead), a random LBS matrix, a warp net
    whose heads move the superpoints apart."""
    pts, cols = point_cloud()
    model = jsk_gs.init_model(jax.random.PRNGKey(seed), cfg,
                              jgs.init_from_pcd(pts, cols, cfg.gauss),
                              np.linspace(0, 1, FRAMES).astype(np.float32))
    rng = np.random.default_rng(seed + 3)
    m = cfg.num_superpoints
    p = dict(model.params)
    p['sp_points'] = jnp.asarray(pts[rng.permutation(len(pts))[:m]])
    p['sp_W'] = jnp.asarray(rng.normal(size=p['sp_W'].shape)
                            .astype(np.float32))
    net = dict(p['sp_deform'])
    for head in ('warp', 'rotation', 'scaling'):
        w = net[head]['w']
        net[head] = {'w': jnp.asarray(0.05 * rng.normal(size=w.shape)
                                      .astype(np.float32)),
                     'b': net[head]['b']}
    p['sp_deform'] = net
    sp_alive = np.ones(m, bool)
    sp_alive[[3, 11]] = False
    return model._replace(params=p, sp_alive=jnp.asarray(sp_alive))


def jax_tids(key, n: int, frames: int) -> np.ndarray:
    """The frames a JAX loop of ``n`` iterations draws from ``key``."""
    keys = jax.random.split(key, n)
    return np.array(jax.vmap(
        lambda k: jax.random.randint(k, (), 0, frames))(keys))


def init_tids(key, n: int, frames: int):
    """(joint loop, distill loop) frames of ``init_skeleton(..., key)``."""
    k1, k2 = jax.random.split(key)
    return jax_tids(k1, n, frames), jax_tids(k2, n, frames)


def to_port(cfg, jmodel):
    tcfg = tsk_gs.SKGSConfig(**to_port_cfg_fields(cfg))
    return convert.model_from_flat(_flatten(jmodel), tcfg,
                                   port_cfg(jax_rcfg()), device='cpu',
                                   trainable=True)


def spy_adam(monkeypatch) -> list:
    """The gradients each Adam update of the port's loops takes."""
    seen = []
    update = toptim.adam_update

    def spy(grads, *args, **kw):
        seen.append({k: g.detach().clone() for k, g in grads.items()
                     if g is not None})
        return update(grads, *args, **kw)
    monkeypatch.setattr(toptim, 'adam_update', spy)
    return seen


def adam_close(got, ref, grads, lr, name):
    """test_torch_train.py's parameter rule over ``len(grads)`` Adam
    iterations (module docstring)."""
    got, ref = np.asarray(got), np.asarray(ref)
    n = len(grads)
    big = np.ones(got.shape, bool)
    for g in grads:
        g = np.abs(to_np(g))
        big &= g > 1e-3 * g.max()
    err = np.abs(got - ref)
    scale = np.abs(ref).max()
    assert err[big].max(initial=0.0) <= 1e-5 * scale + 0.01 * lr * n, name
    assert err.max() <= 2 * lr * n + 1e-5 * scale, (name, err.max())


def tie_gap(cost, alive) -> float:
    """The smallest distance between two distinct entries of the live
    off-diagonal block of ``cost``."""
    live = np.flatnonzero(alive)
    sub = np.asarray(cost, np.float64)[np.ix_(live, live)]
    vals = np.sort(sub[~np.eye(len(live), dtype=bool)])
    return float(np.diff(vals).min())


@pytest.fixture(scope='module', params=['LBS', 'largest'])
def pieces(request):
    """The JAX states before and after each piece of ``init_skeleton``."""
    cfg = sk_cfg(request.param)
    j0 = sp_model(cfg)
    j0 = j0._replace(train_times=jnp.asarray(j0.train_times))
    key = jax.random.PRNGKey(7)
    k1, k2 = jax.random.split(key)
    w, idx = jsk_gs.lbs_weights(cfg, j0.params, j0.sp_alive,
                                j0.params['xyz'])
    p = dict(j0.params)
    p['joint_pos'] = jops.joint_pos_init_midpoint(p)
    j1 = j0._replace(
        params=p, sp_weights=w, sp_knn=idx,
        sp_cache=jops.compute_sp_transforms_all_frames(cfg, j0.params,
                                                       j0.train_times),
        p2sp=jnp.take_along_axis(idx, jnp.argmax(w, -1, keepdims=True),
                                 1)[:, 0])
    j2 = jops.optimize_joint_pos(cfg, j1, k1, steps=N_ITERS)
    j3 = jops.finalize_joints(cfg, j2)
    j4 = jops.distill_sk_deform(cfg, j3, k2, steps=N_ITERS)
    whole = jops.init_skeleton(cfg, j0, key, N_ITERS, N_ITERS)
    return cfg, (j0, j1, j2, j3, j4), whole, init_tids(key, N_ITERS, FRAMES)


def test_pieces_are_init_skeleton(pieces):
    """The JAX pieces in this order are the JAX ``init_skeleton``."""
    _, states, whole, _ = pieces
    a, b = _flatten(states[-1]), _flatten(whole)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], k)


def test_freeze_lbs_matches_jax(pieces):
    cfg, (j0, j1, *_), _, _ = pieces
    t = to_port(cfg, j0)
    tops.freeze_lbs(t.cfg, t)
    with torch.no_grad():
        t.params['joint_pos'].copy_(tops.joint_pos_init_midpoint(t.params))
    f, ref = convert.model_to_flat(t), _flatten(j1)
    for name in ('sp_knn', 'p2sp'):
        np.testing.assert_array_equal(f[name], ref[name], name)
    for name in ('sp_cache', 'sp_weights', 'params/joint_pos'):
        close_rel(f[name], ref[name], 1e-5, name)


def test_optimize_joint_pos_matches_jax(pieces, monkeypatch):
    cfg, (_, j1, j2, *_), _, (tids, _) = pieces
    t = to_port(cfg, j1)
    grads = spy_adam(monkeypatch)
    losses = tops.optimize_joint_pos(t.cfg, t, torch.as_tensor(tids))
    assert losses.shape == (N_ITERS,) and torch.isfinite(losses).all()
    f, ref = convert.model_to_flat(t), _flatten(j2)
    close_rel(f['joint_cost'], ref['joint_cost'], 1e-5, 'joint_cost')
    close_rel(f['params/joint_pos'], ref['params/joint_pos'], 1e-5,
              'joint_pos')
    adam_close(f['params/joint_pos'], ref['params/joint_pos'],
               [g['jp'] for g in grads], LR, 'joint_pos')
    assert not any(p.grad is not None for p in t.leaves().values())


def test_finalize_joints_matches_jax(pieces):
    cfg, (_, _, j2, j3, _), _, _ = pieces
    t = to_port(cfg, j2)
    root = tops.finalize_joints(t.cfg, t)
    f, ref = convert.model_to_flat(t), _flatten(j3)
    # the MST is a discrete choice: the cost's entries lie further apart
    # than the two frameworks' float32 results of the same cost could
    gap = tie_gap(ref['joint_cost'], ref['sp_alive'])
    assert gap > 1e-5 * np.abs(ref['joint_cost']).max(), gap
    for name in ('joint_parents', 'joint_root'):
        np.testing.assert_array_equal(f[name], ref[name], name)
    assert int(root) == int(ref['joint_root'])
    for name in ('params/joints', 'params/global_tr'):
        close_rel(f[name], ref[name], 1e-5, name)


def test_distill_sk_deform_matches_jax(pieces, monkeypatch):
    cfg, (*_, j3, j4), _, (_, tids) = pieces
    t = to_port(cfg, j3)
    grads = spy_adam(monkeypatch)
    losses = tops.distill_sk_deform(t.cfg, t, torch.as_tensor(tids))
    assert losses.shape == (N_ITERS,) and torch.isfinite(losses).all()
    assert float(losses[-1]) < float(losses[0])
    f, ref = convert.model_to_flat(t), _flatten(j4)
    trained = sorted(grads[0])
    assert {'joints', 'global_tr', 'sp_W', 'sk_deform/layers/0/w'} <= \
        set(trained)
    for name in trained:
        adam_close(f['params/' + name], ref['params/' + name],
                   [g[name] for g in grads], LR, name)
    for name in t.leaves():
        if name not in trained:
            np.testing.assert_array_equal(f['params/' + name],
                                          ref['params/' + name], name)
    assert not any(p.grad is not None for p in t.leaves().values())


# ---------------------------------------------------------------- trainer


def run_transition(cfg, scene, meta, tmp, steps, monkeypatch):
    """The JAX trainer from an sp-stage model over ``steps``; before each,
    the port's trainer resumed from its state takes the same step, and at
    the step whose events fire the skeleton initialisation, the event is
    held apart: the port runs it from the JAX state before it (with the
    JAX draws), the JAX trainer runs its events alone, and the step is
    then taken by both from the JAX state after them."""
    jt = jtrainer.SKGSTrainer(cfg, jax_rcfg(), scene, meta, sp_model(cfg),
                              loss_weights=jlosses.LossWeights(LOSS))
    jt.state.sp_initialized = jt.state.reinit_done = True
    snaps = {}
    for step in steps:
        event = None
        if not jt.state.skeleton_initialized:
            _, k = jax.random.split(jt.state.key)
            tids = init_tids(k, N_ITERS, FRAMES)
            run = tops.init_skeleton
            monkeypatch.setattr(tops, 'init_skeleton', lambda c, m, a, b:
                                run(c, m, *map(torch.as_tensor, tids)))
            tt = port_trainer(jt, tmp, None, step)
            assert not tt.skeleton_initialized
            grads = spy_adam(monkeypatch)
            out = tt._init_skeleton()
            monkeypatch.undo()
            jt.maybe_stage_events(step)
            assert jt.state.skeleton_initialized
            event = dict(tflat=convert.model_to_flat(tt.model),
                         jflat=_flatten(jt.state.model), grads=grads,
                         losses={k: to_np(v) for k, v in out.items()})
        tt = port_trainer(jt, tmp, None, step)
        assert tt.skeleton_initialized
        mu_prev = {k: np.array(v) for k, v in
                   _flatten(jt.state.opt_state.mu).items()}
        weights = spy_weights(tt)
        tm = {n: to_np(v) for n, v in tt.train_step(step).items()}
        jm = {n: np.asarray(v) for n, v in jt.train_step(step).items()}
        snaps[step] = dict(
            jax=jm, port=tm, lrs=tt.lr_trees(step), trainer=tt, event=event,
            grads={n: to_np(p.grad).copy()
                   for n, p in tt.model.leaves().items()},
            mu_prev=mu_prev, kink_rows=np.zeros(256, bool), weights=weights,
            jflat=_flatten(jt.state.model),
            tflat=convert.model_to_flat(tt.model),
            jopt=_flatten(jt.state.opt_state),
            topt={f'{m}/{k}': to_np(v).copy() for m in ('mu', 'nu')
                  for k, v in getattr(tt.opt_state, m).items()})
    return snaps


@pytest.fixture(scope='module')
def transition(tile_interpret, jax_scene, tmp_path_factory):  # noqa: F811
    """Steps 4 and 5, the two sk_init steps (the initialisation before
    4), and, on the flagship's shape (sk_init empty), step 4, the first sk
    step, with the initialisation before it."""
    scene, meta = jax_scene
    mp = pytest.MonkeyPatch()
    try:
        runs = {
            'sk_init': run_transition(sk_cfg(), scene, meta,
                                      tmp_path_factory.mktemp('ski'), (4, 5),
                                      mp),
            'sk': run_transition(sk_cfg(sk_init_steps=0), scene, meta,
                                 tmp_path_factory.mktemp('sk'), (4,), mp)}
    finally:
        mp.undo()
    return runs


def check_event(event):
    """The port's initialisation from the JAX state before it, against the
    JAX trainer's."""
    f, ref = event['tflat'], event['jflat']
    for name in ('sp_knn', 'p2sp', 'joint_parents', 'joint_root'):
        np.testing.assert_array_equal(f[name], ref[name], name)
    for name in ('sp_cache', 'sp_weights', 'joint_cost'):
        close_rel(f[name], ref[name], 1e-5, name)
    joint_grads = [g['jp'] for g in event['grads'] if 'jp' in g]
    distill = [g for g in event['grads'] if 'jp' not in g]
    assert len(joint_grads) == len(distill) == N_ITERS
    adam_close(f['params/joint_pos'], ref['params/joint_pos'], joint_grads,
               LR, 'joint_pos')
    for name in distill[0]:
        adam_close(f['params/' + name], ref['params/' + name],
                   [g[name] for g in distill], LR, name)
    for name, v in event['losses'].items():
        assert v.shape == (N_ITERS,) and np.isfinite(v).all(), name


@pytest.mark.parametrize('step', (4, 5))
def test_sk_init_steps_match_jax_trainer(transition, step):
    s = transition['sk_init'][step]
    assert sk_cfg().stage_at(step) == 'sk_init'
    assert {'cmp_t', 'cmp_r', 'cmp_s', 'rgb', 'ssim'} <= set(s['port'])
    assert (s['event'] is not None) == (step == 4)
    if s['event'] is not None:
        check_event(s['event'])
    check_step(s)
    # no image gradient: the colours and opacities do not train
    for name in ('f_dc', 'f_rest', 'opacity', 'xyz'):
        assert not s['grads'][name].any(), name
    assert s['grads']['sk_deform/layers/0/w'].any()
    assert not s['weights']


def test_first_sk_step_initialises_the_skeleton(transition):
    """The flagship's shape: sk_init has no steps, the initialisation runs
    before the first sk step."""
    s = transition['sk'][4]
    assert sk_cfg(sk_init_steps=0).stage_at(4) == 'sk'
    check_event(s['event'])
    check_step(s)
    assert s['trainer'].skeleton_initialized


def test_non_finite_skeleton_raises(tile_interpret, jax_scene,  # noqa: F811
                                    tmp_path):
    """A NaN in the superpoint motion (the warp net's bias, so every
    ``sp_cache`` row) reaches the skeleton: the event raises and the flag
    stays unset."""
    scene, meta = jax_scene
    cfg = sk_cfg()
    jt = jtrainer.SKGSTrainer(cfg, jax_rcfg(), scene, meta, sp_model(cfg),
                              loss_weights=jlosses.LossWeights(LOSS))
    tt = port_trainer(jt, tmp_path, None, 4)
    with torch.no_grad():
        tt.model.sp_deform.warp.b[0] = float('nan')
    with pytest.raises(FloatingPointError, match='non-finite'):
        tt.train_step(4)
    assert not tt.skeleton_initialized
    assert not torch.isfinite(tt.model.sp_cache).all()


def test_convert_carries_the_frozen_lbs(pieces, tmp_path):
    """A JAX model after init_skeleton keeps ``sp_weights`` / ``sp_knn``
    through ``model_from_flat`` -> ``model_to_flat``; a trainer checkpoint
    inside sk_init resumes with the skeleton initialised, as the JAX
    ``restore`` reads it."""
    cfg, _, whole, _ = pieces
    ref = _flatten(whole)
    tcfg = tsk_gs.SKGSConfig(**to_port_cfg_fields(cfg))
    f = convert.model_to_flat(to_port(cfg, whole))
    assert np.abs(ref['sp_weights']).max() > 0
    for name in ('sp_weights', 'sp_knn'):
        np.testing.assert_array_equal(f[name], ref[name], name)
    assert f['sp_knn'].dtype == np.int32
    # a checkpoint without them: zeros of the model's shapes
    older = {k: v for k, v in ref.items()
             if k not in ('sp_weights', 'sp_knn')}
    f0 = convert.model_to_flat(convert.model_from_flat(
        older, tcfg, port_cfg(jax_rcfg()), device='cpu'))
    for name in ('sp_weights', 'sp_knn'):
        assert f0[name].shape == ref[name].shape and not f0[name].any()
    ckpt = {'state/model/' + k: v for k, v in ref.items()}
    ckpt['state/flags/skeleton_initialized'] = np.asarray(False)
    inside = convert.trainer_flags_from_flat(ckpt, tcfg, 4, device='cpu')
    assert cfg.stage_at(4) == 'sk_init' and inside['skeleton_initialized']
    before = convert.trainer_flags_from_flat(ckpt, tcfg, 3, device='cpu')
    assert not before['skeleton_initialized']
