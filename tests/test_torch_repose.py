"""Port parity, the served ``sk`` family's two branches: repose deltas
(``sk_r_delta`` through the FK) and ``test_time_interpolate`` (the
skeleton net's outputs read from the per-frame ``sk_cache``), held against
the JAX package at atol 1e-5 on the tiny model of ``test_torch_slice``, in
quaternion and lie rotation modes.

The ``sk_cache`` is what ``sk`` training writes: each train frame's row of
the net at that frame (``sk_stage``'s 'cache_row', computed by the JAX
package). Quaternion mode caches the normalised quaternion, which the read
path normalises again without the identity bias; lie mode caches the raw
axis-angle and applies ``so3_exp`` again.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sk_gs_tpu.models import deform as jdeform
from sk_gs_tpu.models import sk_gs as jsk_gs
from sk_gs_tpu.models import skeleton as jsk
from sk_gs_tpu_torch.models import sk_gs as tsk_gs
from sk_gs_tpu_torch.models import skeleton as tsk
from tests.test_torch_cli import one_torch_thread  # noqa: F401
from tests.test_torch_slice import FRAMES, M, port_model, tiny_jax_model

ATOL = 1e-5
# times between the train frames (0, 0.2, ..., 1), at frames, and past the
# last gap's end (t = 1 is the last frame)
BETWEEN = (0.07, 0.33, 0.5, 0.91)


def t(x):
    return torch.from_numpy(np.array(x))


def ft(x):
    return torch.tensor(float(x), dtype=torch.float32)


def unit_quats(rng, n):
    q = rng.normal(size=(n, 4)).astype(np.float32)
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def with_cache(cfg, model):
    """``model`` with its ``sk_cache`` filled as ``sk`` training fills it:
    the net's cache row at each train frame."""
    rows = []
    for tid in range(FRAMES):
        out = jsk_gs.sk_stage(cfg, model, model.params['xyz'],
                              model.train_times[tid], time_id=tid,
                              training=True)
        rows.append(out.aux['cache_row'])
    return model._replace(sk_cache=jnp.stack(rows))


def lie_model(cfg, model):
    """The tiny model with a 3-dim (axis-angle) rotation head."""
    rng = np.random.default_rng(7)
    sk_net = cfg.sk_net._replace(out_dims=(3, 4, 3))
    cfg = cfg._replace(sk_net=sk_net, which_rotation='lie')
    net = jdeform.skeleton_net_init(jax.random.PRNGKey(5), sk_net)
    net['heads'] = [{'w': jnp.asarray(0.05 * rng.normal(size=h['w'].shape)
                                      .astype(np.float32)), 'b': h['b']}
                    for h in net['heads']]
    params = dict(model.params)
    params['sk_deform'] = net
    return cfg, model._replace(params=params,
                               sk_cache=jnp.zeros((FRAMES, M, 10)))


@pytest.fixture(scope='module', params=['quaternion', 'lie'])
def mode_models(request, tmp_path_factory):
    cfg, rcfg, model = tiny_jax_model()
    if request.param == 'lie':
        cfg, model = lie_model(cfg, model)
    model = with_cache(cfg, model)
    tmodel = port_model(cfg, rcfg, model, tmp_path_factory.mktemp('ckpt'))
    return request.param, cfg, model, tmodel


@pytest.mark.parametrize('width', [3, 4])
def test_kinematic_transforms_repose(rng, width):
    m = 20
    cost = rng.uniform(1, 2, size=(m, m))
    parents, _, root = jsk.joint_discovery_host((cost + cost.T) / 2,
                                                rng.uniform(size=m) > 0.2,
                                                use_native=False)
    joints = rng.normal(size=(m, 3)).astype(np.float32)
    sk_r = unit_quats(rng, m)
    g_tr = np.concatenate([rng.normal(size=3), unit_quats(rng, 1)[0]]
                          ).astype(np.float32)
    delta = (0.5 * rng.normal(size=(m, 3))).astype(np.float32) \
        if width == 3 else unit_quats(rng, m)
    ref = jsk.kinematic_transforms(jnp.asarray(joints), jnp.asarray(sk_r),
                                   jnp.asarray(g_tr), jnp.asarray(parents),
                                   jnp.asarray(root), jnp.asarray(delta))
    out = tsk.kinematic_transforms(t(joints), t(sk_r), t(g_tr), t(parents),
                                   root, sk_r_delta=t(delta))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL,
                               rtol=0)
    plain = tsk.kinematic_transforms(t(joints), t(sk_r), t(g_tr), t(parents),
                                     root)
    assert np.abs(out.numpy() - plain.numpy()).max() > 1e-2


def deltas_pair(cfg, model, tmodel, tt, time_id, delta, interp):
    jcfg = cfg._replace(test_time_interpolate=interp)
    tcfg = tmodel.cfg._replace(test_time_interpolate=interp)
    ref = jsk_gs.forward_deltas(
        jcfg, model, jnp.asarray(tt, jnp.float32), 'sk', time_id=time_id,
        sk_r_delta=None if delta is None else jnp.asarray(delta),
        training=False)
    got = tsk_gs.forward_deltas(
        tcfg, tmodel, torch.tensor(tt, dtype=torch.float32), 'sk',
        time_id=time_id, sk_r_delta=None if delta is None else t(delta),
        training=False)
    return ref, got


@pytest.mark.parametrize('interp', [False, True])
@pytest.mark.parametrize('reposed', [False, True])
def test_forward_deltas_match_jax(mode_models, interp, reposed):
    """At each train frame (by ``time_id``) and between frames, with and
    without a repose delta: the three deltas and the joint transforms."""
    _mode, cfg, model, tmodel = mode_models
    rng = np.random.default_rng(3)
    delta = (0.4 * rng.normal(size=(M, 3))).astype(np.float32) \
        if reposed else None
    times = np.asarray(model.train_times)
    cases = [(float(times[i]), i) for i in (0, 2, FRAMES - 1)] + \
        [(tt, None) for tt in BETWEEN]
    with torch.no_grad():
        for tt, tid in cases:
            ref, got = deltas_pair(cfg, model, tmodel, tt, tid, delta, interp)
            for name in ('d_xyz', 'd_rotation', 'd_scaling'):
                np.testing.assert_allclose(
                    getattr(got, name).numpy(), np.asarray(getattr(ref, name)),
                    atol=ATOL, rtol=0, err_msg=f'{name} t={tt} id={tid}')
            np.testing.assert_allclose(got.aux['skT'].numpy(),
                                       np.asarray(ref.aux['skT']), atol=ATOL,
                                       rtol=0)


def test_interpolation_reads_the_cache(mode_models):
    """At the train frames the cached rows give the net's deltas (the cache
    holds what the net computes there); between frames they are a blend
    of the two frames' rows, not the net at t."""
    _mode, cfg, model, tmodel = mode_models
    times = tmodel.train_times.numpy()
    with torch.no_grad():
        for i in range(FRAMES):
            net = tsk_gs.forward_deltas(tmodel.cfg, tmodel, ft(times[i]), 'sk')
            cached = tsk_gs.forward_deltas(
                tmodel.cfg._replace(test_time_interpolate=True), tmodel,
                ft(times[i]), 'sk')
            np.testing.assert_allclose(cached.d_xyz.numpy(),
                                       net.d_xyz.numpy(), atol=ATOL, rtol=0)
        mid = 0.5 * (times[1] + times[2])
        net = tsk_gs.forward_deltas(tmodel.cfg, tmodel, ft(mid), 'sk')
        cached = tsk_gs.forward_deltas(
            tmodel.cfg._replace(test_time_interpolate=True), tmodel, ft(mid),
            'sk')
        row = 0.5 * (tmodel.sk_cache[1] + tmodel.sk_cache[2])
        np.testing.assert_allclose(cached.aux['cache_row'].numpy(),
                                   row.numpy(), atol=1e-7, rtol=0)
        assert np.abs(cached.d_xyz.numpy() - net.d_xyz.numpy()).max() > 0


def test_training_reads_the_net(mode_models):
    """``training=True`` runs the net whatever ``test_time_interpolate``
    says, as the JAX step does."""
    _mode, cfg, model, tmodel = mode_models
    tt = BETWEEN[1]
    with torch.no_grad():
        a = tsk_gs.forward_deltas(tmodel.cfg, tmodel, ft(tt), 'sk',
                                  training=True)
        b = tsk_gs.forward_deltas(
            tmodel.cfg._replace(test_time_interpolate=True), tmodel, ft(tt),
            'sk', training=True)
    np.testing.assert_array_equal(a.d_xyz.numpy(), b.d_xyz.numpy())


def test_zero_delta_is_no_delta(mode_models):
    _mode, cfg, model, tmodel = mode_models
    with torch.no_grad():
        a = tsk_gs.forward_deltas(tmodel.cfg, tmodel, ft(0.4), 'sk')
        b = tsk_gs.forward_deltas(tmodel.cfg, tmodel, ft(0.4), 'sk',
                                  sk_r_delta=torch.zeros(M, 3))
    np.testing.assert_array_equal(a.d_xyz.numpy(), b.d_xyz.numpy())
