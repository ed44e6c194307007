"""Port parity, model pieces: sk_gs_tpu_torch.models vs sk_gs_tpu.models on
the same numpy inputs, float32. KNN indices must be identical (ties and
dead columns included); values agree at atol 1e-5 (products and sums taken
in another order)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sk_gs_tpu.framework.checkpoint import _flatten
from sk_gs_tpu.models import deform as jdeform
from sk_gs_tpu.models import gaussian_splatting as jgs
from sk_gs_tpu.models import skeleton as jsk
from sk_gs_tpu.models import superpoints as jsp
from sk_gs_tpu_torch import convert
from sk_gs_tpu_torch.models import deform as tdeform
from sk_gs_tpu_torch.models import gaussian_splatting as tgs
from sk_gs_tpu_torch.models import skeleton as tsk
from sk_gs_tpu_torch.models import superpoints as tsp

ATOL = 1e-5


def t(x):
    return torch.from_numpy(np.array(x))


def close(out, ref, atol=ATOL, err_msg=''):
    np.testing.assert_allclose(out.detach().cpu().numpy(), np.asarray(ref),
                               atol=atol, rtol=0, err_msg=err_msg)


def unit_quats(rng, n):
    q = rng.normal(size=(n, 4)).astype(np.float32)
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


class TestMaskedKnn:
    def test_indices_identical(self, rng):
        q = rng.normal(size=(500, 3)).astype(np.float32)
        keys = rng.normal(size=(64, 3)).astype(np.float32)
        alive = rng.uniform(size=64) > 0.3
        rd, ri = jsp.masked_knn(jnp.asarray(q), jnp.asarray(keys),
                                jnp.asarray(alive), 5)
        d, i = tsp.masked_knn(t(q), t(keys), t(alive), 5)
        assert i.dtype == torch.int32
        np.testing.assert_array_equal(i.numpy(), np.asarray(ri))
        close(d, rd)

    def test_ties_and_dead_columns(self):
        # duplicated keys tie exactly; the lowest index wins. With fewer
        # live keys than k, the dead columns follow in ascending order, and
        # their distance is +inf.
        keys = np.zeros((12, 3), np.float32)
        keys[[2, 5, 9]] = [1.0, 0.0, 0.0]
        keys[[3, 7]] = [0.0, 2.0, 0.0]
        alive = np.zeros(12, bool)
        alive[[2, 3, 5, 7, 9]] = True
        q = np.asarray([[1.0, 0.0, 0.0], [0.0, 2.0, 0.0], [0.5, 1.0, 0.0],
                        [9.0, 9.0, 9.0]], np.float32)
        for k, mask in ((5, alive), (7, alive), (4, np.zeros(12, bool))):
            rd, ri = jsp.masked_knn(jnp.asarray(q), jnp.asarray(keys),
                                    jnp.asarray(mask), k)
            d, i = tsp.masked_knn(t(q), t(keys), t(mask), k)
            np.testing.assert_array_equal(i.numpy(), np.asarray(ri))
            np.testing.assert_array_equal(d.numpy(), np.asarray(rd))
        assert i[0].tolist() == [0, 1, 2, 3]


@pytest.mark.parametrize('method,use_hyper', [
    ('W', False), ('W', True), ('dist', False), ('kernel', False),
    ('weighted_kernel', False)])
def test_calc_lbs_weight(rng, method, use_hyper):
    n, m, k = 300, 32, 5
    pts = rng.normal(size=(n, 3)).astype(np.float32)
    sp = rng.normal(size=(m, 3)).astype(np.float32)
    alive = rng.uniform(size=m) > 0.2
    W = rng.normal(size=(n, m)).astype(np.float32)
    radius = rng.normal(size=(m,)).astype(np.float32)
    weight = rng.normal(size=(m,)).astype(np.float32)
    hyper = rng.normal(size=(n, 2)).astype(np.float32) if use_hyper else None
    sp_hyper = rng.normal(size=(m, 2)).astype(np.float32) if use_hyper else None
    jarr = lambda x: None if x is None else jnp.asarray(x)
    tarr = lambda x: None if x is None else t(x)
    rw, ri = jsp.calc_lbs_weight(
        jnp.asarray(pts), jnp.asarray(sp), jnp.asarray(alive), k, method,
        hyper=jarr(hyper), sp_hyper=jarr(sp_hyper), sp_W=jnp.asarray(W),
        sp_radius_raw=jnp.asarray(radius), sp_weight_raw=jnp.asarray(weight),
        temperature=0.7)
    w, i = tsp.calc_lbs_weight(
        t(pts), t(sp), t(alive), k, method, hyper=tarr(hyper),
        sp_hyper=tarr(sp_hyper), sp_W=t(W), sp_radius_raw=t(radius),
        sp_weight_raw=t(weight), temperature=0.7)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ri))
    close(w, rw)
    close(tsp.select_rows(t(W), i), jsp.select_rows(jnp.asarray(W), ri))


def test_dense_lbs_and_warp_blend(rng):
    n, m, k = 400, 24, 5
    w = rng.uniform(size=(n, k)).astype(np.float32)
    w /= w.sum(-1, keepdims=True)
    idx = np.stack([rng.permutation(m)[:k] for _ in range(n)]).astype(np.int32)
    dense_ref = jsp.dense_lbs_rows(jnp.asarray(w), jnp.asarray(idx), m)
    dense = tsp.dense_lbs_rows(t(w), t(idx), m)
    np.testing.assert_array_equal(dense.numpy(), np.asarray(dense_ref))

    pts = rng.normal(size=(n, 3)).astype(np.float32)
    # off-unit quaternions: the raw matrix formula (pre_normalize=False)
    spT = np.concatenate([rng.normal(size=(m, 3)),
                          rng.normal(size=(m, 4)) * 0.7], -1).astype(np.float32)
    rot = rng.normal(size=(m, 4)).astype(np.float32)
    scl = rng.normal(size=(m, 3)).astype(np.float32)
    ref = jsp.warp_blend_dense(jnp.asarray(pts), jnp.asarray(spT), dense_ref,
                               jnp.asarray(rot), jnp.asarray(scl))
    out = tsp.warp_blend_dense(t(pts), t(spT), dense, t(rot), t(scl))
    for o, r, name in zip(out, ref, ('d_xyz', 'd_rotation', 'd_scaling')):
        close(o, r, err_msg=name)


def test_kinematic_transforms_and_parents_table(rng):
    m = 20
    cost = rng.uniform(1, 2, size=(m, m))
    cost = (cost + cost.T) / 2
    alive = rng.uniform(size=m) > 0.2
    parents, _, root = jsk.joint_discovery_host(cost, alive, use_native=False)
    # the port rebuilds the binary-lifting table from the parent column
    np.testing.assert_array_equal(
        tsk.parents_table(parents[:, 0], root, parents.shape[1]), parents)

    joints = rng.normal(size=(m, 3)).astype(np.float32)
    sk_r = unit_quats(rng, m)
    g_tr = np.concatenate([rng.normal(size=3), unit_quats(rng, 1)[0]]
                          ).astype(np.float32)
    ref = jsk.kinematic_transforms(jnp.asarray(joints), jnp.asarray(sk_r),
                                   jnp.asarray(g_tr), jnp.asarray(parents),
                                   jnp.asarray(root))
    out = tsk.kinematic_transforms(t(joints), t(sk_r), t(g_tr), t(parents),
                                   root)
    close(out, ref)
    # a repose delta, as an so3 log [m, 3] and as a quaternion [m, 4]
    for delta in ((0.5 * rng.normal(size=(m, 3))).astype(np.float32),
                  unit_quats(rng, m)):
        ref = jsk.kinematic_transforms(
            jnp.asarray(joints), jnp.asarray(sk_r), jnp.asarray(g_tr),
            jnp.asarray(parents), jnp.asarray(root), jnp.asarray(delta))
        close(tsk.kinematic_transforms(t(joints), t(sk_r), t(g_tr),
                                       t(parents), root, sk_r_delta=t(delta)),
              ref, err_msg=f'sk_r_delta {delta.shape}')


def test_skeleton_net_apply(rng):
    cfg = jdeform.SkeletonNetConfig(width=32, depth=3, skips=(1,))
    params = jdeform.skeleton_net_init(jax.random.PRNGKey(3), cfg)
    # the init's 1e-6 heads would hide the trunk: give them weight
    params['heads'] = [
        {'w': jnp.asarray(rng.normal(size=h['w'].shape).astype(np.float32)),
         'b': jnp.asarray(rng.normal(size=h['b'].shape).astype(np.float32))}
        for h in params['heads']]
    flat = _flatten({'params': {'sk_deform': params}})
    net = convert.skeleton_net_from_flat(
        flat, tdeform.SkeletonNetConfig(*cfg), 'params/sk_deform/', 'cpu')
    joints = rng.normal(size=(16, 3)).astype(np.float32)
    for tt in (0.0, 0.37):
        ref = jdeform.skeleton_net_apply(params, cfg, jnp.asarray(joints),
                                         jnp.asarray(tt, jnp.float32))
        out = tdeform.skeleton_net_apply(net, tdeform.SkeletonNetConfig(*cfg),
                                         t(joints), torch.tensor(tt))
        assert len(out) == len(ref) == 3
        for o, r in zip(out, ref):
            close(o, r)


def test_gaussian_inputs(rng):
    gcfg = jgs.GaussianConfig(capacity=96, sh_degree=2)
    pts = rng.normal(size=(70, 3)).astype(np.float32)
    cols = rng.uniform(size=(70, 3)).astype(np.float32)
    base = jgs.init_from_pcd(pts, cols, gcfg)
    params = dict(base.params)
    params['rotation'] = jnp.asarray(rng.normal(size=(96, 4)).astype(np.float32))
    params['rotation'] = params['rotation'].at[5].set(0.0)   # zero row
    params['opacity'] = jnp.asarray(rng.normal(size=(96, 1)).astype(np.float32))
    base = base._replace(params=params)
    d_xyz = rng.normal(size=(96, 3)).astype(np.float32) * 0.1
    d_rot = rng.normal(size=(96, 4)).astype(np.float32) * 0.1
    d_scl = rng.normal(size=(96, 3)).astype(np.float32) * 0.01
    ref = jgs.gaussian_inputs(base, gcfg, jnp.asarray(d_xyz), jnp.asarray(d_rot),
                              jnp.asarray(d_scl))
    m = tgs.GaussianModel(params={k: t(v) for k, v in params.items()},
                          alive=t(base.alive),
                          active_sh_degree=t(base.active_sh_degree))
    out = tgs.gaussian_inputs(m, tgs.GaussianConfig(*gcfg), t(d_xyz), t(d_rot),
                              t(d_scl))
    for name in ('means3d', 'scales', 'rotations', 'opacities', 'sh'):
        close(getattr(out, name), getattr(ref, name), err_msg=name)
    np.testing.assert_array_equal(out.mask.numpy(), np.asarray(ref.mask))
    assert ref.colors is None and out.colors is None
