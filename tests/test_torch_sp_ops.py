"""Port parity, the ``sp`` family's pieces: the SO3 / SE3 logs, furthest
point sampling, the superpoint transforms and warps, ``sp_stage``, the
joint cost and joint discovery, the superpoint adjustment masks and the
stage transitions of ``sk_gs_ops``, against the JAX package on the same
inputs (numpy from a seed, or a JAX-built model through ``convert``).

Tolerances: values 1e-5 (absolute; float32 products and sums taken in
another order), gradients (``jax.vjp`` against autograd) 3e-4 of each
leaf's max magnitude, indices, masks, counts and parents exactly. The FPS
data is checked to be tie-free: at every pick the two best scores differ
by more than 1e-5 of the best, so the frameworks' rounding cannot swap
them.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sk_gs_tpu.framework.checkpoint import _flatten, save_pytree
from sk_gs_tpu.models import gaussian_splatting as jgs
from sk_gs_tpu.models import optim as joptim
from sk_gs_tpu.models import sk_gs as jsk_gs
from sk_gs_tpu.models import sk_gs_ops as jops
from sk_gs_tpu.models import skeleton as jskel
from sk_gs_tpu.models import superpoints as jsp
from sk_gs_tpu.ops import knn as jknn
from sk_gs_tpu.ops import se3 as jse3
from sk_gs_tpu_torch import convert
from sk_gs_tpu_torch.models import sk_gs as tsk_gs
from sk_gs_tpu_torch.models import sk_gs_ops as tops
from sk_gs_tpu_torch.models import skeleton as tskel
from sk_gs_tpu_torch.models import superpoints as tsp
from sk_gs_tpu_torch.ops import knn as tknn
from sk_gs_tpu_torch.ops import quaternion as tquat
from sk_gs_tpu_torch.ops import se3 as tse3
from tests.test_torch_cli import one_torch_thread  # noqa: F401
from tests.test_torch_render import port_cfg, to_np
from tests.test_torch_slice import make_view_cfg, tiny_cfg, to_port_cfg_fields

ATOL = 1e-5
M = 16


def t_(x, dtype=None):
    t = torch.from_numpy(np.array(x))
    return t if dtype is None else t.to(dtype)


def close(got, ref, atol=ATOL, err_msg=''):
    np.testing.assert_allclose(to_np(got) if torch.is_tensor(got) else got,
                               np.asarray(ref), atol=atol, rtol=0,
                               err_msg=err_msg)


def close_grad(got, ref, name=''):
    ref = np.asarray(ref)
    scale = np.abs(ref).max()
    assert scale > 0, name
    err = np.abs(to_np(got) - ref).max()
    assert err <= 3e-4 * scale, f'{name}: {err} > 3e-4 x {scale}'


def unit_quats(rng, n):
    q = rng.normal(size=(n, 4)).astype(np.float32)
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


# ---------------------------------------------------------------- se3


def test_so3_se3_logs_match_jax(rng):
    q = unit_quats(rng, 40)
    q[0] = [0.0, 0.0, 0.0, 1.0]                     # the identity
    q[1] = [1e-6, -2e-6, 0.0, 1.0]                  # near it
    q[2] = -q[2]                                    # w < 0: standardised
    T = np.concatenate([rng.normal(size=(40, 3)).astype(np.float32), q], -1)
    ct3 = rng.normal(size=(40, 3)).astype(np.float32)
    ct6 = rng.normal(size=(40, 6)).astype(np.float32)
    ct7 = rng.normal(size=(40, 7)).astype(np.float32)
    for jfn, tfn, x, ct in ((jse3.so3_log, tse3.so3_log, q, ct3),
                            (jse3.se3_log, tse3.se3_log, T, ct6),
                            (jse3.se3_inv, tse3.se3_inv, T, ct7)):
        ref, vjp = jax.vjp(jfn, jnp.asarray(x))
        xt = t_(x).requires_grad_(True)
        got = tfn(xt)
        close(got, ref, err_msg=jfn.__name__)
        got.backward(t_(ct))
        g_ref = vjp(jnp.asarray(ct))[0]
        assert np.isfinite(to_np(xt.grad)).all()
        close_grad(xt.grad, g_ref, jfn.__name__)
    a, b = unit_quats(rng, 8), unit_quats(rng, 8)
    v = rng.normal(size=(8, 3)).astype(np.float32)
    # the port's SO3 group ops are the quaternion ones
    close(tquat.multiply(t_(a), t_(b)), jse3.so3_mul(a, b))
    close(tquat.conjugate(t_(a)), jse3.so3_inv(a))
    close(tquat.apply(t_(a), t_(v)), jse3.so3_act(a, v))


# ---------------------------------------------------------------- fps


def fps_gaps(points, mask, picks):
    """The relative gap between the best and second best score at every
    pick after the first, in float64."""
    pts = points.astype(np.float64)
    dists = np.full(len(pts), np.inf)
    gaps = []
    for i in range(1, len(picks)):
        dists = np.minimum(dists, ((pts - pts[picks[i - 1]]) ** 2).sum(-1))
        score = np.where(mask, dists, -np.inf) if mask is not None else dists
        top2 = np.sort(score)[-2:]
        gaps.append((top2[1] - top2[0]) / top2[1])
    return np.asarray(gaps)


@pytest.mark.parametrize('masked', [False, True])
def test_fps_matches_jax(masked):
    rng = np.random.default_rng(11)
    pts = rng.normal(size=(400, 48)).astype(np.float32)
    mask = None
    if masked:
        mask = rng.uniform(size=400) > 0.4
        mask[:3] = False                  # the first pick is the first live
    ref = np.asarray(jknn.furthest_point_sampling(
        jnp.asarray(pts), 64, None if mask is None else jnp.asarray(mask)))
    got, picked = tknn.furthest_point_sampling(
        t_(pts), 64, None if mask is None else t_(mask), return_dists=True)
    assert got.dtype == torch.int64
    assert fps_gaps(pts, mask, ref).min() > 1e-5
    np.testing.assert_array_equal(to_np(got), ref)
    assert len(set(ref.tolist())) == 64
    if masked:
        assert ref[0] == 3 and mask[ref].all()
    # the running minimum distance at each pick, and it never grows
    p = to_np(picked)
    assert np.isinf(p[0]) and (np.diff(p[1:]) <= 0).all()
    d1 = ((pts[ref[1]] - pts[ref[0]]) ** 2).sum()
    np.testing.assert_allclose(p[1], d1, rtol=1e-5)


# ---------------------------------------------------------------- warps


@pytest.mark.parametrize('method', ['LBS', 'LBS_c', 'largest'])
def test_sp_warps_match_jax(rng, method):
    n = 60
    d_xyz = rng.normal(size=(M, 3)).astype(np.float32) * 0.1
    d_rot = unit_quats(rng, M)
    sp = rng.normal(size=(M, 3)).astype(np.float32)
    pts = rng.normal(size=(n, 3)).astype(np.float32)
    idx = np.stack([rng.permutation(M)[:5] for _ in range(n)]).astype(np.int32)
    w = rng.uniform(size=(n, 5)).astype(np.float32)
    w /= w.sum(-1, keepdims=True)
    p2sp = np.take_along_axis(idx, w.argmax(-1)[:, None], 1)[:, 0]
    attr = rng.normal(size=(M, 3)).astype(np.float32)
    spT = jsp.sp_transforms(d_xyz, d_rot, sp, method)
    tspT = tsp.sp_transforms(t_(d_xyz), t_(d_rot), t_(sp), method)
    close(tspT, spT)
    close(tsp.warp_points(t_(pts), tspT, t_(w), t_(idx), method, t_(p2sp)),
          jsp.warp_points(pts, spT, w, idx, method, p2sp))
    close(tsp.blend_attr(t_(attr), t_(w), t_(idx)),
          jsp.blend_attr(attr, w, idx))


# ---------------------------------------------------------------- models


def jax_sp_model(seed=0, warp_method='LBS'):
    """A JAX sp-stage model: 200 live Gaussians of 256, 13 of 16
    superpoints live, random LBS matrix, hyper features and pivots, warp
    nets with weight in their heads, statistics and a cached transform
    table."""
    rng = np.random.default_rng(seed)
    cfg = tiny_cfg()._replace(warp_method=warp_method)
    pts = rng.uniform(-0.8, 0.8, size=(200, 3)).astype(np.float32)
    cols = rng.uniform(size=(200, 3)).astype(np.float32)
    times = np.linspace(0.0, 1.0, cfg.num_frames).astype(np.float32)
    model = jsk_gs.init_model(jax.random.PRNGKey(seed), cfg,
                              jgs.init_from_pcd(pts, cols, cfg.gauss), times)
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    p = dict(model.params)
    p['sp_points'] = jnp.asarray(pts[rng.permutation(200)[:M]])
    p['sp_W'] = jnp.asarray(f(256, M))
    p['hyper'] = jnp.asarray(0.05 * f(256, cfg.hyper_dim))
    p['sp_hyper'] = jnp.asarray(0.05 * f(M, cfg.hyper_dim))
    p['joint_pos'] = jnp.asarray(0.3 * f(M, M, 3))
    p['scaling'] = jnp.asarray(-3.0 + 0.3 * f(256, 3))
    for net in ('sp_deform', 'canonical'):
        p[net] = dict(p[net])
        for head in ('warp', 'rotation', 'scaling'):
            w = p[net][head]['w']
            p[net][head] = {'w': jnp.asarray(0.05 * f(*w.shape)),
                            'b': p[net][head]['b']}
    sp_alive = np.ones(M, bool)
    sp_alive[[3, 8, 11]] = False
    model = model._replace(
        params=p, sp_alive=jnp.asarray(sp_alive),
        xyz_grad_accum=jnp.asarray(rng.uniform(0, 1e-2, 256)
                                   .astype(np.float32)),
        denom=jnp.asarray(rng.integers(0, 5, 256).astype(np.float32)),
        joint_cost=jnp.asarray(rng.uniform(0.5, 1.5, (M, M))
                               .astype(np.float32)))
    model = model._replace(sp_cache=jops.compute_sp_transforms_all_frames(
        cfg, model.params, model.train_times))
    mu = jax.tree.map(lambda x: jnp.asarray(f(*x.shape)), model.params)
    nu = jax.tree.map(lambda x: jnp.asarray(np.abs(f(*x.shape))),
                      model.params)
    return cfg, model, joptim.AdamState(mu=mu, nu=nu,
                                        count=jnp.asarray(5, jnp.int32))


def port_of(cfg, model, opt, tmp_path):
    """The port's model and Adam state of a JAX pair, through a
    checkpoint file."""
    path = tmp_path / 'ckpt.npz'
    save_pytree({'state': {'model': model, 'opt': opt}}, path)
    flat = convert.load_npz(path)
    tmodel = convert.model_from_flat(
        flat, tsk_gs.SKGSConfig(**to_port_cfg_fields(cfg)),
        port_cfg(make_view_cfg()), device='cpu', trainable=True)
    return tmodel, convert.optimizer_from_flat(flat, tmodel, 'adam')


def check_state(tmodel, topt, model, opt, names=None, atol=ATOL):
    """Every leaf, buffer and moment of the port against the JAX pair."""
    tflat = convert.model_to_flat(tmodel)
    jflat = _flatten(model)
    for name, v in tflat.items():
        if names is not None and name not in names:
            continue
        if v.dtype == bool or np.issubdtype(v.dtype, np.integer):
            np.testing.assert_array_equal(v, jflat[name], name)
        else:
            close(v, jflat[name], atol, name)
    for moment in ('mu', 'nu'):
        ref = _flatten(getattr(opt, moment))
        for name, v in getattr(topt, moment).items():
            close(v, ref[name], atol, f'{moment}/{name}')


@pytest.mark.parametrize('branch', ['main', 'canonical', 'largest'])
def test_sp_stage_matches_jax(branch, tmp_path):
    cfg, model, opt = jax_sp_model(warp_method='largest'
                                   if branch == 'largest' else 'LBS')
    tmodel, _ = port_of(cfg, model, opt, tmp_path)
    tcfg = tmodel.cfg
    rng = np.random.default_rng(4)
    t = np.float32(0.37)
    w0, i0 = jsk_gs.lbs_weights(cfg, model.params, model.sp_alive,
                                model.params['xyz'])
    tw0, ti0 = tsk_gs.lbs_weights(tcfg, tmodel.params, tmodel.sp_alive,
                                  tmodel.params['xyz'])
    np.testing.assert_array_equal(to_np(ti0), np.asarray(i0))
    close(tw0, w0)
    sp_pts = rng.normal(size=(M, 3)).astype(np.float32) * 0.5
    canonical = branch == 'canonical'

    def jfn(params):
        kw = {}
        if canonical:
            w, i = jsk_gs.lbs_weights(cfg, params, model.sp_alive,
                                      params['xyz'])
            kw = dict(use_canonical=True, frozen_weights=w, frozen_knn=i,
                      sp_points=jnp.asarray(sp_pts))
        out = jsk_gs.sp_stage(cfg, params, model.sp_alive, params['xyz'],
                              jnp.asarray(t), **kw)
        return out.d_xyz, out.d_rotation, out.d_scaling, out.aux['cache_row']

    ref, vjp = jax.vjp(jfn, model.params)
    kw = {}
    if canonical:
        w, i = tsk_gs.lbs_weights(tcfg, tmodel.params, tmodel.sp_alive,
                                  tmodel.params['xyz'])
        kw = dict(use_canonical=True, frozen_weights=w, frozen_knn=i,
                  sp_points=t_(sp_pts))
    out = tsk_gs.sp_stage(tcfg, tmodel, tmodel.params['xyz'], torch.tensor(t),
                          **kw)
    got = (out.d_xyz, out.d_rotation, out.d_scaling, out.aux['cache_row'])
    cts = [rng.normal(size=np.shape(r)).astype(np.float32) for r in ref]
    for g, r, name in zip(got, ref, ('d_xyz', 'd_rotation', 'd_scaling',
                                     'cache_row')):
        assert np.abs(np.asarray(r)).max() > 1e-3, name
        close(g, r, err_msg=name)
    if branch == 'largest':
        p2sp = np.take_along_axis(np.asarray(i0),
                                  np.asarray(w0).argmax(-1)[:, None], 1)[:, 0]
        np.testing.assert_array_equal(to_np(out.aux['p2sp']), p2sp)
    torch.autograd.backward(got, [t_(c) for c in cts])
    g_ref = _flatten(vjp(tuple(jnp.asarray(c) for c in cts))[0])
    checked = 0
    for name, p in tmodel.leaves().items():
        r = g_ref[name]
        if not np.abs(r).max() > 0:
            assert p.grad is None or not p.grad.any(), name
            continue
        close_grad(p.grad, r, name)
        checked += 1
    net = 'canonical/' if canonical else 'sp_deform/'
    assert any(k.startswith(net) for k in g_ref if np.abs(g_ref[k]).max())
    assert checked >= 4


def test_forward_deltas_sp_fix_detaches(tmp_path):
    cfg, model, opt = jax_sp_model()
    tmodel, _ = port_of(cfg, model, opt, tmp_path)
    t = torch.tensor(0.6)
    fix = tsk_gs.forward_deltas(tmodel.cfg, tmodel, t, 'sp_fix')
    sp = tsk_gs.forward_deltas(tmodel.cfg, tmodel, t, 'sp')
    ref = jsk_gs.forward_deltas(cfg, model, jnp.asarray(0.6), 'sp_fix')
    for name in ('d_xyz', 'd_rotation', 'd_scaling'):
        assert not getattr(fix, name).requires_grad, name
        assert getattr(sp, name).requires_grad, name
        close(getattr(fix, name), getattr(ref, name), err_msg=name)
    assert fix.aux['knn_w'].requires_grad      # the weights still train


# ---------------------------------------------------------------- joints


def test_joint_cost_and_update_joint_match_jax(rng):
    jp = rng.normal(size=(M, M, 3)).astype(np.float32) * 0.3
    spT = np.concatenate([rng.normal(size=(M, 3)).astype(np.float32) * 0.2,
                          unit_quats(rng, M)], -1)
    spT[4] = spT[5]                          # identical: a zero difference
    alive = np.ones(M, bool)
    alive[[2, 9]] = False
    ref, vjp = jax.vjp(lambda j: jskel.joint_cost_matrix(
        j, jnp.asarray(spT), jnp.asarray(alive)), jnp.asarray(jp))
    jpt = t_(jp).requires_grad_(True)
    got = tskel.joint_cost_matrix(jpt, t_(spT), t_(alive))
    fin = np.isfinite(np.asarray(ref))
    np.testing.assert_array_equal(np.isfinite(to_np(got)), fin)
    close(to_np(got)[fin], np.asarray(ref)[fin])
    ct = np.where(fin, rng.normal(size=(M, M)), 0.0).astype(np.float32)
    got.backward(t_(ct))
    assert np.isfinite(to_np(jpt.grad)).all()
    close_grad(jpt.grad, vjp(jnp.asarray(ct))[0], 'joint_pos')

    cost = np.where(fin, np.asarray(ref), 0.0).astype(np.float32)
    sp_pts = rng.normal(size=(M, 3)).astype(np.float32)
    for k in (6, 0, 20):
        parents, depth, root = jskel.update_joint(
            jnp.asarray(cost), jnp.asarray(sp_pts), jnp.asarray(alive), k)
        tp, td, tr = tskel.update_joint(t_(cost), t_(sp_pts), t_(alive), k)
        np.testing.assert_array_equal(to_np(tp), np.asarray(parents))
        np.testing.assert_array_equal(to_np(td), np.asarray(depth))
        assert int(tr) == int(root)
        assert tp.dtype == td.dtype == tr.dtype == torch.int32
    # the numpy copy against the JAX package's own numpy path and native
    for use_native in (False, True):
        ref = jskel.joint_discovery_host(cost, alive, use_native=use_native)
        got = tskel.joint_discovery_host(cost, alive)
        for a, b in zip(got[:2], ref[:2]):
            np.testing.assert_array_equal(a, b)
        assert got[2] == ref[2]


# ---------------------------------------------------------------- masks


def test_adjust_masks_match_jax(tmp_path):
    cfg, model, opt = jax_sp_model()
    tmodel, _ = port_of(cfg, model, opt, tmp_path)
    w, i = jsk_gs.lbs_weights(cfg, model.params, model.sp_alive,
                              model.params['xyz'])
    w = w * model.alive[:, None]
    args = (model.sp_alive, model.xyz_grad_accum, model.denom,
            model.params['xyz'])
    tw, ti = tsk_gs.lbs_weights(tmodel.cfg, tmodel.params, tmodel.sp_alive,
                                tmodel.params['xyz'])
    tw = tw.detach() * tmodel.alive[:, None]
    targs = (tmodel.sp_alive, tmodel.xyz_grad_accum, tmodel.denom,
             tmodel.params['xyz'].detach())
    for prune_thr, split_thr in ((0.5, 0.05), (3.0, 1e9), (1e-3, 0.0)):
        ref = jsp.superpoint_prune_split_masks(w, i, *args, prune_thr,
                                               split_thr, M)
        got = tsp.superpoint_prune_split_masks(tw, ti, *targs, prune_thr,
                                               split_thr, M)
        for a, b in zip(got[:2], ref[:2]):
            np.testing.assert_array_equal(to_np(a), np.asarray(b))
        close(got[2], ref[2])
    assert np.asarray(ref[1]).any()
    md, mi = jsp.superpoint_merge_masks(
        model.params['sp_points'], model.sp_alive, model.sp_cache, 5, 0.0)
    tmd, tmi = tsp.superpoint_merge_masks(
        tmodel.params['sp_points'].detach(), tmodel.sp_alive,
        tmodel.sp_cache, 5)
    np.testing.assert_array_equal(to_np(tmi), np.asarray(mi))
    fin = np.isfinite(np.asarray(md))
    np.testing.assert_array_equal(np.isfinite(to_np(tmd)), fin)
    close(to_np(tmd)[fin], np.asarray(md)[fin])


# ---------------------------------------------------------------- events


def test_init_superpoints_matches_jax(tmp_path):
    cfg, model, opt = jax_sp_model(1)
    cfg = cfg._replace(init_num_times=4)
    tmodel, topt = port_of(cfg, model, opt, tmp_path)
    traj = jops.sample_trajectories(cfg, model)
    ttraj = tops.sample_trajectories(tmodel.cfg._replace(init_num_times=4),
                                     tmodel)
    close(ttraj, traj)
    picks = np.asarray(jknn.furthest_point_sampling(traj, M, model.alive))
    assert fps_gaps(np.asarray(traj), np.asarray(model.alive),
                    picks).min() > 1e-5
    model2, opt2 = jops.init_superpoints(cfg, model, opt,
                                         jax.random.PRNGKey(0))
    idx = tops.init_superpoints(tmodel.cfg._replace(init_num_times=4), tmodel,
                                topt)
    np.testing.assert_array_equal(to_np(idx), picks)
    assert int(tmodel.alive.sum()) == M and bool(tmodel.sp_alive.all())
    assert int(tmodel.active_sh_degree) == 0
    check_state(tmodel, topt, model2, opt2)


def test_reinit_at_sp_fix_matches_jax(tmp_path):
    cfg, model, opt = jax_sp_model(2)
    tmodel, topt = port_of(cfg, model, opt, tmp_path)
    rng = np.random.default_rng(5)
    pts = rng.uniform(-1.0, 1.0, size=(230, 3)).astype(np.float32)
    cols = rng.uniform(size=(230, 3)).astype(np.float32)
    model2, opt2 = jops.reinit_gaussians_at_sp_fix(cfg, model, opt, pts, cols)
    tops.reinit_gaussians_at_sp_fix(tmodel.cfg, tmodel, topt, pts, cols)
    assert int(tmodel.alive.sum()) == 230
    w = to_np(tmodel.params['sp_W'])
    np.testing.assert_allclose(np.sort(w, -1)[:, -1], np.log(36.0), rtol=1e-6)
    assert ((w > 0).sum(-1) == 1).all()
    # the log-scales carry the 1e-4 of the mean distance (test_torch_init)
    check_state(tmodel, topt, model2, opt2, atol=1e-4)


@pytest.mark.parametrize('thresholds', [(12.0, 1e-3), (1e-3, 0.0)])
def test_superpoint_prune_split_matches_jax(tmp_path, thresholds):
    cfg, model, opt = jax_sp_model(3)
    cfg = cfg._replace(sp_prune_threshold=thresholds[0],
                       sp_split_threshold=thresholds[1])
    tmodel, topt = port_of(cfg, model, opt, tmp_path)
    model2, opt2, stats = jops.superpoint_prune_split(cfg, model, opt)
    got = tops.superpoint_prune_split(tmodel.cfg._replace(
        sp_prune_threshold=thresholds[0], sp_split_threshold=thresholds[1]),
        tmodel, topt)
    assert {k: int(v) for k, v in got.items()} == \
        {k: int(v) for k, v in stats.items()}
    assert int(stats['n_split']) > 0
    if thresholds[0] > 1.0:
        assert int(stats['n_pruned']) > 0
    else:   # every kept superpoint splits: more than the dead slots
        assert int(stats['n_split']) < int(np.asarray(model.sp_alive).sum())
    check_state(tmodel, topt, model2, opt2)


def test_superpoint_merge_matches_jax(tmp_path):
    cfg, model, opt = jax_sp_model(4)
    tmodel, topt = port_of(cfg, model, opt, tmp_path)
    md, _ = jsp.superpoint_merge_masks(model.params['sp_points'],
                                       model.sp_alive, model.sp_cache, 5, 0.0)
    thr = float(np.quantile(np.asarray(md)[np.isfinite(np.asarray(md))], 0.6))
    cfg = cfg._replace(sp_merge_threshold=thr)
    model2, opt2, stats = jops.superpoint_merge(cfg, model, opt,
                                                jax.random.PRNGKey(0))
    got = tops.superpoint_merge(tmodel.cfg._replace(sp_merge_threshold=thr),
                                tmodel)
    assert int(got['n_merged']) == int(stats['n_merged']) > 0
    check_state(tmodel, topt, model2, opt2)
