"""Port parity, the ``static`` / ``init`` training families: KNN, the point
cloud start, the warp net, adaptive density control, the optimizer surgery
and the ``init_fix`` -> ``init`` trainer, against the JAX package.

The trainer comparison runs the JAX trainer's own jitted ``train_step`` on
the ``chunk`` schedule (``tile_kernel.IMPL['schedule'] = 'chunk'``, Pallas
in interpret mode, a chunk that holds each tile's list) against the port
on ``RasterConfig(schedule='chunk')``, over 3 steps: two ``init_fix`` steps,
a densify / prune event after the second, and one ``init`` step, with the
opacity reset after it. The event is made clone-only by a large
``cameras_extent`` (every Gaussian counts as small, so no split noise is
drawn) and deterministic by a zero gradient threshold (every live
Gaussian is selected, so the 56 dead slots fill in row order and the rest
is dropped). Tolerances are those of test_torch_train.py (losses rtol
2e-4; parameters, where a leaf's gradient exceeds 1e-3 of its max, within
1e-5 of the leaf's magnitude plus 1% of the leaf's Adam step per step, and
within 2 lr per step elsewhere), ``alive`` exactly.

Units: KNN distances rtol 1e-5, and 1e-4 for the mean distance to the 3
nearest points (|x|^2 + |y|^2 - 2 x.y: a near neighbour's squared distance
is the difference of terms ~10x its size, rounded in another order); the
warp net 1e-5; densify / prune with the JAX key's noise fed in,
row for row, 1e-6 (the quaternion rotation of the offsets rounds in another
order); the surgery exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sk_gs_tpu.render.tile_kernel as jtk
from sk_gs_tpu.data import synthetic as jsynth
from sk_gs_tpu.framework import trainer as jtrainer
from sk_gs_tpu.framework.checkpoint import _flatten, save_pytree
from sk_gs_tpu.models import deform as jdeform
from sk_gs_tpu.models import gaussian_splatting as jgs
from sk_gs_tpu.models import losses as jlosses
from sk_gs_tpu.models import optim as joptim
from sk_gs_tpu.models import sk_gs as jsk_gs
from sk_gs_tpu.ops import knn as jknn
from sk_gs_tpu_torch import convert
from sk_gs_tpu_torch.data.base import SceneMeta
from sk_gs_tpu_torch.framework import trainer as ttrainer
from sk_gs_tpu_torch.framework.presets import (flagship_point_cloud,
                                               synthetic_fullscale)
from sk_gs_tpu_torch.models import deform as tdeform
from sk_gs_tpu_torch.models import gaussian_splatting as tgs
from sk_gs_tpu_torch.models import losses as tlosses
from sk_gs_tpu_torch.models import optim as toptim
from sk_gs_tpu_torch.models import sk_gs as tsk_gs
from sk_gs_tpu_torch.ops import knn as tknn
from tests.test_torch_cli import one_torch_thread  # noqa: F401
from tests.test_torch_render import port_cfg, to_np
from tests.test_torch_slice import FRAMES, tiny_cfg, to_port_cfg_fields
from tests.test_torch_train import SCENE, close_rel, port_scene

LOSS = {'image': {'method': 'l1', 'lambda': 0.8}, 'ssim': 0.2, 'c_net': 1.0}


def t_(x, dtype=None):
    t = torch.from_numpy(np.array(x))
    return t if dtype is None else t.to(dtype)


# ---------------------------------------------------------------- knn


def test_knn_matches_jax(rng):
    q = rng.normal(size=(300, 3)).astype(np.float32)
    p = rng.normal(size=(500, 3)).astype(np.float32)
    d_ref, i_ref = jknn.knn(jnp.asarray(q), jnp.asarray(p), 5, chunk=128)
    d, i = tknn.knn(torch.from_numpy(q), torch.from_numpy(p), 5, chunk=128)
    np.testing.assert_array_equal(to_np(i), np.asarray(i_ref))
    np.testing.assert_allclose(to_np(d), np.asarray(d_ref), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(
        to_np(tknn.sq_cdist(torch.from_numpy(q), torch.from_numpy(p))),
        np.asarray(jknn.sq_cdist(jnp.asarray(q), jnp.asarray(p))),
        rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize('masked', [False, True])
def test_mean_knn_dist2_matches_jax(rng, masked):
    pts = rng.uniform(-1.3, 1.3, size=(700, 3)).astype(np.float32)
    mask = rng.uniform(size=700) > 0.3 if masked else None
    ref = jknn.mean_knn_dist2(jnp.asarray(pts), k=3, chunk=256,
                              mask=None if mask is None else jnp.asarray(mask))
    got = tknn.mean_knn_dist2(torch.from_numpy(pts), k=3, chunk=256,
                              mask=None if mask is None
                              else torch.from_numpy(mask))
    live = np.ones(700, bool) if mask is None else mask
    np.testing.assert_allclose(to_np(got)[live], np.asarray(ref)[live],
                               rtol=1e-4)


# ---------------------------------------------------------------- the start


def test_init_from_pcd_matches_jax():
    cfg, _, train = synthetic_fullscale()
    gcfg = cfg.gauss._replace(capacity=2500)
    pts, cols = flagship_point_cloud(train)
    ref = jgs.init_from_pcd(pts, cols, jgs.GaussianConfig(*gcfg))
    got = tgs.init_from_pcd(pts, cols, gcfg, device='cpu')
    assert pts.shape == (2000, 3) and pts.min() >= -1.3 and pts.max() <= 1.3
    for name, v in ref.params.items():
        # the log-scales carry half the 1e-4 of the mean distances
        np.testing.assert_allclose(to_np(got.params[name]), np.asarray(v),
                                   rtol=1e-5, atol=1e-4 if name == 'scaling'
                                   else 1e-6, err_msg=name)
    np.testing.assert_array_equal(to_np(got.alive), np.asarray(ref.alive))
    assert int(got.active_sh_degree) == 0
    with pytest.raises(ValueError, match='capacity'):
        tgs.init_from_pcd(pts, cols, gcfg._replace(capacity=100), device='cpu')


def jax_net_flat(cfg, key, prefix):
    return _flatten(jdeform.deform_net_init(key, cfg), prefix)


@pytest.mark.parametrize('variant', ['blender', 'sep_rot_max_scale'])
def test_deform_net_matches_jax(rng, variant):
    cfg = jdeform.DeformNetConfig(depth=4, width=64)
    if variant != 'blender':
        cfg = cfg._replace(is_blender=False, sep_rot=True, max_d_scale=1.5)
    params = jdeform.deform_net_init(jax.random.PRNGKey(3), cfg)
    heads = [h for h in ('warp', 'scaling', 'rotation', 'local_rotation')
             if h in params]
    for h in heads:   # heads with weight, so the outputs are not ~0
        params[h] = {'w': jnp.asarray(rng.normal(size=params[h]['w'].shape)
                                      .astype(np.float32) * 0.1),
                     'b': params[h]['b']}
    tcfg = tdeform.DeformNetConfig(*cfg)
    net = convert.deform_net_from_flat(_flatten(params, 'n/'), tcfg, 'n/',
                                       device='cpu')
    x = rng.normal(size=(50, 3)).astype(np.float32)
    for t in (np.float32(0.37), rng.uniform(size=(50, 1)).astype(np.float32)):
        ref = jdeform.deform_net_apply(params, cfg, jnp.asarray(x),
                                       jnp.asarray(t))
        got = tdeform.deform_net_apply(net, tcfg, torch.from_numpy(x),
                                       torch.as_tensor(t))
        assert set(got) == set(ref)
        for name in ref:
            assert np.abs(np.asarray(ref[name])).max() > 1e-3, name
            np.testing.assert_allclose(to_np(got[name]), np.asarray(ref[name]),
                                       atol=1e-5, err_msg=name)
    # bfloat16 builds (its parity: test_torch_train_options.py); a dtype the
    # JAX package's nets do not compute in is refused
    tdeform.DeformNet(tcfg._replace(compute_dtype='bfloat16'))
    with pytest.raises(ValueError, match='compute_dtype'):
        tdeform.DeformNet(tcfg._replace(compute_dtype='float16'))


def test_deform_net_init_distributions():
    cfg = tdeform.DeformNetConfig()
    net = tdeform.deform_net_init(cfg, torch.Generator().manual_seed(0))
    ref = jax_net_flat(jdeform.DeformNetConfig(*cfg), jax.random.PRNGKey(0),
                       '')
    got = {k.replace('.', '/'): v.detach() for k, v in net.named_parameters()}
    assert {k: tuple(v.shape) for k, v in got.items()} == \
        {k: v.shape for k, v in ref.items()}
    for name, w in got.items():
        r = ref[name]
        if name.endswith('/b'):
            assert not w.any() and not r.any(), name
            continue
        fan_in = w.shape[0]
        head = name.split('/')[0]
        if head in tdeform.HEAD_STD:
            std = tdeform.HEAD_STD[head]
            assert float(w.std()) == pytest.approx(std, rel=0.15), name
        else:
            bound = np.sqrt(6.0 / fan_in)
            assert float(w.abs().max()) <= bound
            assert float(w.abs().max()) > 0.95 * bound
            # the same uniform law as the JAX init
            assert float(w.std()) == pytest.approx(float(r.std()), rel=0.05)


def test_init_model_matches_jax_layout():
    jcfg = tiny_cfg()
    cfg = tsk_gs.SKGSConfig(**to_port_cfg_fields(jcfg))
    rcfg = port_cfg(jax_rcfg())
    pts, cols = flagship_point_cloud(synthetic_fullscale()[2])
    pts, cols = pts[:200], cols[:200]
    times = np.linspace(0.0, 1.0, FRAMES).astype(np.float32)
    ref = jsk_gs.init_model(jax.random.PRNGKey(0), jcfg,
                            jgs.init_from_pcd(pts, cols, jcfg.gauss), times)
    base = tgs.init_from_pcd(pts, cols, cfg.gauss, device='cpu')
    model = tsk_gs.init_model(cfg, rcfg, base, times, seed=0, device='cpu')
    again = tsk_gs.init_model(cfg, rcfg, base, times, seed=0, device='cpu')
    got = convert.model_to_flat(model)
    jflat = _flatten(ref)
    for name, v in got.items():
        assert name in jflat, name
        assert v.shape == jflat[name].shape, name
    assert {k for k in jflat if k.startswith('params/')} == \
        {k for k in got if k.startswith('params/')}
    random_leaves = ('params/sp_points',)
    for name, v in got.items():
        if name.startswith(('params/sp_deform', 'params/canonical',
                            'params/sk_deform')) or name in random_leaves:
            np.testing.assert_array_equal(v, convert.model_to_flat(again)[name])
            continue
        np.testing.assert_allclose(v, jflat[name], rtol=1e-5, atol=1e-6,
                                   err_msg=name)
    assert all(p.requires_grad for p in model.leaves().values())


# ---------------------------------------------------------------- control


def control_case(rng, cap=64, n_alive=40):
    """A JAX GaussianModel with row leaves beyond the six (sp_W, hyper),
    statistics that select some rows, and Adam moments that are not zero."""
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    alive = np.zeros(cap, bool)
    alive[rng.permutation(cap)[:n_alive]] = True
    params = {
        'xyz': f(cap, 3), 'f_dc': f(cap, 1, 3), 'f_rest': f(cap, 15, 3),
        'scaling': np.log(np.where(rng.uniform(size=(cap, 1)) < 0.5,
                                   rng.uniform(0.001, 0.009, (cap, 3)),
                                   rng.uniform(0.012, 0.05, (cap, 3))))
        .astype(np.float32),
        'rotation': f(cap, 4), 'opacity': (f(cap, 1) * 3.0),
        'sp_W': f(cap, 8), 'hyper': f(cap, 4), 'joints': f(5, 3),
    }
    m = jgs.GaussianModel(
        params={k: jnp.asarray(v) for k, v in params.items()},
        alive=jnp.asarray(alive), active_sh_degree=jnp.asarray(3, jnp.int32),
        max_radii2d=jnp.asarray(rng.uniform(0, 40, cap).astype(np.float32)),
        xyz_grad_accum=jnp.asarray(rng.uniform(0, 1e-3, cap)
                                   .astype(np.float32)),
        denom=jnp.asarray(rng.integers(0, 4, cap).astype(np.float32)))
    mu = {k: jnp.asarray(f(*v.shape)) for k, v in params.items()}
    nu = {k: jnp.asarray(np.abs(f(*v.shape))) for k, v in params.items()}
    return m, joptim.AdamState(mu=mu, nu=nu, count=jnp.asarray(7, jnp.int32))


def port_model_state(m, opt):
    pm = tgs.GaussianModel(
        params={k: t_(v) for k, v in m.params.items()}, alive=t_(m.alive),
        active_sh_degree=t_(m.active_sh_degree),
        max_radii2d=t_(m.max_radii2d), xyz_grad_accum=t_(m.xyz_grad_accum),
        denom=t_(m.denom))
    po = toptim.AdamState(mu={k: t_(v) for k, v in opt.mu.items()},
                          nu={k: t_(v) for k, v in opt.nu.items()},
                          count=int(opt.count))
    return pm, po


@pytest.mark.parametrize('n_alive,do_d,do_p,size_thr', [
    (40, True, True, 20.0),     # enough dead slots
    (58, True, True, 0.0),      # the capacity fills: selected rows dropped
    (40, False, True, 20.0),    # prune only
    (40, True, False, 0.0)])    # densify only
def test_densify_and_prune_matches_jax(rng, n_alive, do_d, do_p, size_thr):
    m, opt = control_case(rng, n_alive=n_alive)
    gcfg = jgs.GaussianConfig(densify_grad_threshold=2e-4)
    extent = 1.0
    key = jax.random.PRNGKey(11)
    m2, opt2, stats = jgs.densify_and_prune(
        m, opt, gcfg, extent, key, jnp.asarray(do_d), jnp.asarray(do_p),
        jnp.asarray(size_thr, jnp.float32))
    _, k1, k2 = jax.random.split(key, 3)
    noise = [t_(jax.random.normal(k, (64, 3))) for k in (k1, k2)]
    pm, po = port_model_state(m, opt)
    got = tgs.densify_and_prune_noise(
        pm, po, tgs.GaussianConfig(*gcfg), extent, *noise, do_d, do_p,
        size_thr)
    for name in ('n_cloned', 'n_split', 'n_pruned', 'n_dropped'):
        assert int(got[name]) == int(stats[name]), name
    if do_d:
        assert int(stats['n_cloned']) > 0 and int(stats['n_split']) > 0
    if do_p:
        assert int(stats['n_pruned']) > 0
    if n_alive == 58:
        assert int(stats['n_dropped']) > 0
    np.testing.assert_array_equal(to_np(pm.alive), np.asarray(m2.alive))
    for name, v in m2.params.items():
        np.testing.assert_allclose(to_np(pm.params[name]), np.asarray(v),
                                   rtol=1e-6, atol=1e-6, err_msg=name)
    for name in ('max_radii2d', 'xyz_grad_accum', 'denom'):
        np.testing.assert_array_equal(to_np(getattr(pm, name)),
                                      np.asarray(getattr(m2, name)), name)
    for moment in ('mu', 'nu'):
        for name, v in getattr(opt2, moment).items():
            np.testing.assert_array_equal(to_np(getattr(po, moment)[name]),
                                          np.asarray(v), f'{moment}/{name}')


def test_densify_draws_its_noise_from_the_generator(rng):
    m, opt = control_case(rng)
    runs = []
    for _ in range(2):
        pm, po = port_model_state(m, opt)
        tgs.densify_and_prune(pm, po, tgs.GaussianConfig(), 1.0,
                              torch.Generator().manual_seed(5), True, True,
                              20.0)
        runs.append(to_np(pm.params['xyz']))
    np.testing.assert_array_equal(runs[0], runs[1])
    assert not np.array_equal(runs[0], np.asarray(m.params['xyz']))


def test_reset_opacity_and_surgery_match_jax(rng):
    m, opt = control_case(rng)
    m2, opt2 = jgs.reset_opacity(m, opt)
    pm, po = port_model_state(m, opt)
    tgs.reset_opacity(pm, po)
    np.testing.assert_allclose(to_np(pm.params['opacity']),
                               np.asarray(m2.params['opacity']), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_array_equal(to_np(po.mu['opacity']),
                                  np.asarray(opt2.mu['opacity']))
    rows = rng.uniform(size=64) > 0.5
    ref = joptim.reset_leaf(joptim.reset_rows(opt, 'sp_W', jnp.asarray(rows)),
                            'xyz')
    _, po = port_model_state(m, opt)
    toptim.reset_rows(po, 'sp_W', torch.from_numpy(rows))
    toptim.reset_leaf(po, 'xyz')
    for moment in ('mu', 'nu'):
        for name, v in getattr(ref, moment).items():
            np.testing.assert_array_equal(to_np(getattr(po, moment)[name]),
                                          np.asarray(v), f'{moment}/{name}')


def test_check_interval_matches_jax():
    cases = [(s, iv, close) for s in range(0, 40)
             for iv in ((5, 0, -1), (3, 2, 20), (0, 0, -1), (7, 7, 35))
             for close in ('()', '[)', '(]', '[]')]
    for step, iv, close in cases:
        assert ttrainer.check_interval_v2(step, *iv, close=close) == \
            jtrainer.check_interval_v2(step, *iv, close=close)


# ---------------------------------------------------------------- the step


def jax_rcfg():
    from sk_gs_tpu.render import RasterConfig
    # chunk 256 holds every tile's list of this scene (module docstring)
    return RasterConfig(image_width=64, image_height=48, sh_degree=3,
                        pair_capacity=2 ** 14, chunk=256, use_pallas=True)


def init_cfg():
    """tiny_cfg with two init_fix steps, the densify event after step 2
    (every live Gaussian selected) and the opacity reset after step 3."""
    cfg = tiny_cfg()
    return cfg._replace(
        train_schedule=(('static', 0), ('init_fix', 2), ('init', 8000),
                        ('sp_fix', 3000), ('sp', 27000), ('sk_init', 0),
                        ('sk_fix', 0), ('sk', 40000)),
        gauss=cfg.gauss._replace(densify_grad_threshold=0.0,
                                 init_densify_prune_interval=(2, 0, -1),
                                 init_opacity_reset_interval=(3, 0, -1)))


@pytest.fixture(scope='module')
def chunk_interpret():
    old = jtk.INTERPRET, jtk.IMPL['schedule']
    jtk.INTERPRET, jtk.IMPL['schedule'] = True, 'chunk'
    yield
    jtk.INTERPRET, jtk.IMPL['schedule'] = old


@pytest.fixture(scope='module')
def three_init_steps(chunk_interpret, tmp_path_factory):
    cfg, rcfg = init_cfg(), jax_rcfg()
    scene, meta, _ = jsynth.make_synthetic_scene(chunk=256, use_pallas=True,
                                                 **SCENE)
    meta.cameras_extent = 1e4            # every Gaussian is small: clones
    rng = np.random.default_rng(0)
    pts = rng.uniform(-0.8, 0.8, size=(200, 3)).astype(np.float32)
    cols = rng.uniform(size=(200, 3)).astype(np.float32)
    model = jsk_gs.init_model(jax.random.PRNGKey(0), cfg,
                              jgs.init_from_pcd(pts, cols, cfg.gauss),
                              np.asarray(meta.train_times))
    jt = jtrainer.SKGSTrainer(cfg, rcfg, scene, meta, model,
                              loss_weights=jlosses.LossWeights(LOSS))
    tmp = tmp_path_factory.mktemp('init')
    save_pytree({'state': {'model': model}}, tmp / 'model.npz')
    tcfg = tsk_gs.SKGSConfig(**to_port_cfg_fields(cfg))
    trcfg = port_cfg(rcfg)._replace(schedule='chunk')
    tmodel = convert.model_from_flat(convert.load_npz(tmp / 'model.npz'),
                                     tcfg, trcfg, device='cpu',
                                     trainable=True)
    tt = ttrainer.SKGSTrainer(tcfg, trcfg, port_scene(scene),
                              SceneMeta(background=meta.background,
                                        cameras_extent=1e4),
                              tmodel, tlosses.LossWeights(LOSS), device='cpu')
    snaps = {}
    for step in (1, 2, 3):
        jm = {n: np.asarray(v) for n, v in jt.train_step(step).items()}
        tm = {n: to_np(v) for n, v in tt.train_step(step).items()}
        grads = {n: to_np(p.grad).copy()
                 for n, p in tt.model.leaves().items()}
        snaps[step] = dict(
            jax=jm, port=tm, grads=grads, lrs=tt.lr_trees(step),
            event={k: int(v) for k, v in tt.last_event.items()},
            jflat=_flatten(jt.state.model),
            tflat=convert.model_to_flat(tt.model),
            jopt=_flatten(jt.state.opt_state),
            # copies: the moments are updated in place
            topt={f'{m}/{k}': to_np(v).copy() for m in ('mu', 'nu')
                  for k, v in getattr(tt.opt_state, m).items()})
    save_pytree({'state': jt.ckpt_state()}, tmp / 'trainer.npz')
    return snaps, tt, jt, tmp / 'trainer.npz'


@pytest.mark.parametrize('step', [1, 2, 3])
def test_init_steps_match_jax_trainer(three_init_steps, step):
    snaps, _, _, _ = three_init_steps
    s = snaps[step]
    jm, tm = s['jax'], s['port']
    assert set(jm) == set(tm) >= {'c_net', 'rgb', 'ssim'}
    for name in ('n_bad_grad', 'n_vis', 'num_pairs', 'overflow'):
        assert int(tm[name]) == int(jm[name]), name
    assert int(tm['num_pairs']) > 500 and int(tm['n_vis']) > 100
    for name in ('loss', 'rgb', 'ssim', 'c_net'):
        np.testing.assert_allclose(tm[name], jm[name], rtol=2e-4,
                                   err_msg=name)
    assert tm['c_net'] > 0 if step > 1 else True
    np.testing.assert_allclose(tm['psnr'], jm['psnr'], rtol=1e-5)
    np.testing.assert_allclose(tm['dxyz_max'], jm['dxyz_max'], rtol=1e-3)

    jflat, tflat = s['jflat'], s['tflat']
    np.testing.assert_array_equal(tflat['alive'], jflat['alive'])
    for name in ('max_radii2d', 'denom'):
        np.testing.assert_array_equal(tflat[name], jflat[name], err_msg=name)
    close_rel(tflat['xyz_grad_accum'], jflat['xyz_grad_accum'], 1e-3,
              'xyz_grad_accum')
    for name, lr in s['lrs'].items():
        got, ref = tflat['params/' + name], jflat['params/' + name]
        g = np.abs(s['grads'][name])
        big = g > 1e-3 * g.max()
        err = np.abs(got - ref)
        tol_big = 1e-5 * np.abs(ref).max() + 0.01 * lr * step
        assert err[big].max(initial=0.0) <= tol_big, name
        assert err.max() <= 2 * lr * step + 1e-5 * np.abs(ref).max(), name
    # the Gaussian rows whose moments are zero (unseen, or new and
    # replaced rows after the event) are the same on both sides
    for moment in ('mu', 'nu'):
        for name in ('xyz', 'f_dc', 'opacity', 'scaling', 'hyper', 'sp_W'):
            key = f'{moment}/{name}'
            zero = lambda x: ~x.reshape(x.shape[0], -1).any(-1)
            np.testing.assert_array_equal(zero(s['topt'][key]),
                                          zero(s['jopt'][key]), key)


def test_init_event_clones_and_resets(three_init_steps):
    snaps, _, _, _ = three_init_steps
    assert snaps[1]['event'] == {}
    ev = snaps[2]['event']
    alive1, alive2 = snaps[1]['tflat']['alive'], snaps[2]['tflat']['alive']
    n_dead = int((~alive1).sum())
    assert ev == {'n_cloned': n_dead, 'n_split': 0, 'n_pruned': 0,
                  'n_dropped': int(alive1.sum()) - n_dead}
    assert alive2.all() and not snaps[2]['jflat']['denom'].any()
    # the first live rows, in row order, were copied into the dead slots
    src = np.flatnonzero(alive1)[:n_dead]
    dst = np.flatnonzero(~alive1)
    before = snaps[2]['tflat']
    np.testing.assert_array_equal(before['params/f_dc'][dst],
                                  before['params/f_dc'][src])
    assert snaps[3]['event'] == {'opacity_reset': 1}
    op = snaps[3]['tflat']['params/opacity']
    assert float(op.max()) <= float(np.log(0.01 / 0.99)) + 1e-5
    assert not snaps[3]['topt']['mu/opacity'].any()


def test_init_lr_trees_match_jax(three_init_steps):
    snaps, _, jt, _ = three_init_steps
    for step in (1, 3):
        got = snaps[step]['lrs']
        assert {'sp_deform/trunk/0/w', 'canonical/warp/b', 'hyper',
                'sp_points', 'joint_pos'} <= set(got)
        ref = {k: float(v) for k, v in _flatten(jt.lr_trees(step)).items()}
        assert set(got) == set(ref)
        for name, lr in got.items():
            assert lr == pytest.approx(ref[name], rel=1e-12), name


def test_init_adam_state_reads_from_a_trainer_checkpoint(three_init_steps):
    _, tt, _, ckpt = three_init_steps
    flat = convert.load_npz(ckpt)
    model = convert.model_from_flat(flat, tt.model.cfg, tt.model.rcfg,
                                    device='cpu', trainable=True)
    assert set(model.nets()) == {'sk_deform', 'sp_deform', 'canonical'}
    state = convert.optimizer_from_flat(flat, model, 'adam')
    assert state.count == 3
    for name in ('sp_deform/trunk/1/w', 'canonical/timenet/0/w', 'hyper',
                 'sp_W'):
        np.testing.assert_array_equal(to_np(state.mu[name]),
                                      flat['state/opt/mu/' + name])
    for name, p in model.leaves().items():
        np.testing.assert_array_equal(to_np(p),
                                      flat['state/model/params/' + name])


def test_trainer_refuses_the_init_parts_not_ported(three_init_steps):
    """Nothing of the init family is refused any more: each of its
    regularizers is computed when it has weight, and a net that is not
    is_blender trains (its noisy time, and the parity of both with the JAX
    trainer: test_torch_regularizers.py and test_torch_train_options.py)."""
    _, tt, _, _ = three_init_steps
    blender = tt.cfg
    try:
        for name in ('elastic', 'acc', 'arap', 'arap_p'):
            tt.loss_w = tlosses.LossWeights({**LOSS, name: 0.1})
            assert tt.family('init') == 'init'
            losses = tt._losses('init', 0, tt.zero_grads(), 4)[0]
            value = losses[name].detach()
            assert torch.isfinite(value) and float(value) > 0
        tt.loss_w = tlosses.LossWeights(LOSS)
        tt.cfg = blender._replace(net=blender.net._replace(is_blender=False))
        for stage in ('init_fix', 'init', 'sp'):
            assert tt.family(stage) in ('init', 'sp')
    finally:
        tt.loss_w = tlosses.LossWeights(LOSS)
        tt.cfg = blender
