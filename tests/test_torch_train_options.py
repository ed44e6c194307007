"""Port parity, the trainer's options: the optimizers (Adan here; every
update rule in test_torch_optim.py) and ``train.precision: bf16`` (the nets
in bfloat16), and the helpers that test_torch_regularizers.py holds a net
that is not ``is_blender`` (the time noise) and ``batch_views`` 3 with:
the port's ``SKGSTrainer.train_step`` against the JAX
trainer's own jitted ``train_step`` on the tiny model of
test_torch_slice.py (256 slots, 16 superpoints, 2 x 32 nets) and the 48 x
64 synthetic scene of test_torch_train.py, the JAX blend through its plain
XLA route (``use_pallas`` False), both from one model: a JAX ``init_model``
start (the init family), a random sp-stage model (``random_model_flat``,
the sp family) or the trained-looking sk model (``tiny_jax_model``).

Both packages get the same random draws: the time noise is one numpy
normal handed to the port's ``draw_time_noise`` and to the JAX stage
functions (``sk_gs.init_stage`` / ``sp_stage`` wrapped to add it: the JAX
trainer's own ``noise_scale > 0`` test is a Python branch on a traced value
and raises under its jit, so the JAX trainer cannot take that branch
itself); the regularizers' uniforms likewise (``draw_uniform``, and
``jax.random.uniform`` inside the JAX step, by shape). The JAX gradients
are captured with ``jax.debug.callback`` around its optimizer update.

Tolerances are test_torch_train.py's: losses and the largest warp
(``dxyz_max``) rtol 2e-4, the SSIM term as its index (1 - loss / weight)
and the total loss within 2e-4 plus the SSIM term's difference
(test_torch_sp.py: the SSIM variances cancel in float32 over a nearly
white image), PSNR 1e-5, gradients 3e-4 of
each leaf's max magnitude (the rotation's of the position gradient's max
in the init family, whose isotropic Gaussians make it rounding noise),
parameters where the gradient exceeds 1e-3 of its leaf's max within 1e-5
of the leaf plus 1% of its step (lr) per step, and within 2 lr per step
elsewhere; the statistics, caches and joint cost as there. bf16 has its own
bar: the nets' products round to bfloat16's 8 mantissa bits (a relative
step of 2^-8 = 3.9e-3) on both sides, but the two frameworks' matrix
products accumulate and round in another order, so single values differ by
a bfloat16 step; losses rtol 2e-3 (PSNR 1e-4) and the nets' gradients 2e-2
of each leaf's max, about five such steps (the parameter bar's settled
entries above that), while the float32 leaves (the Gaussians') keep their
bars; and the port's bf16 nets do round (their outputs differ from
the float32 nets' by more than float32 rounding).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sk_gs_tpu.data import synthetic as jsynth
from sk_gs_tpu.framework import trainer as jtrainer
from sk_gs_tpu.framework.checkpoint import (_flatten, load_into_pytree,
                                            save_pytree)
from sk_gs_tpu.models import deform as jdeform
from sk_gs_tpu.models import gaussian_splatting as jgs
from sk_gs_tpu.models import losses as jlosses
from sk_gs_tpu.models import sk_gs as jsk_gs
from sk_gs_tpu_torch import convert
from sk_gs_tpu_torch.data.base import SceneMeta
from sk_gs_tpu_torch.framework import trainer as ttrainer
from sk_gs_tpu_torch.framework.random_model import random_model_flat
from sk_gs_tpu_torch.models import deform as tdeform
from sk_gs_tpu_torch.models import losses as tlosses
from sk_gs_tpu_torch.models import sk_gs as tsk_gs
from tests.test_torch_cli import one_torch_thread  # noqa: F401
from tests.test_torch_render import port_cfg, to_np
from tests.test_torch_slice import (tiny_cfg, tiny_jax_model,
                                    to_port_cfg_fields)
from tests.test_torch_train import SCENE, port_scene

IMAGE = {'image': {'method': 'l1', 'lambda': 0.8}, 'ssim': 0.2}
# the init family starts at step 5, the sp family at step 21: past the
# joint losses' gate (joint_update_interval[1] = 20), no event around it
INIT_STEP, SP_STEP = 5, 21
NOISE = 1.37        # the time noise's standard normal draw, handed to both
WARP_HEAD = 0.05    # the spread of the warp nets' position heads


def options_cfg(**kw):
    """tiny_cfg on a schedule of 10 init steps and 100 sp steps."""
    return tiny_cfg()._replace(
        train_schedule=(('static', 0), ('init_fix', 0), ('init', 10),
                        ('sp_fix', 0), ('sp', 100), ('sk_init', 0),
                        ('sk_fix', 0), ('sk', 40000)),
        init_sampling_step=1, joint_update_interval=(1000, 20, 1000),
        canonical_replace_steps=(), **kw)


def jax_rcfg():
    from sk_gs_tpu.render import RasterConfig
    return RasterConfig(image_width=64, image_height=48, sh_degree=3,
                        pair_capacity=2 ** 14, chunk=256, use_pallas=False)


@pytest.fixture(scope='module')
def scene():
    scene, meta, _ = jsynth.make_synthetic_scene(chunk=256, use_pallas=False,
                                                 **SCENE)
    return scene, meta


def init_start(cfg, meta):
    """The JAX init_model on 200 random points (test_torch_init.py), its
    warp nets' position heads given weight (``WARP_HEAD``), so that the
    warp, and a shift of its time, move the render."""
    rng = np.random.default_rng(0)
    pts = rng.uniform(-0.8, 0.8, size=(200, 3)).astype(np.float32)
    cols = rng.uniform(size=(200, 3)).astype(np.float32)
    model = jsk_gs.init_model(jax.random.PRNGKey(0), cfg,
                              jgs.init_from_pcd(pts, cols, cfg.gauss),
                              np.asarray(meta.train_times))
    p = dict(model.params)
    for name in ('sp_deform', 'canonical'):
        net = dict(p[name])
        w = net['warp']['w']
        net['warp'] = {'w': jnp.asarray(WARP_HEAD * rng.normal(
            size=w.shape).astype(np.float32)), 'b': net['warp']['b']}
        p[name] = net
    return model._replace(params=p)


def sp_start(cfg, meta, tmp):
    """A random sp-stage model (200 live slots) for both packages."""
    tcfg = tsk_gs.SKGSConfig(**to_port_cfg_fields(cfg))
    flat = random_model_flat(tcfg, 1, n_alive=200, log_scale_mean=-3.0,
                             sp_stage=True)
    flat['sp_alive'][3] = False
    rng = np.random.default_rng(2)
    for head in ('warp', 'rotation'):
        key = f'params/sp_deform/{head}/w'
        flat[key] = (WARP_HEAD * rng.normal(size=flat[key].shape)).astype(
            np.float32)
    np.savez(tmp / 'sp.npz', **flat)
    return load_into_pytree(init_start(cfg, meta), tmp / 'sp.npz')


def hand_draws(mp: pytest.MonkeyPatch, tt, draws, noise):
    """Hand the regularizers' uniforms ``draws`` (by length: the init
    family's rows, elastic's 8 and arap's 2 times) and the time noise's
    draw ``noise`` to the port's trainer ``tt`` and, through ``mp``, to the
    JAX step traced next."""
    if draws is not None:
        tt.draw_uniform = lambda n: torch.from_numpy(draws[n])
        mp.setattr(jax.random, 'uniform', lambda key, shape, *a, **kw:
                   jnp.asarray(draws[shape[0]]))
    if noise is None:
        return
    tt.noise_draws = []
    tt.draw_time_noise = lambda: tt.noise_draws.append(noise) or \
        torch.tensor(noise, dtype=torch.float32)

    def with_noise(orig, n_lead):
        # the JAX stage function with the draw for its key, added as the
        # JAX package adds it, without its Python test of the traced scale
        def fn(cfg, params, *args, **kw):
            key, scale = (list(args[n_lead:]) + [None, 0.0])[:2]
            args = list(args[:n_lead])
            if key is not None and not cfg.net.is_blender:
                args[-1] = args[-1] + jnp.float32(noise) \
                    * cfg.time_interval * scale
            return orig(cfg, params, *args, **kw)
        return fn

    # (points, t) and (sp_alive, points, t) come before the key
    mp.setattr(jsk_gs, 'init_stage', with_noise(jsk_gs.init_stage, 2))
    mp.setattr(jsk_gs, 'sp_stage', with_noise(jsk_gs.sp_stage, 3))


def run_pair(cfg, jmodel, scene, meta, loss, steps, tmp, draws=None,
             noise=None, flags=(), **options):
    """The JAX trainer and the port's, built from ``jmodel``, over
    ``steps``, with ``hand_draws``: per step both metrics, the gradients
    (the JAX step's by callback, the port's leaves'), the learning rates;
    both models after, and the trainers."""
    jt = jtrainer.SKGSTrainer(cfg, jax_rcfg(), scene, meta, jmodel,
                              loss_weights=jlosses.LossWeights(loss),
                              **options)
    for k in flags:
        setattr(jt.state, k, True)
    captured = []
    update = jt.opt_update

    def spy(grads, *a, **kw):
        jax.debug.callback(lambda g: captured.append(_flatten(
            jax.tree.map(np.asarray, g))), grads)
        return update(grads, *a, **kw)

    jt.opt_update = spy
    save_pytree({'state': {'model': jmodel}}, tmp / 'model.npz')
    tcfg = tsk_gs.SKGSConfig(**to_port_cfg_fields(cfg))
    trcfg = port_cfg(jax_rcfg())
    model = convert.model_from_flat(convert.load_npz(tmp / 'model.npz'),
                                    tcfg, trcfg, device='cpu',
                                    trainable=True)
    tt = ttrainer.SKGSTrainer(
        tcfg, trcfg, port_scene(scene),
        SceneMeta(background=meta.background,
                  cameras_extent=meta.cameras_extent),
        model, tlosses.LossWeights(loss), device='cpu',
        **{k: True for k in flags}, **options)
    out = []
    mp = pytest.MonkeyPatch()
    try:
        hand_draws(mp, tt, draws, noise)
        for step in steps:
            jm = {n: np.asarray(v) for n, v in jt.train_step(step).items()}
            jax.effects_barrier()
            tm = {n: to_np(v) for n, v in tt.train_step(step).items()}
            out.append(dict(
                jax=jm, port=tm, jgrads=captured[-1],
                tgrads={n: to_np(p.grad).copy()
                        for n, p in tt.model.leaves().items()},
                lrs=tt.lr_trees(step)))
    finally:
        mp.undo()
    return out, _flatten(jt.state.model), convert.model_to_flat(tt.model), \
        tt, jt


def check_steps(runs, jflat, tflat, loss_rtol=2e-4, grad_tol=3e-4,
                grad_tol_of=None, scale_of=None, losses=()):
    """test_torch_train.py's bars over the steps of ``runs``."""
    grad_tol_of, scale_of = grad_tol_of or {}, scale_of or {}
    for k, s in enumerate(runs):
        jm, tm = s['jax'], s['port']
        assert set(jm) == set(tm) >= set(losses), set(jm) ^ set(tm)
        for name in ('n_bad_grad', 'n_vis', 'num_pairs', 'overflow'):
            assert int(tm[name]) == int(jm[name]), name
        assert int(tm['n_bad_grad']) == 0 and not bool(tm['overflow'])
        for name in ('rgb', 'dxyz_max', *losses):
            np.testing.assert_allclose(tm[name], jm[name], rtol=loss_rtol,
                                       err_msg=name)
        # the SSIM term as its index, and the total within the bar plus the
        # SSIM term's difference (test_torch_sp.py)
        w_ssim = IMAGE['ssim']
        np.testing.assert_allclose(1 - tm['ssim'] / w_ssim,
                                   1 - jm['ssim'] / w_ssim, rtol=loss_rtol)
        d_ssim = abs(float(tm['ssim']) - float(jm['ssim']))
        assert abs(float(tm['loss']) - float(jm['loss'])) <= \
            loss_rtol * abs(float(jm['loss'])) + d_ssim
        np.testing.assert_allclose(tm['psnr'], jm['psnr'],
                                   rtol=loss_rtol / 20)
        for name in losses:
            assert float(jm[name]) != 0.0, name
        assert set(s['jgrads']) == set(s['tgrads'])
        for name, ref in s['jgrads'].items():
            got = s['tgrads'][name]
            top = float(np.abs(s['jgrads'][scale_of.get(name, name)]).max())
            if top == 0:
                assert not np.abs(got).max(), name
                continue
            tol = grad_tol_of.get(name.split('/')[0], grad_tol)
            err = float(np.abs(got - ref).max())
            assert err <= tol * top, f'grad {name}: {err} > {tol} x {top}'
    steps = len(runs)
    for name, lr in runs[-1]['lrs'].items():
        got, ref = tflat['params/' + name], jflat['params/' + name]
        # settled entries: the gradient above 1e-3 of its leaf's max, or
        # above the leaf's gradient bar where that is larger
        cut = max(1e-3, grad_tol_of.get(name.split('/')[0], grad_tol))
        big = np.ones(got.shape, bool)
        for s in runs:
            g = np.abs(s['tgrads'][name])
            big &= g > cut * np.abs(s['tgrads'][scale_of.get(name, name)
                                                ]).max()
        err = np.abs(got - ref)
        scale = np.abs(ref).max()
        assert err[big].max(initial=0.0) <= 1e-5 * scale + 0.01 * lr * steps, \
            name
        assert err.max() <= 2 * lr * steps + 1e-5 * scale, name
    for name in ('max_radii2d', 'denom'):
        np.testing.assert_array_equal(tflat[name], jflat[name], err_msg=name)
    top = np.abs(jflat['xyz_grad_accum']).max()
    assert np.abs(tflat['xyz_grad_accum'] - jflat['xyz_grad_accum']).max() \
        <= 1e-3 * top


# ---------------------------------------------------------------- noise


def test_time_noise_moves_the_step(scene, tmp_path):
    """The same init step with the draw 0 moves the Gaussians by 10 times
    the parity bar (the noise is live, and the parity above tells); the
    port's own draws come from its generator (seed + 1)."""
    cfg = options_cfg(net=tiny_cfg().net._replace(is_blender=False))
    tcfg = tsk_gs.SKGSConfig(**to_port_cfg_fields(cfg))
    sc, meta = scene
    save_pytree({'state': {'model': init_start(cfg, meta)}},
                tmp_path / 'm.npz')
    moved = {}
    for noise in (NOISE, 0.0):
        model = convert.model_from_flat(convert.load_npz(tmp_path / 'm.npz'),
                                        tcfg, port_cfg(jax_rcfg()),
                                        device='cpu', trainable=True)
        tt = ttrainer.SKGSTrainer(tcfg, model.rcfg, port_scene(sc),
                                  SceneMeta(background=meta.background),
                                  model, tlosses.LossWeights(IMAGE),
                                  device='cpu')
        fresh = tt.draw_time_noise()
        assert float(fresh) == float(torch.randn(
            (), generator=torch.Generator().manual_seed(1)))
        tt.draw_time_noise = lambda n=noise: torch.tensor(n)
        moved[noise] = float(tt.train_step(INIT_STEP)['dxyz_max'])
    assert abs(moved[NOISE] / moved[0.0] - 1.0) > 10 * 2e-4, moved


# ---------------------------------------------------------------- options


@pytest.fixture(scope='module')
def option_runs(scene, tmp_path_factory):
    """Adan (two sk steps: the first step's zero gradient difference, then
    one) and bf16 (an init step, the nets in bfloat16). The time noise and
    batch_views 3 are held in test_torch_regularizers.py, beside the
    regularizers, in one JAX compilation a family."""
    sc, meta = scene
    tmp = tmp_path_factory.mktemp('options')
    out = {}
    jcfg, _, jmodel = tiny_jax_model()
    out['adan'] = run_pair(jcfg, jmodel, sc, meta, IMAGE,
                           [jcfg.stages['sk'][0] + 1,
                            jcfg.stages['sk'][0] + 2], tmp,
                           flags=('skeleton_initialized',),
                           optimizer='adan')
    cfg = options_cfg()
    bf16 = cfg._replace(net=cfg.net._replace(compute_dtype='bfloat16'),
                        sk_net=cfg.sk_net._replace(compute_dtype='bfloat16'))
    out['bf16'] = run_pair(bf16, init_start(bf16, meta), sc, meta,
                           {**IMAGE, 'c_net': 1.0}, [INIT_STEP], tmp)
    return out


def test_adan_steps_match_jax(option_runs):
    runs, jflat, tflat, tt, jt = option_runs['adan']
    check_steps(runs, jflat, tflat)
    assert type(tt.opt_state).__name__ == 'AdanState'
    assert tt.opt_state.count == 2
    jopt = _flatten(jt.state.opt_state)
    for name in ('xyz', 'sk_deform/layers/0/w'):
        for field in ('mu', 'delta', 'nu', 'prev_grad'):
            ref = jopt[f'{field}/{name}']
            got = to_np(getattr(tt.opt_state, field)[name])
            assert np.abs(ref).max() > 0, (field, name)
            np.testing.assert_allclose(
                got, ref, atol=3e-4 * np.abs(ref).max()
                if field != 'nu' else 6e-4 * np.abs(ref).max(),
                err_msg=f'{field}/{name}')


def test_bf16_step_matches_jax(option_runs):
    runs, jflat, tflat, tt, _ = option_runs['bf16']
    nets = ('sp_deform', 'canonical', 'sk_deform')
    check_steps(runs, jflat, tflat, loss_rtol=2e-3,
                grad_tol_of={n: 2e-2 for n in nets},
                scale_of={'rotation': 'xyz'}, losses=('c_net',))
    assert tt.cfg.net.compute_dtype == 'bfloat16'


def test_bf16_nets_match_jax(rng):
    """The warp net and the skeleton net in bfloat16: float32 outputs
    within the bf16 bar (2e-2 of each output's max) of the JAX package's,
    and away from the float32 nets' by more than float32 rounding."""
    jcfg = jdeform.DeformNetConfig(depth=4, width=64,
                                   compute_dtype='bfloat16')
    params = jdeform.deform_net_init(jax.random.PRNGKey(3), jcfg)
    params['warp'] = {'w': jnp.asarray(0.1 * rng.normal(
        size=params['warp']['w'].shape).astype(np.float32)),
        'b': params['warp']['b']}
    tcfg = tdeform.DeformNetConfig(*jcfg)
    net = convert.deform_net_from_flat(_flatten(params, 'n/'), tcfg, 'n/',
                                       device='cpu')
    x = rng.uniform(-1, 1, size=(300, 3)).astype(np.float32)
    ref = jdeform.deform_net_apply(params, jcfg, jnp.asarray(x),
                                   jnp.asarray(0.4))
    got = tdeform.deform_net_apply(net, tcfg, torch.from_numpy(x),
                                   torch.tensor(0.4))
    f32 = tdeform.deform_net_apply(net, tcfg._replace(compute_dtype='float32'),
                                   torch.from_numpy(x), torch.tensor(0.4))
    for name in ('d_xyz', 'hidden'):
        g, r = to_np(got[name]), np.asarray(ref[name])
        assert got[name].dtype == torch.float32 and r.dtype == np.float32
        top = np.abs(r).max()
        assert np.abs(g - r).max() <= 2e-2 * top, name
        assert np.abs(g - to_np(f32[name])).max() > 1e-5 * top, name
    scfg = jdeform.SkeletonNetConfig(width=64, depth=4, skips=(2,),
                                     compute_dtype='bfloat16')
    sparams = jdeform.skeleton_net_init(jax.random.PRNGKey(4), scfg)
    sparams['heads'] = [{'w': jnp.asarray(0.05 * rng.normal(
        size=h['w'].shape).astype(np.float32)), 'b': h['b']}
        for h in sparams['heads']]
    tscfg = tdeform.SkeletonNetConfig(*scfg)
    snet = convert.skeleton_net_from_flat(_flatten(sparams, 's/'), tscfg,
                                          's/', device='cpu')
    joints = rng.normal(size=(16, 3)).astype(np.float32)
    ref = jdeform.skeleton_net_apply(sparams, scfg, jnp.asarray(joints),
                                     jnp.asarray(0.7))
    got = tdeform.skeleton_net_apply(snet, tscfg, torch.from_numpy(joints),
                                     torch.tensor(0.7))
    for g, r in zip(got, ref):
        assert g.dtype == torch.float32
        assert np.abs(to_np(g) - np.asarray(r)).max() <= \
            2e-2 * np.abs(np.asarray(r)).max()
    with pytest.raises(ValueError, match='compute_dtype'):
        tdeform.DeformNet(tcfg._replace(compute_dtype='float16'))
