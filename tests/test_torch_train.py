"""Port parity, the ``sk`` training step: sk_gs_tpu_torch.framework.trainer
against sk_gs_tpu.framework.trainer on the tiny SK-GS model of
test_torch_slice.py and a synthetic scene made by the JAX package.

The JAX side is its own ``SKGSTrainer.train_step`` (jitted, Pallas blend in
interpret mode, chunk 256 so that one chunk holds each tile's list; see
test_torch_slice.py for why), from fresh Adam moments on both sides, with
the skeleton marked initialised as in a run restored inside the sk stages.

Tolerances, with their reasons:
- losses rtol 2e-4: the SSIM variance terms (E[x^2] - E[x]^2 over a nearly
  white image) cancel in float32, and the two frameworks' convolutions sum
  in different orders;
- gradients 3e-4 of each leaf's max magnitude (tests/test_tile_kernel.py's
  bar for the Pallas backward against the oracle);
- parameters: where a leaf's gradient exceeds 1e-3 of its max, within 1e-5
  of the leaf's magnitude plus 1% of the leaf's Adam step per step taken;
  elsewhere within 2 lr per step, because Adam moves a near-zero gradient
  entry by about +-lr whatever its size, so a rounding-level difference of
  the gradient can flip the step;
- the statistics exactly (max_radii2d, denom) or within 1e-3 of their max
  (xyz_grad_accum, a norm of summed pixel gradients);
- n_bad_grad, n_vis, num_pairs and overflow exactly.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import sk_gs_tpu.render.tile_kernel as jtk
from sk_gs_tpu.data import sampler as jsampler
from sk_gs_tpu.data import synthetic as jsynth
from sk_gs_tpu.framework.checkpoint import _flatten, save_pytree
from sk_gs_tpu.framework.trainer import SKGSTrainer as JaxTrainer
from sk_gs_tpu.models import gaussian_splatting as jgs
from sk_gs_tpu.models import losses as jlosses
from sk_gs_tpu.models import optim as joptim
from sk_gs_tpu.models import sk_gs as jsk_gs
from sk_gs_tpu.render import GaussianInputs as JGaussianInputs
from sk_gs_tpu.render import composite_background as jcomposite
from sk_gs_tpu.render import render as jrender
from sk_gs_tpu_torch import convert
from sk_gs_tpu_torch.data import sampler as tsampler
from sk_gs_tpu_torch.data.base import Scene, SceneMeta
from sk_gs_tpu_torch.data.synthetic import make_synthetic_scene
from sk_gs_tpu_torch.framework.random_model import random_model_flat
from sk_gs_tpu_torch.framework.trainer import SKGSTrainer
from sk_gs_tpu_torch.models import losses as tlosses
from sk_gs_tpu_torch.models import optim as toptim
from sk_gs_tpu_torch.models import sk_gs as tsk_gs
from sk_gs_tpu_torch.parallel import Mesh
from sk_gs_tpu_torch.parallel.trainer import MeshTrainer
from sk_gs_tpu_torch.render import GaussianInputs
from sk_gs_tpu_torch.render.render import composite_background, render
from tests.test_torch_cli import one_torch_thread  # noqa: F401
from tests.test_render import make_view
from tests.test_torch_render import port_cfg, port_view, to_np
from tests.test_torch_slice import FRAMES, tiny_jax_model, to_port_cfg_fields

LOSS = {'image': {'method': 'l1', 'lambda': 0.8}, 'ssim': 0.2}
SCENE = dict(seed=0, num_links=3, gauss_per_link=40, num_frames=FRAMES,
             h=48, w=64, pair_capacity=2 ** 14)


@pytest.fixture(scope='module', autouse=True)
def interpret_mode():
    old = jtk.INTERPRET
    jtk.INTERPRET = True
    yield
    jtk.INTERPRET = old


@pytest.fixture(scope='module')
def jax_scene():
    return jsynth.make_synthetic_scene(chunk=256, use_pallas=True, **SCENE)


def port_scene(scene) -> Scene:
    s = Scene(*(torch.from_numpy(np.array(x)) for x in scene))
    return s._replace(time_ids=s.time_ids.long(),
                      camera_ids=s.camera_ids.long())


@pytest.fixture(scope='module')
def tiny():
    return tiny_jax_model()


def port_model(tiny, tmp_path, trainable=True):
    """The JAX model through a trainer-style checkpoint into the port."""
    cfg, rcfg, model = tiny
    path = tmp_path / f'model_{trainable}.npz'
    save_pytree({'state': {'model': model}}, path)
    return convert.model_from_flat(
        convert.load_npz(path), tsk_gs.SKGSConfig(**to_port_cfg_fields(cfg)),
        port_cfg(rcfg), device='cpu', trainable=trainable)


def close_rel(got, ref, tol, name):
    got, ref = np.asarray(got), np.asarray(ref)
    scale = np.abs(ref).max() + 1e-12
    err = np.abs(got - ref).max()
    assert err <= tol * scale, f'{name}: {err} > {tol} x {scale}'


# ---------------------------------------------------------------- units


def test_adam_matches_jax(rng):
    shapes = {'a': (5, 3), 'b': (4,), 'frozen': (2, 2)}
    lrs = {'a': 0.01, 'b': 0.003, 'frozen': 0.0}
    p0 = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    for clip in (0.0, 0.5):
        jp = {k: jnp.asarray(v) for k, v in p0.items()}
        jstate = joptim.adam_init(jp)
        tp = {k: torch.tensor(v) for k, v in p0.items()}
        tstate = toptim.adam_init(tp)
        for _ in range(3):
            g = {k: rng.normal(size=s).astype(np.float32)
                 for k, s in shapes.items()}
            jp, jstate = joptim.adam_update(
                {k: jnp.asarray(v) for k, v in g.items()}, jstate, jp,
                {k: jnp.asarray(v, jnp.float32) for k, v in lrs.items()},
                clip_norm=clip)
            tstate = toptim.adam_update(
                {k: torch.tensor(v) for k, v in g.items()}, tstate, tp, lrs,
                clip_norm=clip)
        assert tstate.count == int(jstate.count) == 3
        for k in shapes:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                       atol=1e-6, err_msg=k)
            np.testing.assert_allclose(tstate.mu[k].numpy(),
                                       np.asarray(jstate.mu[k]), atol=1e-6)
            np.testing.assert_allclose(tstate.nu[k].numpy(),
                                       np.asarray(jstate.nu[k]), atol=1e-6)
        np.testing.assert_array_equal(tp['frozen'].numpy(), p0['frozen'])
        assert float(tstate.nu['frozen'].abs().max()) > 0


def test_loss_weights_match_jax():
    cfg = {'image': {'method': 'mse', 'lambda': 0.8}, 'ssim': 0.2,
           'joint': {'lambda': 1.0, '_vary': 'linear', '_steps': [100, 200],
                     '_values': [1.0, 0.1]},
           'arap': {'lambda': 0.5, '_vary': 'log', '_steps': [10, 50],
                    '_values': [0.5, 0.005]},
           'cut': {'lambda': 0.3, '_steps': [10, 20], '_values': [0.3, 0.0]},
           'default': 0.05}
    ref, got = jlosses.LossWeights(cfg), tlosses.LossWeights(cfg)
    for step in (0, 5, 10, 30, 100, 150, 199, 200, 5000):
        ref.set_step(step)
        got.set_step(step)
        for name in ('image', 'ssim', 'joint', 'arap', 'cut', 'missing'):
            assert got.w(name) == ref.w(name), (name, step)
            assert got.ever_nonzero(name) == ref.ever_nonzero(name)
    assert got.cfg('image') == ref.cfg('image') == {'method': 'mse'}


def test_sampler_matches_jax():
    ref = jsampler.UniformSampler(48, seed=3)
    got = tsampler.UniformSampler(48, seed=3)
    picks = []
    for step in range(1, 51):
        picks.append((got.sample(step), ref.sample(step)))
    picks.append((got.sample(50), ref.sample(50)))  # a second draw at a step
    assert all(a == b for a, b in picks)
    assert len({a for a, _ in picks}) > 20


def test_synthetic_scene_matches_jax(jax_scene):
    ref, ref_meta, ref_gt = jax_scene
    scene, meta, gt = make_synthetic_scene(device='cpu', **SCENE)
    np.testing.assert_allclose(gt.link_T, ref_gt.link_T, atol=1e-6)
    np.testing.assert_array_equal(gt.means, ref_gt.means)
    for name in ('images', 'Tw2v', 'Tv2c', 'campos', 'tan_fovx', 'tan_fovy',
                 'times'):
        np.testing.assert_allclose(to_np(getattr(scene, name)),
                                   np.asarray(getattr(ref, name)),
                                   atol=3e-5, err_msg=name)
    np.testing.assert_array_equal(to_np(scene.time_ids),
                                  np.asarray(ref.time_ids))
    assert float(to_np(scene.images).min()) < 0.5      # the chain is in view
    np.testing.assert_array_equal(meta.background, ref_meta.background)
    np.testing.assert_allclose(meta.train_times, ref_meta.train_times)
    with pytest.raises(RuntimeError, match='overflow'):
        make_synthetic_scene(device='cpu', **{**SCENE, 'pair_capacity': 64})


def test_lr_trees_match_jax(tiny, jax_scene, tmp_path):
    cfg, rcfg, model = tiny
    scene, meta, _ = jax_scene
    jt = JaxTrainer(cfg, rcfg, scene, meta, model)
    tmodel = port_model(tiny, tmp_path)
    tt = SKGSTrainer(tmodel.cfg, tmodel.rcfg, port_scene(scene),
                     SceneMeta(background=meta.background), tmodel,
                     device='cpu')
    for step in (cfg.stages['sk'][0] + 1, cfg.stages['sk'][0] + 12345):
        ref = {k: float(v) for k, v in _flatten(jt.lr_trees(step)).items()}
        got = tt.lr_trees(step)
        assert set(got) <= set(ref)
        for name, lr in got.items():
            assert lr == pytest.approx(ref[name], rel=1e-12), name
        assert got['global_tr'] == 0.0 and min(got['xyz'], got['sp_W']) > 0
        assert tt.stage_rel_step(step) == jt.stage_rel_step(step)


# ---------------------------------------------------------------- render


def test_render_gradients_match_jax(tiny_grads):
    ref, got = tiny_grads
    for name in ('means3d', 'scales', 'rotations', 'opacities', 'sh',
                 'means2d_offset'):
        assert np.isfinite(got[name]).all() and np.isfinite(ref[name]).all()
        assert np.abs(ref[name]).max() > 0, name
        close_rel(got[name], ref[name], 3e-4, name)


@pytest.fixture(scope='module')
def tiny_grads(tiny):
    """d(0.8 l1 + 0.2 (1 - SSIM)) of one render of the tiny model (its
    deformed Gaussians at t = 0.3) against a random target."""
    cfg, rcfg, model = tiny
    out_def = jsk_gs.forward_deltas(cfg, model, jnp.asarray(0.3), 'sk',
                                    time_id=1)
    g = jgs.gaussian_inputs(model.gauss_view(), cfg.gauss, out_def.d_xyz,
                            out_def.d_rotation, out_def.d_scaling)
    arrays = [np.asarray(x) for x in (g.means3d, g.scales, g.rotations,
                                      g.opacities, g.sh)]
    alive = np.array(model.alive)
    view = make_view()
    target = np.random.default_rng(7).uniform(
        0.5, 1.0, size=(48, 64, 3)).astype(np.float32)
    bg = np.ones(3, np.float32)
    names = ('means3d', 'scales', 'rotations', 'opacities', 'sh',
             'means2d_offset')

    def jloss(*leaves):
        *xs, off = leaves
        gi = JGaussianInputs(*xs, mask=jnp.asarray(alive))
        out = jrender(gi, view, rcfg, active_sh_degree=model.active_sh_degree,
                      means2d_offset=off)
        img = jcomposite(out['images'], out['opacity'], jnp.asarray(bg))
        return 0.8 * jlosses.l1_loss(img, target) \
            + 0.2 * jlosses.ssim_loss(img, target)

    leaves = [jnp.asarray(a) for a in arrays] + [jnp.zeros((alive.size, 2))]
    jg = jax.jit(jax.grad(jloss, argnums=tuple(range(6))))(*leaves)
    ref = {n: np.asarray(v) for n, v in zip(names, jg)}

    tl = [torch.tensor(a, requires_grad=True) for a in arrays]
    off = torch.zeros((alive.size, 2), requires_grad=True)
    gi = GaussianInputs(*tl, mask=torch.from_numpy(alive))
    out = render(gi, port_view(view), port_cfg(rcfg),
                 active_sh_degree=torch.tensor(3), means2d_offset=off)
    img = composite_background(out['images'], out['opacity'],
                               torch.from_numpy(bg))
    tgt = torch.from_numpy(target)
    loss = 0.8 * tlosses.l1_loss(img, tgt) + 0.2 * tlosses.ssim_loss(img, tgt)
    loss.backward()
    got = {n: to_np(t.grad) for n, t in zip(names, tl + [off])}
    return ref, got


# ---------------------------------------------------------------- the step


@pytest.fixture(scope='module')
def three_steps(tiny, jax_scene, tmp_path_factory):
    """Both trainers from the same model and scene, 3 steps; snapshots
    after the first and the third."""
    cfg, rcfg, model = tiny
    scene, meta, _ = jax_scene
    jt = JaxTrainer(cfg, rcfg, scene, meta, model,
                    loss_weights=jlosses.LossWeights(LOSS))
    jt.state.skeleton_initialized = True
    tmp = tmp_path_factory.mktemp('step')
    tmodel = port_model(tiny, tmp)
    init_global_tr = to_np(tmodel.params['global_tr']).copy()
    tt = SKGSTrainer(tmodel.cfg, tmodel.rcfg, port_scene(scene),
                     SceneMeta(background_type=meta.background_type,
                               background=meta.background),
                     tmodel, tlosses.LossWeights(LOSS),
                     skeleton_initialized=True, device='cpu')
    s0 = cfg.stages['sk'][0] + 1
    snaps = {}
    for k in range(3):
        step = s0 + k
        jm = {n: np.asarray(v) for n, v in jt.train_step(step).items()}
        tm = {n: to_np(v) for n, v in tt.train_step(step).items()}
        grads = {n: to_np(p.grad) for n, p in tt.model.leaves().items()}
        if k in (0, 2):
            snaps[k + 1] = dict(
                jax=jm, port=tm, grads=grads, lrs=tt.lr_trees(step),
                jflat=_flatten(jt.state.model),
                tflat=convert.model_to_flat(tt.model))
    ckpt = tmp / 'trainer.npz'
    save_pytree({'state': jt.ckpt_state()}, ckpt)
    return snaps, tt, init_global_tr, ckpt


@pytest.mark.parametrize('steps', [1, 3])
def test_train_step_matches_jax(three_steps, steps):
    snaps, _, init_global_tr, _ = three_steps
    s = snaps[steps]
    jm, tm = s['jax'], s['port']
    assert set(jm) == set(tm)
    for name in ('n_bad_grad', 'n_vis', 'num_pairs', 'overflow'):
        assert int(tm[name]) == int(jm[name]), name
    assert int(tm['num_pairs']) > 500 and int(tm['n_vis']) > 100
    for name in ('loss', 'rgb', 'ssim'):
        np.testing.assert_allclose(tm[name], jm[name], rtol=2e-4,
                                   err_msg=name)
    for name in ('psnr', 'dxyz_max'):
        np.testing.assert_allclose(tm[name], jm[name], rtol=1e-5,
                                   err_msg=name)

    jflat, tflat = s['jflat'], s['tflat']
    for name in ('max_radii2d', 'denom'):
        np.testing.assert_array_equal(tflat[name], jflat[name], err_msg=name)
    close_rel(tflat['xyz_grad_accum'], jflat['xyz_grad_accum'], 1e-3,
              'xyz_grad_accum')
    np.testing.assert_allclose(tflat['sk_cache'], jflat['sk_cache'],
                               atol=1e-5)
    assert np.abs(tflat['sk_cache']).max() > 0.5

    moved = 0
    for name, lr in s['lrs'].items():
        got, ref = tflat['params/' + name], jflat['params/' + name]
        g = np.abs(s['grads'][name])
        big = g > 1e-3 * g.max()
        err = np.abs(got - ref)
        tol_big = 1e-5 * np.abs(ref).max() + 0.01 * lr * steps
        assert err[big].max(initial=0.0) <= tol_big, name
        assert err.max() <= 2 * lr * steps + 1e-5 * np.abs(ref).max(), name
        moved += int(lr > 0)
    assert moved == len(s['lrs']) - 1
    np.testing.assert_array_equal(tflat['params/global_tr'], init_global_tr)


def test_adam_state_reads_from_a_trainer_checkpoint(three_steps):
    _, tt, _, ckpt = three_steps
    flat = convert.load_npz(ckpt)
    state = convert.optimizer_from_flat(flat, tt.model, 'adam')
    assert state.count == tt.opt_state.count == 3
    for name in tt.model.leaves():
        np.testing.assert_array_equal(
            to_np(state.mu[name]), flat['state/opt/mu/' + name])
        close_rel(to_np(tt.opt_state.nu[name]), flat['state/opt/nu/' + name],
                  1e-3, name)
    model = convert.model_from_flat(flat, tt.model.cfg, tt.model.rcfg,
                                    device='cpu', trainable=True)
    for name in ('denom', 'max_radii2d', 'sk_cache'):
        np.testing.assert_array_equal(to_np(getattr(model, name)),
                                      flat['state/model/' + name])
    bare = {k[len('state/model/'):]: v for k, v in flat.items()
            if k.startswith('state/model/')}
    with pytest.raises(KeyError, match='trainer checkpoint'):
        convert.optimizer_from_flat(bare, model, 'adam')


# ---------------------------------------------------------------- port alone


class _FixedView:
    def sample(self, step):
        return 2


def test_single_view_loss_falls(tiny):
    scene, meta, _ = make_synthetic_scene(device='cpu', **SCENE)
    cfg = tsk_gs.SKGSConfig(**to_port_cfg_fields(tiny[0]))
    cfg = cfg._replace(gauss=cfg.gauss._replace(capacity=1024))
    rcfg = port_cfg(tiny[1])
    flat = random_model_flat(cfg, 4, n_alive=800, log_scale_mean=-3.0)
    model = convert.model_from_flat(flat, cfg, rcfg, device='cpu',
                                    trainable=True)
    tt = SKGSTrainer(cfg, rcfg, scene, meta, model, sampler=_FixedView(),
                     skeleton_initialized=True, device='cpu')
    s0 = cfg.stages['sk'][0] + 1
    losses = [float(tt.train_step(s0 + k)['loss']) for k in range(20)]
    assert np.isfinite(losses).all()
    assert np.mean(losses[-3:]) < 0.8 * losses[0], losses
    assert float(tt.model.denom.max()) == 20.0


def test_trainer_refuses_what_is_not_ported(tiny, jax_scene, tmp_path):
    scene = port_scene(jax_scene[0])
    meta = SceneMeta(background=np.ones(3, np.float32))
    model = port_model(tiny, tmp_path)
    cfg, rcfg = model.cfg, model.rcfg
    # a mesh's gs axis must divide the capacity and the tile rows (JAX's
    # messages), and its view axis batch_views; both axes
    # (tests/test_torch_view_parallel.py, test_torch_gs_parallel.py),
    # batch_views and the optimizers of the JAX registry are ported
    # (tests/test_torch_train_options.py)
    with pytest.raises(ValueError, match='grid_h 3 not divisible by mesh '
                       'gs axis 2'):
        MeshTrainer(cfg, rcfg, scene, meta, model, device='cpu',
                    mesh=Mesh(1, 2, 0, {}))
    tile8 = rcfg._replace(tile_h=8)
    with pytest.raises(ValueError, match='capacity 256 not divisible by '
                       'mesh gs axis 3'):
        MeshTrainer(cfg, tile8, scene, meta, model, device='cpu',
                    mesh=Mesh(1, 3, 0, {}))
    tr = MeshTrainer(cfg, tile8, scene, meta, model, device='cpu',
                     mesh=Mesh(1, 2, 1, {}))
    assert tr.n_gs == 2 and tr.pass_model().params['xyz'].shape[0] == 128
    with pytest.raises(ValueError, match='view axis 2'):
        MeshTrainer(cfg, rcfg, scene, meta, model, device='cpu',
                    batch_views=3, mesh=Mesh(2, 1, 0, {}))
    for kw in ({'batch_views': 2}, {'optimizer': 'adan'},
               {'optimizer': 'sgd'}, {'optimizer': 'adamw'}):
        SKGSTrainer(cfg, rcfg, scene, meta, model, device='cpu', **kw)
    with pytest.raises(KeyError, match='rmsprop'):
        SKGSTrainer(cfg, rcfg, scene, meta, model, device='cpu',
                    optimizer='rmsprop')
    # RGBA targets are composited per step (tests/test_torch_background.py)
    rgba = scene._replace(images=torch.ones(FRAMES, 48, 64, 4))
    SKGSTrainer(cfg, rcfg, rgba, meta, model, device='cpu')
    with pytest.raises(ValueError, match='trainable'):
        SKGSTrainer(cfg, rcfg, scene, meta,
                    port_model(tiny, tmp_path, trainable=False),
                    device='cpu')
    tt = SKGSTrainer(cfg, rcfg, scene, meta, model, device='cpu')
    # the first sk-family step runs the skeleton initialisation (its loops
    # cut to 4 iterations here) and sets the flag; the sk_init family is
    # ported
    tt.cfg = cfg._replace(joint_init_steps=4)
    tt.train_step(cfg.stages['sk'][0] + 1)
    assert tt.skeleton_initialized
    assert tt.family('sk_init') == 'sk_init'
