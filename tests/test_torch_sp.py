"""Port parity, the ``sp`` training family and its stage events: the port's
``SKGSTrainer`` against the JAX trainer's own jitted ``train_step``, both
from one model built by the JAX package (``init_model`` on a point cloud,
saved and converted), on the tile schedule with Pallas in interpret mode
(chunk 256 holds each tile's list, see test_torch_slice.py).

Before each step the port's trainer resumes from the JAX trainer's
checkpoint (``convert.model_from_flat``, ``optimizer_from_flat`` and
``trainer_flags_from_flat``: the model, the moments, the stage flags and
the smooth loss's KNN) and takes that step; so each step and its events are
held from the same state, without the drift of two runs apart (Adam moves
an entry whose gradient is near zero by about +-lr, whichever way rounding
tips it).

The schedule puts every event of the flagship's steps 7,500-40,000 into six
steps: the superpoint initialisation and the restart from the point cloud
before step 1 (the one ``init`` step), the ``sp_fix`` step 2 with the white
background's opacity reset after it, and the ``sp`` steps 3-6: step 3 takes
the smooth loss against the all-zero KNN (the reference's behaviour before
the first rebuild), the canonical replacement and the KNN rebuild before
step 4, the joint tree update after steps 4 and 6, a superpoint merge
after step 4, a prune / split and a densify (clone-only: every Gaussian
counts as small and is selected) after step 5, a KNN rebuild over the
clones before step 6. A second, shorter run starts in ``sp`` with
``warp_method`` 'largest'.

Tolerances: losses rtol 2e-4 (test_torch_train.py), the SSIM term as its
index (1 - loss / weight): both frameworks compute the variances as E[x^2]
- E[x]^2 over a nearly white image, whose float32 cancellation leaves
~1e-4 of absolute noise in the index, so as the SSIM loss falls its
relative error grows while the image (PSNR rtol 1e-6) does not move; the
total loss within 2e-4 plus that SSIM difference; gradients within 3e-4
of their leaf's max (the rotation's: of the position gradient's max, as
the point cloud's Gaussians are isotropic and their rotation gradient is
rounding noise), read from the first moments (both sides move the same
moments by 0.1 g; their float32 rounding adds up to 1e-6 of the moments'
max), except the sp_W rows of a smooth-loss pair whose difference JAX's
softmax of the same inputs rounds to another sign (``kink_rows``: at most a
tenth of the live rows); parameters as test_torch_init.py holds them after one step;
``sp_cache`` and ``joint_cost`` within 1e-5 of their max; ``alive``,
``sp_alive``, ``joint_parents``, ``joint_root``, ``p2sp``, the event counts
and the KNN's neighbour sets exactly.
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
from sk_gs_tpu.models import gaussian_splatting as jgs
from sk_gs_tpu.models import losses as jlosses
from sk_gs_tpu.models import sk_gs as jsk_gs
from sk_gs_tpu_torch import convert
from sk_gs_tpu_torch.data.base import SceneMeta
from sk_gs_tpu_torch.framework import trainer as ttrainer
from sk_gs_tpu_torch.framework.presets import synthetic_fullscale
from sk_gs_tpu_torch.models import losses as tlosses
from sk_gs_tpu_torch.models import sk_gs as tsk_gs
from tests.test_torch_cli import one_torch_thread  # noqa: F401
from tests.test_torch_init import jax_rcfg
from tests.test_torch_render import port_cfg, to_np
from tests.test_torch_slice import tiny_cfg, to_port_cfg_fields
from tests.test_torch_train import SCENE, close_rel, port_scene

LOSS = synthetic_fullscale()[2].loss
# the point cloud's Gaussians start isotropic: the rotation's gradient is
# rounding noise, held against the position gradient's scale
ROUNDING_NOISE = {'rotation': 'xyz'}
STEPS = (1, 2, 3, 4, 5, 6)


def sp_cfg(warp_method='LBS'):
    """tiny_cfg (256 slots, M = 16) on a schedule of one init step, one
    sp_fix step and sp, with every sp event inside six steps."""
    cfg = tiny_cfg()
    return cfg._replace(
        train_schedule=(('static', 0), ('init_fix', 0), ('init', 1),
                        ('sp_fix', 1), ('sp', 100), ('sk_init', 0),
                        ('sk_fix', 0), ('sk', 10)),
        warp_method=warp_method, init_sampling_step=1,
        canonical_replace_steps=(4,), joint_update_interval=(2, 4, 100),
        sp_merge_interval=(3, 3, 100), sp_adjust_interval=(3, 4, 100),
        sp_merge_threshold=2e-2, sp_split_threshold=0.0,
        gauss=cfg.gauss._replace(densify_grad_threshold=0.0,
                                 densify_interval=(3, 1, 100)))


def point_cloud(n=200):
    rng = np.random.default_rng(0)
    pts = rng.uniform(-0.8, 0.8, size=(n, 3)).astype(np.float32)
    cols = rng.uniform(size=(n, 3)).astype(np.float32)
    return pts, cols


@pytest.fixture(scope='module')
def tile_interpret():
    old = jtk.INTERPRET
    jtk.INTERPRET = True
    yield
    jtk.INTERPRET = old


@pytest.fixture(scope='module')
def jax_scene():
    scene, meta, _ = jsynth.make_synthetic_scene(chunk=256, use_pallas=True,
                                                 **SCENE)
    return scene, meta


def checkpoint_flat(jt, tmp):
    path = tmp / 'trainer.npz'
    save_pytree({'state': jt.ckpt_state()}, path)
    return convert.load_npz(path)


def port_trainer(jt, tmp, pcd, step):
    """The port's trainer resumed from the JAX trainer's checkpoint after
    ``step - 1``: model, Adam moments, stage flags, and the smooth loss's
    KNN as the checkpoint holds it (the JAX run goes on from that state,
    all zeros included, where a restore would rebuild the zeros)."""
    flat = checkpoint_flat(jt, tmp)
    tcfg = tsk_gs.SKGSConfig(**to_port_cfg_fields(jt.cfg))
    flags = convert.trainer_flags_from_flat(flat, tcfg, step - 1,
                                            device='cpu')
    flags['gs_knn_index'] = torch.as_tensor(
        flat['state/flags/gs_knn_index'], dtype=torch.int64)
    model = convert.model_from_flat(flat, tcfg, port_cfg(jt.rcfg),
                                    device='cpu', trainable=True)
    meta = jt.meta
    tt = ttrainer.SKGSTrainer(
        tcfg, model.rcfg, port_scene(jt.scene),
        SceneMeta(background_type=meta.background_type,
                  background=meta.background,
                  cameras_extent=meta.cameras_extent),
        model, tlosses.LossWeights(LOSS),
        opt_state=convert.optimizer_from_flat(flat, model, 'adam'), pcd=pcd,
        device='cpu',
        **flags)
    tt.gs_knn_update_interval = jt.gs_knn_update_interval
    return tt


def run_steps(cfg, model, scene, meta, tmp, steps, **flags):
    """The JAX trainer over ``steps``; before each, the port's trainer
    resumed from its state takes the same step. A snapshot after each."""
    pcd = point_cloud()
    jt = jtrainer.SKGSTrainer(cfg, jax_rcfg(), scene, meta, model,
                              loss_weights=jlosses.LossWeights(LOSS), pcd=pcd,
                              gs_knn_update_interval=(2, 2))
    for k, v in flags.items():
        setattr(jt.state, k, v)
    snaps = {}
    for step in steps:
        tt = port_trainer(jt, tmp, pcd, step)
        mu_prev = {k: np.array(v) for k, v in
                   _flatten(jt.state.opt_state.mu).items()}
        knn_before = to_np(tt.gs_knn_index).copy()
        weights = spy_weights(tt)
        tm = {n: to_np(v) for n, v in tt.train_step(step).items()}
        jm = {n: np.asarray(v) for n, v in jt.train_step(step).items()}
        snaps[step] = dict(
            jax=jm, port=tm, lrs=tt.lr_trees(step), trainer=tt,
            grads={n: to_np(p.grad).copy()
                   for n, p in tt.model.leaves().items()},
            mu_prev=mu_prev, knn_before=knn_before,
            kink_rows=kink_rows(weights, tt),
            event={k: int(v) for k, v in tt.last_event.items()},
            knn=to_np(tt.gs_knn_index).copy(),
            jknn=np.asarray(jt.state.gs_knn_index),
            jflat=_flatten(jt.state.model),
            tflat=convert.model_to_flat(tt.model),
            jopt=_flatten(jt.state.opt_state),
            topt={f'{m}/{k}': to_np(v).copy() for m in ('mu', 'nu')
                  for k, v in getattr(tt.opt_state, m).items()})
    return snaps


def spy_weights(tt) -> list:
    """The LBS weights, their superpoints and ``sp_W`` of the step's main
    pass, as ``sp_losses`` sees them."""
    seen = []
    sp_losses = tt.sp_losses

    def spy(d, t, step, **kw):
        seen.append((to_np(d.aux['knn_w']).copy(), to_np(d.aux['knn_i']),
                     to_np(tt.model.params['sp_W']).copy()))
        return sp_losses(d, t, step, **kw)
    tt.sp_losses = spy
    return seen


def kink_rows(weights: list, tt) -> np.ndarray:
    """The Gaussian rows of a smooth-loss pair whose difference has another
    sign in JAX's float32 softmax of the same inputs: |x| has no derivative
    at 0, and the frameworks' weights differ in the last bit, so where two
    weights (nearly) tie, sign(w_i - w_j) can be 0 on one side and +-1 on
    the other."""
    rows = np.zeros(tt.model.alive.shape[0], bool)
    if weights:
        w, idx, sp_w = weights[0]
        w_jax = np.asarray(jax.nn.softmax(jnp.asarray(np.take_along_axis(
            sp_w, idx.astype(np.int64), 1)), axis=-1))
        knn = to_np(tt.gs_knn_index)
        sign = lambda x: np.sign(x[:, None] - x[knn])
        alive = to_np(tt.model.alive)
        flip = (sign(w) != sign(w_jax)).any(-1) & alive[:, None]
        rows[np.nonzero(flip)[0]] = True
        rows[knn[flip]] = True
    return rows


@pytest.fixture(scope='module')
def sp_run(tile_interpret, jax_scene, tmp_path_factory):
    scene, meta = jax_scene
    meta.cameras_extent = 1e4          # every Gaussian is small: clones
    cfg = sp_cfg()
    pts, cols = point_cloud()
    model = jsk_gs.init_model(jax.random.PRNGKey(0), cfg,
                              jgs.init_from_pcd(pts, cols, cfg.gauss),
                              np.asarray(meta.train_times))
    return run_steps(cfg, model, scene, meta, tmp_path_factory.mktemp('sp'),
                     STEPS)


def check_step(s):
    """One step of the port, resumed from the JAX state, against the JAX
    step: metrics, gradients, parameters, moments, masks and buffers."""
    jm, tm = s['jax'], s['port']
    assert set(jm) == set(tm)
    for name in ('n_bad_grad', 'n_vis', 'num_pairs', 'overflow'):
        assert int(tm[name]) == int(jm[name]), name
    assert int(tm['num_pairs']) > 300
    for name in set(jm) - {'n_bad_grad', 'n_vis', 'num_pairs', 'overflow',
                           'ssim', 'loss'}:
        np.testing.assert_allclose(tm[name], jm[name], rtol=2e-4, atol=1e-9,
                                   err_msg=name)
    # the SSIM index, and the total loss up to the SSIM term's difference
    w_ssim = LOSS['ssim']
    np.testing.assert_allclose(1 - tm['ssim'] / w_ssim,
                               1 - jm['ssim'] / w_ssim, rtol=2e-4)
    d_ssim = abs(float(tm['ssim']) - float(jm['ssim']))
    assert abs(float(tm['loss']) - float(jm['loss'])) <= \
        2e-4 * abs(float(jm['loss'])) + d_ssim

    jflat, tflat, topt, jopt = s['jflat'], s['tflat'], s['topt'], s['jopt']
    kinks = s['kink_rows']
    assert kinks.sum() <= 0.1 * tflat['alive'].sum(), kinks.sum()
    for name, g in s['grads'].items():
        # both first moments moved from the same mu_prev by 0.1 g (rows an
        # event reset are zero on both sides); the isotropic Gaussians'
        # rotation gradient is rounding noise, held at the position's scale
        diff = np.abs(topt['mu/' + name] - jopt['mu/' + name]) / 0.1
        if name == 'sp_W':
            diff = diff[~kinks]
        slack = 1e-6 * np.abs(s['mu_prev'][name]).max()
        scale = np.abs(s['grads'][ROUNDING_NOISE.get(name, name)]).max()
        assert diff.max(initial=0.0) <= 3e-4 * scale + slack + 1e-12, \
            (name, diff.max(), scale)
    for name in ('alive', 'sp_alive', 'joint_parents', 'joint_root', 'p2sp',
                 'max_radii2d', 'denom'):
        np.testing.assert_array_equal(tflat[name], jflat[name], name)
    close_rel(tflat['xyz_grad_accum'], jflat['xyz_grad_accum'], 1e-3,
              'xyz_grad_accum')
    for name in ('sp_cache', 'joint_cost'):
        close_rel(tflat[name], jflat[name], 1e-5, name)
    for name, lr in s['lrs'].items():
        got, ref = tflat['params/' + name], jflat['params/' + name]
        g = np.abs(s['grads'][name])
        top = np.abs(s['grads'][ROUNDING_NOISE.get(name, name)]).max()
        big = g > 1e-3 * top
        err = np.abs(got - ref)
        tol_big = 1e-5 * np.abs(ref).max() + 0.01 * lr
        assert err[big].max(initial=0.0) <= tol_big, name
        assert err.max() <= 2 * lr + 1e-5 * np.abs(ref).max(), name
    zero = lambda x: ~x.reshape(x.shape[0], -1).any(-1)
    for moment in ('mu', 'nu'):
        for name in s['grads']:
            key = f'{moment}/{name}'
            np.testing.assert_array_equal(zero(topt[key]), zero(jopt[key]),
                                          key)


@pytest.mark.parametrize('step', STEPS)
def test_sp_steps_match_jax_trainer(sp_run, step):
    s = sp_run[step]
    stage = sp_cfg().stage_at(step)
    assert stage == ('init', 'sp_fix', 'sp', 'sp', 'sp', 'sp')[step - 1]
    if stage != 'init':
        assert {'sparse', 'smooth', 'joint', 'joint_all', 'g_cmp_t',
                'c_net'} <= set(s['port'])
    check_step(s)
    # the sk net's leaves step on exact zero gradients while the guided
    # gate is closed (step <= guided_step_start)
    for name, g in s['grads'].items():
        if name.startswith('sk_deform/') and stage != 'init':
            assert not g.any(), name
            assert not s['jopt']['mu/' + name].any(), name


def test_sp_events_match_jax(sp_run):
    events = {step: sp_run[step]['event'] for step in STEPS}
    assert events[1] == {} and events[3] == {}
    assert events[2] == {'opacity_reset': 1}
    assert set(events[4]) == {'joint_root', 'n_merged_sp'}
    assert events[4]['n_merged_sp'] > 0
    assert set(events[5]) == {'n_pruned_sp', 'n_split_sp', 'n_cloned',
                              'n_split', 'n_pruned', 'n_dropped'}
    assert events[5]['n_split_sp'] > 0 and events[5]['n_cloned'] > 0
    assert set(events[6]) == {'joint_root'}
    # before step 1 the superpoint initialisation, then the restart: the
    # point cloud's 200 Gaussians, one-hot LBS on the nearest superpoint
    first = sp_run[1]['trainer']
    assert first.sp_initialized and first.reinit_done
    assert int(sp_run[1]['tflat']['alive'].sum()) == 200
    n_sp = int(sp_run[4]['tflat']['sp_alive'].sum())
    assert n_sp == 16 - events[4]['n_merged_sp']
    after5 = sp_run[5]['tflat']
    assert int(after5['sp_alive'].sum()) == \
        n_sp - events[5]['n_pruned_sp'] + events[5]['n_split_sp']
    assert int(after5['alive'].sum()) == \
        200 + events[5]['n_cloned'] - events[5]['n_pruned']
    assert not any(sp_run[k]['trainer'].skeleton_initialized for k in STEPS)


def test_smooth_knn_starts_at_zeros_and_matches_jax(sp_run):
    """The reference behaviour: the smooth loss's KNN is all zeros until
    its first rebuild (step 1 or the interval, on sp steps only), so the
    sp_fix step and step 3 difference every Gaussian's weights against row
    0's; the rebuilds before steps 4 and 6 give JAX's neighbour sets."""
    for step in (1, 2, 3):
        assert not sp_run[step]['knn'].any()
        assert not sp_run[step]['jknn'].any()
    assert sp_run[3]['port']['smooth'] > 0
    assert not sp_run[4]['knn_before'].any()
    for step, alive_at in ((4, 3), (6, 5)):
        s = sp_run[step]
        alive = sp_run[alive_at]['tflat']['alive']
        assert s['knn'].shape == (256, 20)
        np.testing.assert_array_equal(np.sort(s['knn'][alive], axis=1),
                                      np.sort(s['jknn'][alive], axis=1))


@pytest.mark.parametrize('step,legacy', [(2, False), (2, True), (3, True),
                                         (0, True), (103, True)])
def test_resume_flags_match_jax_restore(tile_interpret, jax_scene, tmp_path,
                                       step, legacy):
    """``trainer_flags_from_flat`` against the JAX trainer's ``restore`` of
    a checkpoint taken after ``step`` with the flags unset and the KNN all
    zeros (``legacy``: a checkpoint without flags): the flags OR-ed with
    the schedule (init 1, sp_fix 2, sp 3-102, sk from 103), and inside
    sp_fix / sp the KNN rebuilt from the checkpoint's Gaussians."""
    scene, meta = jax_scene
    cfg = sp_cfg()
    pts, cols = point_cloud()
    model = jsk_gs.init_model(jax.random.PRNGKey(0), cfg,
                              jgs.init_from_pcd(pts, cols, cfg.gauss),
                              np.asarray(meta.train_times))
    jt = jtrainer.SKGSTrainer(cfg, jax_rcfg(), scene, meta, model,
                              loss_weights=jlosses.LossWeights(LOSS))
    flat = checkpoint_flat(jt, tmp_path)
    state = jt.ckpt_state()
    if legacy:
        flat = {k: v for k, v in flat.items()
                if not k.startswith('state/flags/')}
        state['flags'] = {}
    jt.restore(state, step)
    got = convert.trainer_flags_from_flat(
        flat, tsk_gs.SKGSConfig(**to_port_cfg_fields(cfg)), step,
        device='cpu')
    for name in convert.TRAINER_FLAGS:
        assert got[name] == bool(getattr(jt.state, name)), name
    ref = np.asarray(jt.state.gs_knn_index)
    rebuilt = cfg.stage_at(max(step, 1)) in ('sp_fix', 'sp')
    assert ref.any() == rebuilt
    index = to_np(got['gs_knn_index']) if 'gs_knn_index' in got else \
        np.zeros_like(ref)
    alive = flat['state/model/alive']
    np.testing.assert_array_equal(np.sort(index[alive], axis=1),
                                  np.sort(ref[alive], axis=1))


def test_canonical_replace_copies_the_net(sp_run):
    """After the replacement before step 4, sp_deform started as a copy of
    canonical with its own storage: one step of Adam moved them apart."""
    m = sp_run[4]['trainer'].model
    can = dict(m.canonical.named_parameters())
    for name, p in m.sp_deform.named_parameters():
        assert p.data_ptr() != can[name].data_ptr(), name
    assert not torch.equal(m.sp_deform.trunk[0].w, m.canonical.trunk[0].w)
    before = sp_run[3]['tflat']
    for name in ('params/sp_deform/trunk/0/w', 'params/xyz',
                 'params/sp_points'):
        assert not np.array_equal(before[name], sp_run[4]['tflat'][name])


@pytest.fixture(scope='module')
def largest_run(tile_interpret, jax_scene, tmp_path_factory):
    """``warp_method`` 'largest': an sp model (superpoints at random
    Gaussians, a random LBS matrix) trained at step 3, flags set."""
    scene, meta = jax_scene
    cfg = sp_cfg('largest')
    pts, cols = point_cloud()
    model = jsk_gs.init_model(jax.random.PRNGKey(1), cfg,
                              jgs.init_from_pcd(pts, cols, cfg.gauss),
                              np.asarray(meta.train_times))
    rng = np.random.default_rng(3)
    params = dict(model.params)
    params['sp_points'] = jnp.asarray(pts[rng.permutation(200)[:16]])
    params['sp_W'] = jnp.asarray(rng.normal(size=(256, 16))
                                 .astype(np.float32))
    model = model._replace(params=params)
    return run_steps(cfg, model, scene, meta,
                     tmp_path_factory.mktemp('largest'), (3,),
                     sp_initialized=True, reinit_done=True)


def test_largest_warp_matches_jax(largest_run):
    s = largest_run[3]
    check_step(s)
    alive = s['tflat']['alive']
    assert len(np.unique(s['tflat']['p2sp'][alive])) > 4


def test_sk_step_needs_the_skeleton(sp_run):
    """The first sk-family step runs the skeleton initialisation before it
    and sets the flag (its loops cut to 4 iterations here), on a copy of
    the last sp step's model."""
    tt = sp_run[STEPS[-1]]['trainer']
    cfg = tt.cfg._replace(joint_init_steps=4)
    model = convert.model_from_flat(convert.model_to_flat(tt.model), cfg,
                                    tt.rcfg, device='cpu', trainable=True)
    fresh = ttrainer.SKGSTrainer(cfg, tt.rcfg, tt.scene, tt.meta, model,
                                 tlosses.LossWeights(LOSS),
                                 sp_initialized=True, reinit_done=True,
                                 device='cpu')
    sk_step = cfg.stages['sk'][0] + 1
    assert not fresh.skeleton_initialized
    m = fresh.train_step(sk_step)
    assert fresh.skeleton_initialized and fresh.step == sk_step
    assert np.isfinite(float(m['loss']))
    assert not model.sp_weights.eq(tt.model.sp_weights).all()
    assert not torch.equal(model.params['joints'], tt.model.params['joints'])
    assert not tt.skeleton_initialized


def test_sp_parts_not_ported_raise(sp_run):
    """Nothing of the sp family raises any more: each of its regularizers
    is computed when it has weight (finite), and a net that is not
    is_blender trains (its noisy time, and the parity of both with the JAX
    trainer: test_torch_regularizers.py and test_torch_train_options.py)."""
    tt = sp_run[STEPS[-1]]['trainer']
    step = STEPS[-1]
    blender = tt.cfg
    try:
        for name in ('elastic', 'acc', 'arap', 're_pos', 'jp_dist',
                     'sp_arap_t', 'sp_arap_ct'):
            tt.loss_w = tlosses.LossWeights({**LOSS, name: 0.1})
            assert tt.family('sp') == 'sp'
            losses = tt._losses('sp', 0, tt.zero_grads(), step)[0]
            assert torch.isfinite(losses[name]), name
        tt.loss_w = tlosses.LossWeights(LOSS)
        assert tt.family('sk_init') == 'sk_init'
        tt.cfg = blender._replace(net=blender.net._replace(is_blender=False))
        assert tt.family('sp_fix') == 'sp'
    finally:
        tt.loss_w = tlosses.LossWeights(LOSS)
        tt.cfg = blender
