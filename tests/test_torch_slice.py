"""Port parity, the serving slice end to end: a tiny SK-GS model built by
the JAX package (init_model + joint discovery on a random cost matrix),
saved with save_pytree, converted with sk_gs_tpu_torch.convert, and rendered
at (camera, t) by both packages.

The JAX side is the body of the trainer's eval renderer
(sk_gs_tpu/framework/trainer.py:1578-1592) with the Pallas blend in
interpret mode. Pixels agree at atol 3e-5 (the blend's bound, see
test_torch_render.py); the deformation in front of it agrees at 1e-5, so it
moves the splats by far less than a pixel's worth of that bound. PSNR and
SSIM sums agree at rtol 1e-5.

The JAX raster config uses a chunk that holds every tile's whole list. The
Pallas tile kernel applies the stop rule (T (1 - alpha) < 1e-4) inside a
chunk only: at the next chunk it resumes from the last transmittance that
passed, so an entry after a pixel's stop can still add. The port stops the
pixel for good, as the reference rasterizer and the JAX oracle
(render_reference) do; the two rules agree when one chunk covers the list,
and the port is also held against the oracle at any chunk.
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sk_gs_tpu.render.tile_kernel as jtk
from sk_gs_tpu.framework.checkpoint import save_pytree
from sk_gs_tpu.models import gaussian_splatting as jgs
from sk_gs_tpu.models import losses as jlosses
from sk_gs_tpu.models import sk_gs as jsk_gs
from sk_gs_tpu.models import skeleton as jskel
from sk_gs_tpu.models.deform import DeformNetConfig, SkeletonNetConfig
from sk_gs_tpu.render import (build_tile_lists, composite_background,
                              preprocess, render, render_reference)
from sk_gs_tpu_torch import convert
from sk_gs_tpu_torch.framework.evaluate import evaluate, render_eval
from sk_gs_tpu_torch.framework.presets import synthetic_fullscale
from sk_gs_tpu_torch.models import sk_gs as tsk_gs
from tests.test_torch_cli import one_torch_thread  # noqa: F401
from tests.test_render import make_view
from tests.test_torch_render import port_cfg, port_view

CAP, M, FRAMES = 256, 16, 6
TIMES = (0.0, 0.13, 0.5, 0.62, 0.91, 1.0)
BG = np.asarray([1.0, 1.0, 1.0], np.float32)


@pytest.fixture(autouse=True)
def interpret_mode(monkeypatch):
    monkeypatch.setattr(jtk, 'INTERPRET', True)


def tiny_cfg():
    return jsk_gs.SKGSConfig(
        gauss=jgs.GaussianConfig(capacity=CAP, sh_degree=3),
        net=DeformNetConfig(depth=2, width=32),
        sk_net=SkeletonNetConfig(width=32, depth=2, skips=(1,)),
        num_superpoints=M, num_knn=5, hyper_dim=8, num_frames=FRAMES)


def tiny_jax_model(seed=0):
    """A trained-looking sk model: random joints, a tree from the MST over
    a random cost, skeleton-net heads with weight, random LBS matrix."""
    rng = np.random.default_rng(seed)
    cfg = tiny_cfg()
    rcfg = make_view_cfg()
    pts = rng.normal(size=(200, 3)).astype(np.float32) * 0.7
    cols = rng.uniform(size=(200, 3)).astype(np.float32)
    base = jgs.init_from_pcd(pts, cols, cfg.gauss)
    times = np.linspace(0.0, 1.0, FRAMES).astype(np.float32)
    model = jsk_gs.init_model(jax.random.PRNGKey(seed), cfg, base, times)

    f = lambda *shape: rng.normal(size=shape).astype(np.float32)
    p = dict(model.params)
    p['scaling'] = jnp.asarray(-3.0 + 0.4 * f(CAP, 3))
    p['rotation'] = jnp.asarray(f(CAP, 4))
    p['opacity'] = jnp.asarray(f(CAP, 1))
    p['f_rest'] = jnp.asarray(0.2 * f(*p['f_rest'].shape))
    p['joints'] = jnp.asarray(0.6 * f(M, 3))
    p['sp_W'] = jnp.asarray(f(CAP, M))
    g_q = np.concatenate([0.1 * f(FRAMES, 3), np.ones((FRAMES, 1), np.float32)],
                         -1)
    p['global_tr'] = jnp.asarray(np.concatenate([0.1 * f(FRAMES, 3), g_q], -1))
    net = dict(p['sk_deform'])
    net['heads'] = [{'w': jnp.asarray(0.05 * f(*h['w'].shape)), 'b': h['b']}
                    for h in net['heads']]
    p['sk_deform'] = net

    sp_alive = rng.uniform(size=M) > 0.2
    cost = rng.uniform(1.0, 2.0, size=(M, M))
    parents, depth, root = jskel.joint_discovery_host(
        (cost + cost.T) / 2, sp_alive, use_native=False)
    model = model._replace(
        params=p, sp_alive=jnp.asarray(sp_alive),
        joint_parents=jnp.asarray(parents), joint_depth=jnp.asarray(depth),
        joint_root=jnp.asarray(root, jnp.int32),
        active_sh_degree=jnp.asarray(3, jnp.int32))
    return cfg, rcfg, model


def make_view_cfg():
    from sk_gs_tpu.render import RasterConfig
    # chunk 256 > the longest tile list of this scene (see module docstring)
    return RasterConfig(image_width=64, image_height=48, sh_degree=3,
                        pair_capacity=2 ** 14, chunk=256, use_pallas=True)


def jax_render_eval(cfg, rcfg, model, view, t, stage='sk', oracle=False):
    """trainer.py:1583-1592, un-jitted; ``oracle`` blends with the JAX
    package's per-pixel reference instead of the tile kernel."""
    out_def = jsk_gs.forward_deltas(cfg, model, t, stage, time_id=None,
                                    training=False)
    g = jgs.gaussian_inputs(model.gauss_view(), cfg.gauss,
                            d_xyz=out_def.d_xyz, d_rotation=out_def.d_rotation,
                            d_scaling=out_def.d_scaling)
    if oracle:
        pre = preprocess(g, view, rcfg, model.active_sh_degree)
        out = render_reference(pre, g.opacities, rcfg)
        assert int(build_tile_lists(pre, rcfg).tile_count.max()) > 64
    else:
        out = render(g, view, rcfg, active_sh_degree=model.active_sh_degree)
    return composite_background(out['images'], out['opacity'],
                                jnp.asarray(BG))


def port_model(cfg, rcfg, model, tmp_path):
    """save_pytree -> .npz -> convert, as a served checkpoint would go."""
    path = tmp_path / 'model.npz'
    save_pytree({'state': {'model': model}}, path)
    tcfg = tsk_gs.SKGSConfig(**to_port_cfg_fields(cfg))
    return convert.model_from_flat(convert.load_npz(path), tcfg,
                                   port_cfg(rcfg), device='cpu')


def to_port_cfg_fields(cfg):
    """JAX SKGSConfig -> field dict of the port's (nested configs by value)."""
    from sk_gs_tpu_torch.models import deform, gaussian_splatting
    d = cfg._asdict()
    d['gauss'] = gaussian_splatting.GaussianConfig(*cfg.gauss)
    d['net'] = deform.DeformNetConfig(*cfg.net)
    d['sk_net'] = deform.SkeletonNetConfig(*cfg.sk_net)
    return d


@pytest.fixture(scope='module')
def tiny(tmp_path_factory):
    cfg, rcfg, model = tiny_jax_model()
    tmodel = port_model(cfg, rcfg, model, tmp_path_factory.mktemp('ckpt'))
    return cfg, rcfg, model, tmodel


@pytest.mark.parametrize('stage', ['sk', 'static'])
def test_render_eval_matches_jax(tiny, stage):
    cfg, rcfg, model, tmodel = tiny
    view = make_view()
    for t in (TIMES[1], TIMES[4]) if stage == 'sk' else TIMES[:1]:
        ref = jax_render_eval(cfg, rcfg, model, view,
                              jnp.asarray(t, jnp.float32), stage)
        out = render_eval(tmodel, port_view(view), t, torch.from_numpy(BG),
                          stage=stage)
        img = out['image'].numpy()
        assert img.shape == ref.shape == (48, 64, 3)
        assert float(out['opacity'].max()) > 0.5      # the scene is in view
        np.testing.assert_allclose(img, np.asarray(ref), atol=3e-5,
                                   err_msg=f'{stage} t={t}')


def test_render_eval_matches_oracle_at_small_chunk(tiny):
    cfg, rcfg, model, tmodel = tiny
    tcfg = tmodel.rcfg._replace(chunk=64)
    view = make_view()
    ref = jax_render_eval(cfg, rcfg._replace(chunk=64), model, view,
                          jnp.asarray(0.13, jnp.float32), oracle=True)
    out = render_eval(tmodel, port_view(view), 0.13, torch.from_numpy(BG),
                      rcfg=tcfg)
    np.testing.assert_allclose(out['image'].numpy(), np.asarray(ref),
                               atol=3e-5)


def test_sk_deltas_match_jax(tiny):
    cfg, _, model, tmodel = tiny
    for t in TIMES:
        ref = jsk_gs.forward_deltas(cfg, model, jnp.asarray(t, jnp.float32),
                                    'sk', training=False)
        out = tsk_gs.forward_deltas(tmodel.cfg, tmodel, torch.tensor(t), 'sk')
        for name in ('d_xyz', 'd_rotation', 'd_scaling'):
            np.testing.assert_allclose(getattr(out, name).numpy(),
                                       np.asarray(getattr(ref, name)),
                                       atol=1e-5, err_msg=f'{name} t={t}')
        assert float(np.abs(np.asarray(ref.d_xyz)).max()) > 1e-3
        np.testing.assert_array_equal(out.aux['knn_i'].numpy(),
                                      np.asarray(ref.aux['knn_i']))
    # a train frame's own root transform, by index
    ref = jsk_gs.forward_deltas(cfg, model, jnp.asarray(0.4, jnp.float32), 'sk',
                                time_id=2, training=False)
    out = tsk_gs.forward_deltas(tmodel.cfg, tmodel, torch.tensor(0.4), 'sk',
                                time_id=2)
    np.testing.assert_allclose(out.d_xyz.numpy(), np.asarray(ref.d_xyz),
                               atol=1e-5)


def test_evaluate_sums_match_jax(tiny):
    cfg, rcfg, model, tmodel = tiny
    rng = np.random.default_rng(5)
    view = make_view()
    times = TIMES[1:4]
    gts = [rng.uniform(size=(48, 64, 3)).astype(np.float32),
           rng.uniform(size=(48, 64, 4)).astype(np.float32),   # RGBA
           rng.uniform(size=(48, 64, 3)).astype(np.float32)]
    psnr_ref = ssim_ref = 0.0
    for gt, t in zip(gts, times):
        img = jax_render_eval(cfg, rcfg, model, view,
                              jnp.asarray(t, jnp.float32))
        gt = jnp.asarray(gt)
        if gt.shape[-1] == 4:
            a = gt[..., 3:4]
            gt = gt[..., :3] * a + jnp.asarray(BG) * (1.0 - a)
        psnr_ref += float(jlosses.psnr(img, gt))
        ssim_ref += float(jlosses.ssim(img[..., :3], gt[..., :3]))
    out = evaluate(tmodel, [port_view(view)] * 3, gts, times, BG)
    assert out['count'] == 3 and len(out['requests']) == 3
    np.testing.assert_allclose(out['PSNR'], psnr_ref, rtol=1e-5)
    np.testing.assert_allclose(out['SSIM'], ssim_ref, rtol=1e-5)
    for req in out['requests']:
        assert req['num_pairs'] > 0 and req['overflow'] is False
        assert req['ms'] > 0
    assert out['fps'] > 0


def test_metrics_match_jax(rng):
    a = rng.uniform(size=(40, 30, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(size=a.shape).astype(np.float32) * 0.05, 0, 1)
    from sk_gs_tpu_torch.models import losses as tlosses
    for crop in (False, True):
        np.testing.assert_allclose(
            float(tlosses.ssim(torch.from_numpy(a), torch.from_numpy(b),
                               crop_border=crop)),
            float(jlosses.ssim(jnp.asarray(a), jnp.asarray(b),
                               crop_border=crop)), rtol=1e-5)
    np.testing.assert_allclose(
        float(tlosses.psnr(torch.from_numpy(a), torch.from_numpy(b))),
        float(jlosses.psnr(jnp.asarray(a), jnp.asarray(b))), rtol=1e-5)


def test_unported_branches_raise(tiny):
    cfg, rcfg, model, tmodel = tiny
    t = torch.tensor(0.3)
    # the init and sp families are ported
    for stage, atol in (('init', 1e-7), ('init_fix', 1e-7), ('sp', 1e-5),
                        ('sp_fix', 1e-5)):
        ref = jsk_gs.forward_deltas(cfg, model, jnp.asarray(0.3), stage)
        got = tsk_gs.forward_deltas(tmodel.cfg, tmodel, t, stage)
        np.testing.assert_allclose(got.d_xyz.detach().numpy(),
                                   np.asarray(ref.d_xyz), atol=atol,
                                   err_msg=stage)
    with pytest.raises(ValueError):
        tsk_gs.forward_deltas(tmodel.cfg, tmodel, t, 'no_such_stage')
    # the repose delta and the sk_cache read path are ported: both match
    # the JAX package (the cache holds a random row per frame here;
    # tests/test_torch_repose.py holds the cache that training writes)
    rng = np.random.default_rng(1)
    delta = (0.4 * rng.normal(size=(M, 3))).astype(np.float32)
    cache = rng.normal(size=tuple(tmodel.sk_cache.shape)).astype(np.float32)
    jmodel = model._replace(sk_cache=jnp.asarray(cache))
    tmodel.sk_cache.copy_(torch.from_numpy(cache))
    try:
        for interp, sk_r_delta in ((False, delta), (True, None),
                                   (True, delta)):
            ref = jsk_gs.forward_deltas(
                cfg._replace(test_time_interpolate=interp), jmodel,
                jnp.asarray(0.3), 'sk', training=False,
                sk_r_delta=None if sk_r_delta is None else
                jnp.asarray(sk_r_delta))
            got = tsk_gs.forward_deltas(
                tmodel.cfg._replace(test_time_interpolate=interp), tmodel, t,
                'sk', sk_r_delta=None if sk_r_delta is None else
                torch.from_numpy(sk_r_delta))
            np.testing.assert_allclose(got.d_xyz.detach().numpy(),
                                       np.asarray(ref.d_xyz), atol=1e-5,
                                       err_msg=f'interp {interp}')
    finally:
        tmodel.sk_cache.zero_()


def _as_dict(x):
    if hasattr(x, '_asdict'):
        return {k: _as_dict(v) for k, v in x._asdict().items()}
    return x


def test_fullscale_preset_matches_yaml():
    from sk_gs_tpu.framework.config import make_config
    from train import build_model_cfg
    meta = types.SimpleNamespace(num_frames=48)
    yaml_cfg = make_config('configs/synthetic_fullscale.yaml', [])
    ref_cfg, ref_rcfg = build_model_cfg(yaml_cfg, meta, (400, 400))
    cfg, rcfg, train = synthetic_fullscale()
    assert _as_dict(cfg) == _as_dict(ref_cfg)
    ref_r = ref_rcfg._asdict()
    ref_r.pop('use_pallas')
    got_r = rcfg._asdict()
    assert got_r.pop('use_kernel') is True
    assert got_r.pop('schedule') == 'tile'     # the JAX default IMPL
    assert got_r == ref_r
    assert (cfg.gauss.capacity, cfg.num_superpoints, rcfg.num_tiles,
            rcfg.pix_per_tile) == (100_352, 512, 625, 256)
    # the train settings: the loss weights, optimizer, lr, clip, seed and
    # initial points, and the dataset with train.py's GT pair budget
    assert train.loss == yaml_cfg['loss']
    t = yaml_cfg['train']
    assert train.num_init_points == t['num_init_points'] == 2000
    assert (train.lr, train.optimizer, train.seed) == (
        t['lr'], t['optimizer'], t['seed'])
    assert train.clip_norm == float(t.get('clip_norm', 0.0)) == 0.0
    assert cfg.gauss.lr == train.lr
    d = yaml_cfg['dataset']
    ds = train.dataset
    assert d['kind'] == 'synthetic'
    assert (ds.num_links, ds.gauss_per_link, ds.num_frames, ds.image_size,
            ds.background) == (d['num_links'], d['gauss_per_link'],
                               d['num_frames'], d['image_size'],
                               d['background'])
    assert ds.gt_pair_capacity == min(yaml_cfg['raster']['pair_capacity'],
                                      2 ** 17)
