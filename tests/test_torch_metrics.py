"""Port parity, the full evaluation's metrics: MS-SSIM (its level clamp at
small sizes), the border-cropped SSIM (NaN at 10 px or less in both
packages, a known defect copied), LPIPS on the same weight arrays, and the
split's six columns with their post-processing against the JAX trainer's
``evaluate(full_metrics=True)``.

The LPIPS fallback weights differ by design: the JAX package draws them
from ``jax.random``, which the port cannot reproduce, so each package's
'[uncalibrated]' column comes from its own arrays. Fed the JAX arrays, the
port's values agree to 1e-5 relative."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sk_gs_tpu.data.base import SceneMeta
from sk_gs_tpu.framework import lpips_jax, metrics as jmetrics
from sk_gs_tpu.framework.trainer import SKGSTrainer as JTrainer
from sk_gs_tpu.models import losses as jlosses
from sk_gs_tpu_torch.data.base import Scene
from sk_gs_tpu_torch.framework import lpips, metrics
from sk_gs_tpu_torch.framework.evaluate import FULL_METRICS, split_metrics
from sk_gs_tpu_torch.models import losses
from tests.test_torch_cli import one_torch_thread  # noqa: F401
from tests.test_torch_slice import (BG, FRAMES, make_view, tiny)  # noqa: F401

RTOL = 1e-5


def port_lpips(params, a, b, net):
    """The port's LPIPS of two [H, W, 3] arrays on the weight arrays."""
    nchw = lambda x: torch.from_numpy(x).permute(2, 0, 1)[None]
    return lpips.lpips_nchw(lpips.to_device(params, 'cpu'), nchw(a), nchw(b),
                            net)[0]


def pair(rng, h, w, noise=0.1):
    a = rng.uniform(size=(h, w, 3)).astype(np.float32)
    b = np.clip(a + noise * rng.normal(size=a.shape), 0, 1).astype(np.float32)
    return a, b


@pytest.mark.parametrize('size', [48, 64, 200])
def test_ms_ssim_matches_jax(rng, size):
    a, b = pair(rng, size, size + 8)
    ref = float(jmetrics.ms_ssim(jnp.asarray(a), jnp.asarray(b)))
    got = float(metrics.ms_ssim(torch.from_numpy(a), torch.from_numpy(b)))
    np.testing.assert_allclose(got, ref, rtol=RTOL)
    assert 0.0 < got < 1.0


def test_too_small_is_nan_in_both(rng):
    """Below the 11 px window MS-SSIM is the NaN mean of an empty map, and
    so are LPIPS taps that lose every pixel."""
    a, b = pair(rng, 10, 10)
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    assert np.isnan(float(jmetrics.ms_ssim(ja, jb)))
    assert np.isnan(float(metrics.ms_ssim(ta, tb)))
    for net in ('alex', 'vgg'):
        params = lpips_jax._init_fallback(net)
        ref = lpips_jax._lpips_nchw(
            {k: jnp.asarray(v) for k, v in params.items()},
            ja.transpose(2, 0, 1)[None], jb.transpose(2, 0, 1)[None], net)
        assert np.isnan(float(ref[0])), net
        assert np.isnan(float(port_lpips(params, a, b, net))), net
    assert lpips.fits('alex', 64, 64) and lpips.fits('vgg', 16, 16)
    assert not lpips.fits('vgg', 15, 64)


@pytest.mark.parametrize('size', [8, 10, 11, 24])
def test_border_cropped_ssim(rng, size):
    """The cropped map is empty at 10 px or less: NaN in both packages."""
    a, b = pair(rng, size, size)
    ref = float(jlosses.ssim(jnp.asarray(a), jnp.asarray(b),
                             crop_border=True))
    got = float(losses.ssim(torch.from_numpy(a), torch.from_numpy(b),
                            crop_border=True))
    if size <= 10:
        assert np.isnan(ref) and np.isnan(got)
    else:
        np.testing.assert_allclose(got, ref, rtol=RTOL)


@pytest.mark.parametrize('net', ['alex', 'vgg'])
def test_lpips_matches_jax_on_the_same_arrays(rng, net):
    params = lpips_jax._init_fallback(net)
    a, b = pair(rng, 64, 64, 0.2)
    ref = float(jnp.mean(lpips_jax._lpips_nchw(
        {k: jnp.asarray(v) for k, v in params.items()},
        jnp.asarray(a.transpose(2, 0, 1)[None]),
        jnp.asarray(b.transpose(2, 0, 1)[None]), net)))
    got = float(port_lpips(params, a, b, net))
    np.testing.assert_allclose(got, ref, rtol=RTOL)
    assert got > 0


@pytest.mark.parametrize('net', ['alex', 'vgg'])
def test_lpips_fallback_departs_from_jax(net):
    """Same shapes and calibration, other random features (pinned)."""
    ours, mode = lpips.load_weights(net)
    theirs = lpips_jax._init_fallback(net)
    assert mode == lpips_jax.lpips_mode(net) == 'untrained-fallback'
    assert set(ours) == set(theirs)
    for k in theirs:
        assert ours[k].shape == theirs[k].shape, k
        if k.startswith(('lin', 'conv')) and k.endswith(('_b', 'lin0_w')):
            np.testing.assert_array_equal(ours[k], theirs[k])
    assert not np.allclose(ours['conv0_w'], theirs['conv0_w'])
    std = float(np.std(ours['conv1_w']))
    np.testing.assert_allclose(std, np.std(theirs['conv1_w']), rtol=0.05)


def jax_scene_and_port(tiny_cfg, n=FRAMES, size=(64, 48)):
    """A split of n views of the tiny model's scene, as JAX and port
    Scenes: one camera, the train times, targets from a seeded render."""
    from sk_gs_tpu.data.base import Scene as JScene
    rng = np.random.default_rng(5)
    view = make_view()
    w, h = size
    times = np.linspace(0.0, 1.0, n).astype(np.float32)
    images = rng.uniform(0.6, 1.0, size=(n, h, w, 3)).astype(np.float32)
    fields = dict(images=images,
                  Tw2v=np.repeat(np.asarray(view.Tw2v)[None], n, 0),
                  Tv2c=np.repeat(np.asarray(view.Tv2c)[None], n, 0),
                  campos=np.repeat(np.asarray(view.campos)[None], n, 0),
                  tan_fovx=np.full(n, float(view.tan_fovx), np.float32),
                  tan_fovy=np.full(n, float(view.tan_fovy), np.float32),
                  times=times, time_ids=np.arange(n),
                  camera_ids=np.zeros(n, np.int64))
    jscene = JScene(**{k: jnp.asarray(v) for k, v in fields.items()})
    tscene = Scene(**{k: torch.as_tensor(v) for k, v in fields.items()})
    return jscene, tscene


def test_full_evaluate_matches_jax(tiny, monkeypatch):  # noqa: F811
    """The six columns, averaged over the split, with the JAX trainer's
    post-processing; the LPIPS columns on the JAX fallback arrays."""
    cfg, rcfg, model, tmodel = tiny
    jscene, tscene = jax_scene_and_port(cfg)
    meta = SceneMeta(background_type='white', background=BG,
                     num_frames=FRAMES,
                     train_times=np.asarray(model.train_times))
    jt = JTrainer(cfg, rcfg._replace(use_pallas=False), jscene, meta, model)
    ref = jt.evaluate(jscene, stage='sk', full_metrics=True)
    # the port's own fallback: the uncalibrated columns differ from JAX's
    own = split_metrics(tmodel, tscene, torch.from_numpy(BG), 'sk',
                        full_metrics=True)
    assert set(own) == set(ref)
    for net in ('alex', 'vgg'):
        k = f'LPIPS ({net}) [uncalibrated]'
        assert own[f'LPIPS ({net})'] is None and ref[f'LPIPS ({net})'] is None
        assert abs(own[k] - ref[k]) > 1e-3 * abs(ref[k])
    # the JAX arrays fed to the port
    monkeypatch.setitem(lpips._cache, 'alex',
                        (lpips_jax._init_fallback('alex'),
                         'untrained-fallback'))
    monkeypatch.setitem(lpips._cache, 'vgg',
                        (lpips_jax._init_fallback('vgg'),
                         'untrained-fallback'))
    got = split_metrics(tmodel, tscene, torch.from_numpy(BG), 'sk',
                        full_metrics=True)
    assert list(got) == list(own)
    assert got['LPIPS weights'] == ref['LPIPS weights'] == 'untrained-fallback'
    for k, v in ref.items():
        if isinstance(v, float):
            np.testing.assert_allclose(got[k], v, rtol=1e-4, err_msg=k)
    assert set(FULL_METRICS) - {'LPIPS (alex)', 'LPIPS (vgg)'} <= set(got)


def test_non_finite_columns_are_dropped(tiny):  # noqa: F811
    """At 10 px the border-cropped SSIM, MS-SSIM and both LPIPS are NaN:
    the columns go, as in the JAX trainer's evaluate."""
    cfg, rcfg, model, tmodel = tiny
    from sk_gs_tpu_torch.render.settings import RasterConfig
    _, tscene = jax_scene_and_port(cfg, n=2, size=(10, 10))
    small = RasterConfig(image_width=10, image_height=10, sh_degree=3,
                         pair_capacity=2 ** 12)
    got = split_metrics(tmodel, tscene, torch.from_numpy(BG), 'sk',
                        full_metrics=True, rcfg=small)
    assert set(got) == {'PSNR', 'SSIM', 'LPIPS weights'}
    assert np.isfinite(got['PSNR']) and np.isfinite(got['SSIM'])
