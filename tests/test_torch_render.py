"""Port parity, renderer: sk_gs_tpu_torch.render vs sk_gs_tpu.render on the
same numpy scenes (tests/test_render.py's build_inputs / make_view).

Tolerances: preprocess float fields rtol/atol 1e-5 (the same elementwise
formulas, matrix products summed in another order); integer fields and the
binning exactly; blended pixels atol 3e-5, the bound the JAX package's own
Pallas-vs-oracle test uses (exp and the transmittance product round
differently in the two frameworks). The Pallas kernel runs in interpret
mode, as tests/test_tile_kernel.py runs it.
"""
from importlib import import_module

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sk_gs_tpu.render.binning as jbin
import sk_gs_tpu.render.tile_kernel as jtk
import sk_gs_tpu_torch.render.binning as tbin
import sk_gs_tpu_torch.render.blend as tblend
from sk_gs_tpu_torch.render.settings import (GaussianInputs, RasterConfig,
                                             ViewParams)
from sk_gs_tpu_torch.render.tile_kernel import tile_blend_fwd
from tests.test_render import CFG, build_inputs, make_view

# the render packages re-export functions named like these modules
jpre = import_module('sk_gs_tpu.render.preprocess')
jrender = import_module('sk_gs_tpu.render.render')
tpre = import_module('sk_gs_tpu_torch.render.preprocess')
trender = import_module('sk_gs_tpu_torch.render.render')

CFG_P = CFG._replace(use_pallas=True)


@pytest.fixture(autouse=True)
def interpret_mode(monkeypatch):
    monkeypatch.setattr(jtk, 'INTERPRET', True)


def to_t(x, dtype=None):
    """numpy / jax array (or None) -> CPU tensor."""
    if x is None:
        return None
    t = torch.from_numpy(np.array(x))
    return t if dtype is None else t.to(dtype)


def to_np(t):
    return t.detach().cpu().numpy()


def port_cfg(cfg) -> RasterConfig:
    """The port's RasterConfig for a JAX one (``use_pallas`` has no
    counterpart: the port's wrapper picks kernel or plain by device)."""
    d = cfg._asdict()
    d.pop('use_pallas')
    return RasterConfig(**d)


def port_view(view) -> ViewParams:
    return ViewParams(*(to_t(x) for x in view))


def port_inputs(g) -> GaussianInputs:
    return GaussianInputs(*(to_t(x) for x in g))


def port_pre(pre) -> tpre.PreprocessOut:
    return tpre.PreprocessOut(*(to_t(x) for x in pre))


def port_blend_inputs(binned, pre, opacities, colors):
    """(geo, col) rows in depth-rank order with the zero dummy row last, as
    render.blend_tiles builds them."""
    do = np.asarray(binned.depth_order)
    geo = np.concatenate([np.asarray(pre.means2d), np.asarray(pre.conic),
                          np.asarray(opacities).reshape(-1, 1)], axis=-1)
    geo = np.concatenate([geo, np.zeros((1, 6), np.float32)])[do]
    col = np.asarray(colors)
    col = np.concatenate([col, np.zeros((1, col.shape[1]), np.float32)])[do]
    return torch.from_numpy(geo), torch.from_numpy(col)


def jax_blend(g, view, cfg):
    pre = jpre.preprocess(g, view, cfg)
    binned = jbin.build_tile_lists(pre, cfg)
    pad1 = lambda x: jnp.concatenate([x, jnp.zeros_like(x[:1])], axis=0)
    color, alpha = jtk.blend_chunks_pallas(
        binned, pad1(pre.means2d), pad1(pre.conic),
        pad1(g.opacities.reshape(-1)), pad1(pre.colors), cfg)
    return pre, binned, color, alpha


class TestPreprocess:
    @pytest.mark.parametrize('tight', [True, False])
    def test_matches_jax(self, rng, tight):
        cfg = CFG._replace(tight_culling=tight)
        g = build_inputs(rng, 300)
        mask = rng.uniform(size=300) > 0.1
        g = g._replace(mask=jnp.asarray(mask))
        view = make_view()
        ref = jpre.preprocess(g, view, cfg, jnp.asarray(1))
        out = tpre.preprocess(port_inputs(g), port_view(view), port_cfg(cfg),
                              torch.tensor(1))
        for name in ('means2d', 'depths', 'conic', 'colors', 'tau'):
            np.testing.assert_allclose(to_np(getattr(out, name)),
                                       np.asarray(getattr(ref, name)),
                                       rtol=1e-5, atol=1e-5, err_msg=name)
        for name in ('radius', 'tiles_touched', 'rect_min', 'rect_max',
                     'visible'):
            np.testing.assert_array_equal(to_np(getattr(out, name)),
                                          np.asarray(getattr(ref, name)),
                                          err_msg=name)
        assert out.radius.dtype == torch.int32
        assert out.rect_min.dtype == torch.int32

    def test_int32_truncates_toward_zero(self):
        x = torch.tensor([-1.7, -0.5, 0.5, 2.9, float('nan'), 3e10, -3e10])
        got = tpre.to_int32(x).tolist()
        ref = np.asarray(jnp.asarray(np.asarray(x)).astype(jnp.int32)).tolist()
        assert got == ref


class TestBinning:
    @pytest.mark.parametrize('tile_h,tight', [(16, True), (8, True),
                                              (16, False)])
    def test_integer_identical(self, rng, tile_h, tight):
        cfg = CFG._replace(tile_h=tile_h, tight_culling=tight)
        g = build_inputs(rng, 300)
        pre = jpre.preprocess(g, make_view(), cfg)
        ref = jbin.build_tile_lists(pre, cfg)
        out = tbin.build_tile_lists(port_pre(pre), port_cfg(cfg))
        for name in ('sort_gauss', 'depth_order', 'tile_start', 'tile_count'):
            got = getattr(out, name)
            assert got.dtype == torch.int32, name
            np.testing.assert_array_equal(to_np(got),
                                          np.asarray(getattr(ref, name)),
                                          err_msg=name)
        assert int(out.num_pairs) == int(ref.num_pairs) > 0
        assert bool(out.overflow) is bool(ref.overflow) is False

    def test_overflow_clips_like_jax(self, rng):
        cfg = CFG._replace(pair_capacity=64)
        g = build_inputs(rng, 300)
        pre = jpre.preprocess(g, make_view(), cfg)
        ref = jbin.build_tile_lists(pre, cfg)
        out = tbin.build_tile_lists(port_pre(pre), port_cfg(cfg))
        assert bool(out.overflow) and bool(ref.overflow)
        assert int(out.num_pairs) == int(ref.num_pairs)
        np.testing.assert_array_equal(to_np(out.sort_gauss),
                                      np.asarray(ref.sort_gauss))
        np.testing.assert_array_equal(to_np(out.tile_count),
                                      np.asarray(ref.tile_count))


class TestPlainBlend:
    @pytest.mark.parametrize('tile_h', [16, 8])
    def test_matches_pallas_forward(self, rng, tile_h):
        cfg = CFG_P._replace(tile_h=tile_h)
        g = build_inputs(rng, 200)
        pre, binned, color, alpha = jax_blend(g, make_view(), cfg)
        geo, col = port_blend_inputs(binned, pre, g.opacities, pre.colors)
        args = (geo, col, to_t(binned.sort_gauss), to_t(binned.tile_start),
                to_t(binned.tile_count), port_cfg(cfg))
        t_color, t_alpha = tblend.blend_forward_plain(*args)
        assert t_color.shape == color.shape and t_alpha.shape == alpha.shape
        np.testing.assert_allclose(to_np(t_color), np.asarray(color), atol=3e-5)
        np.testing.assert_allclose(to_np(t_alpha), np.asarray(alpha), atol=3e-5)
        # the wrapper takes the plain version for CPU tensors, and launches
        # nothing
        before = tile_blend_fwd.launches
        w_color, w_alpha = tile_blend_fwd(*args)
        assert tile_blend_fwd.launches == before
        np.testing.assert_array_equal(to_np(w_color), to_np(t_color))
        np.testing.assert_array_equal(to_np(w_alpha), to_np(t_alpha))

    def test_batch_size_does_not_change_result(self, rng):
        cfg = port_cfg(CFG)
        g = build_inputs(rng, 300)
        pre = jpre.preprocess(g, make_view(), CFG)
        binned = jbin.build_tile_lists(pre, CFG)
        geo, col = port_blend_inputs(binned, pre, g.opacities, pre.colors)
        args = (geo, col, to_t(binned.sort_gauss), to_t(binned.tile_start),
                to_t(binned.tile_count), cfg)
        ref_c, ref_a = tblend.blend_forward_plain(*args, batch=1)
        assert float(ref_a.max()) > 0.9   # some pixels stop early
        for batch in (7, 64):
            c, a = tblend.blend_forward_plain(*args, batch=batch)
            np.testing.assert_allclose(to_np(c), to_np(ref_c), atol=1e-6)
            np.testing.assert_allclose(to_np(a), to_np(ref_a), atol=1e-6)

    def test_evaluation_count_matches_sequential_walk(self, rng):
        cfg = port_cfg(CFG)
        g = build_inputs(rng, 120)
        pre = jpre.preprocess(g, make_view(), CFG)
        binned = jbin.build_tile_lists(pre, CFG)
        geo, col = port_blend_inputs(binned, pre, g.opacities, pre.colors)
        stats = {}
        tblend.blend_forward_plain(geo, col, to_t(binned.sort_gauss),
                                   to_t(binned.tile_start),
                                   to_t(binned.tile_count), cfg, stats=stats)
        # walk each tile's entries in order, all its pixels at once
        geo_n, sg = geo.numpy(), np.asarray(binned.sort_gauss)
        ts, tc = np.asarray(binned.tile_start), np.asarray(binned.tile_count)
        px, py = (to_np(v) for v in tblend.tile_pixel_coords(cfg, 'cpu'))
        evals = 0
        for t in range(cfg.num_tiles):
            T = np.ones(cfg.pix_per_tile, np.float32)
            live = np.ones(cfg.pix_per_tile, bool)
            for x, y, a, b, c, o in geo_n[sg[ts[t]:ts[t] + tc[t]]]:
                evals += int(live.sum())
                dx, dy = px[t] - x, py[t] - y
                power = -0.5 * (a * dx * dx + c * dy * dy) - b * dx * dy
                alpha = np.minimum(np.float32(0.99),
                                   o * np.exp(np.minimum(power, 0.0)))
                kept = live & (power <= tblend.POWER_SKIP_EPS) \
                    & (alpha >= tblend.ALPHA_MIN)
                test_t = T * (1.0 - alpha)
                stop = kept & (test_t < tblend.T_EPS)
                T = np.where(kept & ~stop, test_t, T)
                live &= ~stop
        assert stats['evaluations'] == evals > 0


class TestRender:
    @pytest.mark.parametrize('tile_h', [16, 8])
    def test_matches_jax_pallas_render(self, rng, tile_h):
        cfg = CFG_P._replace(tile_h=tile_h)
        g = build_inputs(rng, 300)
        view = make_view()
        ref = jrender.render(g, view, cfg, active_sh_degree=jnp.asarray(2))
        out = trender.render(port_inputs(g), port_view(view), port_cfg(cfg),
                             active_sh_degree=torch.tensor(2))
        for name in ('images', 'opacity'):
            assert tuple(out[name].shape) == ref[name].shape
            np.testing.assert_allclose(to_np(out[name]), np.asarray(ref[name]),
                                       atol=3e-5, err_msg=name)
        for name in ('radii', 'visible', 'num_pairs', 'overflow'):
            np.testing.assert_array_equal(to_np(out[name]),
                                          np.asarray(ref[name]), err_msg=name)

    def test_extras_ride_the_blend(self, rng):
        g = build_inputs(rng, 120)
        g = g._replace(extras=jnp.asarray(
            rng.uniform(size=(120, 2)).astype(np.float32)))
        view = make_view()
        ref = jrender.render(g, view, CFG_P)
        out = trender.render(port_inputs(g), port_view(view), port_cfg(CFG_P))
        for name in ('images', 'opacity', 'extras'):
            np.testing.assert_allclose(to_np(out[name]), np.asarray(ref[name]),
                                       atol=3e-5, err_msg=name)

    def test_composite_background(self, rng):
        img = rng.uniform(size=(6, 5, 3)).astype(np.float32)
        opa = rng.uniform(size=(6, 5)).astype(np.float32)
        bg = np.asarray([1.0, 0.5, 0.25], np.float32)
        ref = jrender.composite_background(jnp.asarray(img), jnp.asarray(opa),
                                           jnp.asarray(bg))
        out = trender.composite_background(torch.from_numpy(img),
                                           torch.from_numpy(opa),
                                           torch.from_numpy(bg))
        np.testing.assert_allclose(to_np(out), np.asarray(ref), atol=1e-7)
        img_t = torch.from_numpy(img)
        assert trender.composite_background(img_t, torch.from_numpy(opa),
                                            None) is img_t
