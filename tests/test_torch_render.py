"""Port parity, renderer: sk_gs_tpu_torch.render vs sk_gs_tpu.render on the
same numpy scenes (tests/test_render.py's build_inputs / make_view).

Tolerances: preprocess float fields rtol/atol 1e-5 (the same elementwise
formulas, matrix products summed in another order); integer fields and the
binning exactly; blended pixels atol 3e-5, the bound the JAX package's own
Pallas-vs-oracle test uses (exp and the transmittance product round
differently in the two frameworks); blend gradients 3e-4 of each column
group's max magnitude, the bar of its gradient test
(tests/test_tile_kernel.py:31-64). The Pallas kernels run in interpret
mode, as tests/test_tile_kernel.py runs them, with a chunk that holds each
tile's list where the stop rule matters (see test_torch_slice.py).
"""
import re
from importlib import import_module
from pathlib import Path

import jax
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
from sk_gs_tpu_torch.render.tile_kernel import (TileBlend, tile_blend_bwd,
                                                tile_blend_fwd)
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
        outcomes = dict.fromkeys(tblend.OUTCOMES, 0)
        for t in range(cfg.num_tiles):
            T = np.ones(cfg.pix_per_tile, np.float32)
            live = np.ones(cfg.pix_per_tile, bool)
            for x, y, a, b, c, o in geo_n[sg[ts[t]:ts[t] + tc[t]]]:
                evals += int(live.sum())
                dx, dy = px[t] - x, py[t] - y
                power = -0.5 * (a * dx * dx + c * dy * dy) - b * dx * dy
                alpha = np.minimum(np.float32(0.99),
                                   o * np.exp(np.minimum(power, 0.0)))
                near = power <= tblend.POWER_SKIP_EPS
                kept = live & near & (alpha >= tblend.ALPHA_MIN)
                test_t = T * (1.0 - alpha)
                stop = kept & (test_t < tblend.T_EPS)
                for name, m in (('skipped_power', live & ~near),
                                ('below_alpha_min', live & near & ~kept),
                                ('adds', kept & ~stop), ('stops', stop)):
                    outcomes[name] += int(m.sum())
                T = np.where(kept & ~stop, test_t, T)
                live &= ~stop
        assert stats['evaluations'] == evals > 0
        assert {k: stats[k] for k in tblend.OUTCOMES} == outcomes

    def test_outcome_counts_add_up(self):
        """Every evaluation of the plain forward has one outcome, and a
        pixel stops at most once."""
        cfg, _, _, _, args, _ = TestPlainBackward.scene(
            np.random.default_rng(0), 16, n=600)
        stats = {}
        _, alpha = tblend.blend_forward_plain(*args, port_cfg(cfg),
                                              stats=stats)
        assert float(alpha.max()) > 0.99          # some pixels stop
        assert sum(stats[k] for k in tblend.OUTCOMES) == stats['evaluations']
        assert stats['adds'] > 0 and stats['below_alpha_min'] > 0
        assert 0 < stats['stops'] <= cfg.num_tiles * cfg.pix_per_tile


FWD_HEADER = (Path(tblend.__file__).resolve().parents[1] / 'csrc'
              / 'blend_fwd_rows.cuh')


def header_float(name: str) -> float:
    """The value of a ``constexpr float`` of the forward kernels' header,
    written as ``<number>f``."""
    m = re.search(rf'constexpr float {name} = ([0-9.e+-]+)f;',
                  FWD_HEADER.read_text())
    assert m, name
    return float(m.group(1))


@pytest.mark.parametrize('o_lo,o_hi', [(1e-6, 1 / 255), (1 / 255, 0.02),
                                       (0.02, 1.0)])
def test_pretest_cut_proves_alpha_below_min(o_lo, o_hi):
    """The forward kernels' pre-test (csrc/blend_fwd_rows.cuh): an
    evaluation with power < cut = logf((1/255) / o) - kCutMargin is
    skipped without expf, which is exact only if o exp(min(power, 0)) <
    1/255 then.
    A copy of the header's formula in float32, at powers just below the
    cut: the float32 product stays below 1/255, and the exact one keeps at
    least half the margin below it, more than the header's bound on CUDA's
    rounding (1.1e-6). Below 1/255 the cut is positive, and every power
    gives an alpha below 1/255 there."""
    f32 = np.float32
    a_min = f32(1 / 255)
    margin = f32(header_float('kCutMargin'))
    assert 0 < margin <= 1e-4
    rng = np.random.default_rng(7)
    o = rng.uniform(o_lo, o_hi, size=4000).astype(f32)
    o = np.concatenate([o, np.asarray([o_lo, o_hi], f32)])
    cut = (np.log(a_min / o) - margin).astype(f32)
    assert cut.dtype == f32
    assert (cut < 0).all() if o_lo >= a_min else (cut > 0).any()
    powers = [cut]
    for _ in range(16):                  # the 16 floats just below the cut
        powers.append(np.nextafter(powers[-1], f32(-np.inf)))
    powers.append((cut - rng.uniform(0, 2, size=cut.shape)).astype(f32))
    for p in powers[1:]:
        assert (p < cut).all()
        x = np.minimum(p, f32(0))
        assert (o * np.exp(x) < a_min).all()                  # in float32
        exact = o.astype(np.float64) * np.exp(x.astype(np.float64))
        assert (exact < float(a_min) * np.exp(-0.5 * float(margin))).all()


GROUPS = {'xy': slice(0, 2), 'conic': slice(2, 5), 'opacity': slice(5, 6),
          'colour': slice(6, None)}


def close_groups(got, ref, tol=3e-4):
    """Per-entry gradient rows within ``tol`` of each column group's max."""
    for name, sl in GROUPS.items():
        scale = np.abs(ref[:, sl]).max()
        assert scale > 0, name
        err = np.abs(got[:, sl] - ref[:, sl]).max()
        assert err <= tol * scale, f'{name}: {err} > {tol} x {scale}'


class TestPlainBackward:
    """blend_backward_plain (kernel #2's plain version) against the Pallas
    backward and against autograd of the plain forward."""

    @staticmethod
    def scene(rng, tile_h, chunk=256, n=300):
        cfg = CFG_P._replace(tile_h=tile_h, chunk=chunk)
        g = build_inputs(rng, n)
        # dense enough that many pixels reach the stop rule
        g = g._replace(opacities=jnp.asarray(
            rng.uniform(0.5, 0.99, size=n).astype(np.float32)))
        pre = jpre.preprocess(g, make_view(), cfg)
        binned = jbin.build_tile_lists(pre, cfg)
        geo, col = port_blend_inputs(binned, pre, g.opacities, pre.colors)
        args = (geo, col, to_t(binned.sort_gauss), to_t(binned.tile_start),
                to_t(binned.tile_count))
        cot = (torch.from_numpy(rng.normal(size=(cfg.num_tiles,
                                                 cfg.pix_per_tile, 3))
                                .astype(np.float32)),
               torch.from_numpy(rng.normal(size=(cfg.num_tiles,
                                                 cfg.pix_per_tile))
                                .astype(np.float32)))
        return cfg, g, pre, binned, args, cot

    @pytest.mark.parametrize('tile_h', [16, 8])
    def test_matches_pallas_backward(self, rng, tile_h):
        cfg, g, pre, binned, args, (gc, ga) = self.scene(rng, tile_h)
        pad1 = lambda x: jnp.concatenate([x, jnp.zeros_like(x[:1])], axis=0)
        do = binned.depth_order
        feat_s = jtk._build_feat_sorted(
            binned.sort_gauss, pad1(pre.means2d)[do], pad1(pre.conic)[do],
            pad1(g.opacities.reshape(-1))[do], pad1(pre.colors)[do])
        color, alpha = jtk._pallas_forward_tile(
            feat_s, binned.tile_start, binned.tile_count, cfg, 3)
        gfeat = jtk._pallas_backward_tile(
            feat_s, binned.tile_start, binned.tile_count, color, alpha,
            jnp.asarray(gc.numpy()).transpose(0, 2, 1),
            jnp.asarray(ga.numpy())[:, None, :], cfg, 3)
        t_color, t_alpha = tblend.blend_forward_plain(*args, port_cfg(cfg))
        assert float(t_alpha.max()) > 0.99     # some pixels stop early
        g_entry = tblend.blend_backward_plain(*args, t_color, t_alpha, gc, ga,
                                              port_cfg(cfg))
        assert g_entry.shape == (binned.sort_gauss.shape[0], 9)
        # rows past the tiles' lists are zero here and unwritten there
        n = int(np.asarray(binned.tile_count).sum())
        assert not g_entry[n:].any()
        close_groups(to_np(g_entry)[:n], np.asarray(gfeat)[:n, :9])
        # the wrapper takes the plain version for CPU tensors: the per-entry
        # rows of the tiles' lists summed onto the depth-ordered rows
        before = tile_blend_bwd.launches
        w_rows = tile_blend_bwd(*args, t_color, t_alpha, gc, ga,
                                port_cfg(cfg))
        assert tile_blend_bwd.launches == before
        sort_gauss = args[2].long()
        ref_rows = torch.zeros((args[0].shape[0], 9)).index_add_(
            0, sort_gauss[:n], g_entry[:n])
        np.testing.assert_array_equal(to_np(w_rows), to_np(ref_rows))
        assert not w_rows[-1].any()       # the dummy row

    @pytest.mark.parametrize('batch', [7, 32])
    def test_matches_autograd_of_plain_forward(self, rng, batch):
        """Per-entry leaves through the plain forward (its clamps pass the
        gradient straight through), at a chunk shorter than the lists."""
        cfg, _, _, _, args, (gc, ga) = self.scene(rng, 16, chunk=64)
        pcfg = port_cfg(cfg)
        geo, col, sort_gauss, tile_start, tile_count = args
        rows = sort_gauss.long()
        geo_e = geo[rows].clone().requires_grad_(True)
        col_e = col[rows].clone().requires_grad_(True)
        ids = torch.arange(rows.shape[0], dtype=torch.int32)
        color, alpha = tblend.blend_forward_plain(geo_e, col_e, ids,
                                                  tile_start, tile_count,
                                                  pcfg, batch=batch)
        loss = torch.sum(color * gc) + torch.sum(alpha * ga)
        ref = torch.cat(torch.autograd.grad(loss, (geo_e, col_e)), dim=-1)
        g_entry = tblend.blend_backward_plain(*args, color.detach(),
                                              alpha.detach(), gc, ga, pcfg,
                                              batch=batch)
        close_groups(to_np(g_entry), to_np(ref), tol=3e-5)

    def test_tile_blend_matches_jax_vjp(self, rng):
        """TileBlend's gradient of the depth-ordered rows, mapped back to
        the Gaussians, against jax.vjp of blend_chunks_pallas."""
        cfg, g, pre, binned, args, (gc, ga) = self.scene(rng, 16)
        pad1 = lambda x: jnp.concatenate([x, jnp.zeros_like(x[:1])], axis=0)
        prim = (pad1(pre.means2d), pad1(pre.conic),
                pad1(g.opacities.reshape(-1)), pad1(pre.colors))
        _, vjp = jax.vjp(lambda *x: jtk.blend_chunks_pallas(binned, *x, cfg),
                         *prim)
        ref = vjp((jnp.asarray(gc.numpy()), jnp.asarray(ga.numpy())))
        ref = np.concatenate([np.asarray(ref[0]), np.asarray(ref[1]),
                              np.asarray(ref[2])[:, None],
                              np.asarray(ref[3])], axis=-1)
        geo, col = (a.clone().requires_grad_(True) for a in args[:2])
        for use_kernel in (True, False):
            pcfg = port_cfg(cfg)._replace(use_kernel=use_kernel)
            before = (tile_blend_fwd.launches, tile_blend_bwd.launches)
            color, alpha = TileBlend.apply(geo, col, *args[2:], pcfg)
            g_geo, g_col = torch.autograd.grad(
                torch.sum(color * gc) + torch.sum(alpha * ga), (geo, col))
            assert (tile_blend_fwd.launches,
                    tile_blend_bwd.launches) == before
            rows = torch.cat([g_geo, g_col], dim=-1)
            got = torch.zeros_like(rows)
            got[binned.depth_order.tolist()] = rows   # rank -> original id
            # the last row is the zero dummy: the JAX side sums its
            # interpret-mode rows past the pairs (never written) onto it
            close_groups(to_np(got)[:-1], ref[:-1])


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
