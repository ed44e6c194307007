"""Port parity, the backward kernels' function (#2 on the tile schedule, #4
on the chunk schedule): the gradient rows [R, 6 + ch] of the depth-ordered
rows, the per-entry walk followed by the segment sum of ``_blend_bwd``.
Their plain versions ``blend_backward_rows_plain`` and
``chunk_blend_backward_rows_plain`` (what the wrappers run on CPU tensors)
against the JAX package's per-row gradients (g_xys, g_conic, g_opa, g_col)
from ``jax.vjp`` of ``blend_chunks_pallas`` in interpret mode, on both
schedules (``tile_kernel.IMPL['schedule']``), with a chunk that holds each
tile's list (the port stops a pixel for good; ROADMAP.md §3).

Tolerances: 3e-4 of each column group's max magnitude against JAX, the bar
of its gradient test (tests/test_tile_kernel.py:31-64); 3e-5 against
autograd of the plain forward (the same float32 arithmetic in another
order). The dummy row and the padding entries past the tiles' lists are
held exactly: the sum reads the live entries only.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sk_gs_tpu.render.binning as jbin
import sk_gs_tpu.render.tile_kernel as jtk
import sk_gs_tpu_torch.render.binning as tbin
import sk_gs_tpu_torch.render.blend as tblend
from sk_gs_tpu.render import preprocess as jpreprocess
from sk_gs_tpu_torch.render.tile_kernel import chunk_blend_bwd, tile_blend_bwd
from tests.test_torch_cli import one_torch_thread  # noqa: F401
from tests.test_render import CFG, build_inputs, make_view
from tests.test_torch_render import (close_groups, port_blend_inputs,
                                     port_cfg, port_pre, to_np)

# extras: 0 gives ch = 3, the kernels' compiled channel count; 2 gives
# ch = 5, their runtime-channel (CH == 0) path
CASES = [('tile', 0), ('tile', 2), ('chunk', 0), ('chunk', 2)]


@pytest.fixture(autouse=True)
def interpret_mode(monkeypatch):
    monkeypatch.setattr(jtk, 'INTERPRET', True)


class Scene:
    """A dense scene (many pixels stop) binned by both packages, the port's
    blend inputs, its plain forward and numpy cotangents."""

    def __init__(self, schedule, extras, chunk=256, seed=0, n=300):
        rng = np.random.default_rng(seed)
        self.cfg = CFG._replace(use_pallas=True, chunk=chunk)
        self.pcfg = port_cfg(self.cfg)._replace(schedule=schedule)
        g = build_inputs(rng, n)
        self.g = g._replace(opacities=jnp.asarray(
            rng.uniform(0.5, 0.99, size=n).astype(np.float32)))
        self.pre = jpreprocess(self.g, make_view(), self.cfg)
        self.ref = jbin.build_tile_lists(self.pre, self.cfg)
        self.out = tbin.build_tile_lists(port_pre(self.pre), self.pcfg)
        colors = np.asarray(self.pre.colors)
        if extras:
            colors = np.concatenate([colors, rng.uniform(
                size=(n, extras)).astype(np.float32)], axis=-1)
        self.colors = colors
        self.geo, self.col = port_blend_inputs(self.ref, self.pre,
                                               self.g.opacities, colors)
        b = self.out
        meta = ((b.chunk_tile, b.chunk_start_flag, b.chunk_src, b.chunk_valid)
                if schedule == 'chunk' else (b.tile_start, b.tile_count))
        self.meta = (b.sort_gauss,) + meta
        fwd = (tblend.chunk_blend_forward_plain if schedule == 'chunk'
               else tblend.blend_forward_plain)
        self.color, self.alpha = fwd(self.geo, self.col, *self.meta,
                                     self.pcfg)
        T, P, ch = self.pcfg.num_tiles, self.pcfg.pix_per_tile, colors.shape[1]
        self.gc = torch.from_numpy(rng.normal(size=(T, P, ch))
                                   .astype(np.float32))
        self.ga = torch.from_numpy(rng.normal(size=(T, P)).astype(np.float32))
        self.rows_plain = (tblend.chunk_blend_backward_rows_plain
                           if schedule == 'chunk'
                           else tblend.blend_backward_rows_plain)
        self.wrapper = chunk_blend_bwd if schedule == 'chunk' else tile_blend_bwd

    def rows(self, meta=None, geo=None, col=None):
        return self.rows_plain(
            self.geo if geo is None else geo,
            self.col if col is None else col, *(meta or self.meta),
            self.color, self.alpha, self.gc, self.ga, self.pcfg)

    def jax_rows(self):
        """[n + 1, 6 + ch] per Gaussian (original ids, the dummy last)."""
        pad1 = lambda x: jnp.concatenate([x, jnp.zeros_like(x[:1])], axis=0)
        prim = (pad1(self.pre.means2d), pad1(self.pre.conic),
                pad1(self.g.opacities.reshape(-1)),
                pad1(jnp.asarray(self.colors)))
        _, vjp = jax.vjp(
            lambda *x: jtk.blend_chunks_pallas(self.ref, *x, self.cfg), *prim)
        jg = vjp((jnp.asarray(self.gc.numpy()), jnp.asarray(self.ga.numpy())))
        return np.concatenate([np.asarray(jg[0]), np.asarray(jg[1]),
                               np.asarray(jg[2])[:, None], np.asarray(jg[3])],
                              axis=-1)

    def by_gaussian(self, rows):
        """Depth-ordered rows -> original ids (the dummy stays last)."""
        got = torch.zeros_like(rows)
        got[self.out.depth_order.long()] = rows
        return to_np(got)


@pytest.mark.parametrize('schedule,extras', CASES)
def test_rows_match_jax_vjp(monkeypatch, schedule, extras):
    monkeypatch.setitem(jtk.IMPL, 'schedule', schedule)
    sc = Scene(schedule, extras)
    assert int(np.asarray(sc.ref.tile_count).max()) <= sc.cfg.chunk
    assert float(sc.alpha.max()) > 0.99            # some pixels stop early
    rows = sc.rows()
    assert rows.shape == (sc.geo.shape[0], 9 + extras)
    # the dummy row n: no live entry reads it, nothing is added to it
    assert not rows[-1].any()
    # the JAX side sums its interpret-mode rows past the pairs (never
    # written) onto the dummy, so it is left out there
    close_groups(sc.by_gaussian(rows)[:-1], sc.jax_rows()[:-1])
    # the wrapper runs exactly this on CPU tensors, and launches nothing
    before = sc.wrapper.launches
    w_rows = sc.wrapper(sc.geo, sc.col, *sc.meta, sc.color, sc.alpha, sc.gc,
                        sc.ga, sc.pcfg)
    assert sc.wrapper.launches == before
    np.testing.assert_array_equal(to_np(w_rows), to_np(rows))


@pytest.mark.parametrize('schedule', ['tile', 'chunk'])
def test_padding_entries_are_not_read(schedule):
    """Rewriting the entries past the tiles' lists to other rows changes
    nothing: the walk and the sum read the live entries only."""
    sc = Scene(schedule, 0, chunk=64)
    n_live = int(sc.out.tile_count.sum())
    sort_gauss = sc.meta[0].clone()
    assert sort_gauss.shape[0] > n_live
    rng = np.random.default_rng(5)
    sort_gauss[n_live:] = torch.from_numpy(rng.integers(
        0, sc.geo.shape[0] - 1, size=sort_gauss.shape[0] - n_live)
        .astype(np.int32))
    rows = sc.rows()
    moved = sc.rows(meta=(sort_gauss,) + sc.meta[1:])
    assert rows.abs().max() > 0
    np.testing.assert_array_equal(to_np(moved), to_np(rows))
    assert not moved[-1].any()


@pytest.mark.parametrize('schedule', ['tile', 'chunk'])
def test_rows_match_autograd_of_plain_forward(schedule):
    """At a chunk shorter than the lists, the rows are autograd's gradient
    of the depth-ordered rows through the plain forward (whose clamps pass
    the gradient straight through)."""
    sc = Scene(schedule, 0, chunk=16, seed=1)
    assert int(sc.out.tile_count.max()) > 16
    geo = sc.geo.clone().requires_grad_(True)
    col = sc.col.clone().requires_grad_(True)
    fwd = (tblend.chunk_blend_forward_plain if schedule == 'chunk'
           else tblend.blend_forward_plain)
    color, alpha = fwd(geo, col, *sc.meta, sc.pcfg)
    loss = torch.sum(color * sc.gc) + torch.sum(alpha * sc.ga)
    ref = torch.cat(torch.autograd.grad(loss, (geo, col)), dim=-1)
    rows = sc.rows()
    close_groups(to_np(rows), to_np(ref), tol=3e-5)
    assert not rows[-1].any()
