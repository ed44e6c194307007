"""Port parity, the ``chunk`` schedule: the binning's chunk metadata, the
plain chunk blend forward and backward (the plain versions of kernels #3
and #4) and ``ChunkBlend``, against the JAX package's chunk schedule
(``tile_kernel.IMPL['schedule'] = 'chunk'``, Pallas in interpret mode) and
its oracle ``render_reference``.

Tolerances as in test_torch_render.py: the chunk metadata exactly; pixels
atol 3e-5; gradients 3e-4 of each column group's max, and 3e-5 for the
plain backward against autograd of the plain forward (the same float32
arithmetic in another order). The port stops a pixel for good at
T (1 - alpha) < 1e-4, where the Pallas chunk kernel resumes at the next
chunk (ROADMAP.md §3), so it is held against ``_pallas_forward`` at a chunk
that holds each tile's list and against the oracle at chunk 16.
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
from sk_gs_tpu.render import render as jrender
from sk_gs_tpu.render import preprocess as jpreprocess
from sk_gs_tpu.render import render_reference
from sk_gs_tpu_torch.render.render import render as trender
from sk_gs_tpu_torch.render.tile_kernel import (KERNELS, ChunkBlend,
                                                chunk_blend_bwd,
                                                chunk_blend_fwd)
from tests.test_torch_cli import one_torch_thread  # noqa: F401
from tests.test_render import CFG, build_inputs, make_view
from tests.test_torch_render import (close_groups, port_blend_inputs,
                                     port_cfg, port_inputs, port_pre,
                                     port_view, to_np)

CHUNK_FIELDS = ('chunk_tile', 'chunk_start_flag', 'chunk_src', 'chunk_valid')


@pytest.fixture(autouse=True)
def chunk_schedule(monkeypatch):
    monkeypatch.setattr(jtk, 'INTERPRET', True)
    monkeypatch.setitem(jtk.IMPL, 'schedule', 'chunk')


def left_scene(seed=0, n=240, dense=False):
    """A cloud off the view's centre: the last column of tiles and most of
    the bottom row, the last tile included, stay empty."""
    rng = np.random.default_rng(seed)
    g = build_inputs(rng, n)
    means = np.asarray(g.means3d) * np.asarray([0.45, 0.4, 0.5], np.float32)
    g = g._replace(means3d=jnp.asarray(means + np.asarray([0.55, 0.3, 0.0],
                                                          np.float32)))
    if dense:   # many pixels reach the stop rule
        g = g._replace(opacities=jnp.asarray(
            rng.uniform(0.5, 0.99, size=n).astype(np.float32)))
    return g


def chunk_cfg(chunk):
    return CFG._replace(use_pallas=True, chunk=chunk)


def port_chunk_cfg(cfg):
    return port_cfg(cfg)._replace(schedule='chunk')


def binned_pair(g, cfg):
    pre = jpreprocess(g, make_view(), cfg)
    ref = jbin.build_tile_lists(pre, cfg)
    out = tbin.build_tile_lists(port_pre(pre), port_chunk_cfg(cfg))
    return pre, ref, out


def chunk_args(out):
    return tuple(getattr(out, k) for k in ('sort_gauss',) + CHUNK_FIELDS)


@pytest.mark.parametrize('chunk', [16, 64])
def test_chunk_fields_match_jax(chunk):
    cfg = chunk_cfg(chunk)
    _, ref, out = binned_pair(left_scene(), cfg)
    counts = np.asarray(ref.tile_count)
    assert counts[-1] == 0 and (counts[:-1] == 0).any()   # empty tiles
    assert counts.max() > chunk                 # tiles span several chunks
    assert int(np.asarray(ref.chunk_valid).sum()) == counts.sum()
    nc = jbin.num_chunks(cfg)
    assert tbin.num_chunks(port_cfg(cfg)) == nc
    assert tbin.padded_capacity(port_cfg(cfg)) == jbin.padded_capacity(cfg)
    for name in CHUNK_FIELDS:
        got = getattr(out, name)
        assert got.dtype == torch.int32 and got.shape == (nc,), name
        np.testing.assert_array_equal(to_np(got), np.asarray(getattr(ref, name)),
                                      err_msg=name)
    np.testing.assert_array_equal(to_np(out.tile_nonempty),
                                  np.asarray(ref.tile_nonempty))


def test_chunk_fields_only_on_the_chunk_schedule():
    cfg = chunk_cfg(64)
    pre = jpreprocess(left_scene(), make_view(), cfg)
    out = tbin.build_tile_lists(port_pre(pre), port_cfg(cfg))
    assert all(getattr(out, k) is None for k in CHUNK_FIELDS)
    with pytest.raises(ValueError, match='schedule'):
        tbin.build_tile_lists(port_pre(pre),
                              port_cfg(cfg)._replace(schedule='chunks'))


def test_plain_forward_matches_pallas_chunk_schedule():
    cfg = chunk_cfg(256)             # one chunk holds each tile's list
    g = left_scene()
    pre, ref, out = binned_pair(g, cfg)
    assert int(np.asarray(ref.tile_count).max()) <= 256
    pad1 = lambda x: jnp.concatenate([x, jnp.zeros_like(x[:1])], axis=0)
    color, alpha = jtk.blend_chunks_pallas(
        ref, pad1(pre.means2d), pad1(pre.conic),
        pad1(g.opacities.reshape(-1)), pad1(pre.colors), cfg)
    geo, col = port_blend_inputs(ref, pre, g.opacities, pre.colors)
    args = (geo, col, *chunk_args(out), port_chunk_cfg(cfg))
    t_color, t_alpha = tblend.chunk_blend_forward_plain(*args)
    np.testing.assert_allclose(to_np(t_color), np.asarray(color), atol=3e-5)
    np.testing.assert_allclose(to_np(t_alpha), np.asarray(alpha), atol=3e-5)
    assert float(t_alpha.max()) > 0.5
    empty = to_np(out.tile_count) == 0
    assert not to_np(t_color)[empty].any() and not to_np(t_alpha)[empty].any()
    # the wrapper takes the plain version for CPU tensors, and launches
    # nothing
    before = chunk_blend_fwd.launches
    w_color, w_alpha = chunk_blend_fwd(*args)
    assert chunk_blend_fwd.launches == before
    np.testing.assert_array_equal(to_np(w_color), to_np(t_color))
    np.testing.assert_array_equal(to_np(w_alpha), to_np(t_alpha))


@pytest.mark.parametrize('chunk', [16, 64, 256])
def test_chunk_walk_is_the_tile_walk_with_chunk_skip(chunk):
    """What kernel #3's per-tile loop computes: the chunk plain forward
    (wave by wave over the chunk layout) equals the tile schedule's walk of
    each tile's whole list with the chunk schedule's skip rule (power > 0),
    whatever the chunk."""
    cfg = chunk_cfg(chunk)
    g = left_scene(seed=4, dense=True)
    pre, ref, out = binned_pair(g, cfg)
    assert int(to_np(out.tile_count).max()) > min(chunk, 200)
    geo, col = port_blend_inputs(ref, pre, g.opacities, pre.colors)
    pcfg = port_chunk_cfg(cfg)
    c_color, c_alpha = tblend.chunk_blend_forward_plain(
        geo, col, *chunk_args(out), pcfg)
    t_color, t_alpha = tblend._forward(geo, col, tblend._tile_batches(
        out.sort_gauss, out.tile_start, out.tile_count, 32,
        geo.shape[0] - 1), pcfg, 0.0, None)
    assert float(t_alpha.max()) > 0.99             # some pixels stop
    np.testing.assert_allclose(to_np(c_color), to_np(t_color), atol=1e-6)
    np.testing.assert_allclose(to_np(c_alpha), to_np(t_alpha), atol=1e-6)


def test_outcome_counts_add_up():
    """The chunk plain forward's stats: every evaluation has one outcome,
    and a pixel stops at most once."""
    cfg = chunk_cfg(16)
    g = left_scene(seed=1, dense=True)
    pre, ref, out = binned_pair(g, cfg)
    geo, col = port_blend_inputs(ref, pre, g.opacities, pre.colors)
    stats = {}
    tblend.chunk_blend_forward_plain(geo, col, *chunk_args(out),
                                     port_chunk_cfg(cfg), stats=stats)
    assert sum(stats[k] for k in tblend.OUTCOMES) == stats['evaluations']
    assert stats['adds'] > 0 and stats['below_alpha_min'] > 0
    assert 0 < stats['stops'] <= cfg.num_tiles * cfg.pix_per_tile


@pytest.mark.parametrize('dense', [False, True])
def test_chunk_render_matches_oracle_at_chunk_16(dense):
    cfg = chunk_cfg(16)
    g = left_scene(seed=1, dense=dense)
    view = make_view()
    pre = jpreprocess(g, view, cfg)
    ref = render_reference(pre, g.opacities, cfg)
    out = trender(port_inputs(g), port_view(view), port_chunk_cfg(cfg))
    assert float(to_np(out['opacity']).max()) > (0.99 if dense else 0.5)
    for name in ('images', 'opacity'):
        np.testing.assert_allclose(to_np(out[name]), np.asarray(ref[name]),
                                   atol=3e-5, err_msg=name)
    # the chunk size does not change the port's result
    wide = trender(port_inputs(g), port_view(view),
                   port_chunk_cfg(chunk_cfg(256)))
    for name in ('images', 'opacity'):
        np.testing.assert_allclose(to_np(out[name]), to_np(wide[name]),
                                   atol=1e-6, err_msg=name)


def test_chunk_render_matches_jax_chunk_render():
    cfg = chunk_cfg(256)
    g = left_scene(seed=2)
    view = make_view()
    ref = jrender(g, view, cfg, active_sh_degree=jnp.asarray(2))
    out = trender(port_inputs(g), port_view(view), port_chunk_cfg(cfg),
                  active_sh_degree=torch.tensor(2))
    for name in ('images', 'opacity'):
        np.testing.assert_allclose(to_np(out[name]), np.asarray(ref[name]),
                                   atol=3e-5, err_msg=name)
    for name in ('radii', 'num_pairs', 'overflow'):
        np.testing.assert_array_equal(to_np(out[name]), np.asarray(ref[name]))


@pytest.mark.parametrize('field', CHUNK_FIELDS)
def test_a_bad_chunk_field_shows(field):
    """The plain version reads every chunk field itself: one wrong entry in
    any of them changes the image."""
    cfg = chunk_cfg(16)
    g = left_scene(seed=1, dense=True)
    pre, ref, out = binned_pair(g, cfg)
    geo, col = port_blend_inputs(ref, pre, g.opacities, pre.colors)
    args = list(chunk_args(out))
    good = tblend.chunk_blend_forward_plain(geo, col, *args,
                                            port_chunk_cfg(cfg))
    i = CHUNK_FIELDS.index(field) + 1
    bad = args[i].clone()
    # the second chunk of a tile that spans several
    wave = tblend.chunk_waves(out.chunk_start_flag)
    c = int(torch.nonzero((wave == 1) & (out.chunk_valid > 8))[0, 0])
    bad[c] = {'chunk_tile': lambda v: v + 1,
              'chunk_start_flag': lambda v: 1 - v,
              'chunk_src': lambda v: v - 3,
              'chunk_valid': lambda v: v - 4}[field](bad[c])
    args[i] = bad
    got = tblend.chunk_blend_forward_plain(geo, col, *args,
                                           port_chunk_cfg(cfg))
    diff = max(float((a - b).abs().max()) for a, b in zip(got, good))
    assert diff > 1e-3, field


def scene_and_cotangents(chunk, seed=3):
    cfg = chunk_cfg(chunk)
    g = left_scene(seed=seed, dense=True)
    pre, ref, out = binned_pair(g, cfg)
    geo, col = port_blend_inputs(ref, pre, g.opacities, pre.colors)
    rng = np.random.default_rng(seed)
    T, P = cfg.num_tiles, cfg.pix_per_tile
    gc = torch.from_numpy(rng.normal(size=(T, P, 3)).astype(np.float32))
    ga = torch.from_numpy(rng.normal(size=(T, P)).astype(np.float32))
    return cfg, g, pre, ref, out, geo, col, gc, ga


def test_chunk_blend_gradients_match_jax_chunk_vjp():
    """ChunkBlend's gradient of the depth-ordered rows, mapped back to the
    Gaussians, against jax.vjp of the JAX chunk schedule's custom VJP."""
    cfg, g, pre, ref, out, geo, col, gc, ga = scene_and_cotangents(256)
    pad1 = lambda x: jnp.concatenate([x, jnp.zeros_like(x[:1])], axis=0)
    prim = (pad1(pre.means2d), pad1(pre.conic),
            pad1(g.opacities.reshape(-1)), pad1(pre.colors))
    _, vjp = jax.vjp(lambda *x: jtk.blend_chunks_pallas(ref, *x, cfg), *prim)
    jg = vjp((jnp.asarray(gc.numpy()), jnp.asarray(ga.numpy())))
    jg = np.concatenate([np.asarray(jg[0]), np.asarray(jg[1]),
                         np.asarray(jg[2])[:, None], np.asarray(jg[3])],
                        axis=-1)
    geo, col = geo.requires_grad_(True), col.requires_grad_(True)
    for use_kernel in (True, False):
        pcfg = port_chunk_cfg(cfg)._replace(use_kernel=use_kernel)
        before = (chunk_blend_fwd.launches, chunk_blend_bwd.launches)
        color, alpha = ChunkBlend.apply(geo, col, *chunk_args(out), pcfg)
        assert float(alpha.detach().max()) > 0.99   # some pixels stop
        g_geo, g_col = torch.autograd.grad(
            torch.sum(color * gc) + torch.sum(alpha * ga), (geo, col))
        assert (chunk_blend_fwd.launches, chunk_blend_bwd.launches) == before
        rows = torch.cat([g_geo, g_col], dim=-1)
        got = torch.zeros_like(rows)
        got[ref.depth_order.tolist()] = rows     # rank -> original id
        # the last row is the dummy: the JAX side sums its interpret-mode
        # rows past the pairs (never written) onto it
        close_groups(to_np(got)[:-1], jg[:-1])


@pytest.mark.parametrize('chunk', [16, 64])
def test_plain_backward_matches_autograd_of_plain_forward(chunk):
    """Per-entry leaves through the chunk plain forward (its clamps pass
    the gradient straight through), at chunks shorter than the lists."""
    cfg, _, _, _, out, geo, col, gc, ga = scene_and_cotangents(chunk)
    pcfg = port_chunk_cfg(cfg)
    sort_gauss, *fields = chunk_args(out)
    rows = sort_gauss.long()
    geo_e = geo[rows].clone().requires_grad_(True)
    col_e = col[rows].clone().requires_grad_(True)
    ids = torch.arange(rows.shape[0], dtype=torch.int32)
    color, alpha = tblend.chunk_blend_forward_plain(geo_e, col_e, ids,
                                                    *fields, pcfg)
    assert float(alpha.detach().max()) > 0.99
    loss = torch.sum(color * gc) + torch.sum(alpha * ga)
    ref = torch.cat(torch.autograd.grad(loss, (geo_e, col_e)), dim=-1)
    g_entry = tblend.chunk_blend_backward_plain(
        geo, col, sort_gauss, *fields, color.detach(), alpha.detach(), gc, ga,
        pcfg)
    assert g_entry.shape == (sort_gauss.shape[0], 9)
    close_groups(to_np(g_entry), to_np(ref), tol=3e-5)
    # the wrapper takes the plain version for CPU tensors: the per-entry
    # rows of the chunks' entries summed onto the depth-ordered rows
    before = chunk_blend_bwd.launches
    w_rows = chunk_blend_bwd(geo, col, sort_gauss, *fields, color.detach(),
                             alpha.detach(), gc, ga, pcfg)
    assert chunk_blend_bwd.launches == before
    n = int(out.tile_count.sum())
    ref_rows = torch.zeros((geo.shape[0], 9)).index_add_(
        0, rows[:n], g_entry[:n])
    np.testing.assert_array_equal(to_np(w_rows), to_np(ref_rows))
    assert not w_rows[-1].any()           # the dummy row


def test_chunk_wrappers_launch_only_on_cuda():
    cfg = port_chunk_cfg(chunk_cfg(64))
    _, _, out = binned_pair(left_scene(), chunk_cfg(64))
    geo, col = torch.zeros(5, 6), torch.zeros(5, 3)
    T, P = cfg.num_tiles, cfg.pix_per_tile
    tiles, alpha = torch.zeros(T, P, 3), torch.zeros(T, P)
    before = (chunk_blend_fwd.launches, chunk_blend_bwd.launches)
    with pytest.raises(ValueError, match='CUDA'):
        chunk_blend_fwd.launch(geo, col, *chunk_args(out), cfg)
    with pytest.raises(ValueError, match='CUDA'):
        chunk_blend_bwd.launch(geo, col, *chunk_args(out), tiles, alpha,
                               tiles, alpha, cfg)
    assert (chunk_blend_fwd.launches, chunk_blend_bwd.launches) == before
    assert [k.name for k in KERNELS[2:]] == ['chunk_blend_fwd',
                                             'chunk_blend_bwd']
