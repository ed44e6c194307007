"""The port's CUDA kernels on the card, against their plain PyTorch versions.

Run on a machine with a CUDA card and nvcc (``--noconftest``: the tests'
conftest.py sets up JAX, which these tests do not use):

    python -m pytest tests/test_torch_gpu.py -m gpu -q --noconftest

Elsewhere every test skips (the card is looked for inside the fixture, never
at import or collection). The chunk-schedule kernels (#3, #4) are held to the
same bars as the tile kernels (#1, #2). Tolerance of the forward 1e-4: power and alpha
round the same on both sides (see csrc/tile_blend_fwd.cu); the
transmittance products and the colour sums are taken in another order, and
the 1e-4 transmittance cut bounds what such a reordering can flip. The
backward's per-entry rows: 3e-4 of each column group's max magnitude, the
bar of the JAX package's gradient test (tests/test_tile_kernel.py:31-64);
its running sums are taken in another order than the plain version's
cumulative sums.
"""
import math

import numpy as np
import pytest
import torch

from sk_gs_tpu_torch import convert
from sk_gs_tpu_torch.framework.evaluate import render_eval
from sk_gs_tpu_torch.framework.presets import synthetic_fullscale
from sk_gs_tpu_torch.framework.random_model import orbit_view, random_model_flat
from sk_gs_tpu_torch.models.gaussian_splatting import gaussian_inputs
from sk_gs_tpu_torch.models.sk_gs import forward_deltas
from sk_gs_tpu_torch.render import GaussianInputs, prepare_blend
from sk_gs_tpu_torch.render.blend import (blend_backward_plain,
                                          blend_forward_plain,
                                          chunk_blend_backward_plain,
                                          chunk_blend_forward_plain)
from sk_gs_tpu_torch.render.settings import RasterConfig
from sk_gs_tpu_torch.render.tile_kernel import (ChunkBlend, TileBlend,
                                                chunk_blend_bwd,
                                                chunk_blend_fwd,
                                                tile_blend_bwd, tile_blend_fwd)

pytestmark = pytest.mark.gpu
TOL = 1e-4
BWD_TOL = 3e-4
GROUPS = {'xy': slice(0, 2), 'conic': slice(2, 5), 'opacity': slice(5, 6),
          'colour': slice(6, None)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card (the kernels build and run only there)')
    return torch.device('cuda')


def random_scene(n, device, seed=0, extras=0):
    rng = np.random.default_rng(seed)
    f = lambda *s: torch.tensor(rng.normal(size=s), dtype=torch.float32,
                                device=device)
    q = f(n, 4)
    return GaussianInputs(
        means3d=f(n, 3) * 0.8, scales=torch.exp(f(n, 3) * 0.5 - 3.0),
        rotations=q / q.norm(dim=-1, keepdim=True),
        opacities=torch.sigmoid(f(n)), sh=f(n, 16, 3) * 0.3,
        extras=f(n, extras) if extras else None)


def compare(inp, cfg):
    b = inp.binned
    args = (inp.geo, inp.col, b.sort_gauss, b.tile_start, b.tile_count, cfg)
    before = tile_blend_fwd.launches
    color, alpha = tile_blend_fwd(*args)
    torch.cuda.synchronize()
    assert tile_blend_fwd.launches == before + 1
    p_color, p_alpha = blend_forward_plain(*args)
    assert color.shape == p_color.shape and alpha.shape == p_alpha.shape
    assert torch.isfinite(color).all() and torch.isfinite(alpha).all()
    assert float((color - p_color).abs().max()) <= TOL
    assert float((alpha - p_alpha).abs().max()) <= TOL
    return color, alpha


def cotangents(color, alpha, seed=1):
    g = torch.Generator(device=color.device).manual_seed(seed)
    return (torch.randn(color.shape, generator=g, device=color.device),
            torch.randn(alpha.shape, generator=g, device=color.device))


def compare_bwd(inp, cfg, color, alpha):
    b = inp.binned
    args = (inp.geo, inp.col, b.sort_gauss, b.tile_start, b.tile_count, color,
            alpha, *cotangents(color, alpha), cfg)
    before = tile_blend_bwd.launches
    g_entry = tile_blend_bwd(*args)
    torch.cuda.synchronize()
    assert tile_blend_bwd.launches == before + 1
    ref = blend_backward_plain(*args)
    assert g_entry.shape == ref.shape == (b.sort_gauss.shape[0],
                                          6 + inp.col.shape[1])
    assert torch.isfinite(g_entry).all()
    for name, sl in GROUPS.items():
        scale = float(ref[:, sl].abs().max())
        assert scale > 0, name
        assert float((g_entry[:, sl] - ref[:, sl]).abs().max()) \
            <= BWD_TOL * scale, name
    # rows past the tiles' lists stay zero
    n = int(b.tile_count.sum())
    assert float(g_entry[n:].abs().max()) == 0.0


@pytest.mark.parametrize('tile_h,extras', [(16, 0), (8, 0), (16, 2)])
def test_kernel_matches_plain_small(cuda, tile_h, extras):
    cfg = RasterConfig(image_width=200, image_height=136, sh_degree=3,
                       pair_capacity=2 ** 18, tile_h=tile_h)
    g = random_scene(3000, cuda, extras=extras)
    view = orbit_view(0.4, cfg.image_width, cfg.image_height, device=cuda)
    inp = prepare_blend(g, view, cfg)
    assert int(inp.binned.num_pairs) > 0
    color, alpha = compare(inp, cfg)
    assert color.shape[-1] == 3 + extras
    # empty tiles come out zero
    empty = inp.binned.tile_count == 0
    assert float(color[empty].abs().sum()) == 0.0
    assert float(alpha[empty].abs().sum()) == 0.0
    compare_bwd(inp, cfg, color, alpha)


def test_kernel_matches_plain_full_width(cuda):
    cfg, rcfg, _ = synthetic_fullscale()
    model = convert.model_from_flat(random_model_flat(cfg, 0, 80_000), cfg,
                                    rcfg, device=cuda)
    view = orbit_view(1.0, rcfg.image_width, rcfg.image_height, device=cuda)
    with torch.no_grad():
        d = forward_deltas(cfg, model, torch.tensor(0.41, device=cuda), 'sk')
        g = gaussian_inputs(model.gauss_view(), cfg.gauss, d.d_xyz,
                            d.d_rotation, d.d_scaling)
        inp = prepare_blend(g, view, rcfg, model.active_sh_degree)
        assert 2 ** 19 <= int(inp.binned.num_pairs) <= 2 ** 20
        assert not bool(inp.binned.overflow)
        color, alpha = compare(inp, rcfg)
        compare_bwd(inp, rcfg, color, alpha)


def test_wrapper_checks_inputs(cuda):
    cfg = RasterConfig(image_width=32, image_height=32)
    geo = torch.zeros(5, 6, device=cuda)
    col = torch.zeros(5, 3, device=cuda)
    ints = torch.zeros(cfg.num_tiles, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match='sort_gauss'):
        tile_blend_fwd(geo, col, ints.to(torch.int64), ints, ints, cfg)
    with pytest.raises(ValueError, match='geo'):
        tile_blend_fwd(torch.zeros(6, 5, device=cuda).t(), col, ints, ints,
                       ints, cfg)
    color, alpha = tile_blend_fwd(geo, col, ints, ints, ints, cfg)
    assert float(color.abs().max()) == 0.0 == float(alpha.abs().max())
    with pytest.raises(ValueError, match='g_color'):
        tile_blend_bwd(geo, col, ints, ints, ints, color, alpha,
                       color[:, :, :2].contiguous(), alpha, cfg)
    with pytest.raises(ValueError, match='tile_alpha'):
        tile_blend_bwd(geo, col, ints, ints, ints, color, alpha.double(),
                       color, alpha, cfg)
    with pytest.raises(ValueError, match='warps'):
        odd = cfg._replace(tile_h=3)
        c3 = torch.zeros(odd.num_tiles, odd.pix_per_tile, 3, device=cuda)
        a3 = torch.zeros(odd.num_tiles, odd.pix_per_tile, device=cuda)
        i3 = torch.zeros(odd.num_tiles, dtype=torch.int32, device=cuda)
        tile_blend_bwd(geo, col, ints, i3, i3, c3, a3, c3, a3, odd)
    g_entry = tile_blend_bwd(geo, col, ints, ints, ints, color, alpha, color,
                             alpha, cfg)
    assert g_entry.shape == (cfg.num_tiles, 9)
    assert float(g_entry.abs().max()) == 0.0


def test_tile_blend_gradients_kernel_vs_plain(cuda):
    """TileBlend's gradients of the depth-ordered rows through the kernels
    and through the plain forward and backward, on the card."""
    cfg = RasterConfig(image_width=200, image_height=136, sh_degree=3,
                       pair_capacity=2 ** 18)
    g = random_scene(3000, cuda, seed=2)
    view = orbit_view(0.9, cfg.image_width, cfg.image_height, device=cuda)
    inp = prepare_blend(g, view, cfg)
    b = inp.binned
    grads = []
    for use_kernel in (True, False):
        geo = inp.geo.clone().requires_grad_(True)
        col = inp.col.clone().requires_grad_(True)
        color, alpha = TileBlend.apply(geo, col, b.sort_gauss, b.tile_start,
                                       b.tile_count,
                                       cfg._replace(use_kernel=use_kernel))
        gc, ga = cotangents(color, alpha, seed=5)
        grads.append(torch.autograd.grad(
            torch.sum(color * gc) + torch.sum(alpha * ga), (geo, col)))
    for got, ref in zip(*grads):
        scale = float(ref.abs().max())
        assert scale > 0
        assert float((got - ref).abs().max()) <= BWD_TOL * scale


def test_render_eval_card_matches_cpu(cuda):
    cfg, rcfg, _ = synthetic_fullscale()
    cfg = cfg._replace(gauss=cfg.gauss._replace(capacity=4096),
                       num_superpoints=64)
    rcfg = rcfg._replace(image_width=96, image_height=80,
                         pair_capacity=2 ** 16)
    flat = random_model_flat(cfg, 3, n_alive=3000, log_scale_mean=-3.0)
    outs = []
    for dev in (cuda, torch.device('cpu')):
        model = convert.model_from_flat(flat, cfg, rcfg, device=dev)
        view = orbit_view(math.pi / 3, 96, 80, device=dev)
        outs.append(render_eval(model, view, 0.3,
                                torch.ones(3, device=dev))['image'].cpu())
    assert float((outs[0] - outs[1]).abs().max()) <= TOL


def chunk_args(inp):
    b = inp.binned
    return (inp.geo, inp.col, b.sort_gauss, b.chunk_tile, b.chunk_start_flag,
            b.chunk_src, b.chunk_valid)


def compare_chunk(inp, cfg):
    """Kernels #3 and #4 against their plain versions; returns the waits."""
    args = chunk_args(inp)
    before = (chunk_blend_fwd.launches, chunk_blend_bwd.launches)
    color, alpha = chunk_blend_fwd(*args, cfg)
    torch.cuda.synchronize()
    p_color, p_alpha = chunk_blend_forward_plain(*args, cfg)
    assert torch.isfinite(color).all() and torch.isfinite(alpha).all()
    assert float((color - p_color).abs().max()) <= TOL
    assert float((alpha - p_alpha).abs().max()) <= TOL
    empty = ~inp.binned.tile_nonempty
    assert float(color[empty].abs().sum()) == 0.0 == float(alpha[empty].sum())
    waits = chunk_blend_fwd.waits()
    cot = cotangents(color, alpha, seed=4)
    g_entry = chunk_blend_bwd(*args, color, alpha, *cot, cfg)
    torch.cuda.synchronize()
    assert (chunk_blend_fwd.launches, chunk_blend_bwd.launches) == \
        (before[0] + 1, before[1] + 1)
    ref = chunk_blend_backward_plain(*args, p_color, p_alpha, *cot, cfg)
    assert torch.isfinite(g_entry).all()
    for name, sl in GROUPS.items():
        scale = float(ref[:, sl].abs().max())
        assert scale > 0, name
        assert float((g_entry[:, sl] - ref[:, sl]).abs().max()) \
            <= BWD_TOL * scale, name
    # the chunk route renders what the tile route renders, but for the
    # skip rule (power > 0 against > 1e-4) on a handful of entries
    t_color, _ = tile_blend_fwd(inp.geo, inp.col, inp.binned.sort_gauss,
                                inp.binned.tile_start, inp.binned.tile_count,
                                cfg._replace(schedule='tile'))
    assert float((t_color - color).abs().mean()) <= 1e-4
    return waits


@pytest.mark.parametrize('chunk,tile_h', [(128, 16), (64, 16), (128, 8)])
def test_chunk_kernels_match_plain_small(cuda, chunk, tile_h):
    cfg = RasterConfig(image_width=200, image_height=136, sh_degree=3,
                       pair_capacity=2 ** 18, chunk=chunk, tile_h=tile_h,
                       schedule='chunk')
    g = random_scene(3000, cuda, seed=6)
    view = orbit_view(0.4, cfg.image_width, cfg.image_height, device=cuda)
    inp = prepare_blend(g, view, cfg)
    assert int(inp.binned.tile_count.max()) > chunk   # several chunks a tile
    compare_chunk(inp, cfg)


def test_chunk_kernels_match_plain_full_width(cuda):
    cfg, rcfg, _ = synthetic_fullscale()
    rcfg = rcfg._replace(schedule='chunk')
    model = convert.model_from_flat(random_model_flat(cfg, 0, 80_000), cfg,
                                    rcfg, device=cuda)
    view = orbit_view(1.0, rcfg.image_width, rcfg.image_height, device=cuda)
    with torch.no_grad():
        d = forward_deltas(cfg, model, torch.tensor(0.41, device=cuda), 'sk')
        g = gaussian_inputs(model.gauss_view(), cfg.gauss, d.d_xyz,
                            d.d_rotation, d.d_scaling)
        inp = prepare_blend(g, view, rcfg, model.active_sh_degree)
        assert 2 ** 19 <= int(inp.binned.num_pairs) <= 2 ** 20
        waits = compare_chunk(inp, rcfg)
    assert 0 <= waits <= int((inp.binned.chunk_valid > 0).sum())


def test_chunk_blend_gradients_kernel_vs_plain(cuda):
    cfg = RasterConfig(image_width=200, image_height=136, sh_degree=3,
                       pair_capacity=2 ** 18, chunk=64, schedule='chunk')
    g = random_scene(3000, cuda, seed=2)
    view = orbit_view(0.9, cfg.image_width, cfg.image_height, device=cuda)
    inp = prepare_blend(g, view, cfg)
    grads = []
    for use_kernel in (True, False):
        geo = inp.geo.clone().requires_grad_(True)
        col = inp.col.clone().requires_grad_(True)
        color, alpha = ChunkBlend.apply(geo, col, *chunk_args(inp)[2:],
                                        cfg._replace(use_kernel=use_kernel))
        gc, ga = cotangents(color, alpha, seed=5)
        grads.append(torch.autograd.grad(
            torch.sum(color * gc) + torch.sum(alpha * ga), (geo, col)))
    for got, ref in zip(*grads):
        scale = float(ref.abs().max())
        assert scale > 0
        assert float((got - ref).abs().max()) <= BWD_TOL * scale
