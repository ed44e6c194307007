"""The port's CUDA kernels on the card, against their plain PyTorch versions.

Run on a machine with a CUDA card and nvcc (``--noconftest``: the tests'
conftest.py sets up JAX, which these tests do not use):

    python -m pytest tests/test_torch_gpu.py -m gpu -q --noconftest

Elsewhere every test skips (the card is looked for inside the fixture, never
at import or collection). The mesh tests run 2 gloo ranks on the one card,
each a process of this file. Beside the kernels: the JPEG decoder built on the
card's machine against the committed fixtures' decodes, and the viewer's
top-k (plain torch ops) on the card against the CPU. The chunk-schedule kernels (#3, #4) are held to the
same bars as the tile kernels (#1, #2). Tolerance of the forward 1e-4: power and alpha
round the same on both sides (see csrc/tile_blend_fwd.cu); the
transmittance products and the colour sums are taken in another order, and
the 1e-4 transmittance cut bounds what such a reordering can flip. The
backward kernels' gradient rows of the depth-ordered rows: 3e-4 of each
column group's max magnitude, the bar of the JAX package's gradient test
(tests/test_tile_kernel.py:31-64); their running sums are taken in another
order than the plain versions' cumulative sums. Two launches on the same
inputs differ only in the order in which the tiles' atomics land on a row:
within 1e-5 of each column group's max.
"""
import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from sk_gs_tpu_torch import convert
from sk_gs_tpu_torch.framework.evaluate import render_eval
from sk_gs_tpu_torch.framework.presets import synthetic_fullscale
from sk_gs_tpu_torch.data.synthetic import make_synthetic_scene
from sk_gs_tpu_torch.framework.random_model import orbit_view, random_model_flat
from sk_gs_tpu_torch.framework.trainer import SKGSTrainer
from sk_gs_tpu_torch.models import sk_gs_ops
from sk_gs_tpu_torch.models.losses import LossWeights
from sk_gs_tpu_torch.ops.knn import furthest_point_sampling
from sk_gs_tpu_torch.models.gaussian_splatting import gaussian_inputs
from sk_gs_tpu_torch.models.sk_gs import forward_deltas
from sk_gs_tpu_torch.render import GaussianInputs, prepare_blend
from sk_gs_tpu_torch.render.binning import chunk_fields, num_chunks
from sk_gs_tpu_torch.render.blend import (ALPHA_MIN, blend_forward_plain,
                                          chunk_blend_forward_plain)
from sk_gs_tpu_torch.render.settings import RasterConfig
from sk_gs_tpu_torch.render.render import composite_background
from sk_gs_tpu_torch.render.tile_kernel import (KERNELS as KERNELS_ALL,
                                                ChunkBlend, TileBlend,
                                                chunk_blend_bwd,
                                                chunk_blend_fwd,
                                                tile_blend_bwd, tile_blend_fwd)
from test_torch_mesh import rank_main, run_ranks
from test_torch_view_parallel import CASES as VIEW_CASES
from test_torch_view_parallel import (case_steps, close_step,
                                            leaf_names, one_step)

pytestmark = pytest.mark.gpu
EXCHANGE_LEAVES = ('means3d', 'scales', 'rotations', 'opacities', 'sh')
TOL = 1e-4
BWD_TOL = 3e-4
RERUN_TOL = 1e-5
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


def compare_rows(kernel, args):
    """A backward kernel (#2 or #4) against its per-row plain version: one
    launch a call, the rows within BWD_TOL, the dummy row zero, and a second
    launch within RERUN_TOL of the first. Returns the rerun differences."""
    geo, col = args[:2]
    before = kernel.launches
    g_rows = kernel(*args)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    again = kernel(*args)
    torch.cuda.synchronize()
    ref = kernel.plain(*args)
    assert g_rows.shape == ref.shape == (geo.shape[0], 6 + col.shape[1])
    assert torch.isfinite(g_rows).all()
    rerun = {}
    for name, sl in GROUPS.items():
        scale = float(ref[:, sl].abs().max())
        assert scale > 0, name
        assert float((g_rows[:, sl] - ref[:, sl]).abs().max()) \
            <= BWD_TOL * scale, name
        rerun[name] = float((again[:, sl] - g_rows[:, sl]).abs().max()) / scale
    print(f'{kernel.name}: two launches differ by {rerun} of the max')
    assert max(rerun.values()) <= RERUN_TOL, rerun
    # no live entry reads the dummy row, so nothing is added to it
    assert float(g_rows[-1].abs().max()) == 0.0 == float(again[-1].abs().max())
    return rerun


def compare_bwd(inp, cfg, color, alpha):
    b = inp.binned
    compare_rows(tile_blend_bwd, (inp.geo, inp.col, b.sort_gauss,
                                  b.tile_start, b.tile_count, color, alpha,
                                  *cotangents(color, alpha), cfg))


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
    g_rows = tile_blend_bwd(geo, col, ints, ints, ints, color, alpha, color,
                            alpha, cfg)
    assert g_rows.shape == (5, 9)
    assert float(g_rows.abs().max()) == 0.0


def test_empty_scene_gives_zero_rows(cuda):
    """No entry in any tile: both backward kernels launch once and leave
    every row zero (empty tiles exit at once)."""
    cfg = RasterConfig(image_width=64, image_height=48, pair_capacity=2 ** 10,
                       chunk=64, schedule='chunk')
    T, P, K = cfg.num_tiles, cfg.pix_per_tile, cfg.pair_capacity
    geo = torch.rand(5, 6, device=cuda)
    geo[-1] = 0.0
    col = torch.rand(5, 3, device=cuda)
    sort_gauss = torch.full((K + cfg.chunk,), 4, dtype=torch.int32,
                            device=cuda)
    zeros_t = torch.zeros(T, dtype=torch.int32, device=cuda)
    fields = chunk_fields(torch.zeros(T + 1, dtype=torch.int64, device=cuda),
                          torch.zeros(T, dtype=torch.int64, device=cuda), cfg)
    assert fields[0].shape == (num_chunks(cfg),)
    color = torch.zeros(T, P, 3, device=cuda)
    alpha = torch.zeros(T, P, device=cuda)
    gc, ga = cotangents(color, alpha)
    for kernel, meta in ((tile_blend_bwd, (zeros_t, zeros_t)),
                         (chunk_blend_bwd, fields)):
        before = kernel.launches
        g_rows = kernel(geo, col, sort_gauss, *meta, color, alpha, gc, ga,
                        cfg)
        torch.cuda.synchronize()
        assert kernel.launches == before + 1, kernel.name
        assert g_rows.shape == (5, 9)
        assert float(g_rows.abs().max()) == 0.0, kernel.name


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
    """Kernels #3 and #4 against their plain versions."""
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
    assert chunk_blend_fwd.launches == before[0] + 1
    compare_rows(chunk_blend_bwd, (*args, color, alpha,
                                   *cotangents(color, alpha, seed=4), cfg))
    assert chunk_blend_bwd.launches == before[1] + 2
    # the chunk route renders what the tile route renders, but for the
    # skip rule (power > 0 against > 1e-4) on a handful of entries
    t_color, _ = tile_blend_fwd(inp.geo, inp.col, inp.binned.sort_gauss,
                                inp.binned.tile_start, inp.binned.tile_count,
                                cfg._replace(schedule='tile'))
    assert float((t_color - color).abs().mean()) <= 1e-4


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


def test_chunk_kernels_runtime_channels(cuda):
    """Kernel #4 at five channels (its runtime-channel path) and kernel #3
    with it."""
    cfg = RasterConfig(image_width=200, image_height=136, sh_degree=3,
                       pair_capacity=2 ** 18, schedule='chunk')
    g = random_scene(3000, cuda, seed=7, extras=2)
    view = orbit_view(0.4, cfg.image_width, cfg.image_height, device=cuda)
    inp = prepare_blend(g, view, cfg)
    assert inp.col.shape[1] == 5
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
        compare_chunk(inp, rcfg)


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


def long_list_scene(device, ch, seed=8):
    """A 64 x 48 image (12 tiles) whose tile 0 holds a list of 2,500
    entries of low opacity, so its pixels stay open deep into it, tile 5
    300 and tile 7 40; the other tiles are empty. A tenth of the entries
    have o < 1/255 and can never be kept. Each entry reads its own row, the
    dummy row (zeros) last. Returns cfg, the rows, and the metadata of both
    schedules."""
    cfg = RasterConfig(image_width=64, image_height=48, pair_capacity=2 ** 13,
                       chunk=128, schedule='chunk')
    rng = np.random.default_rng(seed)
    counts = np.zeros(cfg.num_tiles, np.int64)
    counts[[0, 5, 7]] = (2500, 300, 40)
    tiles = np.repeat(np.arange(cfg.num_tiles), counts)
    n = tiles.size
    x = (tiles % cfg.grid_w) * 16 + rng.uniform(-4, 20, n)
    y = (tiles // cfg.grid_w) * 16 + rng.uniform(-4, 20, n)
    sig = rng.uniform(1.0, 4.0, (n, 2))
    a, c = 0.5 / sig[:, 0] ** 2, 0.5 / sig[:, 1] ** 2
    b = rng.uniform(-0.4, 0.4, n) * np.sqrt(a * c)
    o = rng.uniform(0.002, 0.06, n)
    low = rng.uniform(size=n) < 0.1
    o[low] = rng.uniform(0.0, 0.99 / 255, int(low.sum()))
    geo = np.zeros((n + 1, 6), np.float32)
    geo[:n] = np.stack([x, y, a, b, c, o], -1)
    col = np.zeros((n + 1, ch), np.float32)
    col[:n] = rng.uniform(0, 1, (n, ch))
    sort_gauss = np.full(cfg.pair_capacity + cfg.chunk, n, np.int32)
    sort_gauss[:n] = np.arange(n)
    starts = np.concatenate([[0], np.cumsum(counts)])
    t = lambda v, dt=torch.int32: torch.tensor(v, dtype=dt, device=device)
    fields = chunk_fields(t(starts, torch.int64), t(counts, torch.int64), cfg)
    return (cfg, t(geo, torch.float32), t(col, torch.float32), t(sort_gauss),
            (t(starts[:-1]), t(counts)), fields, counts == 0)


@pytest.mark.parametrize('ch', [3, 5])
def test_forward_kernels_long_list(cuda, ch):
    """Kernels #1 and #3 on a tile list over 2,000 entries with entries of
    o < 1/255: within TOL of their plain versions, empty tiles exactly 0,
    two launches equal bit for bit (the forwards use no atomics), and at
    least one block resident per SM.
    Every pixel's keep and stop decisions are the plain version's: one
    decision taken otherwise, a kept entry j added or not, moves the
    pixel's final transmittance by the factor 1 - alpha_j <= 1 - 1/255,
    while the product's order moves it by far less than a tenth of that;
    so the pixel's alpha must agree within half of (1 - alpha) / 255."""
    cfg, geo, col, sort_gauss, tile_meta, fields, empty = \
        long_list_scene(cuda, ch)
    for kernel, meta, c in ((tile_blend_fwd, tile_meta,
                             cfg._replace(schedule='tile')),
                            (chunk_blend_fwd, fields, cfg)):
        args = (geo, col, sort_gauss, *meta, c)
        before = kernel.launches
        color, alpha = kernel(*args)
        again_color, again_alpha = kernel(*args)
        torch.cuda.synchronize()
        assert kernel.launches == before + 2, kernel.name
        p_color, p_alpha = kernel.plain(*args)
        assert color.shape == p_color.shape == (cfg.num_tiles, 256, ch)
        assert float((color - p_color).abs().max()) <= TOL, kernel.name
        assert float((alpha - p_alpha).abs().max()) <= TOL, kernel.name
        assert torch.equal(color, again_color), kernel.name
        assert torch.equal(alpha, again_alpha), kernel.name
        flips = (alpha - p_alpha).abs() >= 0.5 * (1.0 - p_alpha) * ALPHA_MIN
        assert int(flips.sum()) == 0, kernel.name
        e = torch.from_numpy(empty).to(cuda)
        assert float(color[e].abs().max()) == 0.0 == float(alpha[e].abs().max())
        # tile 0's pixels stay open deep into its list, and some stop
        assert 0.0 < float(alpha[0].min()) and float(alpha[0].max()) > 0.99
        assert kernel.blocks_per_sm(c, ch) >= 1, kernel.name


FWD_HEADER = (Path(__file__).resolve().parents[1] / 'sk_gs_tpu_torch'
              / 'csrc' / 'blend_fwd_rows.cuh')
# the opacity ranges of the pre-test's two cases (o < 1/255: a positive
# cut; o >= 1/255: a negative one) and the common range
CUT_O_RANGES = [(1e-6, 1 / 255), (1 / 255, 0.02), (0.02, 1.0)]


def cut_margin() -> float:
    """The pre-test's margin, ``kCutMargin`` of the forward kernels'
    header."""
    m = re.search(r'constexpr float kCutMargin = ([0-9.e+-]+)f;',
                  FWD_HEADER.read_text())
    assert m
    return float(m.group(1))


def card_cut(o):
    """The header's cut, logf((1/255) / o) - kCutMargin, by the card's own
    float32 division, logf and subtraction."""
    return torch.log(torch.full_like(o, ALPHA_MIN) / o) - cut_margin()


def nudge(p, k):
    """p moved by k[i] floats (up for k > 0, down for k < 0), |k| <= 8."""
    for step in range(8):
        p = torch.where(k > step, torch.nextafter(p, torch.full_like(
            p, math.inf)), p)
        p = torch.where(k < -step, torch.nextafter(p, torch.full_like(
            p, -math.inf)), p)
    return p


@pytest.mark.parametrize('o_lo,o_hi', CUT_O_RANGES)
def test_pretest_cut_on_the_card(cuda, o_lo, o_hi):
    """The forward kernels' pre-test with the card's rounding: at the 16
    float32 powers just below cut = logf((1/255) / o) - kCutMargin, and at
    random ones below it, alpha = o expf(min(power, 0)) computed by the
    card's CUDA float32 ops stays below 1/255, so a skip drops nothing the
    exact path keeps."""
    rng = np.random.default_rng(7)
    o = torch.tensor(np.concatenate([rng.uniform(o_lo, o_hi, 4000),
                                     [o_lo, o_hi]]), dtype=torch.float32,
                     device=cuda)
    cut = card_cut(o)
    p = cut
    for _ in range(16):
        p = torch.nextafter(p, torch.full_like(p, -math.inf))
        assert bool((p < cut).all())
        alpha = o * torch.exp(torch.clamp(p, max=0.0))
        assert bool((alpha < ALPHA_MIN).all())
    p = cut - torch.tensor(rng.uniform(0, 2, o.shape[0]), dtype=torch.float32,
                           device=cuda)
    alpha = o * torch.exp(torch.clamp(p, max=0.0))
    assert bool((p < cut).all()) and bool((alpha < ALPHA_MIN).all())


def cut_scene(device, ch, seed=9):
    """A 400 x 400 image (625 tiles) whose every tile lists ch entries:
    entry k with the one-hot colour e_k, b = c = 0, a = -2 p, centred one
    pixel left of the tile's first column, so that its power at the
    tile's first-column pixels is exactly the float32 p (4 p and below
    elsewhere). Half the entries put p within 8 floats of the card's cut,
    half within 8 floats of the keep threshold ln((1/255) / o). A pixel's
    colour k is then above 0 exactly where it kept entry k (no pixel
    stops). Returns cfg, the rows, both schedules' metadata, and each
    entry's power and opacity."""
    cfg = RasterConfig(image_width=400, image_height=400,
                       pair_capacity=2 ** 14, chunk=8, schedule='chunk')
    T = cfg.num_tiles
    n = T * ch
    rng = np.random.default_rng(seed)
    t = lambda v, dt: torch.tensor(v, dtype=dt, device=device)
    tiles = np.repeat(np.arange(T), ch)
    o = t(rng.uniform(0.005, 0.9, n), torch.float32)
    threshold = torch.log(ALPHA_MIN / o.double()).float()
    p = torch.where(t(rng.uniform(size=n) < 0.5, torch.bool), card_cut(o),
                    threshold)
    p = nudge(p, t(rng.integers(-8, 9, n), torch.int64))
    geo = torch.zeros((n + 1, 6), dtype=torch.float32, device=device)
    geo[:n, 0] = t((tiles % cfg.grid_w) * 16 - 1, torch.float32)
    geo[:n, 1] = t((tiles // cfg.grid_w) * cfg.tile_h + 7.5, torch.float32)
    geo[:n, 2] = -2.0 * p
    geo[:n, 5] = o
    col = torch.zeros((n + 1, ch), dtype=torch.float32, device=device)
    col[torch.arange(n), torch.arange(n) % ch] = 1.0
    sort_gauss = torch.full((cfg.pair_capacity + cfg.chunk,), n,
                            dtype=torch.int32, device=device)
    sort_gauss[:n] = torch.arange(n, dtype=torch.int32, device=device)
    starts = torch.arange(T + 1, device=device) * ch
    counts = torch.full((T,), ch, dtype=torch.int64, device=device)
    fields = chunk_fields(starts, counts, cfg)
    tile_meta = (starts[:-1].to(torch.int32), counts.to(torch.int32))
    return cfg, geo, col, sort_gauss, tile_meta, fields, p, o


@pytest.mark.parametrize('ch', [3, 16])
def test_forward_keep_decisions_at_the_cut(cuda, ch):
    """Kernels #1 and #3 at powers on either side of the pre-test's cut and
    of the keep threshold (``cut_scene``): each (entry, pixel) keep
    decision is the plain version's, and both count the same kept entries.
    At the first-column pixels the plain version keeps exactly where the
    card's o expf(min(p, 0)) >= 1/255, some kept and some not on both
    sides of the threshold, and some entries lie below the cut."""
    cfg, geo, col, sort_gauss, tile_meta, fields, p, o = cut_scene(cuda, ch)
    want = (o * torch.exp(torch.clamp(p, max=0.0)) >= ALPHA_MIN)
    want = want.reshape(cfg.num_tiles, ch)
    assert 0 < int(want.sum()) < want.numel()
    assert bool((p < card_cut(o)).any())
    first_col = torch.arange(cfg.pix_per_tile, device=cuda) % 16 == 0
    for kernel, meta, c in ((tile_blend_fwd, tile_meta,
                             cfg._replace(schedule='tile')),
                            (chunk_blend_fwd, fields, cfg)):
        args = (geo, col, sort_gauss, *meta, c)
        before = kernel.launches
        color, alpha = kernel(*args)
        torch.cuda.synchronize()
        assert kernel.launches == before + 1, kernel.name
        p_color, _ = kernel.plain(*args)
        kept, p_kept = color > 0, p_color > 0
        assert int(kept.sum()) == int(p_kept.sum()), kernel.name
        assert torch.equal(kept, p_kept), kernel.name
        assert torch.equal(p_kept[:, first_col],
                           want[:, None, :].expand(-1, 16, -1)), kernel.name
        assert float(alpha.max()) < 0.5, kernel.name      # no pixel stops


# ---------------------------------------------------------------- sp family


def test_fps_card_matches_cpu(cuda):
    """The FPS on the card picks what the CPU picks on tie-free data (the
    two best scores at every pick differ by more than 1e-5 of the best)."""
    rng = np.random.default_rng(10)
    pts = rng.normal(size=(2000, 48)).astype(np.float32)
    mask = rng.uniform(size=2000) > 0.2
    mask[0] = False
    got = []
    for dev in (cuda, torch.device('cpu')):
        idx, dists = furthest_point_sampling(
            torch.from_numpy(pts).to(dev), 128,
            torch.from_numpy(mask).to(dev), return_dists=True)
        got.append((idx.cpu(), dists.cpu()))
    (i_card, d_card), (i_cpu, d_cpu) = got
    # tie-free: at every pick the best score beats the second by 1e-5
    p64 = pts.astype(np.float64)
    dists = np.full(len(p64), np.inf)
    for i in range(1, 128):
        dists = np.minimum(dists, ((p64 - p64[i_cpu[i - 1]]) ** 2).sum(-1))
        top2 = np.sort(np.where(mask, dists, -np.inf))[-2:]
        assert top2[1] - top2[0] > 1e-5 * top2[1], i
    assert torch.equal(i_card, i_cpu)
    assert bool(torch.from_numpy(mask)[i_card].all()) and int(i_card[0]) == 1
    fin = torch.isfinite(d_cpu)
    assert float(((d_card[fin] - d_cpu[fin]) / d_cpu[fin]).abs().max()) <= 1e-6


def sp_trainer(dev, rcfg_kernel=True, seed=5):
    """A small random sp-stage model behind the trainer on ``dev``."""
    cfg, rcfg, train = synthetic_fullscale()
    cfg = cfg._replace(gauss=cfg.gauss._replace(capacity=4096),
                       num_superpoints=64, num_frames=6,
                       net=cfg.net._replace(depth=4, width=64),
                       sk_net=cfg.sk_net._replace(width=64, depth=4,
                                                  skips=(2,)))
    rcfg = rcfg._replace(image_width=96, image_height=80,
                         pair_capacity=2 ** 16, use_kernel=rcfg_kernel)
    flat = random_model_flat(cfg, seed, n_alive=3000, log_scale_mean=-3.0,
                             sp_stage=True)
    scene, meta, _ = make_synthetic_scene(
        seed=0, num_links=3, gauss_per_link=60, num_frames=6, h=80, w=96,
        pair_capacity=2 ** 15, device=dev)
    model = convert.model_from_flat(flat, cfg, rcfg, device=dev,
                                    trainable=True)
    return SKGSTrainer(cfg, rcfg, scene, meta, model,
                       LossWeights(train.loss), sp_initialized=True,
                       reinit_done=True, device=dev)


def test_sp_step_gradients_kernel_vs_plain(cuda):
    """One sp step's leaf gradients through kernels #1/#2 against the plain
    route, on the card: within 1e-3 of each leaf's max (chip_smoke's
    grad_path bar)."""
    grads = []
    for use_kernel in (True, False):
        tr = sp_trainer(cuda, use_kernel)
        step = 20001
        tr.loss_w.set_step(step)
        before = (tile_blend_fwd.launches, tile_blend_bwd.launches)
        m2d_off = tr.zero_grads()
        losses = tr._losses('sp', 3, m2d_off, step)[0]
        sum(losses.values()).backward()
        torch.cuda.synchronize()
        launched = (tile_blend_fwd.launches - before[0],
                    tile_blend_bwd.launches - before[1])
        assert launched == ((1, 1) if use_kernel else (0, 0))
        assert losses['joint'] > 0 and losses['smooth'] > 0
        grads.append({k: p.grad.detach().clone()
                      for k, p in tr.model.leaves().items()
                      if p.grad is not None})
    got, ref = grads
    assert set(got) == set(ref) >= {'sp_W', 'xyz', 'joint_pos'}
    for name, r in ref.items():
        scale = float(r.abs().max())
        err = float((got[name] - r).abs().max())
        assert err <= 1e-3 * scale + 1e-30, (name, err, scale)


def test_superpoint_prune_split_card_matches_cpu(cuda):
    """The superpoint prune / split on the card edits the same rows as on
    the CPU: masks, copies, moments."""
    out = []
    for dev in (cuda, torch.device('cpu')):
        tr = sp_trainer(dev)
        m = tr.model
        gen = torch.Generator().manual_seed(3)
        m.xyz_grad_accum.copy_(torch.rand(m.xyz_grad_accum.shape,
                                          generator=gen).to(dev) * 1e-3)
        m.denom.fill_(2.0)
        m.sp_alive[::7] = False
        cfg = tr.cfg._replace(sp_prune_threshold=30.0,
                              sp_split_threshold=2e-4)
        stats = sk_gs_ops.superpoint_prune_split(cfg, m, tr.opt_state)
        out.append(({k: int(v) for k, v in stats.items()},
                    convert.model_to_flat(m)))
    (s_card, f_card), (s_cpu, f_cpu) = out
    assert s_card == s_cpu and s_card['n_split'] > 0 and s_card['n_pruned'] > 0
    np.testing.assert_array_equal(f_card['sp_alive'], f_cpu['sp_alive'])
    for name in ('params/sp_points', 'params/joints', 'params/joint_pos',
                 'params/sp_W', 'sp_cache', 'joint_cost'):
        np.testing.assert_allclose(f_card[name], f_cpu[name], atol=1e-5,
                                   err_msg=name)


def adam_over_tol(got, ref, grads, lr, steps) -> float:
    """A parameter's worst error over its bound (chip_smoke's
    params_over_tol for one leaf): where the gradient exceeded 1e-3 of its
    max at every one of ``grads``, 1e-5 of the leaf plus 1% of the Adam
    steps; elsewhere 2 lr a step."""
    big = np.ones(got.shape, bool)
    for g in grads:
        g = g.abs().numpy()
        big &= g > 1e-3 * g.max()
    err = np.abs(got - ref)
    scale = float(np.abs(ref).max())
    tol_big = 1e-5 * scale + 0.01 * lr * steps + 1e-30
    tol_all = 2 * lr * steps + 1e-5 * scale + 1e-30
    return max(float(err[big].max(initial=0.0)) / tol_big,
               float(err.max()) / tol_all)


def test_init_skeleton_card_matches_cpu(cuda, monkeypatch):
    """The skeleton initialisation (20 + 20 iterations, the same frames)
    on the card against the CPU, as chip_smoke's train_reference_sk_init
    holds it (its warp heads scaled as there, so that the superpoints move
    and the joint costs are not Adam's noise): the tree, the frozen LBS
    and the assignment equal; the caches within 1e-5 of their max;
    joint_pos and the distilled leaves by the Adam parameter rule with the
    CPU's gradients (a rule for a few Adam steps: see chip_smoke's
    SK_REF_ITERS)."""
    n = 20
    tids = torch.randint(0, 6, (2, n), generator=torch.Generator()
                         .manual_seed(0))
    out = {}
    for dev in (cuda, torch.device('cpu')):
        tr = sp_trainer(dev)
        tr.model.sp_alive[::8] = False
        with torch.no_grad():
            for head in (tr.model.sp_deform.warp, tr.model.sp_deform.rotation):
                head.w.mul_(1000.0)
        grads = []
        update = sk_gs_ops.optim.adam_update

        def spy(g, *args, _out=grads, **kw):
            _out.append({k: v.detach().cpu().clone() for k, v in g.items()
                         if v is not None})
            return update(g, *args, **kw)
        monkeypatch.setattr(sk_gs_ops.optim, 'adam_update', spy)
        losses = sk_gs_ops.init_skeleton(tr.cfg, tr.model, tids[0].to(dev),
                                         tids[1].to(dev))
        monkeypatch.undo()
        assert all(torch.isfinite(v).all() for v in losses.values())
        out[dev.type] = (convert.model_to_flat(tr.model), grads)
    (f_c, _), (f_p, grads) = out['cuda'], out['cpu']
    for name in ('sp_knn', 'p2sp', 'joint_parents', 'joint_root'):
        np.testing.assert_array_equal(f_c[name], f_p[name], name)
    for name in ('sp_cache', 'sp_weights', 'joint_cost'):
        err = np.abs(f_c[name] - f_p[name]).max()
        assert err <= 1e-5 * np.abs(f_p[name]).max(), (name, err)
    lr = sk_gs_ops.INIT_LR
    worst = {'joint_pos': adam_over_tol(
        f_c['params/joint_pos'], f_p['params/joint_pos'],
        [g['jp'] for g in grads[:n]], lr, n)}
    for name in grads[n]:
        worst[name] = adam_over_tol(f_c['params/' + name],
                                    f_p['params/' + name],
                                    [g[name] for g in grads[n:]], lr, 2 * n)
    assert len(grads) == 2 * n and 'sp_W' in grads[n]
    assert max(worst.values()) <= 1.0, worst


JPEG_FIXTURES = Path(__file__).parent / 'fixtures' / 'jpeg'


@pytest.mark.parametrize('name', sorted(
    p.stem for p in JPEG_FIXTURES.glob('*.jpg')))
def test_jpeg_fixtures_on_the_card_machine(cuda, name):
    """The JPEG decoder built on the card's machine (its own C++ compiler)
    decodes each committed fixture as Pillow did where it was written."""
    from sk_gs_tpu_torch.utils.jpeg import read_jpeg
    from sk_gs_tpu_torch.utils.png import read_png
    got = read_jpeg(JPEG_FIXTURES / f'{name}.jpg')
    ref = read_png(JPEG_FIXTURES / f'{name}.png')
    np.testing.assert_array_equal(got, ref[..., 0] if got.ndim == 2 else ref)


@pytest.mark.parametrize('chunk', [32, 128])
def test_topk_weights_card_matches_cpu(cuda, chunk):
    """The viewer's per-pixel top-k (plain torch ops) on the card against
    the CPU: ids equal, weights within 1e-5."""
    from sk_gs_tpu_torch.render.render import render_topk
    cfg = RasterConfig(image_width=96, image_height=80, sh_degree=0,
                       pair_capacity=2 ** 15, chunk=chunk)
    out = {}
    for dev in ('cuda', 'cpu'):
        g = random_scene(400, dev, seed=5)
        view = orbit_view(0.4, cfg.image_width, cfg.image_height, device=dev)
        idx, w = render_topk(g, view, cfg, k=8)
        out[dev] = (idx.cpu(), w.cpu())
    assert torch.equal(out['cuda'][0], out['cpu'][0])
    assert float((out['cuda'][1] - out['cpu'][1]).abs().max()) <= 1e-5
    assert int((out['cpu'][0] >= 0).sum()) > 1000


# ------------------------------------------------------------ the mesh
# chip_smoke.py's mesh phases at a small size: 2 gloo ranks on one card,
# each a process of this file (tests/test_torch_mesh.py:run_ranks)

def test_view_step_two_gloo_ranks_on_one_card(cuda, tmp_path):
    """tests/test_torch_view_parallel.py's steps (init, sp, sk_init, sk
    with SGD, sk with Adam) on the card: the 2 ranks against one process
    at batch_views 2, within that file's bars, and the replicas equal."""
    ranks = run_ranks(__file__, 'view_steps', 2, tmp_path, 'cuda')
    for i, case in enumerate(VIEW_CASES):
        ref = one_step(*case, device='cuda')
        got = {k[len(f'{i}/'):]: v for k, v in ranks[0].items()
               if k.startswith(f'{i}/')}
        close_step(got, ref, leaf_names(ref))
    for k, v in ranks[0].items():
        np.testing.assert_array_equal(v, ranks[1][k], err_msg=k)


EXCHANGE_CFG = RasterConfig(image_width=64, image_height=64, sh_degree=3,
                            pair_capacity=2 ** 14, chunk=64, tile_h=8)


def exchange_target():
    return torch.from_numpy(np.random.default_rng(3).uniform(
        size=(64, 64, 3)).astype(np.float32))


def exchange_loss(out, target):
    """The image's (or a band's) terms of the mean l1 over the 64 x 64
    image."""
    img = composite_background(out['images'], out['opacity'],
                               torch.ones(3, device=target.device))
    return torch.abs(img - target).sum() / (64 * 64 * 3)


def case_exchange(tmp, rank):
    """This rank's half of ``random_scene(256)`` through the exchange
    render at tile_h 8 on the card: the band and the slice's gradients."""
    from sk_gs_tpu_torch.parallel import make_mesh, shard_rows
    from sk_gs_tpu_torch.parallel.sharded_render import (assemble_bands,
                                                         make_exchange_render)
    mesh = make_mesh(1, 2)
    g = random_scene(256, 'cuda', seed=4)
    leaves = {k: shard_rows(getattr(g, k), mesh, 'gs').clone()
              .requires_grad_(True) for k in EXCHANGE_LEAVES}
    view = orbit_view(0.7, 64, 64, device='cuda')
    for k in KERNELS_ALL:
        k.launches = 0
    out = make_exchange_render(mesh, EXCHANGE_CFG)(
        GaussianInputs(**leaves), view)
    exchange_loss(out, shard_rows(exchange_target().cuda(), mesh, 'gs')
                  ).backward()
    res = {'images': assemble_bands(out['images'], mesh).cpu().numpy(),
           'opacity': assemble_bands(out['opacity'], mesh).cpu().numpy(),
           'overflow': out['overflow'].cpu().numpy(),
           'launches': np.array([k.launches for k in KERNELS_ALL])}
    res.update({f'grad/{k}': v.grad.cpu().numpy() for k, v in leaves.items()})
    return res


def test_exchange_render_tile_h8_two_gloo_ranks_on_one_card(cuda, tmp_path):
    """The exchange render at tile_h 8 over 2 gloo ranks on one card
    against the one-card render: images and opacity 3e-5, gradients 5e-4
    of each leaf's max, #1 once a render and #2 once a backward on each
    rank."""
    from sk_gs_tpu_torch.render.render import render
    ranks = run_ranks(__file__, 'exchange', 2, tmp_path)
    g = random_scene(256, 'cuda', seed=4)
    leaves = {k: getattr(g, k).clone().requires_grad_(True)
              for k in EXCHANGE_LEAVES}
    out = render(GaussianInputs(**leaves),
                 orbit_view(0.7, 64, 64, device='cuda'), EXCHANGE_CFG)
    exchange_loss(out, exchange_target().cuda()).backward()
    assert not bool(out['overflow'])
    for r in ranks:
        assert not bool(r['overflow'])
        np.testing.assert_allclose(
            r['images'], out['images'].detach().cpu().numpy(), atol=3e-5)
        np.testing.assert_allclose(
            r['opacity'], out['opacity'].detach().cpu().numpy(), atol=3e-5)
        assert list(r['launches']) == [1, 1, 0, 0]
    for k, v in leaves.items():
        ref = v.grad.cpu().numpy()
        got = np.concatenate([r[f'grad/{k}'] for r in ranks])
        scale = np.abs(ref).max()
        assert np.abs(got - ref).max() <= 5e-4 * scale, k


if __name__ == '__main__':
    rank_main({'view_steps': case_steps, 'exchange': case_exchange})
