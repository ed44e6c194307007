"""The port's CUDA kernels on the card, against their plain PyTorch versions.

Run on a machine with a CUDA card and nvcc (``--noconftest``: the tests'
conftest.py sets up JAX, which these tests do not use):

    python -m pytest tests/test_torch_gpu.py -m gpu -q --noconftest

Elsewhere every test skips (the card is looked for inside the fixture, never
at import or collection). Tolerance 1e-4: power and alpha round the same on
both sides (see csrc/tile_blend_fwd.cu); the transmittance products and the
colour sums are taken in another order, and the 1e-4 transmittance cut
bounds what such a reordering can flip.
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
from sk_gs_tpu_torch.render.blend import blend_forward_plain
from sk_gs_tpu_torch.render.settings import RasterConfig
from sk_gs_tpu_torch.render.tile_kernel import tile_blend_fwd

pytestmark = pytest.mark.gpu
TOL = 1e-4


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


def test_kernel_matches_plain_full_width(cuda):
    cfg, rcfg = synthetic_fullscale()
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
        compare(inp, rcfg)


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


def test_render_eval_card_matches_cpu(cuda):
    cfg, rcfg = synthetic_fullscale()
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
