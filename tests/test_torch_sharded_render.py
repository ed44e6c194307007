"""Port parity, the Gaussian-sharded renderers
(``sk_gs_tpu_torch/parallel/sharded_render.py``): 4 gloo ranks on the CPU,
each holding a quarter of the Gaussians of tests/test_render.py's
``build_inputs`` (seed 0), run the port's ``make_sharded_render`` and
``make_exchange_render`` against the JAX functions on the 4-device CPU
mesh (tests/test_sharded_render.py's setup), at tile_h 16 (one tile row a
band) and 8 (two): images and opacity to 3e-5, ``radii`` and ``visible``
equal, ``overflow`` False, and the gradients of an l1 loss on the image
composited over white to 5e-4 of each leaf's max (the JAX test's bars).
Each rank takes the backward of its band's part of the loss; the
all-gather's and the all-to-all's backwards carry the other bands'
cotangents to its Gaussians.
"""
from pathlib import Path

import numpy as np
import pytest
import torch

from sk_gs_tpu_torch.parallel import make_mesh, shard_rows
from sk_gs_tpu_torch.parallel.sharded_render import (assemble_bands,
                                                     make_exchange_render,
                                                     make_sharded_render)
from sk_gs_tpu_torch.render.render import composite_background
from sk_gs_tpu_torch.render.settings import (GaussianInputs, RasterConfig,
                                             ViewParams)
from test_torch_mesh import one_torch_thread  # noqa: F401
from test_torch_mesh import rank_main, run_ranks

N, HW, RANKS = 256, 64, 4
LEAVES = ('means3d', 'scales', 'rotations', 'opacities', 'sh')
VIEW = ('Tw2v', 'Tv2c', 'campos', 'tan_fovx', 'tan_fovy')
RENDERERS = {'sharded': make_sharded_render, 'exchange': make_exchange_render}


def raster_cfg(tile_h: int) -> RasterConfig:
    return RasterConfig(image_width=HW, image_height=HW, sh_degree=2,
                        pair_capacity=2 ** 14, chunk=64, tile_h=tile_h)


def case_render(tmp, rank, tile_h):
    """Both renderers on this rank's quarter: the band, the slice's radii
    and visible, overflow, and the gradients of the band's l1 terms."""
    data = np.load(Path(tmp) / 'inputs.npz')
    mesh = make_mesh(n_view=1, n_gs=RANKS)
    cfg = raster_cfg(int(tile_h))
    view = ViewParams(*(torch.from_numpy(data[k]) for k in VIEW))
    band_target = shard_rows(torch.from_numpy(data['target']), mesh, 'gs')
    out = {}
    for name, make in RENDERERS.items():
        leaves = {k: shard_rows(torch.from_numpy(data[k]), mesh, 'gs'
                                ).clone().requires_grad_(True)
                  for k in LEAVES}
        res = make(mesh, cfg)(GaussianInputs(**leaves), view)
        img = composite_background(res['images'], res['opacity'],
                                   torch.ones(3))
        loss = torch.abs(img - band_target).sum() / (HW * HW * 3)
        loss.backward()
        out[f'{name}_images'] = assemble_bands(res['images'], mesh).numpy()
        out[f'{name}_opacity'] = assemble_bands(res['opacity'], mesh).numpy()
        for k in ('radii', 'visible', 'overflow'):
            out[f'{name}_{k}'] = res[k].numpy()
        for k, v in leaves.items():
            out[f'{name}_grad_{k}'] = v.grad.numpy()
    return out


@pytest.fixture(scope='module')
def jax_setup():
    import jax
    from jax.sharding import Mesh
    from tests.test_render import build_inputs, make_view
    g = build_inputs(np.random.default_rng(0), N)
    view = make_view(w=HW, h=HW)
    target = np.random.default_rng(1).uniform(size=(HW, HW, 3)).astype(
        np.float32)
    mesh = Mesh(np.asarray(jax.devices()[:RANKS]).reshape(RANKS), ('gs',))
    return g, view, target, mesh


@pytest.fixture(scope='module')
def runs(jax_setup, tmp_path_factory):
    """tile_h -> (the JAX outputs and gradients, the ranks' outputs)."""
    import jax
    import jax.numpy as jnp
    from sk_gs_tpu.parallel import sharded_render as jsr
    from sk_gs_tpu.render import RasterConfig as JaxRasterConfig
    from sk_gs_tpu.render import composite_background as jcomposite
    g, view, target, mesh = jax_setup
    tmp = tmp_path_factory.mktemp('sharded')
    np.savez(tmp / 'inputs.npz', target=target,
             **{k: np.asarray(getattr(g, k)) for k in LEAVES},
             **{k: np.asarray(getattr(view, k)) for k in VIEW})
    out = {}
    for tile_h in (16, 8):
        cfg = JaxRasterConfig(image_width=HW, image_height=HW, sh_degree=2,
                              pair_capacity=2 ** 14, chunk=64,
                              use_pallas=False, tile_h=tile_h)
        ref = {}
        for name in RENDERERS:
            fn = getattr(jsr, f'make_{name}_render')(mesh, cfg)

            def loss(*leaves, fn=fn):
                with mesh:
                    o = fn(g._replace(**dict(zip(LEAVES, leaves))), view)
                img = jcomposite(o['images'], o['opacity'], jnp.ones(3))
                return jnp.mean(jnp.abs(img - target)), o

            args = tuple(getattr(g, k) for k in LEAVES)
            grads, o = jax.grad(loss, argnums=tuple(range(5)),
                                has_aux=True)(*args)
            ref[name] = ({k: np.asarray(v) for k, v in o.items()},
                         dict(zip(LEAVES, map(np.asarray, grads))))
        out[tile_h] = ref, run_ranks(__file__, 'render', RANKS, tmp, tile_h)
    return out


@pytest.mark.parametrize('name', sorted(RENDERERS))
@pytest.mark.parametrize('tile_h', [16, 8])
def test_render_matches_jax(runs, name, tile_h):
    (o, _), ranks = runs[tile_h][0][name], runs[tile_h][1]
    assert not bool(o['overflow'])
    for r in ranks:
        np.testing.assert_allclose(r[f'{name}_images'], o['images'],
                                   atol=3e-5)
        np.testing.assert_allclose(r[f'{name}_opacity'], o['opacity'],
                                   atol=3e-5)
        assert not bool(r[f'{name}_overflow'])
    for k in ('radii', 'visible'):
        np.testing.assert_array_equal(
            np.concatenate([r[f'{name}_{k}'] for r in ranks]), o[k])


@pytest.mark.parametrize('name', sorted(RENDERERS))
@pytest.mark.parametrize('tile_h', [16, 8])
def test_gradients_match_jax(runs, name, tile_h):
    (_, grads), ranks = runs[tile_h][0][name], runs[tile_h][1]
    for k in LEAVES:
        got = np.concatenate([r[f'{name}_grad_{k}'] for r in ranks])
        scale = np.abs(grads[k]).max() + 1e-8
        np.testing.assert_allclose(got / scale, grads[k] / scale, atol=5e-4,
                                   err_msg=f'{name} gradient of {k}')


if __name__ == '__main__':
    rank_main({'render': case_render})
