"""Render API: preprocess -> binning -> tile blend (port of
``sk_gs_tpu/render/render.py``).

Returns pre-background ``images`` [H, W, C] and ``opacity`` [H, W]; the
caller composites with ``composite_background``.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import torch

from .binning import BinnedSplats, build_tile_lists
from .blend import assemble_image
from .preprocess import PreprocessOut, preprocess
from .settings import GaussianInputs, RasterConfig, ViewParams
from .tile_kernel import TileBlend


class BlendInputs(NamedTuple):
    pre: PreprocessOut
    binned: BinnedSplats
    geo: torch.Tensor  # [n + 1, 6] (x, y, conic a, b, c, opacity) by depth rank
    col: torch.Tensor  # [n + 1, ch] colours (+ extras) by depth rank


def prepare_blend(g: GaussianInputs, view: ViewParams, cfg: RasterConfig,
                  active_sh_degree: Optional[torch.Tensor] = None,
                  means2d_offset: Optional[torch.Tensor] = None
                  ) -> BlendInputs:
    """Everything the tile blend reads. The per-Gaussian rows get a zero
    dummy row n (opacity 0: it never adds) and are brought into depth-rank
    order once, so the blend reads entry i's row at ``sort_gauss[i]``.
    ``means2d_offset`` [N, 2] is added to the pixel means first (binning
    uses the means without it, as in the JAX package)."""
    pre = preprocess(g, view, cfg, active_sh_degree)
    colors = pre.colors
    if g.extras is not None:
        colors = torch.cat([colors, g.extras], dim=-1)
    binned = build_tile_lists(pre, cfg)
    means2d = pre.means2d
    if means2d_offset is not None:
        means2d = means2d + means2d_offset

    def pad1(x):
        return torch.cat([x, torch.zeros_like(x[:1])], dim=0)

    do = binned.depth_order.to(torch.int64)
    geo = pad1(torch.cat([means2d, pre.conic,
                          g.opacities.reshape(-1, 1)], dim=-1))[do]
    return BlendInputs(pre, binned, geo.contiguous(),
                       pad1(colors)[do].contiguous())


def blend_tiles(binned: BinnedSplats, geo: torch.Tensor, col: torch.Tensor,
                cfg: RasterConfig):
    """(tile_color [T, P, ch], tile_alpha [T, P]), differentiable in ``geo``
    and ``col``, through ``TileBlend``: the kernels' wrappers, or the plain
    versions everywhere when ``cfg.use_kernel`` is off. Unlike the JAX
    ``blend_tiles`` it takes the depth-ordered rows of ``prepare_blend``."""
    return TileBlend.apply(geo, col, binned.sort_gauss, binned.tile_start,
                           binned.tile_count, cfg)


def render(g: GaussianInputs, view: ViewParams, cfg: RasterConfig,
           active_sh_degree: Optional[torch.Tensor] = None,
           means2d_offset: Optional[torch.Tensor] = None
           ) -> Dict[str, torch.Tensor]:
    """``means2d_offset``: pass zeros [N, 2] that require grad, and its
    gradient is the pixel-space position gradient the densification
    statistics read (the JAX ``render.py:48`` contract)."""
    pre, binned, geo, col = prepare_blend(g, view, cfg, active_sh_degree,
                                          means2d_offset)
    tile_color, tile_alpha = blend_tiles(binned, geo, col, cfg)
    out = assemble_image(tile_color, tile_alpha, cfg)
    images = out['images']
    result = {
        'images': images[..., :3] if g.extras is not None else images,
        'opacity': out['opacity'],
        'radii': pre.radius,
        'visible': pre.visible,
        'num_pairs': binned.num_pairs,
        'overflow': binned.overflow,
    }
    if g.extras is not None:
        result['extras'] = images[..., 3:]
    return result


def composite_background(images: torch.Tensor, opacity: torch.Tensor,
                         background: Optional[torch.Tensor]) -> torch.Tensor:
    """images + (1 - opacity) * bg."""
    if background is None:
        return images
    bg = torch.as_tensor(background, dtype=images.dtype, device=images.device)
    return images + (1.0 - opacity)[..., None] * torch.broadcast_to(
        bg, images.shape)
