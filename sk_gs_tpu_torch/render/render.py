"""Render API: preprocess -> binning -> tile blend (port of
``sk_gs_tpu/render/render.py``).

``render`` returns pre-background ``images`` [H, W, C] and ``opacity``
[H, W]; the caller composites with ``composite_background``.
``render_topk`` gives each pixel's top-k Gaussians and blend weights (the
viewer's picking).
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import torch

from ..utils.tracing import span
from .binning import BinnedSplats, build_tile_lists
from .blend import assemble_image, topk_weights
from .preprocess import PreprocessOut, preprocess
from .settings import GaussianInputs, RasterConfig, ViewParams
from .tile_kernel import ChunkBlend, TileBlend


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
    uses the means without it, as in the JAX package). Spans:
    'sk.preprocess', then 'sk.binning' (the lists and the gathers)."""
    with span('sk.preprocess'):
        pre = preprocess(g, view, cfg, active_sh_degree)
    with span('sk.binning'):
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
    and ``col``, through ``TileBlend`` or, with ``cfg.schedule == 'chunk'``,
    ``ChunkBlend``: the kernels' wrappers, or the plain versions everywhere
    when ``cfg.use_kernel`` is off. Unlike the JAX ``blend_tiles`` it takes
    the depth-ordered rows of ``prepare_blend``."""
    if cfg.chunked:
        return ChunkBlend.apply(geo, col, binned.sort_gauss,
                                binned.chunk_tile, binned.chunk_start_flag,
                                binned.chunk_src, binned.chunk_valid, cfg)
    return TileBlend.apply(geo, col, binned.sort_gauss, binned.tile_start,
                           binned.tile_count, cfg)


def render(g: GaussianInputs, view: ViewParams, cfg: RasterConfig,
           active_sh_degree: Optional[torch.Tensor] = None,
           means2d_offset: Optional[torch.Tensor] = None
           ) -> Dict[str, torch.Tensor]:
    """``means2d_offset``: pass zeros [N, 2] that require grad, and its
    gradient is the pixel-space position gradient the densification
    statistics read (the JAX ``render.py:48`` contract). The blend and the
    image's assembly are an 'sk.blend' span."""
    pre, binned, geo, col = prepare_blend(g, view, cfg, active_sh_degree,
                                          means2d_offset)
    with span('sk.blend'):
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


def render_topk(g: GaussianInputs, view: ViewParams, cfg: RasterConfig,
                k: int = 8, active_sh_degree: Optional[torch.Tensor] = None):
    """Per-pixel top-k contributing Gaussian ids and blend weights (port of
    ``sk_gs_tpu/render/render.py:render_topk``): (indices [H, W, k] int32
    into the input Gaussians, -1 where fewer than k contribute; weights
    [H, W, k]), by ``blend.topk_weights`` in plain torch ops (the JAX
    package computes it in XLA, not in a kernel)."""
    _, binned, geo, _ = prepare_blend(g, view, cfg, active_sh_degree)
    return topk_weights(binned, geo, cfg, k=k)


def composite_background(images: torch.Tensor, opacity: torch.Tensor,
                         background: Optional[torch.Tensor]) -> torch.Tensor:
    """images + (1 - opacity) * bg."""
    if background is None:
        return images
    bg = torch.as_tensor(background, dtype=images.dtype, device=images.device)
    return images + (1.0 - opacity)[..., None] * torch.broadcast_to(
        bg, images.shape)
