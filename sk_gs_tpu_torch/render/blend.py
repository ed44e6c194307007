"""Plain PyTorch forward tile blend and image assembly.

``blend_forward_plain`` is the plain version of the CUDA kernel
``csrc/tile_blend_fwd.cu``; both follow the blend rules of the JAX package's
tile kernel (``sk_gs_tpu/render/tile_kernel.py:_blend_core``):

- power = -0.5 (a dx^2 + c dy^2) - b dx dy; the entry is skipped when
  power > POWER_SKIP_EPS;
- alpha = min(0.99, o exp(min(power, 0))), kept when alpha >= 1/255;
- front to back, a pixel stops at the first kept entry with
  T (1 - alpha) < 1e-4, and that entry is not added;
- the tile's alpha is 1 - T_final; pixel centres are integer pixel
  coordinates, row-major in the tile.

The entries are walked in batches of ``batch`` for all tiles at once, with
each pixel's transmittance and stop flag carried across batches, so the
batch size does not change the result.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from .settings import TILE, RasterConfig

ALPHA_MIN = 1.0 / 255.0
ALPHA_MAX = 0.99
T_EPS = 1e-4
POWER_SKIP_EPS = 1e-4


def tile_pixel_coords(cfg: RasterConfig, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pixel centres (px, py), each [T, P], row-major inside each tile."""
    t = torch.arange(cfg.num_tiles, device=device)
    lp = torch.arange(cfg.pix_per_tile, device=device)
    px = (t % cfg.grid_w)[:, None] * TILE + (lp % TILE)[None, :]
    py = (t // cfg.grid_w)[:, None] * cfg.tile_h + (lp // TILE)[None, :]
    return px.to(torch.float32), py.to(torch.float32)


def blend_forward_plain(geo: torch.Tensor, col: torch.Tensor,
                        sort_gauss: torch.Tensor, tile_start: torch.Tensor,
                        tile_count: torch.Tensor, cfg: RasterConfig,
                        batch: int = 32, stats: Optional[Dict] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Front-to-back blend of each tile's segment of ``sort_gauss``.

    geo [R, 6] rows (x, y, conic a, b, c, opacity) and col [R, ch] are in
    depth-rank order; ``sort_gauss`` holds row ids. Returns tile_color
    [T, P, ch] and tile_alpha [T, P]. When ``stats`` is a dict, its
    'evaluations' entry receives the number of (entry, pixel) evaluations
    the sequential walk performs (entries a pixel meets before it stops,
    the stopping entry included).
    """
    T, P, ch = cfg.num_tiles, cfg.pix_per_tile, col.shape[-1]
    dev = geo.device
    px, py = tile_pixel_coords(cfg, dev)
    trans = torch.ones((T, P), device=dev)
    done = torch.zeros((T, P), dtype=torch.bool, device=dev)
    color = torch.zeros((T, P, ch), device=dev)
    evals = torch.zeros((), dtype=torch.int64, device=dev)
    dummy = geo.shape[0] - 1
    start = tile_start.to(torch.int64)
    count = tile_count.to(torch.int64)
    max_count = int(count.max()) if T else 0
    offs = torch.arange(batch, device=dev)
    for base in range(0, max_count, batch):
        valid = (base + offs)[None, :] < count[:, None]              # [T, B]
        idx = torch.where(valid, start[:, None] + base + offs[None, :], 0)
        rows = torch.where(valid, sort_gauss.to(torch.int64)[idx], dummy)
        g = geo[rows]                                                # [T, B, 6]
        x, y, a, b, c, o = (g[..., i:i + 1] for i in range(6))       # [T, B, 1]
        dx = px[:, None, :] - x                                      # [T, B, P]
        dy = py[:, None, :] - y
        power = -0.5 * (a * dx * dx + c * dy * dy) - b * dx * dy
        alpha = torch.clamp(o * torch.exp(torch.clamp(power, max=0.0)),
                            max=ALPHA_MAX)
        keep = (power <= POWER_SKIP_EPS) & (alpha >= ALPHA_MIN) & valid[..., None]
        alpha = torch.where(keep, alpha, torch.zeros_like(alpha))
        om = 1.0 - alpha
        p_incl = trans[:, None, :] * torch.cumprod(om, dim=1)
        p_excl = torch.cat([trans[:, None, :], p_incl[:, :-1]], dim=1)
        # p_incl only falls at kept entries, so the first entry below T_EPS
        # is the stopping entry and every later one is cut too
        live = ~done[:, None, :]
        contrib = (p_incl >= T_EPS) & live
        if stats is not None:
            # entries a live pixel reaches: no stop before them
            evals += (live & valid[..., None] & (p_excl >= T_EPS)).sum()
        w = torch.where(contrib, alpha * p_excl, torch.zeros_like(alpha))
        color += torch.einsum('tbp,tbc->tpc', w, col[rows])
        last = torch.where(contrib, p_incl, torch.full_like(p_incl, 2.0)).amin(1)
        trans = torch.where(contrib.any(1), last, trans)
        done |= (p_incl[:, -1] < T_EPS)
        if bool(done.all()):
            break
    if stats is not None:
        stats['evaluations'] = int(evals)
    return color, 1.0 - trans


def assemble_image(tile_color: torch.Tensor, tile_alpha: torch.Tensor,
                   cfg: RasterConfig) -> Dict[str, torch.Tensor]:
    """[T, P, CH] tiles -> [H, W, CH] image and [H, W] opacity, cropped."""
    CH = tile_color.shape[-1]
    gh, gw, th = cfg.grid_h, cfg.grid_w, cfg.tile_h
    img = tile_color.reshape(gh, gw, th, TILE, CH)
    img = img.permute(0, 2, 1, 3, 4).reshape(gh * th, gw * TILE, CH)
    alpha = tile_alpha.reshape(gh, gw, th, TILE)
    alpha = alpha.permute(0, 2, 1, 3).reshape(gh * th, gw * TILE)
    H, W = cfg.image_height, cfg.image_width
    return {'images': img[:H, :W], 'opacity': alpha[:H, :W]}
