"""Plain PyTorch tile blend, forward and backward, and image assembly.

``blend_forward_plain`` and ``blend_backward_plain`` are the plain versions
of the CUDA kernels ``csrc/tile_blend_fwd.cu`` and ``csrc/tile_blend_bwd.cu``;
all four follow the blend rules of the JAX package's tile kernel
(``sk_gs_tpu/render/tile_kernel.py:_blend_core``):

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

The backward is the JAX kernel's analytic one (``_bwd_kernel_tile``): the
two clamps count as identity and the skip, keep and stop decisions as
constants. Autograd through ``blend_forward_plain`` gives the same
gradients, since its clamps pass the gradient straight through.
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


class _ClampMaxStraight(torch.autograd.Function):
    """min(x, hi), with the gradient passed through as if it were x."""

    @staticmethod
    def forward(ctx, x, hi):
        return torch.clamp(x, max=hi)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def _entry_alpha(g: torch.Tensor, px: torch.Tensor, py: torch.Tensor,
                 valid: torch.Tensor):
    """Per-(tile, entry, pixel) terms of a batch of entries ``g`` [T, B, 6]:
    (dx, dy, alpha_raw, alpha, keep), alpha zero where not kept."""
    x, y, a, b, c, o = (g[..., i:i + 1] for i in range(6))       # [T, B, 1]
    dx = px[:, None, :] - x                                      # [T, B, P]
    dy = py[:, None, :] - y
    power = -0.5 * (a * dx * dx + c * dy * dy) - b * dx * dy
    alpha_raw = o * torch.exp(_ClampMaxStraight.apply(power, 0.0))
    alpha = _ClampMaxStraight.apply(alpha_raw, ALPHA_MAX)
    keep = (power <= POWER_SKIP_EPS) & (alpha >= ALPHA_MIN) & valid[..., None]
    alpha = torch.where(keep, alpha, torch.zeros_like(alpha))
    return dx, dy, alpha_raw, alpha, keep


def _batch_rows(sort_gauss, start, count, base, offs, dummy):
    """Entry slots [T, B] of batch ``base`` of every tile, whether each is
    inside its tile's list, and the row each reads (``dummy`` past it)."""
    valid = (base + offs)[None, :] < count[:, None]
    idx = torch.where(valid, start[:, None] + base + offs[None, :], 0)
    rows = torch.where(valid, sort_gauss.to(torch.int64)[idx], dummy)
    return valid, idx, rows


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
    the stopping entry included), and 'adds' the number of those that add
    to the pixel (kept, before the stop).
    """
    T, P, ch = cfg.num_tiles, cfg.pix_per_tile, col.shape[-1]
    dev = geo.device
    px, py = tile_pixel_coords(cfg, dev)
    trans = torch.ones((T, P), device=dev)
    done = torch.zeros((T, P), dtype=torch.bool, device=dev)
    color = torch.zeros((T, P, ch), device=dev)
    evals = torch.zeros((), dtype=torch.int64, device=dev)
    adds = torch.zeros((), dtype=torch.int64, device=dev)
    dummy = geo.shape[0] - 1
    start = tile_start.to(torch.int64)
    count = tile_count.to(torch.int64)
    max_count = int(count.max()) if T else 0
    offs = torch.arange(batch, device=dev)
    for base in range(0, max_count, batch):
        valid, _, rows = _batch_rows(sort_gauss, start, count, base, offs,
                                     dummy)                          # [T, B]
        _, _, _, alpha, _ = _entry_alpha(geo[rows], px, py, valid)   # [T, B, P]
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
            adds += (contrib & (alpha > 0)).sum()
        w = torch.where(contrib, alpha * p_excl, torch.zeros_like(alpha))
        color += torch.einsum('tbp,tbc->tpc', w, col[rows])
        last = torch.where(contrib, p_incl, torch.full_like(p_incl, 2.0)).amin(1)
        trans = torch.where(contrib.any(1), last, trans)
        done |= (p_incl[:, -1] < T_EPS)
        if bool(done.all()):
            break
    if stats is not None:
        stats['evaluations'] = int(evals)
        stats['adds'] = int(adds)
    return color, 1.0 - trans


def blend_backward_plain(geo: torch.Tensor, col: torch.Tensor,
                         sort_gauss: torch.Tensor, tile_start: torch.Tensor,
                         tile_count: torch.Tensor, tile_color: torch.Tensor,
                         tile_alpha: torch.Tensor, g_color: torch.Tensor,
                         g_alpha: torch.Tensor, cfg: RasterConfig,
                         batch: int = 32) -> torch.Tensor:
    """Per-entry gradient rows of the blend, ``g_entry`` [E, 6 + ch] for the
    E = len(sort_gauss) entries: d/d(x, y, a, b, c, opacity, col) of
    sum(g_color * tile_color) + sum(g_alpha * tile_alpha), each row for its
    entry's tile only. Rows of entries that no pixel reached, or that stop
    or follow a pixel's stop, are zero; summed by ``sort_gauss`` they give
    the gradient of ``geo`` and ``col``.

    With D = sum_k g_color_k * C_final_k, B_i = sum_k col_ik g_color_k and
    w_i = alpha_i T_excl,i, a kept entry that adds gets
    g_alpha_i = g_alpha T_final / (1 - alpha_i) + B_i T_excl,i
    - (D - sum_{j <= i} w_j B_j) / (1 - alpha_i), g_power = alpha_raw
    g_alpha_i, and g_col_i = w_i g_color (``tile_kernel.py:606-697``).
    """
    T, P, ch = cfg.num_tiles, cfg.pix_per_tile, col.shape[-1]
    dev = geo.device
    px, py = tile_pixel_coords(cfg, dev)
    g_entry = torch.zeros((sort_gauss.shape[0], 6 + ch), device=dev)
    trans = torch.ones((T, P), device=dev)
    done = torch.zeros((T, P), dtype=torch.bool, device=dev)
    s_run = torch.zeros((T, P), device=dev)      # sum of w_j B_j so far
    t_final = 1.0 - tile_alpha
    d_tot = torch.sum(g_color * tile_color, dim=-1)
    dummy = geo.shape[0] - 1
    start = tile_start.to(torch.int64)
    count = tile_count.to(torch.int64)
    max_count = int(count.max()) if T else 0
    offs = torch.arange(batch, device=dev)
    for base in range(0, max_count, batch):
        valid, idx, rows = _batch_rows(sort_gauss, start, count, base, offs,
                                       dummy)
        g = geo[rows]
        dx, dy, alpha_raw, alpha, keep = _entry_alpha(g, px, py, valid)
        om = 1.0 - alpha
        p_incl = trans[:, None, :] * torch.cumprod(om, dim=1)
        p_excl = torch.cat([trans[:, None, :], p_incl[:, :-1]], dim=1)
        contrib = (p_incl >= T_EPS) & ~done[:, None, :]
        w = torch.where(contrib, alpha * p_excl, torch.zeros_like(alpha))
        b_m = torch.einsum('tbc,tpc->tbp', col[rows], g_color)
        s_incl = s_run[:, None, :] + torch.cumsum(w * b_m, dim=1)
        inv_om = 1.0 / om
        g_a = (g_alpha[:, None, :] * t_final[:, None, :] * inv_om
               + b_m * p_excl - (d_tot[:, None, :] - s_incl) * inv_om)
        g_a = torch.where(contrib & keep, g_a, torch.zeros_like(g_a))
        g_p = alpha_raw * g_a
        a, b, c, o = (g[..., i:i + 1] for i in range(2, 6))
        inv_o = torch.where(o > 0, 1.0 / torch.clamp(o, min=1e-12),
                            torch.zeros_like(o))
        grads = [(a * dx + b * dy) * g_p, (c * dy + b * dx) * g_p,
                 -0.5 * dx * dx * g_p, -dx * dy * g_p, -0.5 * dy * dy * g_p,
                 g_p * inv_o]
        rows_g = torch.cat([torch.stack([v.sum(-1) for v in grads], dim=-1),
                            torch.einsum('tbp,tpc->tbc', w, g_color)], dim=-1)
        g_entry[idx[valid]] = rows_g[valid]
        s_run = s_incl[:, -1]
        last = torch.where(contrib, p_incl, torch.full_like(p_incl, 2.0)).amin(1)
        trans = torch.where(contrib.any(1), last, trans)
        done |= (p_incl[:, -1] < T_EPS)
        if bool(done.all()):
            break
    return g_entry


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
