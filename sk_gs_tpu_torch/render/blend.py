"""Plain PyTorch blends, forward and backward, and image assembly.

``blend_forward_plain`` and ``blend_backward_rows_plain`` are the plain
versions of the CUDA kernels ``csrc/tile_blend_fwd.cu`` and
``csrc/tile_blend_bwd.cu`` (the ``tile`` schedule);
``chunk_blend_forward_plain`` and ``chunk_blend_backward_rows_plain`` those
of ``csrc/chunk_blend_fwd.cu`` and ``csrc/chunk_blend_bwd.cu`` (the
``chunk`` schedule). The backward kernels' function is the per-row
gradient: the per-entry walk (``blend_backward_plain``,
``chunk_blend_backward_plain``, the JAX kernels' per-entry ``gfeat``), then
the per-entry rows of the live entries summed onto the depth-ordered rows
(``rows_from_entries``, ``_blend_bwd``'s segment sum). All follow the blend
rules of the JAX package's kernels (``sk_gs_tpu/render/tile_kernel.py``):

- power = -0.5 (a dx^2 + c dy^2) - b dx dy; the entry is skipped when
  power > POWER_SKIP_EPS on the tile schedule (``_blend_core``) and when
  power > 0 on the chunk schedule (``_chunk_alpha``);
- alpha = min(0.99, o exp(min(power, 0))), kept when alpha >= 1/255;
- front to back, a pixel stops for good at the first kept entry with
  T (1 - alpha) < 1e-4, and that entry is not added;
- the tile's alpha is 1 - T_final; pixel centres are integer pixel
  coordinates, row-major in the tile.

The tile schedule walks each tile's list in batches of ``batch`` for all
tiles at once; the chunk schedule walks the chunks of the binning's chunk
layout wave by wave (every tile's first chunk, then every tile's second,
...), reading each chunk's tile, start flag, first entry and valid count.
Each pixel's transmittance and stop flag are carried from batch to batch,
so neither the batch nor the chunk size changes the result.

The backward is the JAX kernels' analytic one: the two clamps count as
identity and the skip, keep and stop decisions as constants. Autograd
through a plain forward gives the same gradients, since its clamps pass
the gradient straight through.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from .settings import TILE, RasterConfig

ALPHA_MIN = 1.0 / 255.0
ALPHA_MAX = 0.99
T_EPS = 1e-4
POWER_SKIP_EPS = 1e-4
# what becomes of an (entry, pixel) evaluation that the walk reaches (see
# blend_forward_plain's ``stats``)
OUTCOMES = ('skipped_power', 'below_alpha_min', 'adds', 'stops')


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
                 valid: torch.Tensor, skip_eps: float):
    """Per-(tile, entry, pixel) terms of a batch of entries ``g`` [S, B, 6]
    for S tiles whose pixels are px, py [S, P]: (dx, dy, near, alpha_raw,
    alpha, keep), ``near`` where power <= skip_eps, alpha zero where not
    kept."""
    x, y, a, b, c, o = (g[..., i:i + 1] for i in range(6))       # [S, B, 1]
    dx = px[:, None, :] - x                                      # [S, B, P]
    dy = py[:, None, :] - y
    power = -0.5 * (a * dx * dx + c * dy * dy) - b * dx * dy
    alpha_raw = o * torch.exp(_ClampMaxStraight.apply(power, 0.0))
    alpha = _ClampMaxStraight.apply(alpha_raw, ALPHA_MAX)
    near = power <= skip_eps
    keep = near & (alpha >= ALPHA_MIN) & valid[..., None]
    alpha = torch.where(keep, alpha, torch.zeros_like(alpha))
    return dx, dy, near, alpha_raw, alpha, keep


def _walk(alpha: torch.Tensor, trans: torch.Tensor, done: torch.Tensor):
    """One batch of the front-to-back walk with the carried transmittance
    and stop flag [S, P]: (p_excl, contrib, w, trans, done) after it. The
    inclusive product only falls at kept entries, so the first entry below
    T_EPS is the stopping entry and every later one is cut too."""
    om = 1.0 - alpha
    p_incl = trans[:, None, :] * torch.cumprod(om, dim=1)
    p_excl = torch.cat([trans[:, None, :], p_incl[:, :-1]], dim=1)
    contrib = (p_incl >= T_EPS) & ~done[:, None, :]
    w = torch.where(contrib, alpha * p_excl, torch.zeros_like(alpha))
    last = torch.where(contrib, p_incl, torch.full_like(p_incl, 2.0)).amin(1)
    trans = torch.where(contrib.any(1), last, trans)
    done = done | (p_incl[:, -1] < T_EPS)
    return p_excl, contrib, w, trans, done


def _entry_grads(g, dx, dy, alpha_raw, alpha, keep, p_excl, contrib, w,
                 col_rows, g_color, g_alpha, t_final, d_tot, s_run):
    """The per-entry gradient rows [S, B, 6 + ch] of a batch and the
    running sum of w B after it (see ``blend_backward_plain``)."""
    b_m = torch.einsum('sbc,spc->sbp', col_rows, g_color)
    s_incl = s_run[:, None, :] + torch.cumsum(w * b_m, dim=1)
    inv_om = 1.0 / (1.0 - alpha)
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
    rows = torch.cat([torch.stack([v.sum(-1) for v in grads], dim=-1),
                      torch.einsum('sbp,spc->sbc', w, g_color)], dim=-1)
    return rows, s_incl[:, -1]


def _tile_batches(sort_gauss, tile_start, tile_count, batch: int,
                  dummy: int):
    """The tile schedule's batches: batch ``base`` of every tile's list at
    once. Yields the tiles [T], their entry slots' validity [T, B], the
    sort-order index of each slot and the row it reads (``dummy`` past the
    list)."""
    dev = tile_start.device
    tiles = torch.arange(tile_start.shape[0], device=dev)
    start = tile_start.to(torch.int64)
    count = tile_count.to(torch.int64)
    max_count = int(count.max()) if count.numel() else 0
    offs = torch.arange(batch, device=dev)
    sg = sort_gauss.to(torch.int64)
    for base in range(0, max_count, batch):
        valid = (base + offs)[None, :] < count[:, None]
        idx = torch.where(valid, start[:, None] + base + offs[None, :], 0)
        yield tiles, valid, idx, torch.where(valid, sg[idx], dummy)


def chunk_waves(chunk_start_flag: torch.Tensor) -> torch.Tensor:
    """[num_chunks] int64: each chunk's place in its tile's list of chunks
    (0 at the chunk whose start flag is set, then 1, 2, ...)."""
    idx = torch.arange(chunk_start_flag.shape[0],
                       device=chunk_start_flag.device)
    first = torch.cummax(torch.where(chunk_start_flag != 0, idx,
                                     torch.zeros_like(idx)), 0).values
    return idx - first


def _chunk_batches(sort_gauss, chunk_tile, chunk_start_flag, chunk_src,
                   chunk_valid, chunk: int, dummy: int):
    """The chunk schedule's batches: one wave of the chunk layout at a time
    (see the module docstring), chunks with no valid entry skipped. Yields
    as ``_tile_batches`` does, for the wave's tiles [S] and slots [S, C]."""
    dev = chunk_tile.device
    wave = chunk_waves(chunk_start_flag)
    live = chunk_valid > 0
    n_waves = int(wave[live].max()) + 1 if bool(live.any()) else 0
    offs = torch.arange(chunk, device=dev)
    sg = sort_gauss.to(torch.int64)
    for k in range(n_waves):
        sel = torch.nonzero(live & (wave == k))[:, 0]
        valid = offs[None, :] < chunk_valid[sel].to(torch.int64)[:, None]
        idx = torch.where(valid, chunk_src[sel].to(torch.int64)[:, None]
                          + offs[None, :], 0)
        yield (chunk_tile[sel].to(torch.int64), valid, idx,
               torch.where(valid, sg[idx], dummy))


def _forward(geo, col, batches, cfg: RasterConfig, skip_eps: float,
             stats: Optional[Dict]):
    """The walk of ``batches`` (see ``blend_forward_plain``): each tile's
    transmittance, stop flag and colour carried from batch to batch."""
    T, P, ch = cfg.num_tiles, cfg.pix_per_tile, col.shape[-1]
    dev = geo.device
    px, py = tile_pixel_coords(cfg, dev)
    trans = torch.ones((T, P), device=dev)
    done = torch.zeros((T, P), dtype=torch.bool, device=dev)
    color = torch.zeros((T, P, ch), device=dev)
    counts = torch.zeros(len(OUTCOMES), dtype=torch.int64, device=dev)
    for tiles, valid, _, rows in batches:
        _, _, near, _, alpha, keep = _entry_alpha(geo[rows], px[tiles],
                                                  py[tiles], valid, skip_eps)
        live = ~done[tiles]
        p_excl, contrib, w, trans_n, done_n = _walk(alpha, trans[tiles],
                                                       done[tiles])
        if stats is not None:
            # entries a live pixel reaches: no stop before them
            reach = live[:, None, :] & valid[..., None] & (p_excl >= T_EPS)
            counts += torch.stack([(reach & m).sum() for m in (
                ~near, near & ~keep, keep & contrib, keep & ~contrib)])
        color[tiles] += torch.einsum('sbp,sbc->spc', w, col[rows])
        trans[tiles] = trans_n
        done[tiles] = done_n
        if bool(done.all()):
            break
    if stats is not None:
        stats.update(zip(OUTCOMES, counts.tolist()))
        stats['evaluations'] = int(counts.sum())
    return color, 1.0 - trans


def _backward(geo, col, batches, n_entries: int, tile_color, tile_alpha,
              g_color, g_alpha, cfg: RasterConfig, skip_eps: float):
    """The backward walk of ``batches`` (see ``blend_backward_plain``): the
    forward's walk, with the running sum of w B carried as well."""
    T, P, ch = cfg.num_tiles, cfg.pix_per_tile, col.shape[-1]
    dev = geo.device
    px, py = tile_pixel_coords(cfg, dev)
    g_entry = torch.zeros((n_entries, 6 + ch), device=dev)
    trans = torch.ones((T, P), device=dev)
    done = torch.zeros((T, P), dtype=torch.bool, device=dev)
    s_run = torch.zeros((T, P), device=dev)      # sum of w_j B_j so far
    t_final = 1.0 - tile_alpha
    d_tot = torch.sum(g_color * tile_color, dim=-1)
    for tiles, valid, idx, rows in batches:
        g = geo[rows]
        dx, dy, _, alpha_raw, alpha, keep = _entry_alpha(g, px[tiles],
                                                         py[tiles], valid,
                                                         skip_eps)
        p_excl, contrib, w, trans_n, done_n = _walk(alpha, trans[tiles],
                                                       done[tiles])
        rows_g, s_n = _entry_grads(g, dx, dy, alpha_raw, alpha, keep, p_excl,
                                   contrib, w, col[rows], g_color[tiles],
                                   g_alpha[tiles], t_final[tiles],
                                   d_tot[tiles], s_run[tiles])
        g_entry[idx[valid]] = rows_g[valid]
        trans[tiles] = trans_n
        done[tiles] = done_n
        s_run[tiles] = s_n
        if bool(done.all()):
            break
    return g_entry


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
    the stopping entry included), and the ``OUTCOMES`` entries split them:
    'skipped_power' (power above the skip rule), 'below_alpha_min' (alpha
    < 1/255), 'adds' (kept, added to the pixel) and 'stops' (kept, the
    entry at which the pixel stops).
    """
    return _forward(geo, col, _tile_batches(sort_gauss, tile_start,
                                            tile_count, batch,
                                            geo.shape[0] - 1),
                    cfg, POWER_SKIP_EPS, stats)


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
    return _backward(geo, col, _tile_batches(sort_gauss, tile_start,
                                             tile_count, batch,
                                             geo.shape[0] - 1),
                     sort_gauss.shape[0], tile_color, tile_alpha, g_color,
                     g_alpha, cfg, POWER_SKIP_EPS)


def chunk_blend_forward_plain(geo: torch.Tensor, col: torch.Tensor,
                              sort_gauss: torch.Tensor,
                              chunk_tile: torch.Tensor,
                              chunk_start_flag: torch.Tensor,
                              chunk_src: torch.Tensor,
                              chunk_valid: torch.Tensor, cfg: RasterConfig,
                              stats: Optional[Dict] = None
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The chunk schedule's blend (plain version of
    ``csrc/chunk_blend_fwd.cu``): geo, col and sort_gauss as for
    ``blend_forward_plain``, and the binning's chunk metadata. Returns
    tile_color [T, P, ch] and tile_alpha [T, P]; tiles no chunk visits are
    zero. ``stats`` as for ``blend_forward_plain``."""
    return _forward(geo, col, _chunk_batches(
        sort_gauss, chunk_tile, chunk_start_flag, chunk_src, chunk_valid,
        cfg.chunk, geo.shape[0] - 1), cfg, 0.0, stats)


def chunk_blend_backward_plain(geo: torch.Tensor, col: torch.Tensor,
                               sort_gauss: torch.Tensor,
                               chunk_tile: torch.Tensor,
                               chunk_start_flag: torch.Tensor,
                               chunk_src: torch.Tensor,
                               chunk_valid: torch.Tensor,
                               tile_color: torch.Tensor,
                               tile_alpha: torch.Tensor,
                               g_color: torch.Tensor, g_alpha: torch.Tensor,
                               cfg: RasterConfig) -> torch.Tensor:
    """The chunk schedule's backward (plain version of
    ``csrc/chunk_blend_bwd.cu``): ``g_entry`` [E, 6 + ch] as
    ``blend_backward_plain`` gives it, walked chunk by chunk with the
    forward's rules; the running sum of w B is carried across a tile's
    chunks in float32 (the JAX kernel's suffix, final colour minus an
    inclusive cumsum, by linearity)."""
    return _backward(geo, col, _chunk_batches(
        sort_gauss, chunk_tile, chunk_start_flag, chunk_src, chunk_valid,
        cfg.chunk, geo.shape[0] - 1), sort_gauss.shape[0], tile_color,
        tile_alpha, g_color, g_alpha, cfg, 0.0)


def rows_from_entries(g_entry: torch.Tensor, sort_gauss: torch.Tensor,
                      n_live: int, n_rows: int) -> torch.Tensor:
    """Sum the per-entry rows of the live entries, the first ``n_live`` of
    sort order (the tiles' lists, contiguous from 0), onto the ``n_rows``
    depth-ordered rows they read (``_blend_bwd``'s segment sum). The
    padding entries past the lists carry zero rows and are left out, so the
    dummy row stays zero untouched."""
    out = torch.zeros((n_rows, g_entry.shape[1]), dtype=g_entry.dtype,
                      device=g_entry.device)
    return out.index_add_(0, sort_gauss[:n_live].to(torch.int64),
                          g_entry[:n_live])


def blend_backward_rows_plain(geo: torch.Tensor, col: torch.Tensor,
                              sort_gauss: torch.Tensor,
                              tile_start: torch.Tensor,
                              tile_count: torch.Tensor,
                              tile_color: torch.Tensor,
                              tile_alpha: torch.Tensor,
                              g_color: torch.Tensor, g_alpha: torch.Tensor,
                              cfg: RasterConfig) -> torch.Tensor:
    """The tile schedule's backward per depth-ordered row (plain version of
    ``csrc/tile_blend_bwd.cu``): ``g_rows`` [R, 6 + ch], the gradient of
    ``geo`` and ``col``. ``blend_backward_plain``'s per-entry rows, summed
    over the live entries."""
    g_entry = blend_backward_plain(geo, col, sort_gauss, tile_start,
                                   tile_count, tile_color, tile_alpha,
                                   g_color, g_alpha, cfg)
    return rows_from_entries(g_entry, sort_gauss, int(tile_count.sum()),
                             geo.shape[0])


def chunk_blend_backward_rows_plain(geo: torch.Tensor, col: torch.Tensor,
                                    sort_gauss: torch.Tensor,
                                    chunk_tile: torch.Tensor,
                                    chunk_start_flag: torch.Tensor,
                                    chunk_src: torch.Tensor,
                                    chunk_valid: torch.Tensor,
                                    tile_color: torch.Tensor,
                                    tile_alpha: torch.Tensor,
                                    g_color: torch.Tensor,
                                    g_alpha: torch.Tensor,
                                    cfg: RasterConfig) -> torch.Tensor:
    """The chunk schedule's backward per depth-ordered row (plain version of
    ``csrc/chunk_blend_bwd.cu``): ``chunk_blend_backward_plain``'s per-entry
    rows summed over the live entries, as many as the chunks hold."""
    g_entry = chunk_blend_backward_plain(
        geo, col, sort_gauss, chunk_tile, chunk_start_flag, chunk_src,
        chunk_valid, tile_color, tile_alpha, g_color, g_alpha, cfg)
    return rows_from_entries(g_entry, sort_gauss, int(chunk_valid.sum()),
                             geo.shape[0])


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
