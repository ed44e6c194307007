"""Tile binning: expand Gaussians into depth-ordered per-tile splat lists
(port of ``sk_gs_tpu/render/binning.py:63-216``).

Same static-capacity layout and the same entry order as the JAX package:
Gaussians depth-sorted (stable), every Gaussian expanded into the tiles of
its rect in row-major order, the per-pair tile-ellipse cull, then a stable
sort by tile id. The JAX package's TPU-only carrier bit-packing and fused
sort key are replaced by ``searchsorted`` and a stable ``torch.sort``, which
give the identical order. The ``chunk_*`` fields (and ``tile_nonempty``)
feed the chunk schedule's kernels and are built, as ``binning.py:169-190``
builds them, only when ``cfg.schedule == 'chunk'``; they are None otherwise.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .preprocess import PreprocessOut
from .settings import TILE, RasterConfig


class BinnedSplats(NamedTuple):
    sort_gauss: torch.Tensor   # [K + C] int32 depth rank per tile-sorted
    #                            entry; n (the dummy row) past the pairs
    depth_order: torch.Tensor  # [n + 1] int32 original id per depth rank
    tile_start: torch.Tensor   # [T] int32 first entry of each tile
    tile_count: torch.Tensor   # [T] int32 entries per tile
    num_pairs: torch.Tensor    # [] int pairs emitted before the capacity clip
    overflow: torch.Tensor     # [] bool: pair_capacity exceeded
    # the chunk schedule's metadata, [num_chunks(cfg)] int32 each
    chunk_tile: Optional[torch.Tensor] = None        # tile of each chunk
    chunk_start_flag: Optional[torch.Tensor] = None  # 1 at a tile's first
    chunk_src: Optional[torch.Tensor] = None   # first entry in sort order
    chunk_valid: Optional[torch.Tensor] = None  # entries in the chunk (<= C)
    tile_nonempty: Optional[torch.Tensor] = None  # [T] bool


def padded_capacity(cfg: RasterConfig) -> int:
    """Entries of the padded chunk layout: the pair capacity rounded up to
    whole chunks, plus one chunk of padding for each tile."""
    cap = ((cfg.pair_capacity + cfg.chunk - 1) // cfg.chunk) * cfg.chunk
    return cap + cfg.num_tiles * cfg.chunk


def num_chunks(cfg: RasterConfig) -> int:
    return padded_capacity(cfg) // cfg.chunk


def chunk_fields(starts_all: torch.Tensor, counts: torch.Tensor,
                 cfg: RasterConfig):
    """(chunk_tile, chunk_start_flag, chunk_src, chunk_valid) of every
    chunk. Each tile's list is padded to whole chunks (empty tiles get
    none); a chunk's tile is stamped, by scatter-max, at the chunk where the
    tile's padded list starts, and filled forward by a running max. Stamps
    at or past ``num_chunks`` are dropped (JAX's ``mode='drop'``); the
    trailing chunks past the last list keep the last tile and get no valid
    entries, their ``chunk_src`` clamped into [0, K]."""
    C, T, K = cfg.chunk, cfg.num_tiles, cfg.pair_capacity
    nc = num_chunks(cfg)
    dev = counts.device
    padded = (counts + C - 1) // C * C
    offsets = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev),
                         torch.cumsum(padded, 0)])                  # [T + 1]
    pos = offsets[:-1] // C
    keep = pos < nc
    stamp = torch.zeros(nc, dtype=torch.int64, device=dev)
    stamp.scatter_reduce_(0, pos[keep],
                          torch.arange(T, device=dev)[keep], 'amax')
    chunk_tile = torch.cummax(stamp, 0).values
    first = offsets[chunk_tile] // C
    cidx = torch.arange(nc, device=dev)
    local_off = (cidx - first) * C
    chunk_src = torch.clamp(starts_all[chunk_tile] + local_off, 0, K)
    chunk_valid = torch.clamp(counts[chunk_tile] - local_off, 0, C)
    return (chunk_tile.to(torch.int32), (cidx == first).to(torch.int32),
            chunk_src.to(torch.int32), chunk_valid.to(torch.int32))


def build_tile_lists(pre: PreprocessOut, cfg: RasterConfig) -> BinnedSplats:
    n = pre.depths.shape[0]
    K = cfg.pair_capacity
    C = cfg.chunk
    T = cfg.num_tiles
    dev = pre.depths.device

    # 1. stable depth sort: ties keep emission order
    order = torch.sort(pre.depths, stable=True).indices
    touched_s = pre.tiles_touched[order].to(torch.int64)
    rect_w = pre.rect_max[:, 0] - pre.rect_min[:, 0]
    rx_n = pre.rect_min[:, 0][order]
    ry_n = pre.rect_min[:, 1][order]
    rw_n = torch.clamp(rect_w, min=1)[order]

    incl = torch.cumsum(touched_s, dim=0)
    total = incl[-1]

    # 2. expand: slot k belongs to the depth rank gs with
    #    excl[gs] <= k < incl[gs] (a Gaussian touching no tile owns no slot)
    slots = torch.arange(K, device=dev, dtype=torch.int64)
    gs = torch.clamp(torch.searchsorted(incl, slots, right=True), max=n - 1)
    valid = slots < total
    local = slots - (incl[gs] - touched_s[gs])
    rw = rw_n[gs].to(torch.int64)
    tx = rx_n[gs].to(torch.int64) + local % rw
    ty = ry_n[gs].to(torch.int64) + local // rw
    tile_id = torch.where(valid, ty * cfg.grid_w + tx,
                          torch.full_like(tx, T))

    if cfg.tight_culling:
        # drop the pair when the exact minimum of the quadratic form over
        # the tile's pixel box exceeds tau: every pixel then has alpha
        # < 1/255, which the blend masks anyway
        packed = torch.cat([pre.means2d, pre.conic, pre.tau[:, None]],
                           dim=-1)[order]
        pk = packed[gs]
        cx, cy = pk[:, 0], pk[:, 1]
        ca, cb, cc, tau_s = pk[:, 2], pk[:, 3], pk[:, 4], pk[:, 5]
        dxlo = (tx * TILE).to(torch.float32) - cx
        dxhi = dxlo + (TILE - 1)
        dylo = (ty * cfg.tile_h).to(torch.float32) - cy
        dyhi = dylo + (cfg.tile_h - 1)
        inside = (dxlo <= 0) & (0 <= dxhi) & (dylo <= 0) & (0 <= dyhi)

        def q(dx, dy):
            return ca * dx * dx + 2.0 * cb * dx * dy + cc * dy * dy

        def clip(v, lo, hi):
            return torch.minimum(torch.maximum(v, lo), hi)

        a_s = torch.clamp(ca, min=1e-12)
        c_s = torch.clamp(cc, min=1e-12)
        q1 = q(dxlo, clip(-cb * dxlo / c_s, dylo, dyhi))
        q2 = q(dxhi, clip(-cb * dxhi / c_s, dylo, dyhi))
        q3 = q(clip(-cb * dylo / a_s, dxlo, dxhi), dylo)
        q4 = q(clip(-cb * dyhi / a_s, dxlo, dxhi), dyhi)
        min_q = torch.where(inside, torch.zeros_like(q1),
                            torch.minimum(torch.minimum(q1, q2),
                                          torch.minimum(q3, q4)))
        tile_id = torch.where(min_q <= tau_s + 1e-3, tile_id,
                              torch.full_like(tile_id, T))

    # 3. stable sort by tile: depth order is kept inside each tile
    tile_sorted, perm = torch.sort(tile_id, stable=True)
    gs_sorted = gs[perm]

    # 4. per-tile segment starts and counts
    tt = torch.arange(T + 1, device=dev, dtype=torch.int64)
    starts_all = torch.searchsorted(tile_sorted, tt, right=False)
    counts = starts_all[1:] - starts_all[:-1]

    sort_gauss = torch.where(tile_sorted < T, gs_sorted,
                             torch.full_like(gs_sorted, n))
    sort_gauss = torch.cat([sort_gauss,
                            torch.full((C,), n, device=dev, dtype=torch.int64)])
    depth_order = torch.cat([order,
                             torch.full((1,), n, device=dev, dtype=order.dtype)])
    chunked = {}
    if cfg.chunked:
        fields = chunk_fields(starts_all, counts, cfg)
        chunked = dict(zip(('chunk_tile', 'chunk_start_flag', 'chunk_src',
                            'chunk_valid'), fields), tile_nonempty=counts > 0)
    return BinnedSplats(
        sort_gauss=sort_gauss.to(torch.int32),
        depth_order=depth_order.to(torch.int32),
        tile_start=starts_all[:-1].to(torch.int32),
        tile_count=counts.to(torch.int32),
        num_pairs=total,
        overflow=total > K,
        **chunked,
    )
