"""Tile binning: expand Gaussians into depth-ordered per-tile splat lists
(port of ``sk_gs_tpu/render/binning.py:63-216``).

Same static-capacity layout and the same entry order as the JAX package:
Gaussians depth-sorted (stable), every Gaussian expanded into the tiles of
its rect in row-major order, the per-pair tile-ellipse cull, then a stable
sort by tile id. The JAX package's TPU-only carrier bit-packing and fused
sort key are replaced by ``searchsorted`` and a stable ``torch.sort``, which
give the identical order. The ``chunk_*`` fields of the JAX ``BinnedSplats``
feed only its chunk-schedule kernels and are not built here.
"""
from __future__ import annotations

from typing import NamedTuple

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
    return BinnedSplats(
        sort_gauss=sort_gauss.to(torch.int32),
        depth_order=depth_order.to(torch.int32),
        tile_start=starts_all[:-1].to(torch.int32),
        tile_count=counts.to(torch.int32),
        num_pairs=total,
        overflow=total > K,
    )
