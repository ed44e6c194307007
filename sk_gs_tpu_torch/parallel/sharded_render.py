"""Renders with the Gaussians sharded over a mesh axis (port of
``sk_gs_tpu/parallel/sharded_render.py``).

Each rank holds its N/D slice of ``GaussianInputs`` and renders one
horizontal band of tile rows (grid_h/D rows); both renderers run the
blend of each band through ``render.render.blend_tiles``, kernels #1/#2
(or #3/#4 on the chunk schedule) on the card:

- ``make_sharded_render``: each rank preprocesses its slice, the compact
  per-splat outputs are all-gathered, and each rank bins and blends its
  band from all of them;
- ``make_exchange_render``: each splat is sent (all-to-all) only to the
  ranks whose bands its tile rect overlaps, and each rank re-sorts what it
  received by depth and blends its band (``exchange_render_band``).

The returned functions are differentiable: the all-gather's backward sums
the bands' cotangents (``collectives.all_gather``) and the all-to-all's
sends them back, so each rank calls ``backward`` on its band's part of
the loss. ``assemble_bands`` gathers the bands into the whole image, as
the JAX ``out_specs`` ``P(axis)`` assembles it.
"""
from __future__ import annotations

from typing import Dict

import torch

from . import collectives as coll
from .mesh import Mesh
from ..render.binning import build_tile_lists
from ..render.blend import assemble_image
from ..render.preprocess import PreprocessOut, preprocess
from ..render.render import blend_tiles
from ..render.settings import GaussianInputs, RasterConfig, ViewParams

# PreprocessOut's float and integer fields, as two gathered blocks
_FLOAT_FIELDS = ('means2d', 'depths', 'conic', 'colors', 'tau')
_INT_FIELDS = ('radius', 'tiles_touched', 'rect_min', 'rect_max', 'visible')


def band_config(cfg: RasterConfig, n_bands: int) -> RasterConfig:
    """Raster config for one horizontal band of tile rows."""
    if cfg.grid_h % n_bands:
        raise ValueError(
            f'grid_h {cfg.grid_h} not divisible by {n_bands} bands (pad '
            f'image_height to a multiple of {n_bands * cfg.tile_h})')
    band_rows = cfg.grid_h // n_bands
    return cfg._replace(image_height=band_rows * cfg.tile_h,
                        pair_capacity=cfg.pair_capacity // n_bands)


def _restrict_to_band(pre: PreprocessOut, band: int, band_rows: int,
                      cfg: RasterConfig) -> PreprocessOut:
    """Clip tile rects to this rank's tile-row band and shift to band-local
    coordinates (pixel y too)."""
    y0_tile = band * band_rows
    y1_tile = y0_tile + band_rows
    rmin_y = torch.clamp(pre.rect_min[:, 1], y0_tile, y1_tile) - y0_tile
    rmax_y = torch.clamp(pre.rect_max[:, 1], y0_tile, y1_tile) - y0_tile
    area = (pre.rect_max[:, 0] - pre.rect_min[:, 0]) * (rmax_y - rmin_y)
    visible = pre.visible & (area > 0)
    shift = torch.tensor([0.0, float(y0_tile * cfg.tile_h)],
                         device=pre.means2d.device)
    return pre._replace(
        means2d=pre.means2d - shift,
        rect_min=torch.stack([pre.rect_min[:, 0], rmin_y], -1),
        rect_max=torch.stack([pre.rect_max[:, 0], rmax_y], -1),
        tiles_touched=torch.where(visible, area, 0).to(torch.int32),
        depths=torch.where(visible, pre.depths, float('inf')),
        visible=visible,
        radius=torch.where(visible, pre.radius, 0).to(pre.radius.dtype),
    )


def _gather_pre(pre: PreprocessOut, opac: torch.Tensor, group):
    """Every rank's ``pre`` and opacities [N], concatenated in rank order
    (one all-gather of the float fields, one of the integer fields)."""
    f = [getattr(pre, k) for k in _FLOAT_FIELDS] + [opac]
    f = [x.reshape(x.shape[0], -1) for x in f]
    i = [getattr(pre, k).to(torch.int32).reshape(f[0].shape[0], -1)
         for k in _INT_FIELDS]
    fg = coll.all_gather(torch.cat(f, -1), group)
    ig = coll.all_gather(torch.cat(i, -1), group)
    out, o = {}, 0
    for k, x in zip(_FLOAT_FIELDS, f):
        w = x.shape[1]
        out[k] = fg[:, o:o + w].reshape((-1,) + getattr(pre, k).shape[1:])
        o += w
    opac_all = fg[:, o]
    o = 0
    for k, x in zip(_INT_FIELDS, i):
        w = x.shape[1]
        v = ig[:, o:o + w].reshape((-1,) + getattr(pre, k).shape[1:])
        out[k] = v.to(getattr(pre, k).dtype)
        o += w
    return PreprocessOut(**out), opac_all


def _blend_band(pre_b: PreprocessOut, opac: torch.Tensor,
                bcfg: RasterConfig):
    """Bin and blend a band: (images [h, W, C], opacity [h, W], binned),
    the rows brought into depth-rank order with a zero dummy row, as
    ``render.prepare_blend`` brings them."""
    binned = build_tile_lists(pre_b, bcfg)

    def pad1(x):
        return torch.cat([x, torch.zeros_like(x[:1])], dim=0)

    do = binned.depth_order.to(torch.int64)
    geo = pad1(torch.cat([pre_b.means2d, pre_b.conic, opac[:, None]],
                         -1))[do]
    col = pad1(pre_b.colors)[do]
    tile_color, tile_alpha = blend_tiles(binned, geo.contiguous(),
                                         col.contiguous(), bcfg)
    out = assemble_image(tile_color, tile_alpha, bcfg)
    return out['images'], out['opacity'], binned


def make_sharded_render(mesh: Mesh, cfg: RasterConfig, axis: str = 'gs'):
    """A render of this rank's Gaussian slice along ``axis`` into this
    rank's band of image rows: ``fn(g, view)`` -> {'images' [h, W, C],
    'opacity' [h, W] (the band), 'radii', 'visible' (the slice's),
    'overflow' (any rank's band), 'num_pairs' (the band's)}."""
    n_bands = mesh.axis_size(axis)
    bcfg = band_config(cfg, n_bands)
    band_rows = cfg.grid_h // n_bands
    group = mesh.group(axis)

    def render_fn(g: GaussianInputs, view: ViewParams
                  ) -> Dict[str, torch.Tensor]:
        pre_local = preprocess(g, view, cfg)
        pre, opac_all = _gather_pre(pre_local, g.opacities.reshape(-1),
                                    group)
        pre_b = _restrict_to_band(pre, mesh.axis_index(axis), band_rows, cfg)
        images, opacity, binned = _blend_band(pre_b, opac_all, bcfg)
        return {'images': images, 'opacity': opacity,
                'radii': pre_local.radius, 'visible': pre_local.visible,
                'overflow': coll.pmax(binned.overflow.to(torch.int32),
                                      group) > 0,
                'num_pairs': binned.num_pairs}

    return render_fn


# ---------------------------------------------------------------- all-to-all

def _compact_for_band(pre: PreprocessOut, opac: torch.Tensor,
                      sel: torch.Tensor, cap: int):
    """Stable-compact the selected splats to the front, truncate/pad to
    ``cap`` rows (attributes stacked as one [cap, 14] feature block:
    xy(2) conic(3) opacity(1) color(3) depth(1) rect_min(2) rect_max(2)).
    Returns (block, number selected)."""
    n = sel.shape[0]
    order = torch.argsort((~sel).to(torch.int8), stable=True)
    if cap <= n:
        take = order[:cap]
    else:
        take = torch.cat([order, order.new_zeros(cap - n)])
    count = sel.sum()
    ok = sel[take] & (torch.arange(cap, device=sel.device) < count)
    feats = torch.cat([
        pre.means2d, pre.conic, opac[:, None], pre.colors,
        pre.depths[:, None],
        pre.rect_min.to(torch.float32),   # 10: x, 11: y (global tiles)
        pre.rect_max.to(torch.float32),   # 12: x, 13: y (exclusive)
    ], dim=-1)
    out = torch.where(ok[:, None], feats[take], 0.0)
    depth = torch.where(ok, out[:, 9], float('inf'))
    return torch.cat([out[:, :9], depth[:, None], out[:, 10:]], -1), count


def exchange_render_band(pre: PreprocessOut, opac: torch.Tensor,
                         cfg: RasterConfig, mesh: Mesh, axis: str, cap: int):
    """The band-local phase of the all-to-all exchange render. ``pre`` /
    ``opac`` are the LOCAL Gaussian slice's preprocess outputs in GLOBAL
    image coordinates. Each splat goes only to the ranks of ``axis``
    whose tile-row bands its rect overlaps, at most ``cap`` a (source,
    destination) pair; the receiver re-sorts by depth and blends its band.
    Returns (band images, band opacity, overflow: this rank's sends or its
    band's pairs over capacity, binned, rows sent to each rank [D])."""
    n_bands = mesh.axis_size(axis)
    bcfg = band_config(cfg, n_bands)
    band_rows = cfg.grid_h // n_bands

    # route: the band range each splat's rect overlaps
    b0 = torch.div(pre.rect_min[:, 1], band_rows, rounding_mode='floor')
    b1 = torch.div(pre.rect_max[:, 1] - 1, band_rows, rounding_mode='floor')
    sends, n_sel = [], []
    for d in range(n_bands):
        sel = pre.visible & (b0 <= d) & (d <= b1)
        block, cnt = _compact_for_band(pre, opac, sel, cap)
        sends.append(block)
        n_sel.append(cnt)
    send = torch.stack(sends)                      # [D, cap, 14]
    n_sel = torch.stack(n_sel)
    overflow = (n_sel > cap).any()

    recv = coll.all_to_all(send, mesh.group(axis))  # [D, cap, 14]
    recv = recv.reshape(-1, send.shape[-1])         # [D*cap, 14]

    # rebuild a band-local PreprocessOut from the received features
    band = mesh.axis_index(axis)
    y0_tile = band * band_rows
    depths = recv[:, 9]
    visible = torch.isfinite(depths)
    rx0, ry0, rx1, ry1 = (recv[:, c].to(torch.int32) for c in range(10, 14))
    # clip the TRUE global rect rows to this band (band-local coords):
    # widening to the whole band would leak sub-3-sigma contributions the
    # single-device renderer's rect test excludes
    ly0 = torch.clamp(ry0 - y0_tile, 0, band_rows)
    ly1 = torch.clamp(ry1 - y0_tile, 0, band_rows)
    area = (rx1 - rx0) * (ly1 - ly0)
    visible = visible & (area > 0)
    shift = torch.tensor([0.0, float(y0_tile * bcfg.tile_h)],
                         device=recv.device)
    opac_b = recv[:, 5]
    pre_b = PreprocessOut(
        means2d=recv[:, 0:2] - shift,
        depths=torch.where(visible, depths, float('inf')),
        conic=recv[:, 2:5],
        colors=recv[:, 6:9],
        radius=visible.to(torch.int32),
        tiles_touched=torch.where(visible, area, 0).to(torch.int32),
        rect_min=torch.stack([rx0, ly0], -1),
        rect_max=torch.stack([rx1, ly1], -1),
        visible=visible,
        # the alpha >= 1/255 threshold rebuilt from the exchanged opacity
        tau=2.0 * torch.clamp(torch.log(255.0 * torch.clamp(
            opac_b.detach(), min=1e-12)), min=0.0),
    )
    images, opacity, binned = _blend_band(pre_b, opac_b, bcfg)
    return images, opacity, overflow | binned.overflow, binned, n_sel


def make_exchange_render(mesh: Mesh, cfg: RasterConfig, axis: str = 'gs',
                         send_capacity: int = 0):
    """``make_sharded_render``'s function with the all-to-all exchange:
    each rank preprocesses its slice and sends each splat only to the
    bands its rect overlaps (``exchange_render_band``); 'radii' and
    'visible' come from the local preprocess, so adaptive density control
    works from this renderer. Its dict adds 'sent' [D] (the rows this rank
    sent to each rank). ``send_capacity``: the most splats a (source,
    destination) pair sends; by default pair_capacity // D, at least
    1,024."""
    n_bands = mesh.axis_size(axis)
    cap = send_capacity or max(cfg.pair_capacity // n_bands, 1024)
    group = mesh.group(axis)

    def render_fn(g: GaussianInputs, view: ViewParams
                  ) -> Dict[str, torch.Tensor]:
        pre = preprocess(g, view, cfg)
        images, opacity, overflow, binned, sent = exchange_render_band(
            pre, g.opacities.reshape(-1), cfg, mesh, axis, cap)
        return {'images': images, 'opacity': opacity, 'radii': pre.radius,
                'visible': pre.visible,
                'overflow': coll.pmax(overflow.to(torch.int32), group) > 0,
                'num_pairs': binned.num_pairs, 'sent': sent}

    return render_fn


def assemble_bands(band: torch.Tensor, mesh: Mesh,
                   axis: str = 'gs') -> torch.Tensor:
    """The ranks' bands [h, ...] of ``axis`` stacked into the whole image
    [D h, ...] in band order (no gradient)."""
    return coll.all_gather(band.detach(), mesh.group(axis))
