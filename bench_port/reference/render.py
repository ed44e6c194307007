"""The plain reference renderer: 3D Gaussian splatting as the JAX package
defines it (``sk_gs_tpu/render/preprocess.py``, ``binning.py`` and the
tile schedule's blend rules of ``tile_kernel.py``).

Plain PyTorch in float32; imports nothing of the port.

- Preprocess: view-space projection, the EWA screen covariance with its
  1.3 tan(fov) clamp and the +0.3 low-pass, the conic, the 3-sigma radius,
  the opacity-aware rect (the quadratic form below tau = 2 log(255 o)),
  in tiles of 16 x 16 pixels; culled behind z <= 0.2, on a zero
  determinant, an empty rect or a dead slot; SH colour up to degree 3,
  +0.5, clamped at 0.
- Lists: each visible Gaussian in every tile of its rect whose pixel box
  the ellipse tau reaches (the exact minimum of the form, + 1e-3), each
  tile's list in depth order (ties to the lower slot).
- Blend: front to back per pixel (centres at integer coordinates):
  power = -(a dx^2 + c dy^2) / 2 - b dx dy, skipped above 1e-4;
  alpha = min(0.99, o exp(min(power, 0))), kept from 1/255; the pixel
  stops at the first kept entry with T (1 - alpha) < 1e-4, which is not
  added.
- The image is composited over the background by 1 - the final alpha.

The tiles are blended in blocks, so that a block's [tiles, entries,
pixels] tensors stay bounded. ``stats`` counts the work of the blend
(pairs, evaluations, kept, added and stopping entries) for the frozen
roofline arithmetic.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch

TILE = 16
NEAR = 0.2
ALPHA_MIN = 1.0 / 255.0
ALPHA_MAX = 0.99
T_EPS = 1e-4
POWER_SKIP = 1e-4
# entries of one block's [tiles, entries, pixels] tensors
BLOCK_ELEMS = 1 << 24
SH_C0 = 0.28209479177387814
SH_C1 = 0.4886025119029199
SH_C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
         -1.0925484305920792, 0.5462742152960396)
SH_C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658,
         0.3731763325901154, -0.4570457994644658, 1.445305721320277,
         -0.5900435899266435)
I32_MAX_F = 2147483520.0


def to_int(x: torch.Tensor) -> torch.Tensor:
    """Truncation toward zero, saturating at the int32 range (NaN -> 0)."""
    y = torch.clamp(torch.nan_to_num(x, nan=0.0), -2.0 ** 31, I32_MAX_F)
    return y.to(torch.int64)


def sh_colour(sh: torch.Tensor, means: torch.Tensor,
              campos: torch.Tensor) -> torch.Tensor:
    d = means - campos
    d = d / torch.clamp(torch.sqrt(torch.sum(d * d, -1, keepdim=True)),
                        min=1e-12)
    x, y, z = d[:, 0:1], d[:, 1:2], d[:, 2:3]
    xx, yy, zz, xy, yz, xz = x * x, y * y, z * z, x * y, y * z, x * z
    c = SH_C0 * sh[:, 0]
    c = c - SH_C1 * y * sh[:, 1] + SH_C1 * z * sh[:, 2] - SH_C1 * x * sh[:, 3]
    c = (c + SH_C2[0] * xy * sh[:, 4] + SH_C2[1] * yz * sh[:, 5]
         + SH_C2[2] * (2.0 * zz - xx - yy) * sh[:, 6]
         + SH_C2[3] * xz * sh[:, 7] + SH_C2[4] * (xx - yy) * sh[:, 8])
    c = (c + SH_C3[0] * y * (3.0 * xx - yy) * sh[:, 9]
         + SH_C3[1] * xy * z * sh[:, 10]
         + SH_C3[2] * y * (4.0 * zz - xx - yy) * sh[:, 11]
         + SH_C3[3] * z * (2.0 * zz - 3.0 * xx - 3.0 * yy) * sh[:, 12]
         + SH_C3[4] * x * (4.0 * zz - xx - yy) * sh[:, 13]
         + SH_C3[5] * z * (xx - yy) * sh[:, 14]
         + SH_C3[6] * x * (xx - 3.0 * yy) * sh[:, 15])
    return torch.clamp(c + 0.5, min=0.0)


def preprocess(g: Dict[str, torch.Tensor], cam: Dict[str, torch.Tensor],
               size: int, mm=torch.matmul) -> Dict[str, torch.Tensor]:
    """Per-Gaussian screen quantities of ``g`` seen by ``cam`` (Tw2v,
    Tv2c, campos, tan_fovx, tan_fovy) at ``size`` x ``size`` pixels;
    ``mm`` computes the products."""
    means, scales, q = g['means'], g['scales'], g['rotations']
    Tw2v, Tv2c = cam['Tw2v'], cam['Tv2c']
    R, tr = Tw2v[:3, :3], Tw2v[:3, 3]
    p_view = mm(means, R.T) + tr
    full = Tv2c @ Tw2v
    p_hom = mm(means, full[:3, :3].T) + full[:3, 3]
    w = mm(means, full[3, :3, None])[:, 0] + full[3, 3]
    ndc = p_hom * (1.0 / (w + 1e-7))[:, None]

    # R S^2 R^T of the normalised quaternion
    qn = q / torch.sqrt(torch.sum(q * q, -1, keepdim=True) + 1e-24)
    Rg = _rotation(qn)
    s2 = torch.square(scales)
    cov = torch.einsum('nij,nj,nkj->nik', Rg, s2, Rg)

    fx = size / (2.0 * cam['tan_fovx'])
    fy = size / (2.0 * cam['tan_fovy'])
    tz = p_view[:, 2]
    lim_x, lim_y = 1.3 * cam['tan_fovx'], 1.3 * cam['tan_fovy']
    tx = torch.clamp(p_view[:, 0] / tz, -lim_x, lim_x) * tz
    ty = torch.clamp(p_view[:, 1] / tz, -lim_y, lim_y) * tz
    zeros = torch.zeros_like(tz)
    J = torch.stack([torch.stack([fx / tz, zeros, -fx * tx / (tz * tz)], -1),
                     torch.stack([zeros, fy / tz, -fy * ty / (tz * tz)], -1)],
                    1)                                          # [N, 2, 3]
    A = mm(J, R)                                                # [N, 2, 3]
    c2 = mm(mm(A, cov), A.transpose(1, 2))
    cxx, cxy, cyy = c2[:, 0, 0] + 0.3, c2[:, 0, 1], c2[:, 1, 1] + 0.3
    det = cxx * cyy - cxy * cxy
    det_ok = det != 0.0
    inv = 1.0 / torch.where(det_ok, det, torch.ones_like(det))
    conic = torch.stack([cyy * inv, -cxy * inv, cxx * inv], -1)
    mid = 0.5 * (cxx + cyy)
    lam = mid + torch.sqrt(torch.clamp(mid * mid - det, min=0.1))
    radius = torch.ceil(3.0 * torch.sqrt(torch.clamp(lam, min=0.0)))
    px = ((ndc[:, 0] + 1.0) * size - 1.0) * 0.5
    py = ((ndc[:, 1] + 1.0) * size - 1.0) * 0.5
    o = g['opacities']
    tau = 2.0 * torch.clamp(torch.log(255.0 * o), min=0.0)
    rx = torch.minimum(torch.ceil(torch.sqrt(tau * cxx)), radius)
    ry = torch.minimum(torch.ceil(torch.sqrt(tau * cyy)), radius)
    grid = (size + TILE - 1) // TILE
    x0 = torch.clamp(to_int((px - rx) / TILE), 0, grid)
    y0 = torch.clamp(to_int((py - ry) / TILE), 0, grid)
    x1 = torch.clamp(to_int((px + rx + TILE - 1) / TILE), 0, grid)
    y1 = torch.clamp(to_int((py + ry + TILE - 1) / TILE), 0, grid)
    visible = (tz > NEAR) & det_ok & ((x1 - x0) * (y1 - y0) > 0) & g['alive']
    return {'xy': torch.stack([px, py], -1), 'conic': conic, 'opacity': o,
            'colour': sh_colour(g['sh'], means, cam['campos']),
            'depth': tz, 'rect': torch.stack([x0, y0, x1, y1], -1),
            'tau': tau, 'visible': visible, 'grid': grid}


def _rotation(q: torch.Tensor) -> torch.Tensor:
    x, y, z, w = q.unbind(-1)
    return torch.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
    ], -1).reshape(-1, 3, 3)


def tile_lists(pre: Dict[str, torch.Tensor]):
    """(gaussian ids, tile ids) of every kept pair, sorted by tile and, in
    a tile, by depth (ties to the lower slot)."""
    vis = torch.nonzero(pre['visible'])[:, 0]
    depth = pre['depth'][vis]
    vis = vis[torch.sort(depth, stable=True).indices]
    rank = torch.arange(vis.numel(), device=vis.device)
    r = pre['rect'][vis]
    w, h = r[:, 2] - r[:, 0], r[:, 3] - r[:, 1]
    count = w * h
    owner = torch.repeat_interleave(torch.arange(vis.numel(),
                                                 device=vis.device), count)
    start = torch.cumsum(count, 0) - count
    local = torch.arange(owner.numel(), device=vis.device) - start[owner]
    tx = r[owner, 0] + local % w[owner]
    ty = r[owner, 1] + local // w[owner]
    gid = vis[owner]
    # the exact minimum of the quadratic form over the tile's pixel box
    xy = pre['xy'][gid]
    a, b, c = pre['conic'][gid].unbind(-1)
    tau = pre['tau'][gid]
    dxlo = (tx * TILE).to(torch.float32) - xy[:, 0]
    dxhi = dxlo + (TILE - 1)
    dylo = (ty * TILE).to(torch.float32) - xy[:, 1]
    dyhi = dylo + (TILE - 1)
    inside = (dxlo <= 0) & (dxhi >= 0) & (dylo <= 0) & (dyhi >= 0)

    def form(dx, dy):
        return a * dx * dx + 2.0 * b * dx * dy + c * dy * dy

    a_s, c_s = torch.clamp(a, min=1e-12), torch.clamp(c, min=1e-12)
    q = torch.minimum(
        torch.minimum(form(dxlo, torch.clamp(-b * dxlo / c_s, dylo, dyhi)),
                      form(dxhi, torch.clamp(-b * dxhi / c_s, dylo, dyhi))),
        torch.minimum(form(torch.clamp(-b * dylo / a_s, dxlo, dxhi), dylo),
                      form(torch.clamp(-b * dyhi / a_s, dxlo, dxhi), dyhi)))
    keep = inside | (q <= tau + 1e-3)
    grid = pre['grid']
    tile = (ty * grid + tx)[keep]
    rank_k = rank[owner][keep]
    order = torch.sort(tile * (vis.numel() + 1) + rank_k).indices
    return gid[keep][order], tile[order]


def _alphas(xy, conic, o, valid, pix):
    """(alpha [S, L, P], keep [S, L, P]) of S tiles' padded lists (xy
    [S, L, 2], conic [S, L, 3], o [S, L], ``valid`` [S, L]) at the pixel
    centres ``pix`` [S, P, 2]; alpha is zero where not kept."""
    dx = pix[:, None, :, 0] - xy[:, :, None, 0]
    dy = pix[:, None, :, 1] - xy[:, :, None, 1]
    a, b, c = conic[..., 0:1], conic[..., 1:2], conic[..., 2:3]
    power = -0.5 * (a * dx * dx + c * dy * dy) - b * dx * dy
    alpha = torch.clamp(o[..., None] * torch.exp(torch.clamp(power, max=0.0)),
                        max=ALPHA_MAX)
    keep = (power <= POWER_SKIP) & (alpha >= ALPHA_MIN) & valid[..., None]
    return torch.where(keep, alpha, torch.zeros_like(alpha)), keep


def _blend_block(xy, conic, o, col, valid, pix):
    """Colour [S, P, 3] and final transmittance [S, P] of a block of tiles
    (see ``_alphas``; ``col`` [S, L, 3])."""
    alpha, _ = _alphas(xy, conic, o, valid, pix)
    incl = torch.cumprod(1.0 - alpha, dim=1)
    adds = incl >= T_EPS
    excl = torch.cat([torch.ones_like(incl[:, :1]), incl[:, :-1]], dim=1)
    wgt = torch.where(adds, alpha * excl, torch.zeros_like(alpha))
    colour = torch.einsum('slp,slc->spc', wgt, col)
    final = torch.where(adds, incl, torch.full_like(incl, 2.0)).amin(1)
    final = torch.where(final > 1.5, torch.ones_like(final), final)
    return colour, final


def _block_stats(xy, conic, o, valid, pix) -> Dict[str, int]:
    """The walk's work in a block: the (entry, pixel) evaluations a live
    pixel reaches, and of those the kept, added and stopping ones."""
    alpha, keep = _alphas(xy, conic, o, valid, pix)
    incl = torch.cumprod(1.0 - alpha, dim=1)
    excl = torch.cat([torch.ones_like(incl[:, :1]), incl[:, :-1]], 1)
    reach = (excl >= T_EPS) & valid[..., None]
    return {'evaluations': int(reach.sum()),
            'kept': int((reach & keep).sum()),
            'adds': int((keep & (incl >= T_EPS)).sum()),
            'stops': int((reach & keep & (incl < T_EPS)).sum())}


def render(g: Dict[str, torch.Tensor], cam: Dict[str, torch.Tensor],
           size: int, bg: torch.Tensor, stats: Optional[Dict] = None,
           mm=torch.matmul) -> torch.Tensor:
    """The composited image [size, size, 3] of ``g`` seen by ``cam`` over
    ``bg`` [3]."""
    pre = preprocess(g, cam, size, mm)
    gid, tile = tile_lists(pre)
    grid = pre['grid']
    n_tiles = grid * grid
    dev = gid.device
    counts = torch.bincount(tile, minlength=n_tiles)
    starts = torch.cumsum(counts, 0) - counts
    feats = torch.cat([pre['xy'], pre['conic'], pre['opacity'][:, None],
                       pre['colour']], dim=-1)                  # [N, 9]
    lp = torch.arange(TILE * TILE, device=dev)
    # tiles by list length, so that a block pads little
    by_len = torch.sort(counts, descending=True).indices
    lens = counts[by_len].tolist()
    colour = torch.zeros((n_tiles, TILE * TILE, 3), device=dev)
    trans = torch.ones((n_tiles, TILE * TILE), device=dev)
    parts_c, parts_t, parts_i = [], [], []
    if stats is not None:
        stats['pairs'] = stats.get('pairs', 0) + int(gid.numel())
    i = 0
    while i < n_tiles and lens[i] > 0:
        L = lens[i]
        S = max(1, min(n_tiles - i, BLOCK_ELEMS // (L * TILE * TILE)))
        tiles = by_len[i:i + S]
        i += S
        off = torch.arange(L, device=dev)
        valid = off[None, :] < counts[tiles][:, None]
        idx = torch.where(valid, starts[tiles][:, None] + off[None, :], 0)
        rows = torch.where(valid, gid[idx], 0)
        f = feats[rows]                                         # [S, L, 9]
        pix = torch.stack([(tiles % grid)[:, None] * TILE + lp % TILE,
                           (tiles // grid)[:, None] * TILE + lp // TILE],
                          -1).to(torch.float32)                 # [S, P, 2]
        xy, conic, o, col = f[..., 0:2], f[..., 2:5], f[..., 5], f[..., 6:9]
        if stats is not None:
            for k, v in _block_stats(xy, conic, o, valid, pix).items():
                stats[k] = stats.get(k, 0) + v
        c, t = _blend_block(xy, conic, o, col, valid, pix)
        parts_c.append(c)
        parts_t.append(t)
        parts_i.append(tiles)
    if parts_i:
        idx = torch.cat(parts_i)
        colour = colour.index_copy(0, idx, torch.cat(parts_c))
        trans = trans.index_copy(0, idx, torch.cat(parts_t))
    img = colour.reshape(grid, grid, TILE, TILE, 3).permute(0, 2, 1, 3, 4) \
        .reshape(grid * TILE, grid * TILE, 3)[:size, :size]
    tr = trans.reshape(grid, grid, TILE, TILE).permute(0, 2, 1, 3) \
        .reshape(grid * TILE, grid * TILE)[:size, :size]
    return img + tr[..., None] * bg


def camera(views: Dict, i: int, device) -> Dict[str, torch.Tensor]:
    """View ``i`` of ``inputs.view_arrays``' arrays as tensors."""
    f = lambda x: torch.as_tensor(x, dtype=torch.float32, device=device)
    return {'Tw2v': f(views['Tw2v'][i]), 'Tv2c': f(views['Tv2c']),
            'campos': f(views['campos'][i]), 'tan_fovx': f(views['tan_fovx']),
            'tan_fovy': f(views['tan_fovy'])}


def image_gap(a: torch.Tensor, b: torch.Tensor) -> float:
    """Root mean square difference of two images."""
    return math.sqrt(float(torch.mean(torch.square(a.double() - b.double()))))
