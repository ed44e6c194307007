"""Per-Gaussian preprocessing: project, EWA cov2D, conic, tile rects, SH
colour (port of ``sk_gs_tpu/render/preprocess.py``, same operation order so
that float fields agree to rounding and integer fields exactly).

``preprocess`` runs it as one launch of the hand-written kernel
``csrc/preprocess_fwd.cu`` (``preprocess_fwd``) where the inputs lie on a
CUDA device, ``cfg.use_kernel`` is on and autograd records nothing (grad
off, or no input requiring grad): every served render on a card. Everything
else (training steps, the CPU, ``use_kernel`` off) runs the plain version,
``preprocess_plain``.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..ops import quaternion as quat
from ..ops import sh as sh_ops
from ..utils.tracing import span
from .kernel import _check, _Kernel
from .settings import TILE, GaussianInputs, RasterConfig, ViewParams

# largest float32 below 2^31: float -> int32 saturates like XLA's convert
_I32_MAX_F = 2147483520.0


class PreprocessOut(NamedTuple):
    means2d: torch.Tensor        # [N, 2] pixel coordinates
    depths: torch.Tensor         # [N] view z (+inf when culled)
    conic: torch.Tensor          # [N, 3] inverse 2D covariance (a, b, c)
    colors: torch.Tensor         # [N, C]
    radius: torch.Tensor         # [N] int32 3-sigma radius (0 when culled)
    tiles_touched: torch.Tensor  # [N] int32
    rect_min: torch.Tensor       # [N, 2] int32 tile coords (x, y)
    rect_max: torch.Tensor       # [N, 2] int32, exclusive
    visible: torch.Tensor        # [N] bool
    tau: torch.Tensor            # [N] alpha >= 1/255 quadform threshold


def to_int32(x: torch.Tensor) -> torch.Tensor:
    """float -> int32 as XLA converts: truncation toward zero, saturation
    at the int32 range, NaN -> 0 (a bare ``.to(int32)`` is undefined out of
    range)."""
    y = torch.clamp(torch.nan_to_num(x, nan=0.0), -2.0 ** 31, _I32_MAX_F)
    y = y.to(torch.int32)
    return torch.where(x >= 2.0 ** 31, torch.full_like(y, 2 ** 31 - 1), y)


def compute_cov3d(scales: torch.Tensor, rotations: torch.Tensor,
                  scale_modifier: float = 1.0) -> torch.Tensor:
    """R S^2 R^T packed as (xx, xy, xz, yy, yz, zz)."""
    R = quat.to_matrix(rotations, pre_normalize=True)
    s2 = torch.square(scales * scale_modifier)
    out = []
    for i in range(3):
        for k in range(i, 3):
            acc = R[:, i, 0] * s2[:, 0] * R[:, k, 0]
            for j in (1, 2):
                acc = acc + R[:, i, j] * s2[:, j] * R[:, k, j]
            out.append(acc)
    return torch.stack(out, dim=-1)


def project_points(means3d: torch.Tensor, view: ViewParams):
    """Returns (p_view [N, 3], p_ndc [N, 3])."""
    R, t = view.Tw2v[:3, :3], view.Tw2v[:3, 3]
    p_view = means3d @ R.T + t
    P = view.full_proj
    p_hom = means3d @ P[:3, :3].T + P[:3, 3]
    w = means3d @ P[3, :3] + P[3, 3]
    inv_w = 1.0 / (w + 1e-7)
    return p_view, p_hom * inv_w[:, None]


def ndc_to_pix(v: torch.Tensor, size: int) -> torch.Tensor:
    return ((v + 1.0) * size - 1.0) * 0.5


def compute_cov2d(p_view: torch.Tensor, cov3d: torch.Tensor, view: ViewParams,
                  cfg: RasterConfig) -> torch.Tensor:
    """EWA screen-space covariance (cxx, cxy, cyy) with the +0.3 low-pass."""
    fx = cfg.image_width / (2.0 * view.tan_fovx)
    fy = cfg.image_height / (2.0 * view.tan_fovy)
    tz = p_view[:, 2]
    lim_x = 1.3 * view.tan_fovx
    lim_y = 1.3 * view.tan_fovy
    tx = torch.clamp(p_view[:, 0] / tz, -lim_x, lim_x) * tz
    ty = torch.clamp(p_view[:, 1] / tz, -lim_y, lim_y) * tz
    inv_z = 1.0 / tz
    inv_z2 = inv_z * inv_z
    j00 = fx * inv_z
    j02 = -fx * tx * inv_z2
    j11 = fy * inv_z
    j12 = -fy * ty * inv_z2
    W = view.Tw2v[:3, :3]
    a0 = [j00 * W[0, k] + j02 * W[2, k] for k in range(3)]
    a1 = [j11 * W[1, k] + j12 * W[2, k] for k in range(3)]
    sxx, sxy, sxz, syy, syz, szz = cov3d.unbind(-1)

    def sig_row(a):
        return (a[0] * sxx + a[1] * sxy + a[2] * sxz,
                a[0] * sxy + a[1] * syy + a[2] * syz,
                a[0] * sxz + a[1] * syz + a[2] * szz)

    b0 = sig_row(a0)
    b1 = sig_row(a1)
    cxx = b0[0] * a0[0] + b0[1] * a0[1] + b0[2] * a0[2] + 0.3
    cyy = b1[0] * a1[0] + b1[1] * a1[1] + b1[2] * a1[2] + 0.3
    cxy = b0[0] * a1[0] + b0[1] * a1[1] + b0[2] * a1[2]
    return torch.stack([cxx, cxy, cyy], dim=-1)


def preprocess_plain(g: GaussianInputs, view: ViewParams, cfg: RasterConfig,
                     active_sh_degree: Optional[torch.Tensor] = None
                     ) -> PreprocessOut:
    """The plain version, in PyTorch operations. Culled and dead Gaussians
    end with radius 0, tiles_touched 0 and depth +inf, so they never
    produce pairs."""
    p_view, p_ndc = project_points(g.means3d, view)
    in_front = p_view[:, 2] > cfg.near

    cov3d = compute_cov3d(g.scales, g.rotations, cfg.scale_modifier)
    cov2d = compute_cov2d(p_view, cov3d, view, cfg)
    det = cov2d[:, 0] * cov2d[:, 2] - cov2d[:, 1] * cov2d[:, 1]
    det_valid = det != 0.0
    inv_det = 1.0 / torch.where(det_valid, det, torch.ones_like(det))
    conic = torch.stack([cov2d[:, 2] * inv_det, -cov2d[:, 1] * inv_det,
                         cov2d[:, 0] * inv_det], dim=-1)

    mid = 0.5 * (cov2d[:, 0] + cov2d[:, 2])
    disc = torch.sqrt(torch.clamp(mid * mid - det, min=0.1))
    lam_max = mid + disc
    radius_f = torch.ceil(3.0 * torch.sqrt(torch.clamp(lam_max, min=0.0)))

    px = ndc_to_pix(p_ndc[:, 0], cfg.image_width)
    py = ndc_to_pix(p_ndc[:, 1], cfg.image_height)
    means2d = torch.stack([px, py], dim=-1)

    # o * exp(-q/2) >= 1/255  <=>  q <= tau
    tau = 2.0 * torch.clamp(torch.log(255.0 * g.opacities.reshape(-1)), min=0.0)
    if cfg.tight_culling:
        rx_f = torch.minimum(torch.ceil(torch.sqrt(tau * cov2d[:, 0])), radius_f)
        ry_f = torch.minimum(torch.ceil(torch.sqrt(tau * cov2d[:, 2])), radius_f)
    else:
        rx_f = ry_f = radius_f

    th = cfg.tile_h
    rect_min_x = torch.clamp(to_int32((px - rx_f) / TILE), 0, cfg.grid_w)
    rect_min_y = torch.clamp(to_int32((py - ry_f) / th), 0, cfg.grid_h)
    rect_max_x = torch.clamp(to_int32((px + rx_f + TILE - 1) / TILE), 0, cfg.grid_w)
    rect_max_y = torch.clamp(to_int32((py + ry_f + th - 1) / th), 0, cfg.grid_h)
    area = (rect_max_x - rect_min_x) * (rect_max_y - rect_min_y)

    visible = in_front & det_valid & (area > 0)
    if g.mask is not None:
        visible = visible & g.mask

    radius = to_int32(torch.where(visible, radius_f, torch.zeros_like(radius_f)))
    tiles_touched = torch.where(visible, area, torch.zeros_like(area)).to(torch.int32)
    depths = torch.where(visible, p_view[:, 2],
                         torch.full_like(p_view[:, 2], float('inf')))

    if g.colors is not None:
        colors = g.colors
    else:
        sh = g.sh
        if active_sh_degree is not None:
            band_mask = sh_ops.sh_degree_mask(cfg.sh_degree, active_sh_degree,
                                              device=sh.device)
            sh = sh * band_mask[None, :, None]
        colors = sh_ops.sh_to_color(cfg.sh_degree, sh, g.means3d, view.campos)

    rect_min = torch.stack([rect_min_x, rect_min_y], dim=-1).to(torch.int32)
    rect_max = torch.stack([rect_max_x, rect_max_y], dim=-1).to(torch.int32)
    return PreprocessOut(means2d, depths, conic, colors, radius,
                         tiles_touched, rect_min, rect_max, visible, tau)


class PreprocessForward(_Kernel):
    """Wrapper of the preprocess kernel: ``preprocess_plain``'s every field
    for all N rows in one launch (``preprocess`` picks between the two)."""

    name = 'preprocess_fwd'
    replaces = 'none (the JAX package leaves the preprocess to XLA)'
    source = 'sk_gs_tpu_torch/csrc/preprocess_fwd.cu'
    n_pointers = 22
    n_ints = 10
    n_floats = 2
    # a served request launches the forward blend next: build both at once
    builds_with = ('tile_blend_fwd.cu',)

    def launch(self, g: GaussianInputs, view: ViewParams, cfg: RasterConfig,
               active_sh_degree: Optional[torch.Tensor] = None
               ) -> PreprocessOut:
        """``preprocess_plain(g, view, cfg, active_sh_degree)`` on the
        card, with no host read: ``active_sh_degree`` is None (every band)
        or an int32 tensor of one element on the card. The inputs are
        contiguous float32 on one CUDA device (the mask bool); ``g.sh``
        [N, bases, C] with ``cfg.sh_degree`` <= 3, or
        ``g.colors``, which the result hands back as the plain version
        does."""
        dev = g.means3d.device
        if dev.type != 'cuda':
            raise ValueError(f'{self.name} launches on CUDA tensors, got {dev}')
        f32 = torch.float32
        n = g.means3d.shape[0]
        opac = g.opacities.reshape(-1)
        _check(dev, means3d=(g.means3d, f32), scales=(g.scales, f32),
               rotations=(g.rotations, f32), opacities=(opac, f32),
               Tw2v=(view.Tw2v, f32), Tv2c=(view.Tv2c, f32),
               campos=(view.campos, f32), tan_fovx=(view.tan_fovx, f32),
               tan_fovy=(view.tan_fovy, f32))
        for name, t, shape in (('means3d', g.means3d, (n, 3)),
                               ('scales', g.scales, (n, 3)),
                               ('rotations', g.rotations, (n, 4)),
                               ('opacities', opac, (n,)),
                               ('Tw2v', view.Tw2v, (4, 4)),
                               ('Tv2c', view.Tv2c, (4, 4)),
                               ('campos', view.campos, (3,))):
            if tuple(t.shape) != shape:
                raise ValueError(f'{name} must be {list(shape)}, got '
                                 f'{list(t.shape)}')
        for name, t in (('tan_fovx', view.tan_fovx),
                        ('tan_fovy', view.tan_fovy)):
            if t.numel() != 1:
                raise ValueError(f'{name} must hold one value')
        if g.mask is not None:
            _check(dev, mask=(g.mask, torch.bool))
            if tuple(g.mask.shape) != (n,):
                raise ValueError(f'mask must be [{n}]')
        sh, colors = None, g.colors
        if colors is None:
            sh = g.sh
            _check(dev, sh=(sh, f32))
            nb = (cfg.sh_degree + 1) ** 2
            if not 0 <= cfg.sh_degree <= 3:
                raise ValueError(f'sh_degree {cfg.sh_degree} is not in 0..3')
            if sh.dim() != 3 or sh.shape[0] != n or sh.shape[1] < nb \
                    or sh.shape[2] < 1:
                raise ValueError(f'sh must be [{n}, >= {nb}, C], got '
                                 f'{list(sh.shape)}')
            if active_sh_degree is not None and sh.shape[1] != nb:
                raise ValueError(f'the band mask needs sh [{n}, {nb}, C]')
            colors = torch.empty((n, sh.shape[2]), dtype=f32, device=dev)
        if active_sh_degree is not None:
            _check(dev, active_sh_degree=(active_sh_degree, torch.int32))
            if active_sh_degree.numel() != 1:
                raise ValueError('active_sh_degree must hold one value')

        e = lambda *shape, dtype=f32: torch.empty(shape, dtype=dtype,
                                                  device=dev)
        i32 = torch.int32
        out = PreprocessOut(
            means2d=e(n, 2), depths=e(n), conic=e(n, 3), colors=colors,
            radius=e(n, dtype=i32), tiles_touched=e(n, dtype=i32),
            rect_min=e(n, 2, dtype=i32), rect_max=e(n, 2, dtype=i32),
            visible=e(n, dtype=torch.bool), tau=e(n))
        self._run(dev, (g.means3d, g.scales, g.rotations, opac, sh, g.mask,
                        view.Tw2v, view.Tv2c, view.campos, view.tan_fovx,
                        view.tan_fovy, active_sh_degree, out.means2d,
                        out.depths, out.conic,
                        None if sh is None else out.colors, out.radius,
                        out.tiles_touched, out.rect_min, out.rect_max,
                        out.visible, out.tau),
                  (n, cfg.sh_degree, 0 if sh is None else sh.shape[1],
                   colors.shape[1], cfg.image_width, cfg.image_height,
                   cfg.grid_w, cfg.grid_h, cfg.tile_h,
                   int(cfg.tight_culling)),
                  (cfg.near, cfg.scale_modifier))
        return out

    def blocks_per_sm(self, sh_degree: int, row_floats: int) -> int:
        """Blocks of the kernel resident on one SM at once for SH degree
        ``sh_degree`` and SH rows of ``row_floats`` floats (bases x
        channels; 0 where colours are given)."""
        return self._occupancy(sh_degree, row_floats)


preprocess_fwd = PreprocessForward()


def kernel_engages(g: GaussianInputs, view: ViewParams,
                   cfg: RasterConfig) -> bool:
    """Whether ``preprocess`` launches the kernel: the inputs on a CUDA
    device, ``cfg.use_kernel`` on, and autograd recording nothing (grad
    off, or no input of ``g`` or ``view`` requiring grad)."""
    if not cfg.use_kernel or g.means3d.device.type != 'cuda':
        return False
    if torch.is_grad_enabled():
        return not any(isinstance(t, torch.Tensor) and t.requires_grad
                       for t in (*g, *view))
    return True


def preprocess(g: GaussianInputs, view: ViewParams, cfg: RasterConfig,
               active_sh_degree: Optional[torch.Tensor] = None
               ) -> PreprocessOut:
    """``preprocess_plain``'s fields: one launch of ``preprocess_fwd``
    (inside an 'sk.preprocess.kernel' span) where ``kernel_engages``, else
    the plain version. Culled and dead Gaussians end with radius 0,
    tiles_touched 0 and depth +inf, so they never produce pairs."""
    if kernel_engages(g, view, cfg):
        with span('sk.preprocess.kernel'):
            return preprocess_fwd.launch(g, view, cfg, active_sh_degree)
    return preprocess_plain(g, view, cfg, active_sh_degree)
