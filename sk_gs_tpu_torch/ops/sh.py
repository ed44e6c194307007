"""Real spherical harmonics for view-dependent colour (port of
``sk_gs_tpu/ops/sh.py``). Coefficient order: (l=0,m=0), (1,-1), (1,0),
(1,1), (2,-2), ...
"""
from __future__ import annotations

import torch

C0 = 0.28209479177387814
C1 = 0.4886025119029199
C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
      -1.0925484305920792, 0.5462742152960396)
C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658,
      0.3731763325901154, -0.4570457994644658, 1.445305721320277,
      -0.5900435899266435)


def rgb_to_sh(rgb: torch.Tensor) -> torch.Tensor:
    """RGB in [0, 1] -> DC coefficient."""
    return (rgb - 0.5) / C0


def eval_sh(deg: int, sh: torch.Tensor, dirs: torch.Tensor) -> torch.Tensor:
    """SH up to degree ``deg`` (0..3). sh [..., (deg+1)^2, C], unit dirs
    [..., 3] -> [..., C], without the +0.5 offset."""
    result = C0 * sh[..., 0, :]
    if deg >= 1:
        x, y, z = dirs[..., 0:1], dirs[..., 1:2], dirs[..., 2:3]
        result = (result - C1 * y * sh[..., 1, :] + C1 * z * sh[..., 2, :]
                  - C1 * x * sh[..., 3, :])
        if deg >= 2:
            xx, yy, zz = x * x, y * y, z * z
            xy, yz, xz = x * y, y * z, x * z
            result = (result
                      + C2[0] * xy * sh[..., 4, :]
                      + C2[1] * yz * sh[..., 5, :]
                      + C2[2] * (2.0 * zz - xx - yy) * sh[..., 6, :]
                      + C2[3] * xz * sh[..., 7, :]
                      + C2[4] * (xx - yy) * sh[..., 8, :])
            if deg >= 3:
                result = (result
                          + C3[0] * y * (3.0 * xx - yy) * sh[..., 9, :]
                          + C3[1] * xy * z * sh[..., 10, :]
                          + C3[2] * y * (4.0 * zz - xx - yy) * sh[..., 11, :]
                          + C3[3] * z * (2.0 * zz - 3.0 * xx - 3.0 * yy) * sh[..., 12, :]
                          + C3[4] * x * (4.0 * zz - xx - yy) * sh[..., 13, :]
                          + C3[5] * z * (xx - yy) * sh[..., 14, :]
                          + C3[6] * x * (xx - 3.0 * yy) * sh[..., 15, :])
    return result


def sh_to_color(deg: int, sh: torch.Tensor, points: torch.Tensor,
                campos: torch.Tensor, clamp: bool = True) -> torch.Tensor:
    """Rasterizer contract: normalised view dir, +0.5 offset, clamp at 0."""
    d = points - campos
    norm = torch.sqrt(torch.sum(d * d, dim=-1, keepdim=True))
    d = d / torch.clamp(norm, min=1e-12)
    color = eval_sh(deg, sh, d) + 0.5
    if clamp:
        color = torch.clamp(color, min=0.0)
    return color


def num_sh_bases(deg: int) -> int:
    return (deg + 1) ** 2


def sh_degree_mask(max_deg: int, active_deg, dtype=torch.float32,
                   device=None) -> torch.Tensor:
    """[(max_deg+1)^2] multiplicative mask enabling bands <= active_deg."""
    idx = torch.arange(num_sh_bases(max_deg), device=device)
    band = torch.floor(torch.sqrt(idx.to(torch.float32))).to(torch.int32)
    active = torch.as_tensor(active_deg, device=device)
    return (band <= active).to(dtype)
