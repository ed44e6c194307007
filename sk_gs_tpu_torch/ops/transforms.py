"""Camera builders (port of the parts of ``sk_gs_tpu/ops/transforms.py`` the
serving path uses)."""
from __future__ import annotations

from typing import Optional, Tuple

import torch


def perspective_opencv(fovy: float, aspect: float = 1.0, n: float = 0.1,
                       f: float = 1000.0, size: Optional[Tuple[int, int]] = None,
                       dtype=torch.float32, device=None) -> torch.Tensor:
    """OpenCV-convention clip-space projection Tv2c (z forward, y down)."""
    if size is not None:
        aspect = size[0] / size[1]
    y = torch.tan(torch.as_tensor(fovy, dtype=dtype, device=device) * 0.5)
    x = y * aspect
    P = torch.zeros((4, 4), dtype=dtype, device=device)
    P[0, 0] = 1.0 / x
    P[1, 1] = 1.0 / y
    P[2, 2] = (f + n) / (f - n)
    P[2, 3] = -(2.0 * f * n) / (f - n)
    P[3, 2] = 1.0
    return P


def look_at(eye, at, up, coord: str = 'opengl', device=None) -> torch.Tensor:
    """World->view Tw2v; opengl looks down -z, opencv down +z with y down."""
    eye, at, up = (torch.as_tensor(v, dtype=torch.float32, device=device)
                   for v in (eye, at, up))
    fwd = at - eye
    fwd = fwd / torch.linalg.norm(fwd, dim=-1, keepdim=True)
    if coord in ('opencv', 'colmap'):
        z = fwd
        x = -torch.linalg.cross(z, up / torch.linalg.norm(up, dim=-1, keepdim=True))
        x = x / torch.linalg.norm(x, dim=-1, keepdim=True)
        y = torch.linalg.cross(z, x)
    else:
        z = -fwd
        x = torch.linalg.cross(up, z)
        x = x / torch.linalg.norm(x, dim=-1, keepdim=True)
        y = torch.linalg.cross(z, x)
    R = torch.stack([x, y, z], dim=-2)
    t = -torch.einsum('...ij,...j->...i', R, eye)
    Tw2v = torch.zeros((*eye.shape[:-1], 4, 4), dtype=torch.float32,
                       device=device)
    Tw2v[..., :3, :3] = R
    Tw2v[..., :3, 3] = t
    Tw2v[..., 3, 3] = 1.0
    return Tw2v
