"""Quaternion math in the (x, y, z, w) layout, identity [0, 0, 0, 1].

Port of ``sk_gs_tpu/ops/quaternion.py``; functions broadcast over leading
dims.
"""
from __future__ import annotations

import torch


def identity(shape=(), dtype=torch.float32, device=None) -> torch.Tensor:
    q = torch.zeros((*shape, 4), dtype=dtype, device=device)
    q[..., 3] = 1.0
    return q


def normalize(q: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Unit quaternions; ``eps*eps`` inside the sqrt keeps q == 0 finite."""
    n = torch.sqrt(torch.sum(torch.square(q), dim=-1, keepdim=True) + eps * eps)
    return q / n


def conjugate(q: torch.Tensor) -> torch.Tensor:
    """(x, y, z, w) -> (-x, -y, -z, w)."""
    return torch.cat([-q[..., :3], q[..., 3:4]], dim=-1)


def standardize(q: torch.Tensor) -> torch.Tensor:
    """Flip the sign so that the scalar part w is non-negative."""
    return torch.where(q[..., 3:4] < 0, -q, q)


def multiply(q1: torch.Tensor, q2: torch.Tensor) -> torch.Tensor:
    """Hamilton product: rotating by ``multiply(q1, q2)`` rotates by q2
    first, then by q1."""
    x1, y1, z1, w1 = q1.unbind(-1)
    x2, y2, z2, w2 = q2.unbind(-1)
    return torch.stack([
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
    ], dim=-1)


def to_matrix(q: torch.Tensor, pre_normalize: bool = True) -> torch.Tensor:
    """Quaternion -> rotation matrix [..., 3, 3], v' = R @ v. Without
    ``pre_normalize`` the raw formula is the linear map of ``apply`` for any
    (even off-unit) quaternion."""
    if pre_normalize:
        q = normalize(q)
    x, y, z, w = q.unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    R = torch.stack([
        1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
        2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
        2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
    ], dim=-1)
    return R.reshape(*q.shape[:-1], 3, 3)


def apply(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate v [..., 3] by q [..., 4]: v + 2w(u x v) + 2 u x (u x v)."""
    u = q[..., :3]
    w = q[..., 3:4]
    u, v = torch.broadcast_tensors(u, v)
    uv = torch.linalg.cross(u, v)
    return v + 2.0 * (w * uv + torch.linalg.cross(u, uv))


def slerp(q1: torch.Tensor, q2: torch.Tensor, t, eps: float = 1e-7
          ) -> torch.Tensor:
    """Spherical interpolation between unit quaternions, t in [0, 1]."""
    t = torch.as_tensor(t, dtype=q1.dtype, device=q1.device)[..., None]
    q1 = normalize(q1)
    q2 = normalize(q2)
    dot = torch.sum(q1 * q2, dim=-1, keepdim=True)
    q2 = torch.where(dot < 0, -q2, q2)
    dot = torch.abs(dot)
    theta = torch.arccos(torch.clamp(dot, -1.0, 1.0))
    sin_theta = torch.sin(theta)
    use_lerp = sin_theta < eps
    sin_safe = torch.clamp(sin_theta, min=eps)
    w1 = torch.where(use_lerp, 1.0 - t, torch.sin((1.0 - t) * theta) / sin_safe)
    w2 = torch.where(use_lerp, t, torch.sin(t * theta) / sin_safe)
    return normalize(w1 * q1 + w2 * q2)
