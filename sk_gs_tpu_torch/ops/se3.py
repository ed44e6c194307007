"""SO3 / SE3 ops on quaternions (port of ``sk_gs_tpu/ops/se3.py``).

Layouts: SO3 = quaternion (x, y, z, w) [..., 4]; SE3 = (tx, ty, tz, qx, qy,
qz, qw) [..., 7]; SO3 tangent = rotation vector [..., 3].
"""
from __future__ import annotations

import torch

from . import quaternion as quat

_EPS = 1e-8


def so3_exp(phi: torch.Tensor) -> torch.Tensor:
    """Rotation vector [..., 3] -> unit quaternion, Taylor-guarded at 0."""
    theta_sq = torch.sum(phi * phi, dim=-1, keepdim=True)
    theta = torch.sqrt(torch.clamp(theta_sq, min=_EPS * _EPS))
    half = 0.5 * theta
    small = theta_sq < _EPS
    k = torch.where(small, 0.5 - theta_sq / 48.0, torch.sin(half) / theta)
    w = torch.where(small, 1.0 - theta_sq / 8.0, torch.cos(half))
    return torch.cat([phi * k, w], dim=-1)


def se3_identity(shape=(), dtype=torch.float32, device=None) -> torch.Tensor:
    t = torch.zeros((*shape, 3), dtype=dtype, device=device)
    return torch.cat([t, quat.identity(shape, dtype, device)], dim=-1)


def se3_mul(T1: torch.Tensor, T2: torch.Tensor) -> torch.Tensor:
    """Compose: (T1 * T2)(x) = T1(T2(x))."""
    t1, q1 = T1[..., :3], T1[..., 3:7]
    t2, q2 = T2[..., :3], T2[..., 3:7]
    return torch.cat([t1 + quat.apply(q1, t2), quat.multiply(q1, q2)], dim=-1)


def se3_act(T: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Apply SE3 transform(s) to point(s) [..., 3]."""
    return quat.apply(T[..., 3:7], p) + T[..., :3]


def se3_interpolate(T1: torch.Tensor, T2: torch.Tensor, alpha) -> torch.Tensor:
    """Linear translation + slerp rotation blend."""
    alpha = torch.as_tensor(alpha, dtype=T1.dtype, device=T1.device)
    t = (1.0 - alpha[..., None]) * T1[..., :3] + alpha[..., None] * T2[..., :3]
    q = quat.slerp(T1[..., 3:7], T2[..., 3:7], alpha)
    return torch.cat([t, q], dim=-1)
