"""SO3 / SE3 ops on quaternions (port of ``sk_gs_tpu/ops/se3.py``).

Layouts: SO3 = quaternion (x, y, z, w) [..., 4]; SE3 = (tx, ty, tz, qx, qy,
qz, qw) [..., 7]; SO3 tangent = rotation vector [..., 3]; SE3 tangent =
(tau, phi) [..., 6], translation first. The logs keep the JAX package's
finite-gradient forms: the norm of the vector part carries eps^2 under its
square root, so the identity rotation has a finite gradient.
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


def so3_log(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion -> rotation vector [..., 3]. sqrt(|u|^2 + eps^2)
    keeps the backward finite at u = 0, and theta / |u| -> 2 there, as the
    series would give."""
    q = quat.standardize(quat.normalize(q))
    u = q[..., :3]
    w = q[..., 3:4]
    norm_u = torch.sqrt(torch.sum(torch.square(u), dim=-1, keepdim=True)
                        + _EPS * _EPS)
    theta = 2.0 * torch.atan2(norm_u, w)
    return u * (theta / norm_u)


def se3_identity(shape=(), dtype=torch.float32, device=None) -> torch.Tensor:
    t = torch.zeros((*shape, 3), dtype=dtype, device=device)
    return torch.cat([t, quat.identity(shape, dtype, device)], dim=-1)


def se3_mul(T1: torch.Tensor, T2: torch.Tensor) -> torch.Tensor:
    """Compose: (T1 * T2)(x) = T1(T2(x))."""
    t1, q1 = T1[..., :3], T1[..., 3:7]
    t2, q2 = T2[..., :3], T2[..., 3:7]
    return torch.cat([t1 + quat.apply(q1, t2), quat.multiply(q1, q2)], dim=-1)


def se3_inv(T: torch.Tensor) -> torch.Tensor:
    t, q = T[..., :3], T[..., 3:7]
    q_inv = quat.conjugate(q)
    return torch.cat([-quat.apply(q_inv, t), q_inv], dim=-1)


def se3_act(T: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Apply SE3 transform(s) to point(s) [..., 3]."""
    return quat.apply(T[..., 3:7], p) + T[..., :3]


def _so3_left_jacobian_terms(phi: torch.Tensor):
    """Coefficients (A, B) with V = I + A [phi]x + B [phi]x^2."""
    theta_sq = torch.sum(phi * phi, dim=-1, keepdim=True)
    theta = torch.sqrt(torch.clamp(theta_sq, min=_EPS * _EPS))
    small = theta_sq < _EPS
    A = torch.where(small, 0.5 - theta_sq / 24.0,
                    (1.0 - torch.cos(theta)) / torch.clamp(theta_sq, min=_EPS))
    B = torch.where(small, 1.0 / 6.0 - theta_sq / 120.0,
                    (theta - torch.sin(theta))
                    / torch.clamp(theta_sq * theta, min=_EPS))
    return A, B


def se3_log(T: torch.Tensor) -> torch.Tensor:
    """SE3 [..., 7] -> tangent (tau, phi) [..., 6], tau = V^-1 t with
    V^-1 = I - [phi]x / 2 + C [phi]x^2, C = (1 - (theta/2) cot(theta/2)) /
    theta^2 (series below eps)."""
    t, q = T[..., :3], T[..., 3:7]
    phi = so3_log(q)
    theta_sq = torch.sum(phi * phi, dim=-1, keepdim=True)
    theta = torch.sqrt(torch.clamp(theta_sq, min=_EPS * _EPS))
    small = theta_sq < _EPS
    half = 0.5 * theta
    cot_term = half * torch.cos(half) / torch.clamp(torch.sin(half), min=_EPS)
    C = torch.where(small, 1.0 / 12.0 + theta_sq / 720.0,
                    (1.0 - cot_term) / torch.clamp(theta_sq, min=_EPS))
    phi_b, t_b = torch.broadcast_tensors(phi, t)
    c1 = torch.linalg.cross(phi_b, t_b)
    c2 = torch.linalg.cross(phi_b, c1)
    tau = t - 0.5 * c1 + C * c2
    return torch.cat([tau, phi], dim=-1)


def se3_interpolate(T1: torch.Tensor, T2: torch.Tensor, alpha) -> torch.Tensor:
    """Linear translation + slerp rotation blend."""
    alpha = torch.as_tensor(alpha, dtype=T1.dtype, device=T1.device)
    t = (1.0 - alpha[..., None]) * T1[..., :3] + alpha[..., None] * T2[..., :3]
    q = quat.slerp(T1[..., 3:7], T2[..., 3:7], alpha)
    return torch.cat([t, q], dim=-1)
