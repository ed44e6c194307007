"""Masked KNN, LBS weights and the dense LBS warp (port of the parts of
``sk_gs_tpu/models/superpoints.py`` the skeleton warp uses)."""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..ops import quaternion as quat


def masked_knn(queries: torch.Tensor, keys: torch.Tensor,
               key_mask: torch.Tensor, k: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """k nearest live keys per query: (squared dists [N, k], ids [N, k]).

    Same selection as the JAX package, index for index: the distance is the
    per-coordinate difference-square sum (``torch.cdist``'s matmul form
    rounds differently and can pick other neighbours); k argmin passes,
    each taking the first minimum, so ties go to the lowest index; dead
    columns carry a finite ramp increasing with the index, so an all-dead
    row still yields ascending indices.
    """
    d2 = torch.square(queries[:, None, 0] - keys[None, :, 0])
    for j in range(1, queries.shape[1]):
        d2 = d2 + torch.square(queries[:, None, j] - keys[None, :, j])
    inf = torch.tensor(float('inf'), device=d2.device)
    d2 = torch.where(key_mask[None, :], d2, inf)
    m = d2.shape[1]
    col = torch.arange(m, device=d2.device)[None, :]
    ramp = (col + 1).to(torch.float32) * torch.tensor(3.0e38 / m,
                                                      dtype=torch.float32,
                                                      device=d2.device)
    taken = torch.where(key_mask[None, :], d2, ramp)
    dists, idxs = [], []
    for _ in range(k):
        i = torch.argmin(taken, dim=1, keepdim=True)                # [N, 1]
        dists.append(torch.gather(d2, 1, i)[:, 0])
        idxs.append(i[:, 0])
        taken.scatter_(1, i, float('inf'))
    return torch.stack(dists, dim=1), torch.stack(idxs, dim=1).to(torch.int32)


def select_rows(table: torch.Tensor, indices: torch.Tensor) -> torch.Tensor:
    """table[n, indices[n, k]] -> [N, K]."""
    return torch.gather(table, 1, indices.to(torch.int64))


def calc_lbs_weight(points: torch.Tensor, sp_points: torch.Tensor,
                    sp_alive: torch.Tensor, k: int, method: str,
                    hyper: Optional[torch.Tensor] = None,
                    sp_hyper: Optional[torch.Tensor] = None,
                    sp_W: Optional[torch.Tensor] = None,
                    sp_radius_raw: Optional[torch.Tensor] = None,
                    sp_weight_raw: Optional[torch.Tensor] = None,
                    temperature: float = 1.0
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(weights [N, K] summing to 1, indices [N, K])."""
    q = points.detach()
    kp = sp_points.detach()
    if hyper is not None and sp_hyper is not None:
        q = torch.cat([q, hyper], dim=-1)
        kp = torch.cat([kp, sp_hyper], dim=-1)
    nn_dist, indices = masked_knn(q, kp, sp_alive, k)
    idx = indices.to(torch.int64)
    if method in ('kernel', 'weighted_kernel'):
        radius = torch.exp(sp_radius_raw)[idx]
        w = torch.exp(-nn_dist / (2.0 * radius * radius))
        if method == 'weighted_kernel':
            w = w * torch.sigmoid(sp_weight_raw)[idx]
        w = w + 1e-7
        w = w / torch.sum(w, dim=-1, keepdim=True)
    elif method == 'W':
        w = torch.softmax(select_rows(sp_W, indices), dim=-1)
    else:  # 'dist'
        w = torch.softmax(-nn_dist / temperature, dim=-1)
    return w, indices


def dense_lbs_rows(weights: torch.Tensor, indices: torch.Tensor,
                   m: int) -> torch.Tensor:
    """K-sparse LBS weights -> dense rows [N, M] (the K ids of a row are
    distinct, so the scatter-add writes each weight once)."""
    dense = torch.zeros((weights.shape[0], m), dtype=weights.dtype,
                        device=weights.device)
    return dense.scatter_add_(1, indices.to(torch.int64), weights)


def warp_blend_dense(points: torch.Tensor, spT: torch.Tensor,
                     dense_w: torch.Tensor, rot_attr: torch.Tensor,
                     scale_attr: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(d_xyz, d_rotation, d_scaling) through one [N, M] @ [M, 12+4+3]
    product: sum_k w_k (R_k p + t_k) = (sum_k w_k R_k) p + sum_k w_k t_k.
    The rotation matrix is the raw (unnormalised) quaternion formula, as in
    the JAX package."""
    R = quat.to_matrix(spT[..., 3:7], pre_normalize=False)
    table = torch.cat([R.reshape(R.shape[0], 9), spT[..., :3], rot_attr,
                       scale_attr], dim=-1)
    b = dense_w @ table
    Rb = b[:, :9].reshape(-1, 3, 3)
    d_xyz = torch.einsum('nij,nj->ni', Rb, points) + b[:, 9:12] - points
    d_rotation = b[:, 12:12 + rot_attr.shape[-1]]
    d_scaling = b[:, 12 + rot_attr.shape[-1]:]
    return d_xyz, d_rotation, d_scaling
