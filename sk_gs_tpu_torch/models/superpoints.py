"""Masked KNN, LBS weights, the superpoint transforms and warps, and the
superpoint adjustment masks (port of ``sk_gs_tpu/models/superpoints.py``).

Dead superpoints (``sp_alive`` False) lie at +inf KNN distance: never
selected, no LBS weight.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..ops import quaternion as quat
from ..ops import se3


def rot_bias(like: torch.Tensor) -> torch.Tensor:
    """The identity bias (0, 0, 0, 1) of the warp net's raw rotation head,
    made on ``like``'s device: a host tensor's copy would synchronise the
    host with the card, which a CUDA graph cannot capture."""
    return torch.eye(4, dtype=like.dtype, device=like.device)[3]


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
    # constants as Python scalars: a tensor made on the host and copied to
    # the card would synchronise the host with the card at every call
    d2 = torch.where(key_mask[None, :], d2, float('inf'))
    m = d2.shape[1]
    col = torch.arange(m, device=d2.device)[None, :]
    ramp = (col + 1).to(torch.float32) * float(np.float32(3.0e38 / m))
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


def sp_transforms(d_xyz: torch.Tensor, d_rot: torch.Tensor,
                  sp_points: torch.Tensor, warp_method: str) -> torch.Tensor:
    """Per-superpoint SE3 [M, 7] from the warp net's outputs; ``LBS_c``
    rotates about the superpoint (t = d_xyz + p + R(-p))."""
    if warp_method == 'LBS_c':
        t = d_xyz + sp_points + quat.apply(d_rot, -sp_points)
    else:
        t = d_xyz
    return torch.cat([t, d_rot], dim=-1)


def warp_points(points: torch.Tensor, spT: torch.Tensor,
                weights: torch.Tensor, indices: torch.Tensor,
                warp_method: str, p2sp: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
    """d_xyz [N, 3] of the blended SE3 actions; ``largest`` takes each
    point's heaviest superpoint ``p2sp`` alone."""
    if warp_method == 'largest':
        return se3.se3_act(spT[p2sp.to(torch.int64)], points) - points
    pk = se3.se3_act(spT[indices.to(torch.int64)], points[:, None, :])
    return torch.sum(pk * weights[..., None], dim=1) - points


def blend_attr(attr: torch.Tensor, weights: torch.Tensor,
               indices: torch.Tensor) -> torch.Tensor:
    """Weighted blend of per-superpoint attributes [M, C] -> [N, C]."""
    return torch.sum(attr[indices.to(torch.int64)] * weights[..., None], dim=1)


def segment_sum(values: torch.Tensor, ids: torch.Tensor, n: int
                ) -> torch.Tensor:
    """Sum of ``values`` [E, ...] into ``n`` segments by ``ids`` [E]."""
    out = torch.zeros((n, *values.shape[1:]), dtype=values.dtype,
                      device=values.device)
    return out.index_add_(0, ids.to(torch.int64), values)


def get_superpoint_features(value: torch.Tensor, neighbor: torch.Tensor,
                            g: torch.Tensor, num_sp: int) -> torch.Tensor:
    """The weighted mean [num_sp, C] of the per-point ``value`` [N, C] on
    each superpoint, a point's share the LBS weight ``g`` [N, K] of its
    superpoints ``neighbor`` [N, K] (``superpoints.py:193-202``): two
    ``segment_sum`` calls, whose backward is a gather."""
    c = value.shape[-1]
    src = (value[:, None, :] * g[:, :, None]).reshape(-1, c)
    idx = neighbor.reshape(-1)
    vsum = segment_sum(src, idx, num_sp)
    wsum = segment_sum(g.reshape(-1), idx, num_sp)
    return vsum / torch.clamp(wsum[:, None], min=1e-5)


def superpoint_prune_split_masks(
        weights: torch.Tensor, indices: torch.Tensor, sp_alive: torch.Tensor,
        xyz_grad_accum: torch.Tensor, denom: torch.Tensor,
        points: torch.Tensor, prune_threshold: float, split_threshold: float,
        m_cap: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(prune [M], split [M], split positions [M, 3]): prune a live
    superpoint whose LBS weight mass W is below the threshold; split a kept
    one whose weighted mean position gradient reaches the split threshold
    or whose W is at least twice the 90th percentile of the kept W; the
    split position is the weight-normalised mean of its points."""
    flat_idx = indices.reshape(-1)
    W = segment_sum(weights.reshape(-1), flat_idx, m_cap)
    prune = sp_alive & (W < prune_threshold)
    keep = sp_alive & ~prune

    p_grad = torch.where(denom > 0,
                         xyz_grad_accum / torch.clamp(denom, min=1.0),
                         torch.zeros_like(denom))
    sp_grad = segment_sum((p_grad[:, None] * weights).reshape(-1), flat_idx,
                          m_cap)
    split = keep & (sp_grad / torch.clamp(W, min=1e-6) >= split_threshold)

    inf = torch.full_like(W, float('inf'))
    w_sorted = torch.sort(torch.where(keep, W, inf)).values
    # 0.9 * n_keep in float32, truncated, as the JAX package computes it
    n_keep = keep.sum().to(torch.float32)
    k90 = torch.clamp((0.9 * n_keep).to(torch.int64), 0, m_cap - 1)
    w90 = w_sorted[k90]
    split = split | (keep & (W >= 2.0 * w90) & torch.isfinite(w90))

    wsum = torch.clamp(W, min=1e-6)
    wnorm = weights / wsum[indices.to(torch.int64)]
    new_pos = segment_sum((points[:, None, :] * wnorm[..., None])
                          .reshape(-1, 3), flat_idx, m_cap)
    return prune, split, new_pos


def superpoint_merge_masks(sp_points: torch.Tensor, sp_alive: torch.Tensor,
                           sp_cache: torch.Tensor, num_knn: int
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(min_diff [M], min_index [M]): over each live superpoint's
    ``num_knn`` nearest live superpoints (nearest first, ties in index
    order as ``top_k`` takes them), the smallest mean over the frames of
    the cached transform difference, and that neighbour."""
    m = sp_points.shape[0]
    d = torch.linalg.norm(sp_points[:, None] - sp_points[None, :], dim=-1)
    inf = torch.tensor(float('inf'), device=d.device)
    d = torch.where(sp_alive[None, :] & sp_alive[:, None], d, inf)
    d = torch.where(torch.eye(m, dtype=torch.bool, device=d.device), inf, d)
    k = min(m, num_knn)
    knn = torch.sort(d, dim=-1, stable=True).indices[:, :k]
    tr_diff = torch.linalg.norm(sp_cache[:, :, None, :] - sp_cache[:, knn, :],
                                dim=-1)                          # [T, M, K]
    tr_diff = torch.mean(tr_diff, dim=0)
    tr_diff = torch.where(sp_alive[:, None], tr_diff, inf)
    min_diff, min_k = torch.min(tr_diff, dim=1)
    min_index = knn[torch.arange(m, device=d.device), min_k]
    return min_diff, min_index
