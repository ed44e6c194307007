"""Motion regularizers: ARAP, elastic, acceleration and point ARAP (port of
``sk_gs_tpu/models/regularizers.py``).

- ``arap_connectivity`` / ``arap_error``: a KNN graph with adaptive
  weights, each node's best-fit rotation (SVD Procrustes) and the stretch
  energy over a trajectory;
- ``elastic_loss``: the variance of edge lengths over time samples, self-
  normalised, weighted by LBS kernel weights;
- ``acc_loss``: the finite-difference acceleration;
- ``points_arap_loss``: the preservation of squared KNN distances.

The Procrustes rotations carry no gradient, as in the JAX package, where a
custom JVP returns a zero tangent: an SVD's backward at repeated singular
values (a node whose neighbours sit symmetrically about it, or a trajectory
that is still rigid) divides by their zero difference. Here the SVD runs
under ``torch.no_grad`` on a detached matrix, so autograd never reaches it.
"""
from __future__ import annotations

from typing import Tuple

import torch

from ..ops.knn import smallest_k
from .skeleton import _safe_norm


def arap_connectivity(points: torch.Tensor, mask: torch.Tensor, k: int = 10,
                      radius: float = 0.1, least_edge_num: int = 3
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(nn_idx [M, K], weight [M, K], edge_mask [M, K]): each live node's K
    nearest live nodes (K clamped to M - 1), the edges beyond ``radius``
    dropped but the first ``least_edge_num``, weights exp(-d / mean d) over
    the kept edges, normalised per node. The weights carry the gradient of
    the kept distances."""
    m = points.shape[0]
    k = min(k, m - 1)
    d2 = torch.sum(torch.square(points[:, None] - points[None]), dim=-1)
    inf = float('inf')
    d2 = torch.where(mask[None, :], d2, inf)
    eye = torch.eye(m, dtype=torch.bool, device=points.device)
    d2 = torch.where(eye, inf, d2)
    # ties (the dead and the own column, all inf) in index order, as the
    # JAX package's top_k
    nn_dist, nn_idx = smallest_k(d2, k)
    col = torch.arange(k, device=points.device)[None, :]
    keep = (col < least_edge_num) | (nn_dist < radius * radius)
    keep = keep & mask[:, None] & torch.isfinite(nn_dist)
    # zero (not inf) the dropped entries before the exp: exp(-inf / c) is 0
    # but its gradient with respect to c is inf * 0
    nd = torch.where(keep, nn_dist, 0.0)
    n_keep = torch.sum(keep).to(nd.dtype)
    mean_d = torch.sum(nd) / torch.clamp(n_keep, min=1.0)
    w = torch.exp(-nd / torch.clamp(mean_d, min=1e-8))
    w = torch.where(keep, w, 0.0)
    w = w / torch.clamp(torch.sum(w, dim=-1, keepdim=True), min=1e-8)
    return nn_idx, w, keep


@torch.no_grad()
def _procrustes_rotations(S: torch.Tensor) -> torch.Tensor:
    """V diag(1, 1, det(V U^T)) U^T of each S = U diag(s) V^T [M, 3, 3]."""
    u, _, vh = torch.linalg.svd(S)
    v = vh.mT
    det = torch.linalg.det(v @ u.mT)
    d = torch.stack([torch.ones_like(det), torch.ones_like(det), det], -1)
    return (v * d[:, None, :]) @ u.mT


def _best_fit_rotations(e0: torch.Tensor, et: torch.Tensor,
                        w: torch.Tensor) -> torch.Tensor:
    """Each node's rotation R minimising sum_k w_k |e_t - R e_0|^2, from the
    detached S = sum_k w_k e0_k et_k^T; no gradient."""
    S = torch.einsum('mk,mki,mkj->mij', w, e0, et)
    return _procrustes_rotations(S.detach())


def arap_error(nodes_seq: torch.Tensor, nn_idx: torch.Tensor,
               w: torch.Tensor) -> torch.Tensor:
    """ARAP stretch energy of a node trajectory [T, M, 3]: the weighted
    squared distance of each later frame's edges to the first frame's
    edges turned by the node's best-fit rotation, summed."""
    idx = nn_idx.to(torch.int64)
    n0 = nodes_seq[0]
    e0 = n0[:, None, :] - n0[idx]                                  # [M, K, 3]
    err = torch.zeros((), dtype=nodes_seq.dtype, device=nodes_seq.device)
    for nodes_t in nodes_seq[1:]:
        et = nodes_t[:, None, :] - nodes_t[idx]
        R = _best_fit_rotations(e0, et, w)
        rigid = torch.einsum('mij,mkj->mki', R, e0)
        stretch = torch.sum(torch.square(et - rigid), dim=-1)     # [M, K]
        err = err + torch.sum(w * stretch)
    return err


def elastic_loss(nodes_t: torch.Tensor, nn_idx: torch.Tensor,
                 nn_w: torch.Tensor) -> torch.Tensor:
    """Edge-length variance over time samples: nodes_t [M, T, 3]; nn_idx /
    nn_w [M, Kc] the neighbours and their weights."""
    idx = nn_idx.to(torch.int64)
    edge_t = _safe_norm(nodes_t[idx] - nodes_t[:, None])           # [M, Kc, T]
    var = torch.var(edge_t, dim=2, unbiased=False)
    var = var / (var.detach() + 1e-5)
    return torch.mean(torch.sum(var * nn_w, dim=1))


def acc_loss(nodes_3t: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Finite-difference acceleration: nodes_3t [M, 3, 3] holds each node
    at (t - dt, t, t + dt); ``mask`` [M] float weighs the nodes."""
    acc = _safe_norm(nodes_3t[:, 0] + nodes_3t[:, 2] - 2.0 * nodes_3t[:, 1])
    acc = acc / (acc.detach() + 1e-5)
    return torch.sum(acc * mask) / torch.clamp(torch.sum(mask), min=1.0)


def points_arap_loss(points_c: torch.Tensor, points_t: torch.Tensor,
                     nn_idx: torch.Tensor, mask: torch.Tensor
                     ) -> torch.Tensor:
    """Mean |d_c - d_t| of the squared distances of each masked point to
    its neighbours ``nn_idx`` [N, K], before (``points_c``) and after
    (``points_t``) the warp."""
    idx = nn_idx.to(torch.int64)
    mask = mask.to(points_t.dtype)
    dc = torch.sum(torch.square(points_c[:, None] - points_c[idx]), dim=-1)
    dt = torch.sum(torch.square(points_t[:, None] - points_t[idx]), dim=-1)
    diff = torch.abs(dc - dt) * mask[:, None]
    return torch.sum(diff) / torch.clamp(torch.sum(mask) * idx.shape[1],
                                         min=1.0)
