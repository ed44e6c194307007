"""Squared distances and k nearest neighbours (port of ``sq_cdist``, ``knn``
and ``mean_knn_dist2`` of ``sk_gs_tpu/ops/knn.py``).

Distances use the |x|^2 + |y|^2 - 2 x.y expansion (one matrix product), as
in the JAX package; queries go in chunks to bound the [chunk, M] block.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch


def sq_cdist(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Squared euclidean distances [N, M] between x [N, D] and y [M, D]."""
    x2 = torch.sum(x * x, dim=-1, keepdim=True)
    y2 = torch.sum(y * y, dim=-1)
    return torch.clamp(x2 + y2[None, :] - 2.0 * (x @ y.T), min=0.0)


def knn(queries: torch.Tensor, points: torch.Tensor, k: int,
        chunk: int = 4096) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sq_dists [N, k], indices [N, k]) of each query's k nearest points,
    ascending."""
    d2, idx = [], []
    for q in torch.split(queries, chunk):
        d, i = torch.topk(sq_cdist(q, points), k, dim=-1, largest=False)
        d2.append(d)
        idx.append(i)
    return torch.cat(d2), torch.cat(idx)


def mean_knn_dist2(points: torch.Tensor, k: int = 3, chunk: int = 2048,
                   mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean squared distance of each point to its k nearest *other* points
    (the ``simple_knn`` scale initialiser). With a capacity ``mask``, dead
    slots sit at +1e12 so they are never neighbours; their own output is
    arbitrary."""
    n = points.shape[0]
    big = None if mask is None else torch.where(
        mask, 0.0, 1e12).to(points.dtype)
    out = []
    for base in range(0, n, chunk):
        qc = points[base:base + chunk]
        d2 = sq_cdist(qc, points)
        if big is not None:
            d2 = d2 + big[None, :]
        rows = torch.arange(base, base + qc.shape[0], device=points.device)
        d2[torch.arange(qc.shape[0], device=points.device), rows] = \
            float('inf')                                     # not itself
        out.append(torch.topk(d2, k, dim=-1, largest=False).values.mean(-1))
    return torch.cat(out)
