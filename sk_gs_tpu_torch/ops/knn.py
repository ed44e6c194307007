"""Squared distances, k nearest neighbours and furthest point sampling
(port of ``sq_cdist``, ``knn``, ``mean_knn_dist2`` and
``furthest_point_sampling`` of ``sk_gs_tpu/ops/knn.py``, and the trainer's
KNN over the live rows, ``live_knn_index``).

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
    ascending, equal distances in index order (the order of the JAX
    package's ``top_k``; duplicated points, such as a clone and its source,
    tie exactly)."""
    d2, idx = [], []
    for q in torch.split(queries, chunk):
        d, i = smallest_k(sq_cdist(q, points), k)
        d2.append(d)
        idx.append(i)
    return torch.cat(d2), torch.cat(idx)


def live_knn_index(points: torch.Tensor, alive: torch.Tensor, k: int,
                   chunk: int = 2048) -> torch.Tensor:
    """Indices [N, k] (int64) of each row's k nearest live rows, itself
    left out (the first of its k + 1 nearest): dead rows are pushed 1e12
    away. The smooth loss's Gaussian KNN (``sk_gs_tpu/framework/
    trainer.py:1297-1309``)."""
    with torch.no_grad():
        far = torch.where(alive, 0.0, 1e12).to(points.dtype)
        pts = points + far[:, None]
        _, idx = knn(pts, pts, k + 1, chunk=chunk)
    return idx[:, 1:]


def smallest_k(d2: torch.Tensor, k: int) -> Tuple[torch.Tensor,
                                                   torch.Tensor]:
    """The k smallest entries of each row by (value, column): every entry
    below the row's k-th value, then the lowest columns equal to it."""
    kth = torch.topk(d2, k, dim=-1, largest=False).values[:, -1:]
    below = d2 < kth
    tied = d2 == kth
    room = k - below.sum(-1, keepdim=True)
    pick = below | (tied & (torch.cumsum(tied.to(torch.int32), -1) <= room))
    cols = torch.nonzero(pick)[:, 1].reshape(d2.shape[0], k)   # column order
    vals = torch.gather(d2, 1, cols)
    vals, order = torch.sort(vals, dim=-1, stable=True)
    return vals, torch.gather(cols, 1, order)


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


def furthest_point_sampling(points: torch.Tensor, num_samples: int,
                            mask: Optional[torch.Tensor] = None,
                            return_dists: bool = False):
    """Indices [num_samples] (int64) of a furthest-point subset of ``points``
    [N, D] (any feature width D): the first live row (row 0 without a
    ``mask``), then num_samples - 1 times the row whose running minimum
    squared distance to the picks is largest, first index on ties. Dead
    rows score -1e30 and are never picked. Everything stays on the
    device: no host sync per pick. With ``return_dists`` also the running
    minimum distance of each pick when it was picked ([num_samples], inf
    for the first)."""
    n = points.shape[0]
    dev = points.device
    big = None if mask is None else torch.where(
        mask, 0.0, -1e30).to(points.dtype)
    selected = torch.zeros(num_samples, dtype=torch.int64, device=dev)
    if mask is not None:
        selected[0] = torch.argmax(mask.to(torch.int32))
    picked = torch.full((num_samples,), float('inf'), dtype=points.dtype,
                        device=dev)
    dists = torch.full((n,), float('inf'), dtype=points.dtype, device=dev)
    for i in range(1, num_samples):
        last = points.index_select(0, selected[i - 1:i])            # [1, D]
        dists = torch.minimum(dists, torch.sum((points - last) ** 2, -1))
        score = dists if big is None else dists + big
        best = torch.argmax(score)
        selected[i] = best
        picked[i] = dists[best]
    return (selected, picked) if return_dists else selected
