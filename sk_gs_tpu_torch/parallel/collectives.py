"""The collectives of the mesh, with the gradients JAX gives their
transposes (the port's own module: under ``shard_map`` XLA inserts and
transposes them).

- ``all_gather(x, group, dim)``: the ranks' ``x`` concatenated along
  ``dim`` in rank order; its backward is the reduce-scatter, written as an
  all-reduce of the cotangent and this rank's slice of it. Each rank's
  loss is then its own part of the total (the cotangents are summed).
- ``all_to_all(x, group)``: block d of ``x``'s first axis to rank d, the
  blocks received in rank order; its backward is the all-to-all of the
  cotangent.
- ``psum``, ``pmax``: the all-reduces, without a gradient; ``psum_all``
  and ``pmax_all`` reduce a list of tensors in one call.
- ``broadcast_from(tensors, group, src)``: ``src``'s tensors written into
  every rank's, in place, returning how far they were apart.

``torch.distributed.nn.functional`` is not used: its backwards call
collectives of their own choosing. A group of one rank (or None)
communicates nothing. Gloo takes CUDA tensors in every collective used
here (``all_reduce`` SUM and MAX, ``broadcast``, ``all_gather_into_tensor``,
``all_to_all_single``; torch 2.11 on an H100, ``chip_smoke.py``'s mesh
phases), so no tensor is copied to the host here: gloo stages them itself.
``counts`` holds the calls and the bytes each rank sends into them.
"""
from __future__ import annotations

from typing import Dict, Iterable

import torch
import torch.distributed as dist

from ..utils.tracing import host_read

counts: Dict[str, int] = {'calls': 0, 'bytes': 0}


def reset_counts():
    for k in counts:
        counts[k] = 0


def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def group_rank(group) -> int:
    return 0 if group is None else dist.get_rank(group)


def _run(x: torch.Tensor, fn) -> torch.Tensor:
    """``fn(x)`` on a contiguous ``x``; counts the call and its bytes."""
    counts['calls'] += 1
    counts['bytes'] += x.numel() * x.element_size()
    return fn(x.contiguous())


def _reduce(x: torch.Tensor, group, op) -> torch.Tensor:
    def fn(t):
        t = t.clone()
        dist.all_reduce(t, op=op, group=group)
        return t
    return _run(x, fn)


def _gather(x: torch.Tensor, group) -> torch.Tensor:
    """[D * n, ...] of the ranks' [n, ...] in rank order."""
    def fn(t):
        out = torch.empty((group_size(group) * t.shape[0],) + t.shape[1:],
                          dtype=t.dtype, device=t.device)
        dist.all_gather_into_tensor(out, t, group=group)
        return out
    return _run(x, fn)


def _exchange(x: torch.Tensor, group) -> torch.Tensor:
    def fn(t):
        out = torch.empty_like(t)
        dist.all_to_all_single(out, t, group=group)
        return out
    return _run(x, fn)


def psum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over the group's ranks (no gradient)."""
    if group_size(group) == 1:
        return x.detach().clone()
    return _reduce(x.detach(), group, dist.ReduceOp.SUM)


def pmax(x: torch.Tensor, group) -> torch.Tensor:
    """The elementwise max of ``x`` over the group's ranks (no gradient)."""
    if group_size(group) == 1:
        return x.detach().clone()
    return _reduce(x.detach(), group, dist.ReduceOp.MAX)


def _reduce_all(tensors, group, op, wire: torch.dtype):
    tensors = list(tensors)
    if group_size(group) == 1:
        return tensors
    flat = _reduce(torch.cat([t.reshape(-1).to(wire) for t in tensors]),
                   group, op)
    out, o = [], 0
    for t in tensors:
        out.append(flat[o:o + t.numel()].view(t.shape).to(t.dtype))
        o += t.numel()
    return out


def psum_all(tensors: Iterable[torch.Tensor], group) -> list:
    """``psum`` of each tensor, through one all-reduce of them flattened
    into float32 (integers exact below 2^24); the inputs themselves on a
    group of one rank."""
    return _reduce_all(tensors, group, dist.ReduceOp.SUM, torch.float32)


def pmax_all(tensors: Iterable[torch.Tensor], group) -> list:
    """``pmax`` of each tensor, through one all-reduce of them flattened
    into float64; the inputs themselves on a group of one rank."""
    return _reduce_all(tensors, group, dist.ReduceOp.MAX, torch.float64)


class _AllGather(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim, ctx.n = group, dim, x.shape[dim]
        out = _gather(x.movedim(dim, 0), group)
        return out.movedim(0, dim)

    @staticmethod
    def backward(ctx, g):
        g = _reduce(g, ctx.group, dist.ReduceOp.SUM)
        i = group_rank(ctx.group)
        return g.narrow(ctx.dim, i * ctx.n, ctx.n), None, None


class _AllToAll(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _exchange(x, group)

    @staticmethod
    def backward(ctx, g):
        return _exchange(g, ctx.group), None


def all_gather(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The ranks' ``x`` concatenated along ``dim`` in rank order (JAX's
    ``all_gather(..., tiled=True)``), differentiable in ``x``."""
    if group_size(group) == 1:
        return x
    if x.requires_grad:
        return _AllGather.apply(x, group, dim)
    return _gather(x.movedim(dim, 0), group).movedim(0, dim)


def all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` [D, ...] (D the group's size): block d goes to rank d, and the
    result's block d came from rank d (JAX's ``all_to_all(split_axis=0,
    concat_axis=0, tiled=True)``), differentiable in ``x``."""
    d = group_size(group)
    if x.shape[0] != d:
        raise ValueError(f'all_to_all needs [{d}, ...] blocks, got '
                         f'{list(x.shape)}')
    if d == 1:
        return x
    if x.requires_grad:
        return _AllToAll.apply(x, group)
    return _exchange(x, group)


def broadcast_from(tensors: Iterable[torch.Tensor], group,
                   src: int) -> float:
    """Write global rank ``src``'s ``tensors`` into every rank's, in place
    (one broadcast per dtype, the tensors flattened into it). Returns the
    largest absolute difference this rank's tensors had from ``src``'s
    before (0 on ``src``)."""
    tensors = list(tensors)
    if group_size(group) == 1 or not tensors:
        return 0.0
    drift = 0.0
    by_dtype: Dict[torch.dtype, list] = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for dtype, ts in by_dtype.items():
        flat = torch.cat([t.detach().reshape(-1) for t in ts])
        wire = flat.to(torch.uint8) if dtype == torch.bool else flat

        def fn(t, src=src):
            t = t.clone()
            dist.broadcast(t, src=src, group=group)
            return t
        got = _run(wire, fn).to(dtype)
        if dtype.is_floating_point:
            diff = torch.where(got == flat, 0.0, (got - flat).abs())
        else:
            diff = (got.to(torch.int64) - flat.to(torch.int64)).abs()
        if diff.numel():
            drift = max(drift, float(host_read(diff.max())))
        o = 0
        with torch.no_grad():
            for t in ts:
                n = t.numel()
                t.copy_(got[o:o + n].view(t.shape))
                o += n
    return drift
