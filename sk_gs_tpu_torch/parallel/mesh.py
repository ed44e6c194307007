"""The device mesh over ``torch.distributed`` (port of
``sk_gs_tpu/parallel/mesh.py``).

One process drives one device, and the ranks form an (n_view, n_gs) grid
in row order, as the JAX ``make_mesh`` reshapes its devices:

- ``view``: data parallelism over camera views (a column of the grid);
- ``gs``:   model parallelism over the Gaussian capacity axis (a row).

Where JAX places arrays on the mesh with ``NamedSharding`` and lets XLA
insert the collectives, each rank here holds its own tensors and calls the
collectives of ``parallel.collectives`` on the process group of an axis
(``Mesh.group``). So the JAX helpers ``replicated``, ``view_sharded``,
``gs_sharded`` (a ``NamedSharding`` each) and ``shard_map_compat`` (a
``shard_map`` across JAX versions) have no counterpart: a replicated
tensor is the same tensor on every rank, and a sharded one is this rank's
slice of it (``shard_rows``).
"""
from __future__ import annotations

import os
import warnings
from typing import Dict, Optional

import torch
import torch.distributed as dist

AXES = ('view', 'gs')
DEFAULT_PORT = '12321'


def _env(name: str) -> Optional[str]:
    return os.environ.get(name)


def init_distributed(coordinator: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     backend: Optional[str] = None) -> Dict[str, int]:
    """Join the process group when launched as one process per device
    (``torchrun``, or ``MASTER_ADDR`` / ``WORLD_SIZE`` / ``RANK`` set by
    hand), with the JAX function's rules (``mesh.py:25-93``).

    Env fallbacks: coordinator ``MASTER_ADDR[:MASTER_PORT]`` (port 12321
    when unset), num_processes ``WORLD_SIZE``, process_id ``RANK``. A
    process count of 1 skips the group: a coordinator passed explicitly
    then raises ``ValueError`` (it would train uncoordinated replicas), and
    one found in the env only warns (a stale ``MASTER_ADDR`` under a
    launcher). ``backend`` defaults to 'nccl' where the process sees a
    card and 'gloo' elsewhere; 'nccl' with more ranks on a host
    (``LOCAL_WORLD_SIZE``, else the process count) than cards raises and
    names the 'gloo' option, which runs several ranks on one card. Returns
    ``process_index``, ``process_count``, ``local_device_count`` (the
    devices this process drives: 1) and ``device_count`` (the mesh's: one
    a process)."""
    explicit_coordinator = coordinator is not None
    if coordinator is None and _env('MASTER_ADDR') is not None:
        coordinator = _env('MASTER_ADDR') + ':' + (_env('MASTER_PORT')
                                                   or DEFAULT_PORT)
    if num_processes is None and _env('WORLD_SIZE') is not None:
        num_processes = int(_env('WORLD_SIZE'))
    if process_id is None and _env('RANK') is not None:
        process_id = int(_env('RANK'))

    multi = (num_processes or 1) > 1
    if explicit_coordinator and not multi:
        raise ValueError(
            f'coordinator {coordinator!r} was passed explicitly but '
            f'num_processes is {num_processes or 1}; set num_processes>1 '
            f'(or WORLD_SIZE) for a multi-process launch')
    if coordinator is not None and not multi and not explicit_coordinator:
        warnings.warn(
            f'coordinator {coordinator!r} found in env but process count is '
            f'{num_processes or 1}; skipping torch.distributed.'
            f'init_process_group — set WORLD_SIZE>1 for a multi-process '
            f'launch')
    if multi and not dist.is_initialized():
        if coordinator is None or process_id is None:
            raise ValueError(
                f'{num_processes} processes need a coordinator '
                f'(MASTER_ADDR) and a process id (RANK)')
        if backend is None:
            backend = 'nccl' if torch.cuda.is_available() else 'gloo'
        if backend == 'nccl':
            local = int(_env('LOCAL_WORLD_SIZE') or num_processes)
            cards = torch.cuda.device_count()
            if local > cards:
                raise ValueError(
                    f"backend 'nccl' takes one card a rank, but {local} "
                    f"ranks share {cards} card(s) here; use backend 'gloo' "
                    f"(--dist-backend gloo) to run several ranks on one "
                    f"card")
        dist.init_process_group(backend, init_method=f'tcp://{coordinator}',
                                world_size=num_processes, rank=process_id)
    initialized = dist.is_initialized()
    world = dist.get_world_size() if initialized else 1
    return {'process_index': dist.get_rank() if initialized else 0,
            'process_count': world, 'local_device_count': 1,
            'device_count': world}


class Mesh:
    """The ranks as an (n_view, n_gs) grid in row order: rank r sits at
    (r // n_gs, r % n_gs). ``group(axis)`` is the process group of this
    rank's column ('view') or row ('gs'), or of every rank for both axes
    (``('view', 'gs')``, what a JAX ``psum`` over both reduces); None on a
    one-process mesh. ``shape`` maps each axis to its size, as the JAX
    ``Mesh.shape``."""

    def __init__(self, n_view: int, n_gs: int, rank: int,
                 groups: Dict[str, object]):
        self.n_view, self.n_gs, self.rank = n_view, n_gs, rank
        self.shape = {'view': n_view, 'gs': n_gs}
        self._groups = groups

    @property
    def size(self) -> int:
        return self.n_view * self.n_gs

    def axis_index(self, axis: str) -> int:
        """This rank's index along ``axis``."""
        return self.rank // self.n_gs if axis == 'view' else \
            self.rank % self.n_gs if axis == 'gs' else self._bad(axis)

    def axis_size(self, axis: str) -> int:
        if axis not in AXES:
            self._bad(axis)
        return self.shape[axis]

    def axis_ranks(self, axis) -> list:
        """The global ranks of this rank's group along ``axis`` (both axes:
        every rank), in axis order."""
        v, g = self.axis_index('view'), self.axis_index('gs')
        if self._both(axis):
            return list(range(self.size))
        if axis == 'view':
            return [i * self.n_gs + g for i in range(self.n_view)]
        return [v * self.n_gs + j for j in range(self.n_gs)]

    def group(self, axis):
        """The process group along ``axis``, or of every rank when
        ``axis`` names both axes."""
        if self._both(axis):
            return self._groups.get('world')
        if axis not in AXES:
            self._bad(axis)
        return self._groups.get(axis)

    def _both(self, axis) -> bool:
        if isinstance(axis, tuple):
            if sorted(axis) != sorted(AXES):
                self._bad(axis)
            return True
        return False

    @staticmethod
    def _bad(axis: str):
        raise ValueError(f'mesh axis {axis!r} is not one of {AXES}')

    def __repr__(self) -> str:
        return (f'Mesh(view={self.n_view}, gs={self.n_gs}, '
                f'rank={self.rank})')


def make_mesh(n_view: Optional[int] = None, n_gs: int = 1) -> Mesh:
    """The ('view', 'gs') mesh over every rank of the process group (one
    rank without one). Every rank must call it, in the same order as its
    other group creations: it makes one process group per row and per
    column of the grid; the group of both axes is the default group."""
    initialized = dist.is_initialized()
    world = dist.get_world_size() if initialized else 1
    if n_view is None:
        n_view = world // n_gs
    if n_view * n_gs != world:
        raise ValueError(f'{n_view}x{n_gs} != {world} devices')
    rank = dist.get_rank() if initialized else 0
    groups: Dict[str, object] = {}
    if initialized:
        v, g = rank // n_gs, rank % n_gs
        for i in range(n_view):
            pg = dist.new_group([i * n_gs + j for j in range(n_gs)])
            if i == v:
                groups['gs'] = pg
        for j in range(n_gs):
            pg = dist.new_group([i * n_gs + j for i in range(n_view)])
            if j == g:
                groups['view'] = pg
        groups['world'] = dist.group.WORLD
    return Mesh(n_view, n_gs, rank, groups)


def shard_rows(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """This rank's contiguous slice of ``x``'s first axis along ``axis``
    (what the JAX ``P(axis)`` places on the device)."""
    d, i = mesh.axis_size(axis), mesh.axis_index(axis)
    n = x.shape[0]
    if n % d:
        raise ValueError(f'{n} rows do not split into {d} shards')
    return x[i * (n // d):(i + 1) * (n // d)]
