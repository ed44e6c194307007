"""The blend's CUDA kernels, their wrappers, and the autograd functions
around them.

- ``tile_blend_fwd`` wraps ``csrc/tile_blend_fwd.cu``, the port of
  ``sk_gs_tpu/render/tile_kernel.py:_fwd_kernel_tile``;
- ``tile_blend_bwd`` wraps ``csrc/tile_blend_bwd.cu``, the port of
  ``_bwd_kernel_tile`` with ``_blend_bwd``'s segment sum: the gradient rows
  [R, 6 + ch] of the depth-ordered rows;
- ``chunk_blend_fwd`` and ``chunk_blend_bwd`` wrap ``csrc/chunk_blend_fwd.cu``
  and ``csrc/chunk_blend_bwd.cu``, the ports of the ``chunk`` schedule's
  ``_fwd_kernel`` and of ``_bwd_kernel`` with the segment sum;
- ``TileBlend`` and ``ChunkBlend`` are the ``torch.autograd.Function`` of
  the blend on either schedule (the JAX package's ``_blend_custom`` custom
  VJP): forward through the forward kernel, backward through the backward
  kernel, whose rows are the gradients of ``geo`` and ``col``.

On CUDA tensors a wrapper launches its kernel, or raises; on CPU tensors it
runs the plain version in ``blend.py``. It never falls back from one to the
other.
"""
from __future__ import annotations

from typing import Tuple

import torch

from .binning import num_chunks
from .blend import (blend_backward_rows_plain, blend_forward_plain,
                    chunk_blend_backward_rows_plain, chunk_blend_forward_plain)
from .kernel import _check, _Kernel
from .settings import RasterConfig


def _check_rows(geo, col, sort_gauss, cfg: RasterConfig):
    """The depth-ordered rows and the entries' row ids."""
    _check(geo.device, geo=(geo, torch.float32), col=(col, torch.float32),
           sort_gauss=(sort_gauss, torch.int32))
    if geo.dim() != 2 or geo.shape[1] != 6:
        raise ValueError(f'geo must be [R, 6], got {tuple(geo.shape)}')
    if col.dim() != 2 or col.shape[0] != geo.shape[0] or col.shape[1] < 1:
        raise ValueError(f'col must be [R, ch], got {tuple(col.shape)}')
    if sort_gauss.dim() != 1:
        raise ValueError('sort_gauss must be 1-D')
    if cfg.pix_per_tile > 1024:
        raise ValueError(f'tile of {cfg.pix_per_tile} pixels exceeds 1024 '
                         'threads')


def _check_blend_inputs(geo, col, sort_gauss, tile_start, tile_count,
                        cfg: RasterConfig):
    T = cfg.num_tiles
    _check_rows(geo, col, sort_gauss, cfg)
    _check(geo.device, tile_start=(tile_start, torch.int32),
           tile_count=(tile_count, torch.int32))
    if tile_start.shape != (T,) or tile_count.shape != (T,):
        raise ValueError(f'tile_start / tile_count must be [{T}]')


def _check_pixel_grads(dev, tile_color, tile_alpha, g_color, g_alpha,
                       shape):
    """The forward's outputs and their cotangents: contiguous float32,
    [T, P, ch] colours and [T, P] alphas."""
    f32 = torch.float32
    _check(dev, tile_color=(tile_color, f32), tile_alpha=(tile_alpha, f32),
           g_color=(g_color, f32), g_alpha=(g_alpha, f32))
    for name, t, want in (('tile_color', tile_color, shape),
                          ('tile_alpha', tile_alpha, shape[:2]),
                          ('g_color', g_color, shape),
                          ('g_alpha', g_alpha, shape[:2])):
        if tuple(t.shape) != tuple(want):
            raise ValueError(f'{name} must be {list(want)}, got '
                             f'{list(t.shape)}')


class _BlendKernel(_Kernel):
    """A blend kernel: its occupancy depends on the tile height and the
    channels. Called, it runs ``plain`` (the plain version, same
    arguments) when the first tensor lies on the CPU and ``launch``
    otherwise."""

    plain = None

    def __call__(self, *args):
        if args[0].device.type == 'cpu':
            return type(self).plain(*args)
        return self.launch(*args)

    def blocks_per_sm(self, cfg: RasterConfig, ch: int) -> int:
        """Blocks of the kernel resident on one SM at once for ``cfg``'s
        tile height and ``ch`` channels (cudaOccupancyMaxActiveBlocksPer
        Multiprocessor, on the current device)."""
        return self._occupancy(cfg.tile_h, ch)


def _check_pixel_count(cfg: RasterConfig):
    if cfg.pix_per_tile % 32:
        raise ValueError(f'tile of {cfg.pix_per_tile} pixels is not a whole '
                         'number of warps')


class TileBlendForward(_BlendKernel):
    """Callable wrapper of the forward kernel."""

    name = 'tile_blend_fwd'
    replaces = 'sk_gs_tpu/render/tile_kernel.py:519'
    source = 'sk_gs_tpu_torch/csrc/tile_blend_fwd.cu'
    n_pointers = 7
    n_ints = 4
    plain = staticmethod(blend_forward_plain)

    def launch(self, geo, col, sort_gauss, tile_start, tile_count,
               cfg: RasterConfig) -> Tuple[torch.Tensor, torch.Tensor]:
        """geo [R, 6] (x, y, a, b, c, opacity) and col [R, ch] in depth-rank
        order, last row a zero dummy; sort_gauss int32 row ids; tile_start /
        tile_count [T] int32. Returns tile_color [T, P, ch], tile_alpha
        [T, P]."""
        dev = geo.device
        if dev.type != 'cuda':
            raise ValueError(f'{self.name} launches on CUDA tensors, got {dev}')
        _check_blend_inputs(geo, col, sort_gauss, tile_start, tile_count, cfg)
        _check_pixel_count(cfg)
        T, P, ch = cfg.num_tiles, cfg.pix_per_tile, col.shape[1]
        color = torch.empty((T, P, ch), dtype=torch.float32, device=dev)
        alpha = torch.empty((T, P), dtype=torch.float32, device=dev)
        self._run(dev, (geo, col, sort_gauss, tile_start, tile_count, color,
                        alpha), (T, cfg.grid_w, cfg.tile_h, ch))
        return color, alpha


class _RowsKernel(_BlendKernel):
    """A backward kernel: it adds the gradient rows [R, 6 + ch] of the
    depth-ordered rows by atomics into ``g_rows``, which the wrapper zeroes
    (so the sums vary at rounding level from run to run)."""

    def _g_rows(self, dev, geo, col, cfg: RasterConfig):
        _check_pixel_count(cfg)
        return torch.zeros((geo.shape[0], 6 + col.shape[1]),
                           dtype=torch.float32, device=dev)


class TileBlendBackward(_RowsKernel):
    """Callable wrapper of the backward kernel."""

    name = 'tile_blend_bwd'
    replaces = 'sk_gs_tpu/render/tile_kernel.py:570'
    source = 'sk_gs_tpu_torch/csrc/tile_blend_bwd.cu'
    n_pointers = 10
    n_ints = 4
    plain = staticmethod(blend_backward_rows_plain)

    def launch(self, geo, col, sort_gauss, tile_start, tile_count,
               tile_color, tile_alpha, g_color, g_alpha,
               cfg: RasterConfig) -> torch.Tensor:
        """The blend inputs as for the forward, its outputs tile_color
        [T, P, ch] and tile_alpha [T, P], and their cotangents. Returns the
        gradient rows g_rows [R, 6 + ch] of geo and col (see
        ``blend.blend_backward_rows_plain``)."""
        dev = geo.device
        if dev.type != 'cuda':
            raise ValueError(f'{self.name} launches on CUDA tensors, got {dev}')
        _check_blend_inputs(geo, col, sort_gauss, tile_start, tile_count, cfg)
        T, P, ch = cfg.num_tiles, cfg.pix_per_tile, col.shape[1]
        _check_pixel_grads(dev, tile_color, tile_alpha, g_color, g_alpha,
                           (T, P, ch))
        g_rows = self._g_rows(dev, geo, col, cfg)
        self._run(dev, (geo, col, sort_gauss, tile_start, tile_count,
                        tile_color, tile_alpha, g_color, g_alpha, g_rows),
                  (T, cfg.grid_w, cfg.tile_h, ch))
        return g_rows


def _check_chunk_inputs(dev, cfg: RasterConfig, **fields):
    """The chunk metadata: contiguous int32 [num_chunks(cfg)] on ``dev``."""
    nc = num_chunks(cfg)
    _check(dev, **{k: (v, torch.int32) for k, v in fields.items()})
    for name, t in fields.items():
        if tuple(t.shape) != (nc,):
            raise ValueError(f'{name} must be [{nc}], got {list(t.shape)}')


def _check_chunk_call(name, geo, col, sort_gauss, chunk_fields,
                      cfg: RasterConfig):
    """A chunk-schedule kernel's rows, entries and chunk metadata."""
    dev = geo.device
    if dev.type != 'cuda':
        raise ValueError(f'{name} launches on CUDA tensors, got {dev}')
    _check_rows(geo, col, sort_gauss, cfg)
    chunk_tile, chunk_start_flag, chunk_src, chunk_valid = chunk_fields
    _check_chunk_inputs(dev, cfg, chunk_tile=chunk_tile,
                        chunk_start_flag=chunk_start_flag,
                        chunk_src=chunk_src, chunk_valid=chunk_valid)
    if sort_gauss.shape[0] < cfg.pair_capacity + cfg.chunk:
        raise ValueError('sort_gauss must hold pair_capacity + chunk '
                         'entries')


class ChunkBlendForward(_BlendKernel):
    """Callable wrapper of the chunk schedule's forward kernel: one block
    per tile walks its chunks in order."""

    name = 'chunk_blend_fwd'
    replaces = 'sk_gs_tpu/render/tile_kernel.py:327'
    source = 'sk_gs_tpu_torch/csrc/chunk_blend_fwd.cu'
    n_pointers = 9
    n_ints = 5
    plain = staticmethod(chunk_blend_forward_plain)

    def launch(self, geo, col, sort_gauss, chunk_tile, chunk_start_flag,
               chunk_src, chunk_valid, cfg: RasterConfig
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """geo, col and sort_gauss as for ``TileBlendForward``, and the
        binning's chunk metadata. Returns tile_color [T, P, ch] and
        tile_alpha [T, P]."""
        fields = (chunk_tile, chunk_start_flag, chunk_src, chunk_valid)
        _check_chunk_call(self.name, geo, col, sort_gauss, fields, cfg)
        _check_pixel_count(cfg)
        dev = geo.device
        T, P, ch = cfg.num_tiles, cfg.pix_per_tile, col.shape[1]
        color = torch.empty((T, P, ch), dtype=torch.float32, device=dev)
        alpha = torch.empty((T, P), dtype=torch.float32, device=dev)
        self._run(dev, (geo, col, sort_gauss, *fields, color, alpha),
                  (T, num_chunks(cfg), cfg.grid_w, cfg.tile_h, ch))
        return color, alpha


class ChunkBlendBackward(_RowsKernel):
    """Callable wrapper of the chunk schedule's backward kernel: one block
    per tile walks its chunks in order."""

    name = 'chunk_blend_bwd'
    replaces = 'sk_gs_tpu/render/tile_kernel.py:382'
    source = 'sk_gs_tpu_torch/csrc/chunk_blend_bwd.cu'
    n_pointers = 12
    n_ints = 5
    plain = staticmethod(chunk_blend_backward_rows_plain)

    def launch(self, geo, col, sort_gauss, chunk_tile, chunk_start_flag,
               chunk_src, chunk_valid, tile_color, tile_alpha, g_color,
               g_alpha, cfg: RasterConfig) -> torch.Tensor:
        """The forward's inputs, its outputs and their cotangents. Returns
        the gradient rows g_rows [R, 6 + ch] of geo and col (see
        ``blend.chunk_blend_backward_rows_plain``)."""
        fields = (chunk_tile, chunk_start_flag, chunk_src, chunk_valid)
        _check_chunk_call(self.name, geo, col, sort_gauss, fields, cfg)
        dev = geo.device
        T, P, ch = cfg.num_tiles, cfg.pix_per_tile, col.shape[1]
        _check_pixel_grads(dev, tile_color, tile_alpha, g_color, g_alpha,
                           (T, P, ch))
        g_rows = self._g_rows(dev, geo, col, cfg)
        self._run(dev, (geo, col, sort_gauss, *fields, tile_color,
                        tile_alpha, g_color, g_alpha, g_rows),
                  (T, num_chunks(cfg), cfg.grid_w, cfg.tile_h, ch))
        return g_rows


tile_blend_fwd = TileBlendForward()
tile_blend_bwd = TileBlendBackward()
chunk_blend_fwd = ChunkBlendForward()
chunk_blend_bwd = ChunkBlendBackward()
KERNELS = (tile_blend_fwd, tile_blend_bwd, chunk_blend_fwd, chunk_blend_bwd)


def _blend_function(name: str, fwd_kernel, bwd_kernel, doc: str):
    """The ``torch.autograd.Function`` of a blend schedule (the JAX
    package's ``_blend_custom`` custom VJP), applied as
    ``.apply(geo, col, sort_gauss, *schedule_metadata, cfg)``: forward
    through ``fwd_kernel``, backward through ``bwd_kernel`` (the wrappers:
    the kernels on CUDA tensors, the plain versions on CPU ones; with
    ``cfg.use_kernel`` off, the plain versions on every device), whose
    gradient rows [R, 6 + ch] split into those of ``geo`` and ``col``."""

    def forward(ctx, geo, col, *args):
        *meta, cfg = args
        fwd = fwd_kernel if cfg.use_kernel else fwd_kernel.plain
        color, alpha = fwd(geo, col, *meta, cfg)
        ctx.cfg = cfg
        ctx.save_for_backward(geo, col, *meta, color, alpha)
        return color, alpha

    def backward(ctx, g_color, g_alpha):
        geo, col, *meta, color, alpha = ctx.saved_tensors
        cfg = ctx.cfg
        bwd = bwd_kernel if cfg.use_kernel else bwd_kernel.plain
        g_rows = bwd(geo, col, *meta, color, alpha, g_color.contiguous(),
                     g_alpha.contiguous(), cfg)
        return (g_rows[:, :6], g_rows[:, 6:]) + (None,) * (len(meta) + 1)

    return type(name, (torch.autograd.Function,),
                {'__doc__': doc, 'forward': staticmethod(forward),
                 'backward': staticmethod(backward)})


TileBlend = _blend_function(
    'TileBlend', tile_blend_fwd, tile_blend_bwd,
    """(tile_color, tile_alpha) of the depth-ordered rows ``geo``/``col``,
    differentiable in both: ``.apply(geo, col, sort_gauss, tile_start,
    tile_count, cfg)``, through kernels #1 and #2.""")
ChunkBlend = _blend_function(
    'ChunkBlend', chunk_blend_fwd, chunk_blend_bwd,
    """``TileBlend`` on the chunk schedule: ``.apply(geo, col, sort_gauss,
    chunk_tile, chunk_start_flag, chunk_src, chunk_valid, cfg)``, through
    kernels #3 and #4.""")
