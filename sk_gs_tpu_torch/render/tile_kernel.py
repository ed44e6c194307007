"""The blend's CUDA kernels, their wrappers, and the autograd functions
around them.

- ``tile_blend_fwd`` wraps ``csrc/tile_blend_fwd.cu``, the port of
  ``sk_gs_tpu/render/tile_kernel.py:_fwd_kernel_tile``;
- ``tile_blend_bwd`` wraps ``csrc/tile_blend_bwd.cu``, the port of
  ``_bwd_kernel_tile``: per-entry gradient rows;
- ``chunk_blend_fwd`` and ``chunk_blend_bwd`` wrap ``csrc/chunk_blend_fwd.cu``
  and ``csrc/chunk_blend_bwd.cu``, the ports of the ``chunk`` schedule's
  ``_fwd_kernel`` and ``_bwd_kernel``;
- ``TileBlend`` and ``ChunkBlend`` are the ``torch.autograd.Function`` of
  the blend on either schedule (the JAX package's ``_blend_custom`` custom
  VJP): forward through the forward kernel, backward through the backward
  kernel, then the per-entry rows summed onto the depth-ordered rows by
  ``sort_gauss`` (``_blend_bwd``'s segment sum).

On CUDA tensors a wrapper launches its kernel, or raises; on CPU tensors it
runs the plain version in ``blend.py``. It never falls back from one to the
other.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Tuple

import torch

from ..cuda_build import CudaLibrary
from .binning import num_chunks
from .blend import (blend_backward_plain, blend_forward_plain,
                    chunk_blend_backward_plain, chunk_blend_forward_plain,
                    chunk_waves)
from .settings import RasterConfig


def _check(dev: torch.device, **tensors):
    """Each (tensor, dtype) must be contiguous, of that dtype, on ``dev``."""
    for name, (t, dtype) in tensors.items():
        if t.device != dev or t.dtype != dtype or not t.is_contiguous():
            raise ValueError(f'{name}: need a contiguous {dtype} tensor on '
                             f'{dev}, got {t.dtype} on {t.device}')


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


class _Kernel:
    """A kernel's library, its C entry point and its launch count. Called,
    it runs ``plain`` (the plain version, same arguments) when the first
    tensor lies on the CPU and ``launch`` otherwise."""

    name = ''
    route = 'cuda'
    replaces = ''
    source = ''
    n_pointers = 0
    n_ints = 0
    plain = None

    def __call__(self, *args):
        if args[0].device.type == 'cpu':
            return type(self).plain(*args)
        return self.launch(*args)

    def __init__(self):
        self.library = CudaLibrary(Path(self.source).name)
        self.launches = 0
        self._fn = None

    def _load(self):
        if self._fn is None:
            lib = self.library.load()
            fn = getattr(lib, self.name)
            fn.argtypes = ([ctypes.c_void_p] * self.n_pointers
                           + [ctypes.c_int] * self.n_ints + [ctypes.c_void_p])
            fn.restype = ctypes.c_int
            err = getattr(lib, self.name + '_error_string')
            err.argtypes = [ctypes.c_int]
            err.restype = ctypes.c_char_p
            self._err = err
            self._fn = fn
        return self._fn

    def _run(self, dev: torch.device, tensors, ints):
        if dev.type != 'cuda':
            raise ValueError(f'{self.name} launches on CUDA tensors, got {dev}')
        fn = self._load()
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = fn(*(t.data_ptr() for t in tensors), *ints, stream)
        if err != 0:
            raise RuntimeError(f'{self.name} launch failed: '
                               f'{self._err(err).decode()} ({err})')
        self.launches += 1


class TileBlendForward(_Kernel):
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
        T, P, ch = cfg.num_tiles, cfg.pix_per_tile, col.shape[1]
        color = torch.empty((T, P, ch), dtype=torch.float32, device=dev)
        alpha = torch.empty((T, P), dtype=torch.float32, device=dev)
        self._run(dev, (geo, col, sort_gauss, tile_start, tile_count, color,
                        alpha), (T, cfg.grid_w, cfg.tile_h, ch))
        return color, alpha


class TileBlendBackward(_Kernel):
    """Callable wrapper of the backward kernel."""

    name = 'tile_blend_bwd'
    replaces = 'sk_gs_tpu/render/tile_kernel.py:570'
    source = 'sk_gs_tpu_torch/csrc/tile_blend_bwd.cu'
    n_pointers = 10
    n_ints = 4
    plain = staticmethod(blend_backward_plain)

    def launch(self, geo, col, sort_gauss, tile_start, tile_count,
               tile_color, tile_alpha, g_color, g_alpha,
               cfg: RasterConfig) -> torch.Tensor:
        """The blend inputs as for the forward, its outputs tile_color
        [T, P, ch] and tile_alpha [T, P], and their cotangents. Returns the
        per-entry gradient rows g_entry [len(sort_gauss), 6 + ch] (see
        ``blend.blend_backward_plain``)."""
        dev = geo.device
        if dev.type != 'cuda':
            raise ValueError(f'{self.name} launches on CUDA tensors, got {dev}')
        _check_blend_inputs(geo, col, sort_gauss, tile_start, tile_count, cfg)
        T, P, ch = cfg.num_tiles, cfg.pix_per_tile, col.shape[1]
        _check_pixel_grads(dev, tile_color, tile_alpha, g_color, g_alpha,
                           (T, P, ch))
        if P % 32:
            raise ValueError(f'tile of {P} pixels is not a whole number of '
                             'warps')
        g_entry = torch.zeros((sort_gauss.shape[0], 6 + ch),
                              dtype=torch.float32, device=dev)
        self._run(dev, (geo, col, sort_gauss, tile_start, tile_count,
                        tile_color, tile_alpha, g_color, g_alpha, g_entry),
                  (T, cfg.grid_w, cfg.tile_h, ch))
        return g_entry


def _check_chunk_inputs(dev, cfg: RasterConfig, **fields):
    """The chunk metadata: contiguous int32 [num_chunks(cfg)] on ``dev``."""
    nc = num_chunks(cfg)
    _check(dev, **{k: (v, torch.int32) for k, v in fields.items()})
    for name, t in fields.items():
        if tuple(t.shape) != (nc,):
            raise ValueError(f'{name} must be [{nc}], got {list(t.shape)}')


def ticket_order(chunk_start_flag: torch.Tensor):
    """(wave, order), int32 [num_chunks]: each chunk's place in its tile's
    list of chunks, and the chunks sorted by it (stable), the order in
    which the chunk kernels hand out their work tickets."""
    wave = chunk_waves(chunk_start_flag)
    order = torch.sort(wave, stable=True).indices
    return wave.to(torch.int32), order.to(torch.int32)


class _ChunkKernel(_Kernel):
    """A chunk-schedule kernel: its tickets, waits and per-tile progress
    counters ([2 + T] int32) of the last launch stay in ``counters``."""

    def __init__(self):
        super().__init__()
        self.counters = None

    def waits(self) -> int:
        """Chunks of the last launch that found their predecessor not yet
        published and had to wait (reading it synchronises)."""
        return int(self.counters[1]) if self.counters is not None else 0

    def _prepare(self, geo, col, sort_gauss, chunk_fields, cfg):
        dev = geo.device
        if dev.type != 'cuda':
            raise ValueError(f'{self.name} launches on CUDA tensors, got {dev}')
        _check_rows(geo, col, sort_gauss, cfg)
        chunk_tile, chunk_start_flag, chunk_src, chunk_valid = chunk_fields
        _check_chunk_inputs(dev, cfg, chunk_tile=chunk_tile,
                            chunk_start_flag=chunk_start_flag,
                            chunk_src=chunk_src, chunk_valid=chunk_valid)
        if sort_gauss.shape[0] < cfg.pair_capacity + cfg.chunk:
            raise ValueError('sort_gauss must hold pair_capacity + chunk '
                             'entries')
        if cfg.pix_per_tile % 32:
            raise ValueError(f'tile of {cfg.pix_per_tile} pixels is not a '
                             'whole number of warps')
        wave, order = ticket_order(chunk_start_flag)
        self.counters = torch.zeros(2 + cfg.num_tiles, dtype=torch.int32,
                                    device=dev)
        return (chunk_tile, chunk_src, chunk_valid, wave, order,
                self.counters)


class ChunkBlendForward(_ChunkKernel):
    """Callable wrapper of the chunk schedule's forward kernel."""

    name = 'chunk_blend_fwd'
    replaces = 'sk_gs_tpu/render/tile_kernel.py:327'
    source = 'sk_gs_tpu_torch/csrc/chunk_blend_fwd.cu'
    n_pointers = 13
    n_ints = 5
    plain = staticmethod(chunk_blend_forward_plain)

    def launch(self, geo, col, sort_gauss, chunk_tile, chunk_start_flag,
               chunk_src, chunk_valid, cfg: RasterConfig
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """geo, col and sort_gauss as for ``TileBlendForward``, and the
        binning's chunk metadata. Returns tile_color [T, P, ch] and
        tile_alpha [T, P]."""
        meta = self._prepare(geo, col, sort_gauss, (
            chunk_tile, chunk_start_flag, chunk_src, chunk_valid), cfg)
        dev = geo.device
        T, P, ch = cfg.num_tiles, cfg.pix_per_tile, col.shape[1]
        t_run = torch.ones((T, P), dtype=torch.float32, device=dev)
        done = torch.zeros((T, P), dtype=torch.int32, device=dev)
        color = torch.zeros((T, P, ch), dtype=torch.float32, device=dev)
        alpha = torch.zeros((T, P), dtype=torch.float32, device=dev)
        self._run(dev, (geo, col, sort_gauss, *meta, t_run, done, color,
                        alpha),
                  (num_chunks(cfg), cfg.chunk, cfg.grid_w, cfg.tile_h, ch))
        return color, alpha


class ChunkBlendBackward(_ChunkKernel):
    """Callable wrapper of the chunk schedule's backward kernel."""

    name = 'chunk_blend_bwd'
    replaces = 'sk_gs_tpu/render/tile_kernel.py:382'
    source = 'sk_gs_tpu_torch/csrc/chunk_blend_bwd.cu'
    n_pointers = 17
    n_ints = 5
    plain = staticmethod(chunk_blend_backward_plain)

    def launch(self, geo, col, sort_gauss, chunk_tile, chunk_start_flag,
               chunk_src, chunk_valid, tile_color, tile_alpha, g_color,
               g_alpha, cfg: RasterConfig) -> torch.Tensor:
        """The forward's inputs, its outputs and their cotangents. Returns
        the per-entry gradient rows g_entry [len(sort_gauss), 6 + ch]."""
        meta = self._prepare(geo, col, sort_gauss, (
            chunk_tile, chunk_start_flag, chunk_src, chunk_valid), cfg)
        dev = geo.device
        T, P, ch = cfg.num_tiles, cfg.pix_per_tile, col.shape[1]
        _check_pixel_grads(dev, tile_color, tile_alpha, g_color, g_alpha,
                           (T, P, ch))
        t_run = torch.ones((T, P), dtype=torch.float32, device=dev)
        s_run = torch.zeros((T, P), dtype=torch.float32, device=dev)
        done = torch.zeros((T, P), dtype=torch.int32, device=dev)
        g_entry = torch.zeros((sort_gauss.shape[0], 6 + ch),
                              dtype=torch.float32, device=dev)
        self._run(dev, (geo, col, sort_gauss, *meta[:5], tile_color,
                        tile_alpha, g_color, g_alpha, meta[5], t_run, s_run,
                        done, g_entry),
                  (num_chunks(cfg), cfg.chunk, cfg.grid_w, cfg.tile_h, ch))
        return g_entry


tile_blend_fwd = TileBlendForward()
tile_blend_bwd = TileBlendBackward()
chunk_blend_fwd = ChunkBlendForward()
chunk_blend_bwd = ChunkBlendBackward()
KERNELS = (tile_blend_fwd, tile_blend_bwd, chunk_blend_fwd, chunk_blend_bwd)


def rows_from_entries(g_entry: torch.Tensor, sort_gauss: torch.Tensor,
                      n_rows: int) -> torch.Tensor:
    """Sum the per-entry rows onto the ``n_rows`` depth-ordered rows they
    read (``_blend_bwd``'s segment sum; atomics on the card, so the
    summation order varies from run to run)."""
    out = torch.zeros((n_rows, g_entry.shape[1]), dtype=g_entry.dtype,
                      device=g_entry.device)
    return out.index_add_(0, sort_gauss.to(torch.int64), g_entry)


def _blend_function(name: str, fwd_kernel, bwd_kernel, doc: str):
    """The ``torch.autograd.Function`` of a blend schedule (the JAX
    package's ``_blend_custom`` custom VJP), applied as
    ``.apply(geo, col, sort_gauss, *schedule_metadata, cfg)``: forward
    through ``fwd_kernel``, backward through ``bwd_kernel`` (the wrappers:
    the kernels on CUDA tensors, the plain versions on CPU ones; with
    ``cfg.use_kernel`` off, the plain versions on every device), then the
    per-entry rows summed onto the depth-ordered rows by ``sort_gauss``."""

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
        g_entry = bwd(geo, col, *meta, color, alpha, g_color.contiguous(),
                      g_alpha.contiguous(), cfg)
        g_rows = rows_from_entries(g_entry, meta[0], geo.shape[0])
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
