"""The tile blend's CUDA kernels, their wrappers, and the autograd function
around them.

- ``tile_blend_fwd`` wraps ``csrc/tile_blend_fwd.cu``, the port of
  ``sk_gs_tpu/render/tile_kernel.py:_fwd_kernel_tile``;
- ``tile_blend_bwd`` wraps ``csrc/tile_blend_bwd.cu``, the port of
  ``_bwd_kernel_tile``: per-entry gradient rows;
- ``TileBlend`` is the ``torch.autograd.Function`` of the blend (the JAX
  package's ``_blend_custom`` custom VJP): forward through the first,
  backward through the second, then the per-entry rows summed onto the
  depth-ordered rows by ``sort_gauss`` (``_blend_bwd``'s segment sum).

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
from .blend import blend_backward_plain, blend_forward_plain
from .settings import RasterConfig


def _check(dev: torch.device, **tensors):
    """Each (tensor, dtype) must be contiguous, of that dtype, on ``dev``."""
    for name, (t, dtype) in tensors.items():
        if t.device != dev or t.dtype != dtype or not t.is_contiguous():
            raise ValueError(f'{name}: need a contiguous {dtype} tensor on '
                             f'{dev}, got {t.dtype} on {t.device}')


def _check_blend_inputs(geo, col, sort_gauss, tile_start, tile_count,
                        cfg: RasterConfig):
    T = cfg.num_tiles
    _check(geo.device, geo=(geo, torch.float32), col=(col, torch.float32),
           sort_gauss=(sort_gauss, torch.int32),
           tile_start=(tile_start, torch.int32),
           tile_count=(tile_count, torch.int32))
    if geo.dim() != 2 or geo.shape[1] != 6:
        raise ValueError(f'geo must be [R, 6], got {tuple(geo.shape)}')
    if col.dim() != 2 or col.shape[0] != geo.shape[0] or col.shape[1] < 1:
        raise ValueError(f'col must be [R, ch], got {tuple(col.shape)}')
    if sort_gauss.dim() != 1 or tile_start.shape != (T,) \
            or tile_count.shape != (T,):
        raise ValueError('sort_gauss must be 1-D and tile_start / '
                         f'tile_count [{T}]')
    if cfg.pix_per_tile > 1024:
        raise ValueError(f'tile of {cfg.pix_per_tile} pixels exceeds 1024 '
                         'threads')


class _Kernel:
    """A kernel's library, its C entry point and its launch count."""

    name = ''
    route = 'cuda'
    replaces = ''
    source = ''
    n_pointers = 0
    n_ints = 0

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

    def __call__(self, geo: torch.Tensor, col: torch.Tensor,
                 sort_gauss: torch.Tensor, tile_start: torch.Tensor,
                 tile_count: torch.Tensor, cfg: RasterConfig
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        """geo [R, 6] (x, y, a, b, c, opacity) and col [R, ch] in depth-rank
        order, last row a zero dummy; sort_gauss int32 row ids; tile_start /
        tile_count [T] int32. Returns tile_color [T, P, ch], tile_alpha [T, P].
        """
        if geo.device.type == 'cpu':
            return blend_forward_plain(geo, col, sort_gauss, tile_start,
                                       tile_count, cfg)
        return self.launch(geo, col, sort_gauss, tile_start, tile_count, cfg)

    def launch(self, geo, col, sort_gauss, tile_start, tile_count,
               cfg: RasterConfig) -> Tuple[torch.Tensor, torch.Tensor]:
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

    def __call__(self, geo, col, sort_gauss, tile_start, tile_count,
                 tile_color, tile_alpha, g_color, g_alpha,
                 cfg: RasterConfig) -> torch.Tensor:
        """The blend inputs as for the forward, its outputs tile_color
        [T, P, ch] and tile_alpha [T, P], and their cotangents. Returns the
        per-entry gradient rows g_entry [len(sort_gauss), 6 + ch] (see
        ``blend.blend_backward_plain``)."""
        if geo.device.type == 'cpu':
            return blend_backward_plain(geo, col, sort_gauss, tile_start,
                                        tile_count, tile_color, tile_alpha,
                                        g_color, g_alpha, cfg)
        return self.launch(geo, col, sort_gauss, tile_start, tile_count,
                           tile_color, tile_alpha, g_color, g_alpha, cfg)

    def launch(self, geo, col, sort_gauss, tile_start, tile_count,
               tile_color, tile_alpha, g_color, g_alpha,
               cfg: RasterConfig) -> torch.Tensor:
        dev = geo.device
        if dev.type != 'cuda':
            raise ValueError(f'{self.name} launches on CUDA tensors, got {dev}')
        _check_blend_inputs(geo, col, sort_gauss, tile_start, tile_count, cfg)
        T, P, ch = cfg.num_tiles, cfg.pix_per_tile, col.shape[1]
        f32 = torch.float32
        _check(dev, tile_color=(tile_color, f32), tile_alpha=(tile_alpha, f32),
               g_color=(g_color, f32), g_alpha=(g_alpha, f32))
        for name, t, shape in (('tile_color', tile_color, (T, P, ch)),
                               ('tile_alpha', tile_alpha, (T, P)),
                               ('g_color', g_color, (T, P, ch)),
                               ('g_alpha', g_alpha, (T, P))):
            if tuple(t.shape) != shape:
                raise ValueError(f'{name} must be {list(shape)}, got '
                                 f'{list(t.shape)}')
        if P % 32:
            raise ValueError(f'tile of {P} pixels is not a whole number of '
                             'warps')
        g_entry = torch.zeros((sort_gauss.shape[0], 6 + ch), dtype=f32,
                              device=dev)
        self._run(dev, (geo, col, sort_gauss, tile_start, tile_count,
                        tile_color, tile_alpha, g_color, g_alpha, g_entry),
                  (T, cfg.grid_w, cfg.tile_h, ch))
        return g_entry


tile_blend_fwd = TileBlendForward()
tile_blend_bwd = TileBlendBackward()
KERNELS = (tile_blend_fwd, tile_blend_bwd)


def rows_from_entries(g_entry: torch.Tensor, sort_gauss: torch.Tensor,
                      n_rows: int) -> torch.Tensor:
    """Sum the per-entry rows onto the ``n_rows`` depth-ordered rows they
    read (``_blend_bwd``'s segment sum; atomics on the card, so the
    summation order varies from run to run)."""
    out = torch.zeros((n_rows, g_entry.shape[1]), dtype=g_entry.dtype,
                      device=g_entry.device)
    return out.index_add_(0, sort_gauss.to(torch.int64), g_entry)


class TileBlend(torch.autograd.Function):
    """(tile_color, tile_alpha) of the depth-ordered rows ``geo``/``col``,
    differentiable in both. ``cfg.use_kernel`` picks the wrappers above (the
    kernels on CUDA tensors, the plain versions on CPU ones); with it off,
    the plain forward and backward run on every device."""

    @staticmethod
    def forward(ctx, geo, col, sort_gauss, tile_start, tile_count,
                cfg: RasterConfig):
        fwd = tile_blend_fwd if cfg.use_kernel else blend_forward_plain
        color, alpha = fwd(geo, col, sort_gauss, tile_start, tile_count, cfg)
        ctx.cfg = cfg
        ctx.save_for_backward(geo, col, sort_gauss, tile_start, tile_count,
                              color, alpha)
        return color, alpha

    @staticmethod
    def backward(ctx, g_color, g_alpha):
        geo, col, sort_gauss, tile_start, tile_count, color, alpha = \
            ctx.saved_tensors
        cfg = ctx.cfg
        bwd = tile_blend_bwd if cfg.use_kernel else blend_backward_plain
        g_entry = bwd(geo, col, sort_gauss, tile_start, tile_count, color,
                      alpha, g_color.contiguous(), g_alpha.contiguous(), cfg)
        g_rows = rows_from_entries(g_entry, sort_gauss, geo.shape[0])
        return g_rows[:, :6], g_rows[:, 6:], None, None, None, None
