"""Forward tile blend: the wrapper of the CUDA kernel ``csrc/tile_blend_fwd.cu``
(the port of ``sk_gs_tpu/render/tile_kernel.py:_fwd_kernel_tile``).

On CUDA tensors the wrapper launches the kernel, or raises; on CPU tensors
it runs the plain version ``blend.blend_forward_plain``. It never falls
back from one to the other.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from ..cuda_build import CudaLibrary
from .blend import blend_forward_plain
from .settings import RasterConfig


class TileBlendForward:
    """Callable wrapper; ``launches`` counts kernel launches."""

    name = 'tile_blend_fwd'
    route = 'cuda'
    replaces = 'sk_gs_tpu/render/tile_kernel.py:519'
    source = 'sk_gs_tpu_torch/csrc/tile_blend_fwd.cu'

    def __init__(self):
        self.library = CudaLibrary('tile_blend_fwd.cu')
        self.launches = 0
        self._fn = None

    def _load(self):
        if self._fn is None:
            lib = self.library.load()
            fn = lib.tile_blend_fwd
            fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
            lib.tile_blend_fwd_error_string.argtypes = [ctypes.c_int]
            lib.tile_blend_fwd_error_string.restype = ctypes.c_char_p
            self._err = lib.tile_blend_fwd_error_string
            self._fn = fn
        return self._fn

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
        T, P = cfg.num_tiles, cfg.pix_per_tile
        dev = geo.device
        if dev.type != 'cuda':
            raise ValueError(f'tile_blend_fwd launches on CUDA tensors, got {dev}')
        for name, t, dtype in (('geo', geo, torch.float32),
                               ('col', col, torch.float32),
                               ('sort_gauss', sort_gauss, torch.int32),
                               ('tile_start', tile_start, torch.int32),
                               ('tile_count', tile_count, torch.int32)):
            if t.device != dev or t.dtype != dtype or not t.is_contiguous():
                raise ValueError(f'{name}: need a contiguous {dtype} tensor on '
                                 f'{dev}, got {t.dtype} on {t.device}')
        if geo.dim() != 2 or geo.shape[1] != 6:
            raise ValueError(f'geo must be [R, 6], got {tuple(geo.shape)}')
        if col.dim() != 2 or col.shape[0] != geo.shape[0] or col.shape[1] < 1:
            raise ValueError(f'col must be [R, ch], got {tuple(col.shape)}')
        if sort_gauss.dim() != 1 or tile_start.shape != (T,) \
                or tile_count.shape != (T,):
            raise ValueError('sort_gauss must be 1-D and tile_start / '
                             f'tile_count [{T}]')
        if P > 1024:
            raise ValueError(f'tile of {P} pixels exceeds 1024 threads')
        ch = col.shape[1]
        color = torch.empty((T, P, ch), dtype=torch.float32, device=dev)
        alpha = torch.empty((T, P), dtype=torch.float32, device=dev)
        fn = self._load()
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = fn(geo.data_ptr(), col.data_ptr(), sort_gauss.data_ptr(),
                     tile_start.data_ptr(), tile_count.data_ptr(),
                     color.data_ptr(), alpha.data_ptr(), T, cfg.grid_w,
                     cfg.tile_h, ch, stream)
        if err != 0:
            raise RuntimeError(f'tile_blend_fwd launch failed: '
                               f'{self._err(err).decode()} ({err})')
        self.launches += 1
        return color, alpha


tile_blend_fwd = TileBlendForward()
KERNELS = (tile_blend_fwd,)
