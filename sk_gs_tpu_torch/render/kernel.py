"""What every wrapper of a hand-written CUDA kernel of the render shares:
the library, the C entry point, the launch count and the input checks.

A wrapper's ``launch`` runs its kernel on CUDA tensors, or raises; it
never falls back to the plain version.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from ..cuda_build import CudaLibrary, build_all


def _check(dev: torch.device, **tensors):
    """Each (tensor, dtype) must be contiguous, of that dtype, on ``dev``."""
    for name, (t, dtype) in tensors.items():
        if t.device != dev or t.dtype != dtype or not t.is_contiguous():
            raise ValueError(f'{name}: need a contiguous {dtype} tensor on '
                             f'{dev}, got {t.dtype} on {t.device}')


class _Kernel:
    """A kernel's library, its C entry point and its launch count. Its
    library also exports ``<name>_occupancy``. The C entry point takes
    ``n_pointers`` pointers (None passes a null one), ``n_ints`` ints,
    ``n_floats`` floats and the stream. ``builds_with`` names sources
    (``csrc/``) whose libraries the first load builds in parallel with this
    one."""

    name = ''
    route = 'cuda'
    replaces = ''
    source = ''
    n_pointers = 0
    n_ints = 0
    n_floats = 0
    builds_with = ()

    def __init__(self):
        self.library = CudaLibrary(Path(self.source).name)
        self.launches = 0
        self._fn = None

    def _load(self):
        if self._fn is None:
            if self.builds_with:
                build_all([self.library]
                          + [CudaLibrary(s) for s in self.builds_with])
            lib = self.library.load()
            fn = getattr(lib, self.name)
            fn.argtypes = ([ctypes.c_void_p] * self.n_pointers
                           + [ctypes.c_int] * self.n_ints
                           + [ctypes.c_float] * self.n_floats
                           + [ctypes.c_void_p])
            fn.restype = ctypes.c_int
            err = getattr(lib, self.name + '_error_string')
            err.argtypes = [ctypes.c_int]
            err.restype = ctypes.c_char_p
            self._err = err
            self._fn = fn
        return self._fn

    def _run(self, dev: torch.device, tensors, ints, floats=()):
        if dev.type != 'cuda':
            raise ValueError(f'{self.name} launches on CUDA tensors, got {dev}')
        fn = self._load()
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = fn(*(None if t is None else t.data_ptr() for t in tensors),
                     *ints, *floats, stream)
        if err != 0:
            raise RuntimeError(f'{self.name} launch failed: '
                               f'{self._err(err).decode()} ({err})')
        self.launches += 1

    def _occupancy(self, *ints) -> int:
        """Blocks of the kernel resident on one SM at once
        (cudaOccupancyMaxActiveBlocksPerMultiprocessor, on the current
        device), ``<name>_occupancy`` asked with ``ints``."""
        self._load()                     # the library and its error strings
        fn = getattr(self.library.load(), self.name + '_occupancy')
        fn.argtypes = [ctypes.c_int] * len(ints) + [ctypes.POINTER(ctypes.c_int)]
        fn.restype = ctypes.c_int
        blocks = ctypes.c_int(0)
        err = fn(*ints, ctypes.byref(blocks))
        if err != 0:
            raise RuntimeError(f'{self.name} occupancy query failed: '
                               f'{self._err(err).decode()} ({err})')
        return blocks.value
