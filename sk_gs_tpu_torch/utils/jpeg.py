"""Baseline JPEG files, decoded by the port's own host library
(``csrc/jpeg_decode.cpp``, built with ``c++`` at first use into
``build/torch_kernels/``; the card's machine has no Pillow and no libjpeg
binding).

``decode_jpeg`` gives what ``np.asarray(PIL.Image.open(f))`` gives on
libjpeg's defaults, byte for byte: [H, W, 3] uint8 RGB of a 3-component
file, [H, W] of a greyscale one. Baseline and extended sequential Huffman
files at 8 bits are read; progressive, arithmetic-coded, lossless,
hierarchical, 12-bit, CMYK / YCCK and 2- or 4-component files, and
truncated ones, raise a ``ValueError`` that names the file and the reason.
A file is decoded by one call into the library, which releases the
interpreter lock (``ctypes``), so a thread pool decodes many at once.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import numpy as np

from ..cuda_build import HostLibrary

SIGNATURE = b'\xff\xd8\xff'
LIBRARY = HostLibrary('jpeg_decode.cpp')
_ERR_LEN = 256


def _lib() -> ctypes.CDLL:
    lib = LIBRARY.load()
    if not getattr(lib, '_sk_typed', False):
        ptr, size, cint_p = ctypes.c_void_p, ctypes.c_size_t, \
            ctypes.POINTER(ctypes.c_int)
        lib.sk_jpeg_info.argtypes = [ptr, size, cint_p, cint_p, cint_p,
                                     ctypes.c_char_p, ctypes.c_int]
        lib.sk_jpeg_info.restype = ctypes.c_int
        lib.sk_jpeg_decode.argtypes = [ptr, size, ptr, size,
                                       ctypes.c_char_p, ctypes.c_int]
        lib.sk_jpeg_decode.restype = ctypes.c_int
        lib._sk_typed = True
    return lib


def decode_jpeg(data: bytes, name: str = '<bytes>') -> np.ndarray:
    """uint8 [H, W, 3] (or [H, W] greyscale) of the JPEG file ``data``;
    ``name`` is the file named by an error."""
    lib = _lib()
    src = np.frombuffer(data, np.uint8)
    err = ctypes.create_string_buffer(_ERR_LEN)
    h, w, c = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    if lib.sk_jpeg_info(src.ctypes.data, src.size, ctypes.byref(h),
                        ctypes.byref(w), ctypes.byref(c), err, _ERR_LEN):
        raise ValueError(f'{name}: {err.value.decode()}')
    shape = (h.value, w.value) if c.value == 1 else \
        (h.value, w.value, c.value)
    out = np.empty(shape, np.uint8)
    if lib.sk_jpeg_decode(src.ctypes.data, src.size, out.ctypes.data,
                          out.size, err, _ERR_LEN):
        raise ValueError(f'{name}: {err.value.decode()}')
    return out


def read_jpeg(path) -> np.ndarray:
    """``decode_jpeg`` of the file at ``path``."""
    return decode_jpeg(Path(path).read_bytes(), str(path))
