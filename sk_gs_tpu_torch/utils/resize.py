"""Pillow's bilinear ``Image.resize`` on uint8 [H, W, C] arrays, from numpy
(the card's machine has no Pillow; the JAX package's loaders resize
through it, ``sk_gs_tpu/data/dnerf.py:23-31`` and ``zju.py:160-165``).

The arithmetic is Pillow's (``libImaging/Resample.c``): a separable
triangle filter whose support widens with the scale at a downscale (so
it antialiases), its coefficients computed in double, normalised to sum
1 and rounded to fixed point with 22 fractional bits, the horizontal pass
first, each pass rounded and clipped to uint8. An RGBA image goes through
premultiplied alpha (``RGBa``), as ``Image.resize`` converts it, and back;
grey + alpha through ``La`` the same way.
"""
from __future__ import annotations

import math
from typing import Tuple

import numpy as np

PRECISION_BITS = 32 - 8 - 2


def _coeffs(in_size: int, out_size: int) -> Tuple[np.ndarray, np.ndarray]:
    """(first input index [out], fixed-point weights [out, taps]) of one
    pass (``precompute_coeffs`` and ``normalize_coeffs_8bpc``)."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 1.0 * filterscale
    taps = int(math.ceil(support)) * 2 + 1
    first = np.zeros(out_size, np.int64)
    kk = np.zeros((out_size, taps), np.float64)
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size) - xmin
        x = np.arange(xmax)
        k = np.maximum(1.0 - np.abs((x + xmin - center + 0.5)
                                    * (1.0 / filterscale)), 0.0)
        total = k.sum()
        if total != 0.0:
            k = k / total
        first[xx] = xmin
        kk[xx, :xmax] = k
    fixed = np.where(kk < 0, np.trunc(-0.5 + kk * (1 << PRECISION_BITS)),
                     np.trunc(0.5 + kk * (1 << PRECISION_BITS)))
    return first, fixed.astype(np.int32)


def _pass(img: np.ndarray, out_size: int, axis: int) -> np.ndarray:
    """One pass along ``axis`` of uint8 ``img``, rounded and clipped."""
    first, k = _coeffs(img.shape[axis], out_size)
    # the sums fit int32, as Pillow keeps them: 255 x 2^22 x (1 + rounding)
    src = np.moveaxis(img, axis, 0).astype(np.int32)
    acc = np.full((out_size,) + src.shape[1:], 1 << (PRECISION_BITS - 1),
                  np.int32)
    last = src.shape[0] - 1
    extra = (1,) * (src.ndim - 1)
    for j in range(k.shape[1]):
        # taps past a row's span carry weight 0: clamp their index
        idx = np.minimum(first + j, last)
        acc += src[idx] * k[:, j].reshape((-1,) + extra)
    out = np.clip(acc >> PRECISION_BITS, 0, 255).astype(np.uint8)
    return np.moveaxis(out, 0, axis)


def _premultiply(img: np.ndarray) -> np.ndarray:
    """RGBA -> RGBa (``rgbA2rgba``): colour x alpha / 255, rounded."""
    out = img.copy()
    tmp = img[..., :-1].astype(np.int32) * img[..., -1:] + 128
    out[..., :-1] = ((tmp >> 8) + tmp) >> 8
    return out


def _unpremultiply(img: np.ndarray) -> np.ndarray:
    """RGBa -> RGBA (``rgba2rgbA``): colour x 255 / alpha, truncated and
    clipped; kept where alpha is 0 or 255."""
    out = img.copy()
    alpha = img[..., -1:].astype(np.int32)
    keep = (alpha == 0) | (alpha == 255)
    div = (255 * img[..., :-1].astype(np.int32)) // np.maximum(alpha, 1)
    out[..., :-1] = np.where(keep, img[..., :-1], np.minimum(div, 255))
    return out


def resize(img: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """``Image.fromarray(img).resize(size, Image.BILINEAR)`` as an array:
    ``img`` uint8 [H, W] or [H, W, C] (C = 1, 2, 3 or 4: L, LA, RGB,
    RGBA), ``size`` = (W, H) out."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise ValueError(f'resize takes uint8 images, got {img.dtype}')
    w, h = size
    if (img.shape[1], img.shape[0]) == (w, h):
        return img.copy()
    alpha = img.ndim == 3 and img.shape[2] in (2, 4)
    out = _premultiply(img) if alpha else img
    if w != img.shape[1]:
        out = _pass(out, w, 1)
    if h != img.shape[0]:
        out = _pass(out, h, 0)
    return _unpremultiply(out) if alpha else out
