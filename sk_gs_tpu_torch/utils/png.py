"""8-bit PNG files with the standard library only (``zlib`` and
``struct``; the card's machine has no Pillow), and the image readers that
pick a file's decoder by its first bytes.

``encode_png`` gives the bytes of an [H, W, 3] or [H, W, 4] uint8 array
(or floats in [0, 1], clipped and scaled by 255 as the JAX package's
frames are) as a PNG file, non-interlaced, each row with the filter that
minimises the sum of its bytes taken as signed, the heuristic of libpng
and Pillow; ``write_png`` writes them. ``read_png`` and ``read_pngs`` read
8-bit greyscale, grey + alpha, RGB and RGBA PNG files, non-interlaced,
with any of the five row filters, every chunk's CRC checked (palette,
16-bit and interlaced files raise), and baseline JPEG files through
``utils/jpeg.py``; any other file raises.

Sub, Average and Paeth predict a byte from its left neighbour, so a row
cannot be undone in one vector step. ``read_png`` undoes the filters on
anti-diagonals instead: a pixel (y, x) depends on (y, x - 1), (y - 1, x)
and (y - 1, x - 1), all on the two diagonals before x + y, so every pixel
of one diagonal is decoded at once, H + W - 1 numpy steps a frame whatever
the mix of filters.
"""
from __future__ import annotations

import os
import struct
import zlib
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import List, Sequence, Tuple

import numpy as np

from .jpeg import SIGNATURE as JPEG_SIGNATURE
from .jpeg import decode_jpeg

SIGNATURE = b'\x89PNG\r\n\x1a\n'
_CHANNELS = {0: 1, 4: 2, 2: 3, 6: 4}      # colour type -> channels
_COLOUR_TYPE = {c: t for t, c in _CHANNELS.items()}


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack('>I', len(data)) + kind + data
            + struct.pack('>I', zlib.crc32(kind + data) & 0xFFFFFFFF))


def to_uint8(img) -> np.ndarray:
    """Floats in [0, 1] -> uint8 by clip and truncation (x 255)."""
    img = np.asarray(img)
    if img.dtype == np.uint8:
        return img
    return (np.clip(img, 0.0, 1.0) * 255).astype(np.uint8)


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _filtered_rows(x: np.ndarray, c: int) -> np.ndarray:
    """[5, H, W c] int16: the rows of ``x`` [H, W c] under each filter."""
    x = x.astype(np.int16)
    zero_col = np.zeros((x.shape[0], c), np.int16)
    a = np.concatenate([zero_col, x[:, :-c]], axis=1)
    b = np.concatenate([np.zeros_like(x[:1]), x[:-1]], axis=0)
    up_left = np.concatenate([np.zeros_like(a[:1]), a[:-1]], axis=0)
    preds = (0, a, b, (a + b) >> 1, _paeth(a, b, up_left))
    return np.stack([(x - p) & 0xFF for p in preds])


def encode_png(img) -> bytes:
    """The PNG file of ``img`` [H, W, 3|4] (uint8, or floats in [0, 1])."""
    img = to_uint8(img)
    if img.ndim != 3 or img.shape[2] not in (3, 4):
        raise ValueError(f'need [H, W, 3|4], got {img.shape}')
    h, w, c = img.shape
    cand = _filtered_rows(np.ascontiguousarray(img).reshape(h, w * c), c)
    # the sum of each row's bytes taken as signed (libpng's heuristic)
    cost = np.abs(cand.astype(np.uint8).view(np.int8).astype(np.int32)) \
        .sum(axis=2)
    best = np.argmin(cost, axis=0)
    rows = np.concatenate([best[:, None].astype(np.uint8),
                           cand[best, np.arange(h)].astype(np.uint8)], axis=1)
    ihdr = struct.pack('>IIBBBBB', w, h, 8, _COLOUR_TYPE[c], 0, 0, 0)
    return (SIGNATURE + _chunk(b'IHDR', ihdr)
            + _chunk(b'IDAT', zlib.compress(rows.tobytes(), 6))
            + _chunk(b'IEND', b''))


def write_png(path, img) -> Path:
    path = Path(path)
    path.write_bytes(encode_png(img))
    return path


def _skewed(buf: np.ndarray, h: int, n_diag: int) -> np.ndarray:
    """The view ``v`` of ``buf`` [h + 1, 2 h + W + 1, c] with ``v[d + 2, y +
    1]`` = ``buf[y + 1, h + 1 + d - y]``: pixel (y, d - y) of the image held
    at ``buf[1:, h + 1:]``."""
    s_row, s_pix, s_ch = buf.strides
    return np.lib.stride_tricks.as_strided(
        buf[:, h:], shape=(n_diag + 2, h + 1, buf.shape[2]),
        strides=(s_pix, s_row - s_pix, s_ch))


def _unfilter(raw: np.ndarray, filters: np.ndarray) -> np.ndarray:
    """[H, W, F c] uint8 of F images' filtered rows ``raw`` [H, W, F c],
    side by side in the channels, under their row filters ``filters`` [H,
    F c] (each image's row filter repeated over its c channels), decoded
    one anti-diagonal at a time: several images a pass share the numpy
    calls, which cost more than their arithmetic on rows this short.

    The images sit in a buffer with a zero row above them and h + 1 zero
    columns to their left, which is what the filters read beyond the
    edges. In its skewed view diagonal d is one slab, ``[d + 2, y + 1]`` =
    pixel (y, d - y): the left neighbour of the slab's rows is ``[d + 1, y
    + 1]``, the one above ``[d + 1, y]`` and the one up and to the left
    ``[d, y]``."""
    h, w, c = raw.shape
    n_diag = h + w - 1
    buf = np.zeros((h + 1, 2 * h + w + 1, c), np.int16)
    buf[1:, h + 1:h + 1 + w] = raw
    # the slabs contiguous: numpy runs the loop's short ops ~2x faster so
    todo = np.ascontiguousarray(_skewed(buf, h, n_diag))
    out = np.zeros_like(todo)
    # one 0/1 mask a filter: numpy's where and choose cost several times a
    # multiply on these short rows
    f = np.zeros((h + 1, c), np.int16)
    f[1:] = filters
    m = {k: (f == k).astype(np.int16) for k in (1, 2, 3, 4)
         if (filters == k).any()}
    for d in range(n_diag):
        lo, hi = max(0, d - w + 1) + 1, min(h - 1, d) + 2
        a = out[d + 1, lo:hi]
        b = out[d + 1, lo - 1:hi - 1]
        pred = todo[d + 2, lo:hi]
        if 1 in m:
            pred = pred + m[1][lo:hi] * a
        if 2 in m:
            pred = pred + m[2][lo:hi] * b
        if 3 in m:
            pred = pred + m[3][lo:hi] * ((a + b) >> 1)
        if 4 in m:
            # Paeth: a, b or c, whichever is nearest to a + b - c
            c_ = out[d, lo - 1:hi - 1]
            ac, bc = a - c_, b - c_
            pa, pb, pc = np.abs(bc), np.abs(ac), np.abs(ac + bc)
            take_a = pa <= np.minimum(pb, pc)
            take_b = (pb <= pc) > take_a
            pred = pred + m[4][lo:hi] * (c_ + take_a * ac + take_b * bc)
        out[d + 2, lo:hi] = pred & 0xFF
    _skewed(buf, h, n_diag)[...] = out
    return buf[1:, h + 1:h + 1 + w].astype(np.uint8)


def _filtered(data: bytes, path) -> Tuple[np.ndarray, np.ndarray]:
    """(filtered bytes [H, W, C] uint8, row filters [H]) of the 8-bit
    non-interlaced PNG file ``data`` read from ``path``, every chunk's CRC
    checked."""
    if data[:8] != SIGNATURE:
        raise ValueError(f'{path}: neither a PNG nor a JPEG file')
    pos, idat, head = 8, [], None
    while pos < len(data):
        n, = struct.unpack('>I', data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + n]
        crc, = struct.unpack('>I', data[pos + 8 + n:pos + 12 + n])
        if zlib.crc32(kind + body) & 0xFFFFFFFF != crc:
            raise ValueError(f'{path}: bad CRC in chunk {kind!r}')
        if kind == b'IHDR':
            head = struct.unpack('>IIBBBBB', body)
        elif kind == b'IDAT':
            idat.append(body)
        elif kind == b'IEND':
            break
        pos += 12 + n
    w, h, depth, ctype, _, _, interlace = head
    if depth != 8 or ctype not in _CHANNELS or interlace:
        raise ValueError(f'{path}: unsupported PNG (depth {depth}, colour '
                         f'type {ctype}, interlace {interlace}); 8-bit '
                         'grey, grey + alpha, RGB and RGBA, non-interlaced, '
                         'are read')
    c = _CHANNELS[ctype]
    raw = np.frombuffer(zlib.decompress(b''.join(idat)), np.uint8)
    raw = raw.reshape(h, 1 + w * c)
    filters = raw[:, 0]
    if filters.max(initial=0) > 4:
        y = int(np.argmax(filters > 4))
        raise ValueError(f'{path}: bad filter {filters[y]} in row {y}')
    return raw[:, 1:].reshape(h, w, c), filters


def _decoded_jpeg(data: bytes, path) -> np.ndarray:
    img = decode_jpeg(data, str(path))
    return img[..., None] if img.ndim == 2 else img


def read_pngs(paths: Sequence, batch: int = 8) -> List[np.ndarray]:
    """[H, W, C] uint8 of each image file in ``paths``, by its first bytes:
    a JPEG file decoded by ``utils/jpeg.py`` (greyscale as C = 1), the JPEG
    files on a thread pool; an 8-bit non-interlaced PNG file by the
    diagonal unfilter, up to ``batch`` PNG files of one shape in a row
    decoded together."""
    datas = [Path(p).read_bytes() for p in paths]
    out: List = [None] * len(datas)
    jpegs = [i for i, d in enumerate(datas) if d[:3] == JPEG_SIGNATURE]
    if jpegs:
        workers = min(len(jpegs), os.cpu_count() or 1, 8)
        with ThreadPoolExecutor(workers) as pool:
            for i, img in zip(jpegs, pool.map(
                    lambda i: _decoded_jpeg(datas[i], paths[i]), jpegs)):
                out[i] = img
    pngs = [i for i, o in enumerate(out) if o is None]
    files = [_filtered(datas[i], paths[i]) for i in pngs]
    i = 0
    while i < len(files):
        shape = files[i][0].shape
        j = i + 1
        while j < len(files) and j - i < batch and files[j][0].shape == shape:
            j += 1
        raw = np.concatenate([r for r, _ in files[i:j]], axis=2)
        filters = np.repeat(np.stack([f for _, f in files[i:j]], axis=1),
                            shape[2], axis=1)
        dec = _unfilter(raw, filters)
        for k in range(j - i):
            out[pngs[i + k]] = dec[..., k * shape[2]:(k + 1) * shape[2]]
        i = j
    return out


def read_png(path) -> np.ndarray:
    """[H, W, C] uint8 of one PNG or JPEG file (``read_pngs``)."""
    return read_pngs([path])[0]
