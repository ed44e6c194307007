"""8-bit PNG files with the standard library only (``zlib`` and
``struct``; the card's machine has no Pillow).

``write_png`` writes an [H, W, 3] or [H, W, 4] uint8 array (or floats in
[0, 1], clipped and scaled by 255 as the JAX package's frames are),
non-interlaced, every row with filter 0. ``read_png`` reads 8-bit
greyscale, RGB and RGBA files, non-interlaced, with any of the five row
filters; it checks every chunk's CRC.
"""
from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np

SIGNATURE = b'\x89PNG\r\n\x1a\n'
_CHANNELS = {0: 1, 2: 3, 6: 4}      # colour type -> channels


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack('>I', len(data)) + kind + data
            + struct.pack('>I', zlib.crc32(kind + data) & 0xFFFFFFFF))


def to_uint8(img) -> np.ndarray:
    """Floats in [0, 1] -> uint8 by clip and truncation (x 255)."""
    img = np.asarray(img)
    if img.dtype == np.uint8:
        return img
    return (np.clip(img, 0.0, 1.0) * 255).astype(np.uint8)


def write_png(path, img) -> Path:
    img = to_uint8(img)
    if img.ndim != 3 or img.shape[2] not in (3, 4):
        raise ValueError(f'need [H, W, 3|4], got {img.shape}')
    h, w, c = img.shape
    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           np.ascontiguousarray(img).reshape(h, w * c)],
                          axis=1)
    ihdr = struct.pack('>IIBBBBB', w, h, 8, 2 if c == 3 else 6, 0, 0, 0)
    path = Path(path)
    path.write_bytes(SIGNATURE + _chunk(b'IHDR', ihdr)
                     + _chunk(b'IDAT', zlib.compress(rows.tobytes(), 6))
                     + _chunk(b'IEND', b''))
    return path


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def read_png(path) -> np.ndarray:
    """[H, W, C] uint8 of an 8-bit non-interlaced PNG."""
    data = Path(path).read_bytes()
    if data[:8] != SIGNATURE:
        raise ValueError(f'{path}: not a PNG file')
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
                         f'type {ctype}, interlace {interlace})')
    c = _CHANNELS[ctype]
    raw = np.frombuffer(zlib.decompress(b''.join(idat)), np.uint8)
    raw = raw.reshape(h, 1 + w * c)
    out = np.zeros((h, w * c), np.int32)
    prev = np.zeros(w * c, np.int32)
    for y in range(h):
        f, line = raw[y, 0], raw[y, 1:].astype(np.int32)
        if f == 0:
            cur = line
        elif f == 2:
            cur = (line + prev) & 0xFF
        elif f in (1, 3, 4):
            cur = np.zeros_like(line)
            for x in range(0, w * c, c):     # left neighbours: pixel by pixel
                a = cur[x - c:x] if x else np.zeros(c, np.int32)
                b, up_left = prev[x:x + c], (prev[x - c:x] if x
                                             else np.zeros(c, np.int32))
                pred = {1: a, 3: (a + b) // 2,
                        4: _paeth(a, b, up_left)}[int(f)]
                cur[x:x + c] = (line[x:x + c] + pred) & 0xFF
        else:
            raise ValueError(f'{path}: bad filter {f} in row {y}')
        out[y] = cur
        prev = cur
    return out.astype(np.uint8).reshape(h, w, c)
