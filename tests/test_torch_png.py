"""The port's PNG reader and writer against Pillow: files Pillow wrote
(its adaptive row filters), files encoded here with each of the five row
filters forced on alternate rows, colour types 0 / 2 / 4 / 6 at odd sizes,
frames decoded several at a time; exact equality. Palette, 16-bit,
interlaced, progressive JPEG and other files raise, naming the file; a
baseline JPEG file reads as Pillow decodes it."""
import struct
import zlib

import numpy as np
import pytest
from PIL import Image

from sk_gs_tpu_torch.utils import png

MODES = {'L': 1, 'LA': 2, 'RGB': 3, 'RGBA': 4}
COLOUR_TYPE = {1: 0, 2: 4, 3: 2, 4: 6}
SIZES = ((1, 1), (7, 5), (31, 29), (17, 64))


def ramp(rng, h, w, c):
    """A smooth ramp plus noise: Pillow picks every filter on such rows."""
    yy, xx = np.mgrid[0:h, 0:w]
    return ((xx[..., None] * 3 + yy[..., None] * 5 + np.arange(c) * 40
             + rng.integers(0, 6, size=(h, w, c))) % 256).astype(np.uint8)


def encode(img, filters):
    """A PNG of ``img`` [H, W, C] uint8 with row y under ``filters[y]``
    (the encoder of the PNG spec, pixel by pixel)."""
    h, w, c = img.shape
    x = img.reshape(h, w * c).astype(int)
    rows = []
    for y in range(h):
        f = filters[y]
        line = [f]
        for i in range(w * c):
            a = x[y, i - c] if i >= c else 0
            b = x[y - 1, i] if y else 0
            cc = x[y - 1, i - c] if y and i >= c else 0
            if f == 0:
                pred = 0
            elif f == 1:
                pred = a
            elif f == 2:
                pred = b
            elif f == 3:
                pred = (a + b) // 2
            else:
                p = a + b - cc
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - cc)
                pred = a if pa <= pb and pa <= pc else (b if pb <= pc else cc)
            line.append((x[y, i] - pred) % 256)
        rows.append(bytes(line))
    ihdr = struct.pack('>IIBBBBB', w, h, 8, COLOUR_TYPE[c], 0, 0, 0)
    return (png.SIGNATURE + png._chunk(b'IHDR', ihdr)
            + png._chunk(b'IDAT', zlib.compress(b''.join(rows)))
            + png._chunk(b'IEND', b''))


@pytest.mark.parametrize('mode', list(MODES))
@pytest.mark.parametrize('size', SIZES)
def test_reads_pillows_files(mode, size, rng, tmp_path):
    h, w = size
    c = MODES[mode]
    arr = ramp(rng, h, w, c)
    Image.fromarray(arr[..., 0] if c == 1 else arr, mode).save(
        tmp_path / 'a.png')
    ref = np.asarray(Image.open(tmp_path / 'a.png')).reshape(h, w, c)
    got = png.read_png(tmp_path / 'a.png')
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize('first', range(5))
@pytest.mark.parametrize('c', [1, 2, 3, 4])
def test_each_filter_on_alternate_rows(first, c, rng, tmp_path):
    """Row y under filter ``first`` when y is even, else the next one."""
    h, w = 13, 11
    arr = rng.integers(0, 256, size=(h, w, c)).astype(np.uint8)
    filters = [first if y % 2 == 0 else (first + 1 + y // 2 % 4) % 5
               for y in range(h)]
    (tmp_path / 'f.png').write_bytes(encode(arr, filters))
    np.testing.assert_array_equal(
        np.asarray(Image.open(tmp_path / 'f.png')).reshape(h, w, c), arr)
    np.testing.assert_array_equal(png.read_png(tmp_path / 'f.png'), arr)


def test_several_frames_at_once(rng, tmp_path):
    """``read_pngs`` decodes runs of one shape together; mixed shapes and
    channel counts come back in order."""
    arrs, paths = [], []
    for i, (shape, mode) in enumerate([((9, 12, 4), 'RGBA')] * 5
                                      + [((9, 12, 3), 'RGB'),
                                         ((5, 6, 4), 'RGBA')] * 2):
        arr = ramp(rng, *shape)
        Image.fromarray(arr, mode).save(tmp_path / f'{i}.png')
        arrs.append(arr)
        paths.append(tmp_path / f'{i}.png')
    got = png.read_pngs(paths, batch=3)
    assert len(got) == len(arrs)
    for g, a in zip(got, arrs):
        np.testing.assert_array_equal(g, a)


@pytest.mark.parametrize('c', [3, 4])
def test_writer_round_trip(c, rng, tmp_path):
    """The writer's adaptive filters decode in Pillow and in the reader."""
    arr = ramp(rng, 23, 19, c)
    png.write_png(tmp_path / 'w.png', arr)
    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / 'w.png')),
                                  arr)
    np.testing.assert_array_equal(png.read_png(tmp_path / 'w.png'), arr)


def test_unsupported_files_raise(rng, tmp_path):
    arr = rng.integers(0, 256, size=(6, 5, 3)).astype(np.uint8)
    Image.fromarray(arr).convert('P').save(tmp_path / 'p.png')
    Image.fromarray(arr[..., 0].astype(np.uint16) * 257).save(
        tmp_path / 'i16.png')
    # an Adam7 header (Pillow writes no interlaced files)
    ihdr = struct.pack('>IIBBBBB', 5, 6, 8, 2, 0, 0, 1)
    (tmp_path / 'inter.png').write_bytes(
        png.SIGNATURE + png._chunk(b'IHDR', ihdr)
        + png._chunk(b'IDAT', zlib.compress(bytes(6 * 16)))
        + png._chunk(b'IEND', b''))
    Image.fromarray(arr).save(tmp_path / 'prog.jpg', progressive=True)
    (tmp_path / 'a.gif').write_bytes(b'GIF89a' + bytes(20))
    for name in ('p.png', 'i16.png', 'inter.png', 'prog.jpg', 'a.gif'):
        with pytest.raises(ValueError, match=name):
            png.read_png(tmp_path / name)
    # a baseline JPEG file is read, by its first bytes, as Pillow reads it
    Image.fromarray(arr).save(tmp_path / 'a.jpg')
    np.testing.assert_array_equal(png.read_png(tmp_path / 'a.jpg'),
                                  np.asarray(Image.open(tmp_path / 'a.jpg')))
