"""The port's JPEG decoder (``sk_gs_tpu_torch/utils/jpeg.py`` over
``csrc/jpeg_decode.cpp``, built with the host's C++ compiler) against
Pillow, byte for byte: files Pillow writes at quality 50 / 75 / 90 / 100
with 4:4:4, 4:2:2 and 4:2:0 sampling at sizes 1x1 to 800x600, greyscale,
restart intervals by blocks and by rows, optimised Huffman tables,
16-bit quantisation tables in an extended sequential frame, on
smooth, noisy and saturated images; files the decoder does not read
(progressive, CMYK, truncated, not a JPEG) raise a ``ValueError`` naming
the file; the committed fixtures (``tests/fixtures/jpeg``, which the chip
run decodes) equal their committed Pillow decodes; and ``chip_smoke.py``'s
numpy baseline encoder writes files that Pillow and the port decode alike
(its tables are libjpeg's defaults), at the sampling factors and scan
layouts Pillow does not write (4:4:0, 4:1:1, non-interleaved scans)."""
import io
import itertools
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

import chip_smoke
from sk_gs_tpu_torch.utils import jpeg, png
from tests.test_torch_cli import one_torch_thread  # noqa: F401

FIXTURES = Path(__file__).parent / 'fixtures' / 'jpeg'
QUALITIES = (50, 75, 90, 100)
SUBSAMPLING = {'444': 0, '422': 1, '420': 2}
SIZES = ((1, 1), (8, 8), (17, 13), (37, 53), (600, 800))


def make_image(h, w, kind, seed=0, grey=False):
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float64)
    if kind == 'noise':
        img = rng.integers(0, 256, (h, w, 3)).astype(np.float64)
    elif kind == 'saturated':
        img = np.where(((x // 3 + y // 5) % 2)[..., None] == 1,
                       [255.0, 0.0, 0.0], [0.0, 0.0, 255.0])
        img[(x + y) % 7 == 0] = [0, 255, 0]
    else:
        img = np.stack([255 * x / max(w - 1, 1), 255 * y / max(h - 1, 1),
                        128 + 100 * np.sin((x + 2 * y) / 9)], -1)
        img = img + rng.normal(0, 4, img.shape)
    img = np.clip(img, 0, 255).astype(np.uint8)
    return img[..., 0] if grey else img


def pillow_file(img, **opts) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, 'JPEG', **opts)
    return buf.getvalue()


def assert_decodes_as_pillow(data: bytes):
    ref = np.asarray(Image.open(io.BytesIO(data)))
    got = jpeg.decode_jpeg(data)
    assert got.dtype == np.uint8 and got.shape == ref.shape
    assert int(np.abs(got.astype(int) - ref).max()) == 0


@pytest.mark.parametrize('size', SIZES, ids=lambda s: f'{s[0]}x{s[1]}')
@pytest.mark.parametrize('sub', SUBSAMPLING)
@pytest.mark.parametrize('quality', QUALITIES)
def test_decodes_as_pillow(quality, sub, size):
    kinds = ('smooth',) if size == SIZES[-1] else \
        ('smooth', 'noise', 'saturated')
    for kind in kinds:
        img = make_image(*size, kind)
        assert_decodes_as_pillow(pillow_file(
            img, quality=quality, subsampling=SUBSAMPLING[sub]))


@pytest.mark.parametrize('quality', QUALITIES)
@pytest.mark.parametrize('size', SIZES, ids=lambda s: f'{s[0]}x{s[1]}')
def test_greyscale_decodes_as_pillow(size, quality):
    data = pillow_file(make_image(*size, 'smooth', grey=True),
                       quality=quality)
    assert_decodes_as_pillow(data)
    assert jpeg.decode_jpeg(data).ndim == 2


@pytest.mark.parametrize('opts', [
    {'restart_marker_blocks': 1}, {'restart_marker_blocks': 5},
    {'restart_marker_rows': 1}, {'restart_marker_rows': 3},
    {'optimize': True}, {'optimize': True, 'restart_marker_blocks': 2}],
    ids=lambda o: '-'.join(f'{k}{v}' for k, v in o.items()))
@pytest.mark.parametrize('sub', SUBSAMPLING)
def test_restarts_and_optimized_tables(sub, opts):
    for (h, w), kind in itertools.product(((37, 53), (96, 128)),
                                          ('smooth', 'noise')):
        assert_decodes_as_pillow(pillow_file(
            make_image(h, w, kind), quality=85,
            subsampling=SUBSAMPLING[sub], **opts))


@pytest.mark.parametrize('qtables', [
    [[300] * 64, [1000] * 64], [[257] * 64, list(range(2, 66))]],
    ids=['coarse', 'mixed'])
def test_sixteen_bit_tables_extended_sequential(qtables):
    """Quantisation tables past 255 are written 16-bit, in an extended
    sequential (SOF1) frame: both are read."""
    data = pillow_file(make_image(40, 56, 'noise'), qtables=qtables)
    i = data.index(b'\xff\xdb')
    assert data[i + 4] >> 4 == 1 and b'\xff\xc1' in data
    assert_decodes_as_pillow(data)


def test_unsupported_files_raise_naming_the_file(tmp_path):
    img = make_image(40, 56, 'smooth')
    Image.fromarray(img).save(tmp_path / 'prog.jpg', progressive=True)
    Image.fromarray(img).convert('CMYK').save(tmp_path / 'cmyk.jpg')
    data = pillow_file(img, quality=90)
    (tmp_path / 'cut.jpg').write_bytes(data[:len(data) // 2])
    (tmp_path / 'cut_scan.jpg').write_bytes(data[:-40])
    (tmp_path / 'no.jpg').write_bytes(b'GIF89a' + bytes(30))
    for name, why in (('prog.jpg', 'progressive'), ('cmyk.jpg', 'CMYK'),
                      ('cut.jpg', 'truncated'), ('cut_scan.jpg', 'truncated'),
                      ('no.jpg', 'not a JPEG')):
        with pytest.raises(ValueError, match=f'{name}.*{why}'):
            jpeg.read_jpeg(tmp_path / name)


def test_many_files_on_a_thread_pool(tmp_path):
    """``read_pngs`` decodes JPEG files on its thread pool beside PNG files,
    in order, each as Pillow reads it."""
    paths, refs = [], []
    for i in range(12):
        img = make_image(33 + i, 47, ('smooth', 'noise')[i % 2], seed=i)
        path = tmp_path / (f'{i}.jpg' if i % 3 else f'{i}.png')
        Image.fromarray(img).save(path, **({'quality': 70 + i} if i % 3
                                           else {}))
        paths.append(path)
        refs.append(np.asarray(Image.open(path)))
    for got, ref in zip(png.read_pngs(paths), refs):
        np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize('name', sorted(
    p.stem for p in FIXTURES.glob('*.jpg')))
def test_fixtures_equal_their_decodes(name):
    got = jpeg.read_jpeg(FIXTURES / f'{name}.jpg')
    ref = np.asarray(Image.open(FIXTURES / f'{name}.png'))
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(
        np.asarray(Image.open(FIXTURES / f'{name}.jpg')), ref)


def test_fixtures_cover_the_layouts():
    names = {p.stem for p in FIXTURES.glob('*.jpg')}
    assert len(names) >= 10
    for part in ('444', '422', '420', 'grey', 'restart', 'optimized',
                 'odd', 'q100', '440', '411', 'noninterleaved'):
        assert any(part in n for n in names), part
    assert sum(p.stat().st_size for p in FIXTURES.iterdir()) < 1e6


def dht_tables(data: bytes) -> dict:
    """{(class, id): (counts, symbols)} of a file's DHT segments."""
    out, pos = {}, 2
    while pos < len(data):
        marker, n = data[pos + 1], int.from_bytes(data[pos + 2:pos + 4], 'big')
        if marker == 0xDA:
            break
        body = data[pos + 4:pos + 2 + n]
        while marker == 0xC4 and body:
            counts = tuple(body[1:17])
            out[(body[0] >> 4, body[0] & 15)] = (
                counts, bytes(body[17:17 + sum(counts)]))
            body = body[17 + sum(counts):]
        pos += 2 + n
    return out


def test_encoder_tables_are_libjpegs():
    ref = dht_tables(pillow_file(make_image(16, 16, 'smooth'), quality=90))
    assert set(ref) == set(chip_smoke.JPEG_HUFF)
    for key, (counts, symbols) in chip_smoke.JPEG_HUFF.items():
        assert ref[key] == (tuple(counts), bytes(symbols)), key
    data = pillow_file(make_image(16, 16, 'smooth'), quality=90,
                       subsampling=2)
    ours = chip_smoke.encode_jpeg(make_image(16, 16, 'smooth'), 90)
    assert dht_tables(ours) == dht_tables(data)
    # the quantisation tables Pillow writes at quality 90 (zigzag order)
    q = chip_smoke.jpeg_quant_tables(90)
    i = data.index(b'\xff\xdb')
    assert data[i + 5:i + 69] == bytes(q[0][chip_smoke.JPEG_ZIGZAG]
                                       .astype(np.uint8))


ENCODER_CASES = {
    '420': {}, '444': {'sampling': ((1, 1),) * 3},
    '422': {'sampling': ((2, 1), (1, 1), (1, 1))},
    '440': {'sampling': ((1, 2), (1, 1), (1, 1))},
    '411': {'sampling': ((4, 1), (1, 1), (1, 1))},
    'mixed': {'sampling': ((2, 2), (1, 2), (2, 1))},
    '420_restart_1': {'restart_interval': 1},
    '420_noninterleaved': {'interleaved': False},
    '440_noninterleaved_restart_3': {
        'sampling': ((1, 2), (1, 1), (1, 1)), 'interleaved': False,
        'restart_interval': 3},
}


@pytest.mark.parametrize('quality', (50, 90, 100))
@pytest.mark.parametrize('case', ENCODER_CASES)
def test_encoder_files_decode_alike(case, quality):
    for size, kind in itertools.product(((1, 1), (13, 17), (40, 33)),
                                        ('smooth', 'saturated')):
        data = chip_smoke.encode_jpeg(make_image(*size, kind), quality,
                                      **ENCODER_CASES[case])
        assert_decodes_as_pillow(data)


def test_encoder_greyscale_and_quality():
    grey = make_image(29, 31, 'smooth', grey=True)
    data = chip_smoke.encode_jpeg(grey, 75)
    assert_decodes_as_pillow(data)
    img = make_image(96, 128, 'smooth')
    dec = jpeg.decode_jpeg(chip_smoke.encode_jpeg(img, 90)).astype(float)
    psnr = 10 * np.log10(255.0 ** 2 / np.mean((dec - img) ** 2))
    assert psnr > 30
