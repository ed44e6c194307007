"""Regenerate the JPEG fixtures of this directory: small files written by
Pillow (and two by ``chip_smoke.py``'s baseline encoder, for the sampling
factors and the non-interleaved scans that Pillow does not write), each
beside its decode by Pillow as a lossless PNG (``<name>.png``), which
``chip_smoke.py``'s ``jpeg`` phase holds the port's decoder to on the card
(the card's machine has no Pillow).

    python tests/fixtures/jpeg/make_fixtures.py

The images are made from a seed with numpy: smooth gradients, saturated
colour blocks (where the decoder's clamps and range limit show) and a
little noise, at odd sizes.
"""
import io
import sys
from pathlib import Path

import numpy as np
from PIL import Image

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE.parents[2]))

# name: (height, width, grey, Pillow save options) or, with 'encoder',
# chip_smoke.encode_jpeg's options
CASES = {
    's444_q90': (61, 83, False, {'quality': 90, 'subsampling': 0}),
    's422_q75': (64, 96, False, {'quality': 75, 'subsampling': 1}),
    's420_q50_odd': (97, 131, False, {'quality': 50, 'subsampling': 2}),
    's420_q100': (120, 160, False, {'quality': 100, 'subsampling': 2}),
    'grey_q85_odd': (45, 67, True, {'quality': 85}),
    's420_restart_blocks': (80, 112, False, {'quality': 80, 'subsampling': 2,
                                             'restart_marker_blocks': 3}),
    's422_restart_rows': (50, 70, False, {'quality': 90, 'subsampling': 1,
                                          'restart_marker_rows': 1}),
    's420_optimized': (256, 200, False, {'quality': 92, 'subsampling': 2,
                                         'optimize': True}),
    'tiny_1x1': (1, 1, False, {'quality': 90, 'subsampling': 2}),
    's440_noninterleaved_restart': (73, 58, False, {
        'encoder': True, 'quality': 85, 'sampling': ((1, 2), (1, 1), (1, 1)),
        'restart_interval': 5, 'interleaved': False}),
    's411_box': (40, 90, False, {'encoder': True, 'quality': 70,
                                 'sampling': ((4, 1), (1, 1), (1, 1))}),
}


def image(rng, h, w, grey):
    y, x = np.mgrid[0:h, 0:w].astype(np.float64)
    img = np.stack([255 * x / max(w - 1, 1), 255 * y / max(h - 1, 1),
                    128 + 100 * np.sin((x + 2 * y) / 9)], -1)
    # saturated blocks: pure red, green, blue and yellow
    for k, col in enumerate(([255, 0, 0], [0, 255, 0], [0, 0, 255],
                             [255, 255, 0])):
        y0, x0 = (k * h) // 5, (k * w) // 4
        img[y0:y0 + max(h // 6, 1), x0:x0 + max(w // 6, 1)] = col
    img = np.clip(img + rng.normal(0, 6, img.shape), 0, 255).astype(np.uint8)
    return img[..., 0] if grey else img


def main():
    from chip_smoke import encode_jpeg
    rng = np.random.default_rng(0)
    for name, (h, w, grey, opts) in CASES.items():
        img = image(rng, h, w, grey)
        if opts.get('encoder'):
            opts = {k: v for k, v in opts.items() if k != 'encoder'}
            data = encode_jpeg(img, **opts)
        else:
            buf = io.BytesIO()
            Image.fromarray(img).save(buf, 'JPEG', **opts)
            data = buf.getvalue()
        (HERE / f'{name}.jpg').write_bytes(data)
        decoded = Image.open(io.BytesIO(data))
        decoded.load()
        decoded.save(HERE / f'{name}.png')


if __name__ == '__main__':
    main()
