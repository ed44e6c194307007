"""The port's bilinear resize against Pillow's ``Image.resize(...,
BILINEAR)``: modes L, LA, RGB and RGBA (alpha 0, 255 and partial: the
premultiplied round trip), the loaders' factors 2, 1.5625 and 1.3, sizes
800 -> 512, 33 -> 16 and 17 -> 11, an upscale and a resize along one axis;
exact uint8 equality."""
import numpy as np
import pytest
from PIL import Image

from sk_gs_tpu_torch.utils.resize import resize

MODES = {'L': 1, 'LA': 2, 'RGB': 3, 'RGBA': 4}
# (H, W) in -> (W, H) out
CASES = [((800, 800), (512, 512)),            # 1.5625 (wim_512)
         ((800, 800), (400, 400)),            # 2 (d_nerf_400)
         ((33, 33), (16, 16)), ((17, 17), (11, 11)),
         ((40, 52), (round(52 / 1.3), round(40 / 1.3))),
         ((13, 10), (20, 30)),                # upscale
         ((23, 31), (31, 12))]                # one axis


def image(rng, h, w, c):
    """A ramp plus noise; alpha mixes 0, 255 and partial values."""
    yy, xx = np.mgrid[0:h, 0:w]
    arr = ((xx[..., None] * 7 + yy[..., None] * 3 + np.arange(c) * 50
            + rng.integers(0, 60, size=(h, w, c))) % 256).astype(np.uint8)
    if c in (2, 4):
        arr[..., -1] = rng.choice([0, 255, 1, 17, 128, 254], size=(h, w))
    return arr[..., 0] if c == 1 else arr


@pytest.mark.parametrize('mode', list(MODES))
@pytest.mark.parametrize('shape,size', CASES)
def test_matches_pillow_bilinear(mode, shape, size, rng):
    arr = image(rng, *shape, MODES[mode])
    ref = np.asarray(Image.fromarray(arr, mode).resize(size, Image.BILINEAR))
    got = resize(arr, size)
    assert got.dtype == np.uint8 and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)


def test_same_size_is_a_copy(rng):
    arr = image(rng, 9, 7, 4)
    out = resize(arr, (7, 9))
    np.testing.assert_array_equal(out, arr)
    assert out is not arr


def test_refuses_floats():
    with pytest.raises(ValueError, match='uint8'):
        resize(np.zeros((4, 4, 3), np.float32), (2, 2))
