"""The port's loaders against the JAX package's on the same files: the
committed real-format fixtures (``tests/fixtures/golden``: the D-NeRF and
WIM minis, the pickled ZJU-MoCap cache, ``golden.npz`` at the bars of
``tests/test_golden_loaders.py``) and generated layouts (D-NeRF and WIM
from ``tests/test_datasets.py``, ZJU-MoCap annotations and COLMAP text and
binary models written here). Every ``Scene`` field and every ``SceneMeta``
field, with and without downscale, over white, black and each background
composited per step: cameras within 1e-6, images within 1e-7 (both decode
the same bytes and composite in float32). ``framework.build.build_scene``
dispatches as ``train.py:build_scene`` does, the evaluation split falling
back to the train split without its file. A JPEG image raises, naming the
file."""
import struct
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from sk_gs_tpu.data import colmap as jcolmap
from sk_gs_tpu.data import dnerf as jdnerf
from sk_gs_tpu.data import wim as jwim
from sk_gs_tpu.data import zju as jzju
from sk_gs_tpu_torch.data import base, colmap, dnerf, wim, zju
from sk_gs_tpu_torch.framework import build
from tests.test_datasets import dnerf_root, wim_root  # noqa: F401

FIX = Path(__file__).parent / 'fixtures' / 'golden'
BACKGROUNDS = ('white', 'black') + base.DYNAMIC_BG
CAMERA_FIELDS = ('Tw2v', 'Tv2c', 'campos', 'tan_fovx', 'tan_fovy')


def assert_same_scene(got, ref, img_tol=1e-7, cam_tol=1e-6):
    """Every field of the port's (Scene, SceneMeta) against the JAX one."""
    (scene, meta), (jscene, jmeta) = got, ref
    for name in scene._fields:
        a = getattr(scene, name).cpu().numpy()
        b = np.asarray(getattr(jscene, name))
        assert a.shape == b.shape, (name, a.shape, b.shape)
        if name == 'images':
            np.testing.assert_allclose(a, b, rtol=0, atol=img_tol)
        elif name in CAMERA_FIELDS:
            np.testing.assert_allclose(a, b, rtol=0, atol=cam_tol,
                                       err_msg=name)
        else:
            np.testing.assert_array_equal(a, b, err_msg=name)
    for name in ('background_type', 'near', 'far', 'num_frames', 'scene'):
        assert getattr(meta, name) == getattr(jmeta, name), name
    assert meta.cameras_extent == pytest.approx(jmeta.cameras_extent,
                                                rel=1e-6)
    np.testing.assert_array_equal(meta.train_times, jmeta.train_times)
    if jmeta.background is None:
        assert meta.background is None
    else:
        np.testing.assert_array_equal(meta.background, jmeta.background)


@pytest.mark.parametrize('background', BACKGROUNDS)
@pytest.mark.parametrize('downscale', [1, 2])
def test_dnerf_golden(background, downscale):
    kw = dict(downscale=downscale, background=background)
    got = dnerf.load_dnerf(str(FIX / 'dnerf'), 'mini', device='cpu', **kw)
    assert_same_scene(got, jdnerf.load_dnerf(str(FIX / 'dnerf'), 'mini',
                                             **kw))
    assert got[0].images.shape[-1] == (
        4 if background in base.DYNAMIC_BG else 3)


@pytest.mark.parametrize('downscale', [1, 1.3])
def test_dnerf_generated(dnerf_root, downscale):  # noqa: F811
    kw = dict(downscale=downscale, background='white', num_frames_max=3)
    assert_same_scene(
        dnerf.load_dnerf(str(dnerf_root), 'lego', device='cpu', **kw),
        jdnerf.load_dnerf(str(dnerf_root), 'lego', **kw))


@pytest.mark.parametrize('split', ['train', 'test'])
@pytest.mark.parametrize('downscale', [1, 1.5625])
def test_wim_golden(split, downscale):
    kw = dict(split=split, downscale=downscale, frame_ranges=(0, 2))
    assert_same_scene(wim.load_wim(str(FIX / 'wim'), 'mini', device='cpu',
                                   **kw),
                      jwim.load_wim(str(FIX / 'wim'), 'mini', **kw))


@pytest.mark.parametrize('background', BACKGROUNDS)
def test_wim_generated(wim_root, background):  # noqa: F811
    kw = dict(frame_ranges=(1, 3), background=background, downscale=2)
    got = wim.load_wim(str(wim_root), 'robo', device='cpu', **kw)
    assert_same_scene(got, jwim.load_wim(str(wim_root), 'robo', **kw))
    # frame-major: 18 train cameras a frame
    np.testing.assert_array_equal(got[0].time_ids.numpy(),
                                  np.repeat([0, 1], 18))
    np.testing.assert_array_equal(got[0].camera_ids.numpy(),
                                  np.tile(np.arange(18), 2))


def test_golden_npz_bars():
    """The port's loaders at ``tests/test_golden_loaders.py``'s bars
    against the tensors the reference's dataset classes gave."""
    golden = dict(np.load(FIX / 'golden.npz'))
    scene, _ = dnerf.load_dnerf(str(FIX / 'dnerf'), 'mini', near=2.0,
                                far=6.0, device='cpu')
    for i in range(2):
        for name, key in (('Tw2v', 'Tw2v'), ('Tv2c', 'Tv2c'),
                          ('campos', 'campos')):
            np.testing.assert_allclose(getattr(scene, name)[i].numpy(),
                                       golden[f'dnerf_{key}_{i}'], rtol=0,
                                       atol=1e-6)
        np.testing.assert_allclose(scene.images[i].numpy(),
                                   golden[f'dnerf_img_{i}'][..., :3],
                                   rtol=0, atol=2e-3)
    fovx, fovy = golden['dnerf_FoV']
    np.testing.assert_allclose(float(scene.tan_fovx[0]), np.tan(fovx / 2),
                               rtol=1e-5)
    np.testing.assert_allclose(float(scene.tan_fovy[0]), np.tan(fovy / 2),
                               rtol=1e-5)

    scene, _ = wim.load_wim(str(FIX / 'wim'), 'mini', frame_ranges=(0, 2),
                            near=0.01, far=1000.0, device='cpu')
    n_cams = 18
    for k in range(n_cams):
        for v in (k, n_cams + k):
            np.testing.assert_allclose(scene.Tw2v[v].numpy(),
                                       golden['wim_Tw2v'][k], rtol=0,
                                       atol=1e-6)
        np.testing.assert_allclose(scene.campos[k].numpy(),
                                   golden['wim_Tv2w'][k, :3, 3], rtol=0,
                                   atol=1e-6)
    np.testing.assert_allclose(scene.Tv2c[0].numpy(), golden['wim_Tv2c'],
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(scene.times.numpy(), golden['wim_times'],
                               atol=1e-7)
    np.testing.assert_array_equal(scene.time_ids.numpy(),
                                  golden['wim_time_ids'])
    np.testing.assert_array_equal(scene.camera_ids.numpy(),
                                  golden['wim_camera_ids'])
    np.testing.assert_allclose(scene.images[0].numpy()[::37, ::41],
                               golden['wim_img0_sub'][..., :3], rtol=0,
                               atol=2e-3)

    scene, _ = zju.load_zju_pickled(str(FIX / 'zju'), '313', image_size=32,
                                    compression=False, background='black',
                                    move_center=False, device='cpu')
    for k in range(3):
        np.testing.assert_allclose(scene.Tw2v[k].numpy(),
                                   golden['zju_Tw2v'][k], rtol=0, atol=1e-5)
        np.testing.assert_allclose(scene.campos[k].numpy(),
                                   golden['zju_Tv2w'][k, :3, 3], rtol=0,
                                   atol=1e-5)
        np.testing.assert_allclose(scene.Tv2c[k].numpy(),
                                   golden['zju_Tv2c'][k], rtol=0, atol=1e-6)
        fovx, fovy = golden['zju_FoV'][k]
        np.testing.assert_allclose(float(scene.tan_fovx[k]),
                                   np.tan(fovx / 2), rtol=1e-5)
        np.testing.assert_allclose(float(scene.tan_fovy[k]),
                                   np.tan(fovy / 2), rtol=1e-5)
    np.testing.assert_allclose(scene.times.numpy(), golden['zju_times'],
                               atol=1e-7)
    np.testing.assert_array_equal(scene.time_ids.numpy(),
                                  golden['zju_time_ids'])
    np.testing.assert_array_equal(scene.camera_ids.numpy(),
                                  golden['zju_camera_ids'])
    np.testing.assert_allclose(
        scene.images[0].numpy(),
        golden['zju_img0'][..., :3].astype(np.float32) / 255.0, rtol=0,
        atol=2e-3)


@pytest.mark.parametrize('move_center', [True, False])
@pytest.mark.parametrize('image_size', [32, 24])
@pytest.mark.parametrize('background', ['none', 'white', 'random'])
def test_zju_pickled_golden(move_center, image_size, background):
    """The committed pickle; at 24 px through the RGBA resize."""
    kw = dict(image_size=image_size, compression=False,
              move_center=move_center, background=background)
    assert_same_scene(
        zju.load_zju_pickled(str(FIX / 'zju'), '313', device='cpu', **kw),
        jzju.load_zju_pickled(str(FIX / 'zju'), '313', **kw), img_tol=1e-6)


def test_zju_pickled_blosc_missing():
    """A compressed cache needs blosc, which neither machine has: the
    port raises as the JAX package does."""
    with pytest.raises(ImportError, match='blosc'):
        zju.load_zju_pickled(str(FIX / 'zju'), '313', device='cpu')


def write_zju_annots(root: Path, rng, n_cams=5, n_frames=2, hw=16,
                     suffix='.png', save_kw=None):
    scene_root = root / 'CoreView_7'
    (scene_root / 'imgs').mkdir(parents=True)
    (scene_root / 'mask').mkdir()
    K = np.tile(np.array([[30.0, 0, 8], [0, 31.0, 8], [0, 0, 1]],
                         np.float32), (n_cams, 1, 1))
    th = rng.uniform(0, 1, size=n_cams)
    R = np.stack([np.array([[np.cos(t), -np.sin(t), 0],
                            [np.sin(t), np.cos(t), 0], [0, 0, 1]],
                           np.float32) for t in th])
    T = rng.normal(size=(n_cams, 3, 1)).astype(np.float32) * 1000
    ims = []
    for f in range(n_frames):
        names = []
        for c in range(n_cams):
            name = f'imgs/f{f}_c{c}{suffix}'
            Image.fromarray(rng.integers(0, 256, size=(hw, hw, 3))
                            .astype(np.uint8)).save(scene_root / name,
                                                    **(save_kw or {}))
            if c % 2 == 0:
                mask = (rng.uniform(size=(hw, hw)) > 0.4).astype(np.uint8)
                Image.fromarray(mask * 255).save(
                    scene_root / 'mask' / f'f{f}_c{c}.png')
            names.append(name)
        ims.append({'ims': names})
    np.save(scene_root / 'annots.npy',
            {'cams': {'K': K, 'R': R, 'T': T}, 'ims': ims})
    return root


@pytest.mark.parametrize('split,background', [('train', 'white'),
                                               ('train', 'random'),
                                               ('test', 'random')])
def test_zju_annots(tmp_path, rng, split, background):
    """Masks as alpha: the train cameras (0, 2, 4) have one each, the test
    cameras (1, 3) none."""
    root = write_zju_annots(tmp_path / 'zju', rng)
    kw = dict(split=split, train_camera_ids=(0, 2, 4), background=background)
    got = zju.load_zju(str(root), '7', device='cpu', **kw)
    assert_same_scene(got, jzju.load_zju(str(root), '7', **kw))
    assert got[0].images.shape[-1] == (
        4 if (split, background) == ('train', 'random') else 3)


def write_colmap(root: Path, rng, binary: bool, n_img=5, hw=(12, 16),
                 suffix='.png', save_kw=None):
    """A sparse model in COLMAP's text or binary format, and its images."""
    sparse = root / 'sparse' / '0'
    sparse.mkdir(parents=True)
    (root / 'images').mkdir()
    h, w = hw
    q = rng.normal(size=(n_img, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    t = rng.normal(size=(n_img, 3))
    names = [f'im{i}{suffix}' for i in range(n_img)][::-1]
    for name in names:
        Image.fromarray(rng.integers(0, 256, size=(h, w, 3))
                        .astype(np.uint8)).save(root / 'images' / name,
                                                **(save_kw or {}))
    pts = rng.normal(size=(7, 3))
    cols = rng.integers(0, 256, size=(7, 3))
    if not binary:
        (sparse / 'cameras.txt').write_text(
            f'# cameras\n1 PINHOLE {w} {h} 20.5 21.0 8 6\n')
        lines = ['# images']
        for i, name in enumerate(names):
            lines += [f'{i + 1} ' + ' '.join(map(str, q[i])) + ' '
                      + ' '.join(map(str, t[i])) + f' 1 {name}', '']
        (sparse / 'images.txt').write_text('\n'.join(lines) + '\n')
        (sparse / 'points3D.txt').write_text('\n'.join(
            f'{j} ' + ' '.join(map(str, pts[j])) + ' '
            + ' '.join(map(str, cols[j])) + ' 0.5'
            for j in range(7)) + '\n')
        return root
    with (sparse / 'cameras.bin').open('wb') as f:
        f.write(struct.pack('<Q', 1))
        f.write(struct.pack('<iiQQ', 1, 1, w, h))
        f.write(struct.pack('<4d', 20.5, 21.0, 8, 6))
    with (sparse / 'images.bin').open('wb') as f:
        f.write(struct.pack('<Q', n_img))
        for i, name in enumerate(names):
            f.write(struct.pack('<i', i + 1))
            f.write(struct.pack('<7d', *q[i], *t[i]))
            f.write(struct.pack('<i', 1))
            f.write(name.encode() + b'\x00')
            f.write(struct.pack('<Q', 2))
            f.write(struct.pack('<ddq', 1.0, 2.0, -1) * 2)
    with (sparse / 'points3D.bin').open('wb') as f:
        f.write(struct.pack('<Q', 7))
        for j in range(7):
            f.write(struct.pack('<Q', j))
            f.write(struct.pack('<3d', *pts[j]))
            f.write(struct.pack('<3B', *cols[j]))
            f.write(struct.pack('<d', 0.5))
            f.write(struct.pack('<Q', 1))
            f.write(struct.pack('<ii', 0, 0))
    return root


@pytest.mark.parametrize('binary', [False, True])
@pytest.mark.parametrize('split,llffhold', [('train', 0), ('train', 2),
                                            ('test', 2)])
def test_colmap(tmp_path, rng, binary, split, llffhold):
    root = write_colmap(tmp_path / 'scene', rng, binary)
    kw = dict(split=split, llffhold=llffhold, downscale=2)
    scene, meta, pts, cols = colmap.load_colmap(str(root), device='cpu',
                                                **kw)
    jscene, jmeta, jpts, jcols = jcolmap.load_colmap(str(root), **kw)
    assert_same_scene((scene, meta), (jscene, jmeta))
    np.testing.assert_array_equal(pts, jpts)
    np.testing.assert_array_equal(cols, jcols)


def test_jpeg_raises_naming_the_file(tmp_path, rng):
    """A JPEG the port does not read (progressive) raises through each
    loader, naming the file; baseline ones load (below)."""
    root = write_colmap(tmp_path / 'scene', rng, False, suffix='.jpg',
                        save_kw={'progressive': True})
    with pytest.raises(ValueError, match=r'im\d\.jpg.*progressive'):
        colmap.load_colmap(str(root), device='cpu')
    root = write_zju_annots(tmp_path / 'zju', rng, suffix='.jpg',
                            save_kw={'progressive': True})
    with pytest.raises(ValueError, match=r'f0_c0\.jpg.*progressive'):
        zju.load_zju(str(root), '7', device='cpu')


@pytest.mark.parametrize('quality,subsampling', [(90, 2), (75, 0)])
@pytest.mark.parametrize('split', ['train', 'test'])
def test_zju_jpeg(tmp_path, rng, split, quality, subsampling):
    """The real layout's frames: JPEG images, PNG masks, loaded as the JAX
    loader (Pillow) loads them, arrays equal."""
    root = write_zju_annots(tmp_path / 'zju', rng, suffix='.jpg', hw=37,
                            save_kw={'quality': quality,
                                     'subsampling': subsampling})
    kw = dict(split=split, train_camera_ids=(0, 2, 4), background='random')
    got = zju.load_zju(str(root), '7', device='cpu', **kw)
    assert_same_scene(got, jzju.load_zju(str(root), '7', **kw))


@pytest.mark.parametrize('downscale', [1, 2])
def test_colmap_jpeg(tmp_path, rng, downscale):
    """COLMAP's JPEG images, decoded and resized as the JAX loader does."""
    root = write_colmap(tmp_path / 'scene', rng, True, suffix='.jpg',
                        hw=(41, 29), save_kw={'quality': 80})
    kw = dict(split='train', llffhold=2, downscale=downscale)
    scene, meta, pts, cols = colmap.load_colmap(str(root), device='cpu',
                                                **kw)
    jscene, jmeta, _, _ = jcolmap.load_colmap(str(root), **kw)
    assert_same_scene((scene, meta), (jscene, jmeta))


def test_build_scene_dispatch(tmp_path, rng, dnerf_root):  # noqa: F811
    """``build.build_scene`` against ``train.build_scene`` for each kind
    on the same config: the eval split (D-NeRF mini has no val split: the
    train split) and COLMAP's point cloud."""
    from train import build_scene as jbuild
    colmap_root = write_colmap(tmp_path / 'scene', rng, True)
    raster = {'pair_capacity': 2 ** 12, 'chunk': 64, 'use_pallas': False}
    cases = [
        {'kind': 'dnerf', 'root': str(FIX / 'dnerf'), 'scene': 'mini',
         'background': 'checker', 'downscale': 2},
        {'kind': 'dnerf', 'root': str(dnerf_root), 'scene': 'lego'},
        {'kind': 'wim', 'root': str(FIX / 'wim'), 'scene': 'mini',
         'frame_ranges': [0, 1], 'downscale': 4},
        {'kind': 'zju_pickled', 'root': str(FIX / 'zju'), 'scene': 313,
         'compression': False, 'image_size': 32, 'background': 'black'},
        {'kind': 'colmap', 'root': str(colmap_root), 'background': 'black'},
    ]
    for d in cases:
        cfg = {'dataset': d, 'train': {'seed': 0}, 'raster': raster}
        scene, meta, eval_scene, pcd = build.build_scene(cfg, device='cpu')
        jscene, jmeta, jeval, jpcd = jbuild(cfg)
        assert_same_scene((scene, meta), (jscene, jmeta))
        assert_same_scene((eval_scene, meta), (jeval, jmeta))
        assert (eval_scene is scene) == (jeval is jscene), d
        if jpcd is None:
            assert pcd is None
        else:
            for a, b in zip(pcd, jpcd):
                np.testing.assert_array_equal(a, b)
    with pytest.raises(NotImplementedError, match='kind nerf'):
        build.build_scene({'dataset': {'kind': 'nerf'}, 'train': {},
                           'raster': raster}, device='cpu')


def test_checkerboard_and_solid_backgrounds():
    from sk_gs_tpu.data.base import image_checkerboard, solid_background
    np.testing.assert_array_equal(base.image_checkerboard(20, 28, 8),
                                  image_checkerboard(20, 28, 8))
    for kind in ('white', 'black', 'none') + base.DYNAMIC_BG:
        ref = solid_background(kind)
        got = base.solid_background(kind)
        assert (got is None) == (ref is None)
        if ref is not None:
            np.testing.assert_array_equal(got, ref)
    with pytest.raises(NotImplementedError):
        base.solid_background('grey')
