"""ZJU-MoCap scenes (port of ``load_zju``, ``_bilinear_shift`` and
``load_zju_pickled`` of ``sk_gs_tpu/data/zju.py``).

``load_zju`` reads ``CoreView_{scene}/annots.npy`` (each camera's K, R
and T, T in millimetres; each frame's image list), the train cameras {0,
6, 12, 19} and the rest for test, each image with its mask from
``mask_dir`` as alpha. ``load_zju_pickled`` reads one pickle a split of
images, masks (blosc-compressed unless ``compression`` is off), and
per-(camera, frame) intrinsics and extrinsics, each camera with its own
projection. The real dataset's images are JPEG files and its masks PNG
files; ``load_image`` reads either by its first bytes.
"""
from __future__ import annotations

import pickle
from pathlib import Path
from typing import Sequence, Tuple

import numpy as np

from ..ops.transforms import (convert_coord_system, focal_to_fov,
                              perspective_pp)
from ..utils.resize import resize
from .base import Scene, SceneMeta, build_scene
from .dnerf import load_image


def load_zju(root: str, scene: str = '377', split: str = 'train',
             num_max_frames: int = 300, downscale: int = 1,
             background: str = 'white',
             train_camera_ids: Sequence[int] = (0, 6, 12, 19),
             mask_dir: str = 'mask',
             coord_src: str = 'opengl', coord_dst: str = 'colmap',
             near: float = 0.01, far: float = 100.0, device='cuda'
             ) -> Tuple[Scene, SceneMeta]:
    scene_root = Path(root) / f'CoreView_{scene}'
    annots = np.load(scene_root / 'annots.npy', allow_pickle=True).item()
    cams = annots['cams']
    K = np.asarray(cams['K'], np.float32)
    R = np.asarray(cams['R'], np.float32)
    T = np.asarray(cams['T'], np.float32)
    Tw2v = np.zeros((len(K), 4, 4), np.float32)
    Tw2v[:, :3, :3] = R
    Tw2v[:, :3, 3:] = T * 1e-3          # millimetres -> metres
    Tw2v[:, 3, 3] = 1
    image_infos = annots['ims']
    n_frames = len(image_infos) if num_max_frames < 0 else \
        min(len(image_infos), num_max_frames)
    paths, time_ids, camera_ids = [], [], []
    for fid in range(n_frames):
        for cid, ip in enumerate(image_infos[fid]['ims']):
            if (split == 'train') == (cid in train_camera_ids):
                paths.append(ip)
                time_ids.append(fid)
                camera_ids.append(cid)
    images = []
    for p in paths:
        img = load_image(scene_root / p, downscale)[..., :3]
        mask_path = scene_root / mask_dir / Path(p).with_suffix('.png').name
        if mask_path.exists():
            m = load_image(mask_path, downscale)
            if m.ndim == 3:
                m = m[..., 0]
            img = np.concatenate([img, m[..., None]], axis=-1)
        images.append(img)
    images = np.stack(images)
    focal = float(K[:, 0, 0].mean()) / downscale
    h, w = images.shape[1:3]
    fovx = float(focal_to_fov(focal, w))
    Tw2v = convert_coord_system(Tw2v, coord_src, coord_dst)
    Tv2w_per_image = np.linalg.inv(Tw2v)[np.asarray(camera_ids)]
    times = np.asarray(time_ids, np.float32) / n_frames
    meta = SceneMeta(background_type=background, near=near, far=far,
                     scene=scene)
    return build_scene(images, Tv2w_per_image, fovx, times, meta,
                       camera_ids=np.asarray(camera_ids),
                       time_ids=np.asarray(time_ids), device=device)


def _bilinear_shift(img: np.ndarray, dx: float, dy: float) -> np.ndarray:
    """Translate by a fractional (dx, dy) with bilinear sampling and a zero
    border (the reference's ``cv2.warpAffine`` recentring)."""
    h, w = img.shape[:2]
    ys = np.arange(h, dtype=np.float32) - dy
    xs = np.arange(w, dtype=np.float32) - dx
    y0 = np.clip(np.floor(ys).astype(np.int64), 0, h - 1)
    x0 = np.clip(np.floor(xs).astype(np.int64), 0, w - 1)
    y1 = np.clip(y0 + 1, 0, h - 1)
    x1 = np.clip(x0 + 1, 0, w - 1)
    wy = np.clip(ys - y0, 0.0, 1.0)[:, None, None]
    wx = np.clip(xs - x0, 0.0, 1.0)[None, :, None]
    a = img[y0][:, x0]
    b = img[y0][:, x1]
    c = img[y1][:, x0]
    d = img[y1][:, x1]
    out = (a * (1 - wy) * (1 - wx) + b * (1 - wy) * wx
           + c * wy * (1 - wx) + d * wy * wx)
    valid_y = ((ys >= 0) & (ys <= h - 1))[:, None, None]
    valid_x = ((xs >= 0) & (xs <= w - 1))[None, :, None]
    return np.where(valid_y & valid_x, out, 0.0).astype(img.dtype)


def load_zju_pickled(root: str, scene: str = '377',
                     pickle_path: str = 'cache_train.pickle',
                     frame_ranges: Tuple[int, int] = (-1, -1), step: int = 1,
                     image_size: int = 512, compression: bool = True,
                     background: str = 'none', move_center: bool = True,
                     near: float = 0.1, far: float = 1000.0, device='cuda'
                     ) -> Tuple[Scene, SceneMeta]:
    """The pickled variant: camera translations divided by WIM's coordinate
    scale 1.5, images resized to ``image_size`` (Pillow's bilinear filter,
    RGBA with the mask as alpha), the principal point moved to the centre
    when ``move_center``."""
    with open(Path(root) / scene / pickle_path, 'rb') as f:
        data = pickle.load(f)
    frame_indies = np.unique(data['frame_id'])
    imgs_per_cam = len(frame_indies)
    fid_max = int(frame_indies.max())
    id_min = int(frame_indies.min()) if frame_ranges[0] < 0 else \
        max(int(frame_ranges[0]), int(frame_indies.min()))
    id_max = int(frame_indies.max()) + 1 if frame_ranges[1] < 0 else \
        min(int(frame_ranges[1]), int(frame_indies.max()) + 1)
    camera_indies = np.unique(data['camera_id'])
    images, times, time_ids, camera_ids = [], [], [], []
    poses, intrinsics = [], []
    coordinate_scale = 1.5
    for f_id in range(0, imgs_per_cam, step):
        if not (id_min <= int(frame_indies[f_id]) < id_max):
            continue
        for k, c_id in enumerate(camera_indies):
            index = int(c_id) * imgs_per_cam + f_id
            img = data['img'][index]
            mask = data['mask'][index]
            if compression:
                try:
                    import blosc
                except ImportError as e:
                    raise ImportError(
                        'pickled ZJU cache is blosc-compressed; install '
                        'blosc or regenerate with compression=False') from e
                img = blosc.unpack_array(img)
                mask = blosc.unpack_array(mask)
            mask = np.asarray(mask)
            if mask.ndim == 2:
                mask = mask[None, :, :]
            img = np.concatenate([img, mask.astype(np.uint8) * 255], axis=0)
            img = np.transpose(img, (1, 2, 0)).astype(np.float32)
            img_scale = 1.0
            if img.shape[0] != image_size:
                img_scale = image_size / img.shape[0]
                img = resize(img.astype(np.uint8), (image_size, image_size)
                             ).astype(np.float32)
            intrinsic = np.asarray(data['camera_intrinsic'][index],
                                   np.float32) * img_scale
            intrinsic[2, 2] = 1.0
            if move_center:
                h_i, w_i = img.shape[:2]
                img = _bilinear_shift(img, w_i * 0.5 - intrinsic[0, 2],
                                      h_i * 0.5 - intrinsic[1, 2])
                intrinsic[0, 2] = 0.5 * w_i
                intrinsic[1, 2] = 0.5 * h_i
            images.append(img / 255.0)
            times.append((int(data['frame_id'][f_id]) - id_min) / fid_max)
            time_ids.append(f_id)
            camera_ids.append(k)
            if len(poses) < len(camera_indies):
                rot = np.asarray(data['camera_rotation'][index], np.float32)
                trans = np.asarray(data['camera_translation'][index],
                                   np.float32) / coordinate_scale
                pose = np.concatenate(
                    [np.concatenate([rot, trans], axis=-1),
                     np.asarray([[0, 0, 0, 1]], np.float32)], axis=0)
                poses.append(np.linalg.inv(pose))
                intrinsics.append(intrinsic)
    images = np.stack(images)
    time_ids = np.unique(np.asarray(time_ids), return_inverse=True)[1]
    camera_ids = np.asarray(camera_ids)
    poses = np.stack(poses)          # [C, 4, 4] Tv2w, COLMAP already
    intrinsics = np.stack(intrinsics)
    h, w = images.shape[1:3]
    # each camera's own projection from its raw intrinsics (fx != fy, the
    # principal point off the centre without move_center)
    fx, fy = intrinsics[:, 0, 0], intrinsics[:, 1, 1]
    cx, cy = intrinsics[:, 0, 2], intrinsics[:, 1, 2]
    Tv2c_cams = perspective_pp((w, h), fx, fy, cx, cy, n=near, f=far)
    fovx = float(focal_to_fov(float(fx.mean()), w))
    meta = SceneMeta(background_type=background, near=near, far=far,
                     scene=scene)
    return build_scene(images, poses[camera_ids], fovx,
                       np.asarray(times, np.float32), meta,
                       camera_ids=camera_ids, time_ids=time_ids,
                       Tv2c=Tv2c_cams[camera_ids],
                       tan_fovx=(w / (2.0 * fx))[camera_ids],
                       tan_fovy=(h / (2.0 * fy))[camera_ids], device=device)
