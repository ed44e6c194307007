"""COLMAP static scenes (port of ``sk_gs_tpu/data/colmap.py``): the sparse
reconstruction in text (``*.txt``) or binary (``*.bin``) form, cameras
PINHOLE / SIMPLE_PINHOLE / SIMPLE_RADIAL (the first parameter is the
focal), every ``llffhold``-th image (sorted by name) held out for the test
split, and the seed point cloud (``points3D``) for the first Gaussians.
Real COLMAP scenes ship JPEG images; ``load_images`` reads JPEG and PNG
files by their first bytes.
"""
from __future__ import annotations

import struct
from pathlib import Path
from typing import Dict, Tuple

import numpy as np
import torch

from ..ops import quaternion as quat_ops
from ..ops.transforms import focal_to_fov
from .base import Scene, SceneMeta, build_scene
from .dnerf import load_images


def _read_cameras_txt(path: Path) -> Dict[int, dict]:
    cams = {}
    for line in path.read_text().splitlines():
        if line.startswith('#') or not line.strip():
            continue
        parts = line.split()
        cam_id, model, w, h = int(parts[0]), parts[1], int(parts[2]), int(parts[3])
        params = [float(p) for p in parts[4:]]
        cams[cam_id] = {'model': model, 'width': w, 'height': h,
                        'params': params}
    return cams


def _read_images_txt(path: Path):
    images = []
    # keep blank lines: each image line is FOLLOWED by its (possibly empty)
    # 2D-points line, so the stride-2 walk must see both
    lines = [l for l in path.read_text().splitlines()
             if not l.startswith('#')]
    for i in range(0, len(lines) - 1, 2):
        if not lines[i].strip():
            continue
        parts = lines[i].split()
        qw, qx, qy, qz = (float(p) for p in parts[1:5])
        t = np.asarray([float(p) for p in parts[5:8]], np.float32)
        images.append({'q_wxyz': (qw, qx, qy, qz), 't': t,
                       'camera_id': int(parts[8]), 'name': parts[9]})
    return images


def _read_points3d_txt(path: Path):
    pts, cols = [], []
    for line in path.read_text().splitlines():
        if line.startswith('#') or not line.strip():
            continue
        parts = line.split()
        pts.append([float(p) for p in parts[1:4]])
        cols.append([int(c) / 255.0 for c in parts[4:7]])
    return np.asarray(pts, np.float32), np.asarray(cols, np.float32)


def _read_cameras_bin(path: Path) -> Dict[int, dict]:
    models = {0: ('SIMPLE_PINHOLE', 3), 1: ('PINHOLE', 4),
              2: ('SIMPLE_RADIAL', 4), 3: ('RADIAL', 5), 4: ('OPENCV', 8)}
    cams = {}
    with path.open('rb') as f:
        n = struct.unpack('<Q', f.read(8))[0]
        for _ in range(n):
            cam_id, model_id, w, h = struct.unpack('<iiQQ', f.read(24))
            name, np_ = models[model_id]
            params = struct.unpack(f'<{np_}d', f.read(8 * np_))
            cams[cam_id] = {'model': name, 'width': w, 'height': h,
                            'params': list(params)}
    return cams


def _read_images_bin(path: Path):
    images = []
    with path.open('rb') as f:
        n = struct.unpack('<Q', f.read(8))[0]
        for _ in range(n):
            _img_id = struct.unpack('<i', f.read(4))[0]
            qw, qx, qy, qz, tx, ty, tz = struct.unpack('<7d', f.read(56))
            cam_id = struct.unpack('<i', f.read(4))[0]
            name = b''
            while True:
                c = f.read(1)
                if c == b'\x00':
                    break
                name += c
            n2d = struct.unpack('<Q', f.read(8))[0]
            f.read(24 * n2d)
            images.append({'q_wxyz': (qw, qx, qy, qz),
                           't': np.asarray([tx, ty, tz], np.float32),
                           'camera_id': cam_id, 'name': name.decode()})
    return images


def _read_points3d_bin(path: Path):
    pts, cols = [], []
    with path.open('rb') as f:
        n = struct.unpack('<Q', f.read(8))[0]
        for _ in range(n):
            _pid = struct.unpack('<Q', f.read(8))[0]
            xyz = struct.unpack('<3d', f.read(24))
            rgb = struct.unpack('<3B', f.read(3))
            f.read(8)  # error
            track_len = struct.unpack('<Q', f.read(8))[0]
            f.read(8 * track_len)
            pts.append(xyz)
            cols.append([c / 255.0 for c in rgb])
    return np.asarray(pts, np.float32), np.asarray(cols, np.float32)


def load_colmap(root: str, images_dir: str = 'images',
                downscale: float = 1, background: str = 'black',
                llffhold: int = 8, split: str = 'train',
                near: float = 0.01, far: float = 100.0, device='cuda'
                ) -> Tuple[Scene, SceneMeta, np.ndarray, np.ndarray]:
    """(scene, meta, the point cloud's points [n, 3], colours [n, 3])."""
    root = Path(root)
    sparse = root / 'sparse' / '0'
    if not sparse.exists():
        sparse = root / 'sparse'
    if (sparse / 'cameras.txt').exists():
        cams = _read_cameras_txt(sparse / 'cameras.txt')
        images = _read_images_txt(sparse / 'images.txt')
        pts, cols = _read_points3d_txt(sparse / 'points3D.txt')
    else:
        cams = _read_cameras_bin(sparse / 'cameras.bin')
        images = _read_images_bin(sparse / 'images.bin')
        pts, cols = _read_points3d_bin(sparse / 'points3D.bin')
    images = sorted(images, key=lambda im: im['name'])
    if llffhold > 0:
        images = [im for i, im in enumerate(images)
                  if (i % llffhold != 0) == (split == 'train')]
    Tv2w_list, fovx = [], None
    for im in images:
        cam = cams[im['camera_id']]
        fovx = float(focal_to_fov(cam['params'][0] / downscale,
                                  round(cam['width'] / downscale)))
        qw, qx, qy, qz = im['q_wxyz']
        # COLMAP stores world -> camera as (w, x, y, z); ours is (x, y, z, w)
        R = quat_ops.to_matrix(torch.tensor([qx, qy, qz, qw],
                                            dtype=torch.float32)).numpy()
        Tw2v = np.eye(4, dtype=np.float32)
        Tw2v[:3, :3] = R
        Tw2v[:3, 3] = im['t']
        Tv2w_list.append(np.linalg.inv(Tw2v))
    imgs = load_images([root / images_dir / im['name'] for im in images],
                       downscale)[..., :3]
    meta = SceneMeta(background_type=background, near=near, far=far,
                     scene=root.name)
    scene, meta = build_scene(imgs, np.stack(Tv2w_list), fovx,
                              np.zeros(len(imgs), np.float32), meta,
                              device=device)
    return scene, meta, pts, cols
