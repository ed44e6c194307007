"""D-NeRF scenes (port of ``load_image`` and ``load_dnerf`` of
``sk_gs_tpu/data/dnerf.py``): ``transforms_{split}.json`` with the shared
``camera_angle_x`` and each frame's OpenGL ``transform_matrix`` (camera to
world) and ``time``, and ``<file_path>.png`` images, RGBA over white.

The images are decoded by the port's own readers, picked by each file's
first bytes (``utils/png.py:read_pngs``: PNG, or baseline JPEG through
``utils/jpeg.py``), and resized by its own copy of Pillow's bilinear
filter.
"""
from __future__ import annotations

import json
import os
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Sequence, Tuple

import numpy as np

from ..ops.transforms import convert_coord_system
from ..utils.png import read_png, read_pngs
from ..utils.resize import resize
from .base import Scene, SceneMeta, build_scene


def _as_loaded(img: np.ndarray, downscale: float) -> np.ndarray:
    if img.shape[2] == 1:
        img = img[..., 0]
    if downscale and downscale > 1:
        img = resize(img, (round(img.shape[1] / downscale),
                           round(img.shape[0] / downscale)))
    return img


def load_image(path, downscale: float = 1) -> np.ndarray:
    """uint8 [H, W, C] of an image file as ``np.asarray`` of the Pillow
    image gives it ([H, W] for greyscale), resized to round(W /
    downscale) x round(H / downscale) by Pillow's bilinear filter when
    ``downscale`` > 1."""
    return _as_loaded(read_png(path), downscale)


def load_images(paths: Sequence, downscale: float = 1) -> np.ndarray:
    """uint8 [F, ...] of ``load_image`` over ``paths``: the files decoded
    by ``read_pngs`` (PNG files several at a time, JPEG files on a thread
    pool), the resizes on a thread pool (numpy releases the interpreter
    lock in their long loops)."""
    imgs = read_pngs(paths)
    with ThreadPoolExecutor(min(len(imgs), os.cpu_count() or 1, 8) or 1) \
            as pool:
        return np.stack(list(pool.map(lambda x: _as_loaded(x, downscale),
                                      imgs)))


def load_dnerf(root: str, scene: str, split: str = 'train',
               downscale: float = 1, background: str = 'white',
               coord_src: str = 'opengl', coord_dst: str = 'colmap',
               near: float = 2.0, far: float = 6.0,
               num_frames_max: int = -1, device='cuda'
               ) -> Tuple[Scene, SceneMeta]:
    scene_root = Path(root) / scene
    with (scene_root / f'transforms_{split}.json').open() as f:
        meta_json = json.load(f)
    cams, paths, times = [], [], []
    frames = meta_json['frames']
    for i, frame in enumerate(frames):
        cams.append(np.asarray(frame['transform_matrix'], np.float32))
        paths.append(scene_root / (frame['file_path'] + '.png'))
        times.append(frame.get('time', i / max(len(frames) - 1, 1)))
    if num_frames_max > 0:
        cams, paths, times = (cams[:num_frames_max], paths[:num_frames_max],
                              times[:num_frames_max])
    fovx = float(meta_json['camera_angle_x'])
    # the conversion with inverse=True takes camera-to-world matrices
    Tv2w = convert_coord_system(np.stack(cams), coord_src, coord_dst,
                                inverse=True)
    meta = SceneMeta(background_type=background, near=near, far=far,
                     scene=scene)
    return build_scene(load_images(paths, downscale), Tv2w, fovx,
                       np.asarray(times, np.float32), meta, device=device)
