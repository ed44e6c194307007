"""Watch-It-Move scenes (port of ``load_wim``, ``sk_gs_tpu/data/wim.py``):
20 cameras, ``cam_{idx:03d}.json`` with a transposed OpenGL ``cam2world``
and pinhole intrinsics (fx = fy); cameras {0, 10} test, the rest train;
``frame_{fid:05d}_cam_{cid:03d}.png`` over ``frame_ranges``, frame-major,
each view with its frame index (``time_ids``) and its camera's place in
the split (``camera_ids``); RGBA over white.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Sequence, Tuple

import numpy as np

from ..ops.transforms import convert_coord_system, focal_to_fov
from .base import Scene, SceneMeta, build_scene
from .dnerf import load_images


def load_wim(root: str, scene: str, split: str = 'train',
             downscale: float = 1, background: str = 'white',
             test_cameras: Sequence[int] = (0, 10),
             frame_ranges: Tuple[int, int] = (0, 50),
             coord_src: str = 'opengl', coord_dst: str = 'colmap',
             near: float = 0.01, far: float = 100.0, device='cuda'
             ) -> Tuple[Scene, SceneMeta]:
    scene_root = Path(root) / scene
    camera_indices = [i for i in range(20)
                      if (i not in test_cameras) == (split == 'train')]
    Tv2w_list, size, focal = [], None, None
    for cam_idx in camera_indices:
        with (scene_root / f'cam_{cam_idx:03d}.json').open() as f:
            info = json.load(f)['camera_data']
        Tv2w_list.append(np.asarray(info['cam2world'], np.float32).T)
        size = (info['width'], info['height'])
        focal = info['intrinsics']['fx']
    fovx = float(focal_to_fov(focal, size[0]))
    Tv2w_cams = convert_coord_system(np.stack(Tv2w_list), coord_src,
                                     coord_dst, inverse=True)
    paths, Tv2w, times, time_ids, camera_ids = [], [], [], [], []
    for i, fid in enumerate(range(*frame_ranges)):
        for k, cid in enumerate(camera_indices):
            paths.append(scene_root / f'frame_{fid:05d}_cam_{cid:03d}.png')
            Tv2w.append(Tv2w_cams[k])
            times.append((fid - frame_ranges[0])
                         / (frame_ranges[1] - frame_ranges[0]))
            time_ids.append(i)
            camera_ids.append(k)
    meta = SceneMeta(background_type=background, near=near, far=far,
                     scene=scene)
    return build_scene(load_images(paths, downscale), np.stack(Tv2w), fovx,
                       np.asarray(times, np.float32), meta,
                       camera_ids=np.asarray(camera_ids),
                       time_ids=np.asarray(time_ids), device=device)
