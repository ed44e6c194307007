"""Scene container (port of ``Scene``, ``SceneMeta`` and ``build_scene`` of
``sk_gs_tpu/data/base.py``, for images over a solid background).

A split is one ``Scene`` of tensors on the training device: the images and
every view's camera, time and frame index. The background types that the
JAX package composites per step ('random', 'random2', 'reference',
'checker') are not ported and raise.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from .. import resolve_device
from ..ops.transforms import perspective_opencv
from ..render.settings import ViewParams

DYNAMIC_BG = ('random', 'random2', 'reference', 'checker')


class Scene(NamedTuple):
    """One split on one device."""
    images: torch.Tensor       # [F, H, W, 3] float32 in [0, 1]
    Tw2v: torch.Tensor         # [F, 4, 4]
    Tv2c: torch.Tensor         # [F, 4, 4]
    campos: torch.Tensor       # [F, 3]
    tan_fovx: torch.Tensor     # [F]
    tan_fovy: torch.Tensor     # [F]
    times: torch.Tensor        # [F] in [0, 1]
    time_ids: torch.Tensor     # [F] int64, frame index of each view
    camera_ids: torch.Tensor   # [F] int64

    @property
    def num_views(self) -> int:
        return self.images.shape[0]

    @property
    def image_size(self) -> Tuple[int, int]:
        return self.images.shape[2], self.images.shape[1]  # (W, H)

    def view(self, i) -> ViewParams:
        return ViewParams(Tw2v=self.Tw2v[i], Tv2c=self.Tv2c[i],
                          campos=self.campos[i], tan_fovx=self.tan_fovx[i],
                          tan_fovy=self.tan_fovy[i])

    def to(self, device) -> 'Scene':
        return Scene(*(x.to(device) for x in self))


@dataclass
class SceneMeta:
    """Host-side split metadata."""
    background_type: str = 'white'
    background: Optional[np.ndarray] = None   # [3] for a solid background
    cameras_extent: float = 1.0
    near: float = 0.01
    far: float = 100.0
    num_frames: int = 0
    scene: str = ''
    train_times: Optional[np.ndarray] = None  # [num_frames]


def solid_background(background_type: str) -> Optional[np.ndarray]:
    if background_type == 'white':
        return np.ones(3, np.float32)
    if background_type == 'black':
        return np.zeros(3, np.float32)
    if background_type == 'none':
        return None
    if background_type in DYNAMIC_BG:
        raise NotImplementedError(
            f'background {background_type!r} (composited per step) is not '
            'ported yet')
    raise NotImplementedError(f'background {background_type}')


def fovx_to_fovy(fovx: float, aspect: float) -> float:
    """aspect = W / H."""
    return 2.0 * math.atan(math.tan(fovx * 0.5) / aspect)


def build_scene(images: np.ndarray, Tv2w: np.ndarray, fovx: float,
                times: np.ndarray, meta: SceneMeta,
                camera_ids: Optional[np.ndarray] = None,
                time_ids: Optional[np.ndarray] = None,
                device='cuda') -> Tuple[Scene, SceneMeta]:
    """A Scene from [F, H, W, 3|4] float32 images, camera-to-world matrices
    and a shared horizontal field of view. RGBA images are composited over
    the solid background here."""
    device = resolve_device(device)
    f, h, w = images.shape[:3]
    fovy = fovx_to_fovy(fovx, w / h)
    Tw2v = np.linalg.inv(Tv2w).astype(np.float32)
    Tv2c = perspective_opencv(fovy, size=(w, h), n=meta.near, f=meta.far)
    campos = Tv2w[:, :3, 3].astype(np.float32)

    bg = solid_background(meta.background_type)
    if images.shape[-1] == 4:
        alpha = images[..., 3:4]
        rgb = images[..., :3]
        if bg is not None:
            rgb = rgb * alpha + bg * (1.0 - alpha)
        images = rgb
    meta.background = bg
    center = campos.mean(axis=0, keepdims=True)
    meta.cameras_extent = float(np.linalg.norm(campos - center, axis=-1).max()) \
        * 1.1
    meta.num_frames = int(len(np.unique(times)))
    if camera_ids is None:
        camera_ids = np.zeros(f, np.int64)
    if time_ids is None:
        time_ids = np.arange(f)
    meta.train_times = np.asarray(times[camera_ids == camera_ids[0]],
                                  np.float32)

    def put(x, dtype=torch.float32):
        return torch.as_tensor(np.asarray(x), dtype=dtype).to(device)

    scene = Scene(
        images=put(images),
        Tw2v=put(Tw2v),
        Tv2c=Tv2c.expand(f, 4, 4).contiguous().to(device),
        campos=put(campos),
        tan_fovx=put(np.full(f, np.tan(fovx * 0.5), np.float32)),
        tan_fovy=put(np.full(f, np.tan(fovy * 0.5), np.float32)),
        times=put(times),
        time_ids=put(time_ids, torch.int64),
        camera_ids=put(camera_ids, torch.int64),
    )
    return scene, meta
