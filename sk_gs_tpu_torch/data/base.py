"""Scene container (port of ``Scene``, ``SceneMeta``, the backgrounds and
``build_scene`` of ``sk_gs_tpu/data/base.py``).

A split is one ``Scene`` of tensors on the training device: the images and
every view's camera, time and frame index. RGBA images are composited over
a solid background at load; for the background types composited per step
('random', 'random2', 'reference', 'checker') they stay RGBA and the
trainer draws a background for each step (``sample_background``).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from .. import resolve_device
from ..ops.transforms import get_center_and_diag, perspective_opencv
from ..render.settings import ViewParams

# the background types composited per step (reference base.py:125-170)
DYNAMIC_BG = ('random', 'random2', 'reference', 'checker')


class Scene(NamedTuple):
    """One split on one device."""
    images: torch.Tensor       # [F, H, W, 3|4] float32 in [0, 1] (RGBA
                               # for the DYNAMIC_BG types)
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
    background: Optional[np.ndarray] = None   # [3] solid, [H, W, 3] checker
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
    if background_type == 'none' or background_type in DYNAMIC_BG:
        return None
    raise NotImplementedError(f'background {background_type}')


def image_checkerboard(h: int, w: int, size: int = 8) -> np.ndarray:
    """[H, W, 3] grey / white checkerboard of ``size``-pixel cells, grey
    first (the 'checker' background)."""
    yy, xx = np.mgrid[0:h, 0:w]
    cells = ((yy // size + xx // size) % 2).astype(np.float32)
    return np.repeat((0.5 + 0.5 * cells)[..., None], 3, axis=-1)


def sample_background(background_type: str, gen: torch.Generator, h: int,
                      w: int, checker: Optional[torch.Tensor] = None,
                      reference_rgb: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
    """[H, W, 3] background of one step, drawn from ``gen`` on its device:
    'random' a uniform colour a pixel, 'random2' one uniform colour,
    'reference' the ground truth's RGB itself, 'checker' the board."""
    if background_type == 'random':
        return torch.rand((h, w, 3), generator=gen, device=gen.device)
    if background_type == 'random2':
        return torch.rand((1, 1, 3), generator=gen,
                          device=gen.device).expand(h, w, 3)
    if background_type == 'reference':
        return reference_rgb
    if background_type == 'checker':
        return checker
    raise NotImplementedError(f'dynamic background {background_type}')


def fovx_to_fovy(fovx: float, aspect: float) -> float:
    """aspect = W / H."""
    return 2.0 * math.atan(math.tan(fovx * 0.5) / aspect)


def build_scene(images, Tv2w: np.ndarray, fovx: float, times: np.ndarray,
                meta: SceneMeta, camera_ids: Optional[np.ndarray] = None,
                time_ids: Optional[np.ndarray] = None,
                Tv2c: Optional[np.ndarray] = None,
                tan_fovx: Optional[np.ndarray] = None,
                tan_fovy: Optional[np.ndarray] = None,
                device='cuda') -> Tuple[Scene, SceneMeta]:
    """A Scene on ``device`` from [F, H, W, 3|4] images (uint8, divided by
    255 on the device, or float32 in [0, 1]), camera-to-world matrices and
    a shared horizontal field of view; ``Tv2c`` [F, 4, 4], ``tan_fovx`` and
    ``tan_fovy`` [F] replace the projection that fov gives, view by view.
    RGBA images are composited over a solid background here and kept for
    the ``DYNAMIC_BG`` types."""
    device = resolve_device(device)
    f, h, w = images.shape[:3]
    fovy = fovx_to_fovy(fovx, w / h)
    Tw2v = np.linalg.inv(Tv2w).astype(np.float32)
    campos = Tv2w[:, :3, 3].astype(np.float32)

    def put(x, dtype=torch.float32):
        return torch.as_tensor(np.asarray(x), dtype=dtype).to(device)

    imgs = torch.as_tensor(np.asarray(images)).to(device)
    if imgs.dtype == torch.uint8:
        imgs = imgs.to(torch.float32) / 255.0
    bg = solid_background(meta.background_type)
    dynamic = meta.background_type in DYNAMIC_BG
    if imgs.shape[-1] == 4 and not dynamic:
        alpha = imgs[..., 3:4]
        rgb = imgs[..., :3]
        if bg is not None:
            rgb = rgb * alpha + torch.as_tensor(bg).to(device) * (1.0 - alpha)
        imgs = rgb.contiguous()
    if meta.background_type == 'checker':
        meta.background = image_checkerboard(h, w)
    elif not dynamic:
        meta.background = bg

    _, diag = get_center_and_diag(campos)
    meta.cameras_extent = diag * 1.1
    meta.num_frames = int(len(np.unique(times)))
    if camera_ids is None:
        camera_ids = np.zeros(f, np.int64)
    if time_ids is None:
        time_ids = np.arange(f)
    meta.train_times = np.asarray(times[camera_ids == camera_ids[0]],
                                  np.float32)
    if Tv2c is None:
        Tv2c = perspective_opencv(fovy, size=(w, h), n=meta.near,
                                  f=meta.far).expand(f, 4, 4)
    scene = Scene(
        images=imgs.to(torch.float32),
        Tw2v=put(Tw2v),
        Tv2c=put(Tv2c),
        campos=put(campos),
        tan_fovx=put(np.full(f, np.tan(fovx * 0.5), np.float32)
                     if tan_fovx is None else tan_fovx),
        tan_fovy=put(np.full(f, np.tan(fovy * 0.5), np.float32)
                     if tan_fovy is None else tan_fovy),
        times=put(times),
        time_ids=put(time_ids, torch.int64),
        camera_ids=put(camera_ids, torch.int64),
    )
    return scene, meta
