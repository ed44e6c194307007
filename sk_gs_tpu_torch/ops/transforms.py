"""Camera builders (port of ``sk_gs_tpu/ops/transforms.py``: the
projection and ``look_at`` on tensors, and the loaders' conversions on
numpy arrays)."""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch


def perspective_opencv(fovy: float, aspect: float = 1.0, n: float = 0.1,
                       f: float = 1000.0, size: Optional[Tuple[int, int]] = None,
                       dtype=torch.float32, device=None) -> torch.Tensor:
    """OpenCV-convention clip-space projection Tv2c (z forward, y down)."""
    if size is not None:
        aspect = size[0] / size[1]
    y = torch.tan(torch.as_tensor(fovy, dtype=dtype, device=device) * 0.5)
    x = y * aspect
    P = torch.zeros((4, 4), dtype=dtype, device=device)
    P[0, 0] = 1.0 / x
    P[1, 1] = 1.0 / y
    P[2, 2] = (f + n) / (f - n)
    P[2, 3] = -(2.0 * f * n) / (f - n)
    P[3, 2] = 1.0
    return P


def look_at(eye, at, up, coord: str = 'opengl', device=None) -> torch.Tensor:
    """World->view Tw2v; opengl looks down -z, opencv down +z with y down."""
    eye, at, up = (torch.as_tensor(v, dtype=torch.float32, device=device)
                   for v in (eye, at, up))
    fwd = at - eye
    fwd = fwd / torch.linalg.norm(fwd, dim=-1, keepdim=True)
    if coord in ('opencv', 'colmap'):
        z = fwd
        x = -torch.linalg.cross(z, up / torch.linalg.norm(up, dim=-1, keepdim=True))
        x = x / torch.linalg.norm(x, dim=-1, keepdim=True)
        y = torch.linalg.cross(z, x)
    else:
        z = -fwd
        x = torch.linalg.cross(up, z)
        x = x / torch.linalg.norm(x, dim=-1, keepdim=True)
        y = torch.linalg.cross(z, x)
    R = torch.stack([x, y, z], dim=-2)
    t = -torch.einsum('...ij,...j->...i', R, eye)
    Tw2v = torch.zeros((*eye.shape[:-1], 4, 4), dtype=torch.float32,
                       device=device)
    Tw2v[..., :3, :3] = R
    Tw2v[..., :3, 3] = t
    Tw2v[..., 3, 3] = 1.0
    return Tw2v


# ------------------------------------------------------------ at load time
# The loaders' camera maths, on numpy arrays on the host (the JAX package's
# ``ops/transforms.py:17-76, 127-150, 206-213``).

# 'colmap' is an alias for 'opencv'
COORDINATE_ALIASES = {
    'opengl': 'opengl', 'blender': 'blender', 'colmap': 'opencv',
    'opencv': 'opencv', 'llff': 'llff', 'pytorch3d': 'pytorch3d',
}

_CONVERT_MATRIX = {
    'opengl': {
        'blender': [[1., 0, 0, 0], [0, 0, -1., 0], [0, 1., 0, 0], [0, 0, 0, 1.]],
        'opencv': [[1., 0, 0, 0], [0, -1., 0, 0], [0, 0, -1., 0], [0, 0, 0, 1.]],
        'llff': [[0, -1., 0, 0], [1., 0, 0, 0], [0, 0, 1., 0], [0, 0, 0, 1.]],
        'pytorch3d': [[0, 0, -1., 0], [0, 1., 0, 0], [1., 0, 0, 0], [0, 0, 0, 1.]],
    },
    'blender': {
        'opengl': [[1., 0, 0, 0], [0, 0, 1., 0], [0, -1., 0, 0], [0, 0, 0, 1.]],
        'opencv': [[1., 0, 0, 0], [0, 0, -1., 0], [0, 1., 0, 0], [0, 0, 0, 1.]],
    },
    'opencv': {
        'opengl': [[1., 0, 0, 0], [0, -1., 0, 0], [0, 0, -1., 0], [0, 0, 0, 1.]],
        'blender': [[1., 0, 0, 0], [0, 0, 1., 0], [0, -1., 0, 0], [0, 0, 0, 1.]],
    },
}


def _canon(name: str) -> str:
    return COORDINATE_ALIASES[name.lower()]


def convert_coord_system(T: np.ndarray, src: str = 'opengl',
                         dst: str = 'opengl', inverse: bool = False
                         ) -> np.ndarray:
    """A camera matrix (Tw2v, or Tv2w with ``inverse``) [..., 4, 4] from
    convention ``src`` to ``dst``; the matrix multiplies on the other side
    when either is OpenCV."""
    src, dst = _canon(src), _canon(dst)
    if src == dst:
        return T
    M = np.asarray(_CONVERT_MATRIX[src][dst] if inverse
                   else _CONVERT_MATRIX[dst][src], dtype=T.dtype)
    if dst == 'opencv' or src == 'opencv':
        return T @ M if inverse else M @ T
    return M @ T if inverse else T @ M


def focal_to_fov(focal, size):
    return 2.0 * np.arctan2(size, 2.0 * focal)


def perspective_pp(size: Tuple[int, int], fx, fy, cx=None, cy=None,
                   n: float = 0.1, f: float = 1000.0) -> np.ndarray:
    """[..., 4, 4] float32 OpenCV-convention projection from raw
    intrinsics: per-camera focals and a principal point that may be off
    the centre (``ops_3d.perspective2``; the pickled ZJU-MoCap cameras)."""
    W, H = size
    f32 = lambda v: np.asarray(v, np.float32)
    fx, fy = f32(fx), f32(fy)
    cx = f32(W / 2 if cx is None else cx)
    cy = f32(H / 2 if cy is None else cy)
    shape = np.broadcast_shapes(fx.shape, fy.shape, cx.shape, cy.shape)
    P = np.zeros((*shape, 4, 4), np.float32)
    P[..., 0, 0] = 2.0 * fx / W
    P[..., 1, 1] = 2.0 * fy / H
    P[..., 0, 2] = (2.0 * cx - W) / W
    P[..., 1, 2] = (2.0 * cy - H) / H
    P[..., 2, 2] = (f + n) / (f - n)
    P[..., 2, 3] = -(2.0 * f * n) / (f - n)
    P[..., 3, 2] = 1.0
    return P


def get_center_and_diag(cam_centers: np.ndarray) -> Tuple[np.ndarray, float]:
    """The mean camera centre [3] and the largest distance of a camera from
    it (Inria's rule for ``cameras_extent``)."""
    cam_centers = np.asarray(cam_centers)
    center = cam_centers.mean(axis=0, keepdims=True)
    diagonal = float(np.linalg.norm(cam_centers - center, axis=-1).max())
    return center.reshape(3), diagonal
