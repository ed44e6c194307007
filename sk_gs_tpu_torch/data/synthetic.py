"""Synthetic articulated scene (port of ``make_chain_gt``,
``gt_frame_gaussians``, ``orbit_views`` and ``make_synthetic_scene`` of
``sk_gs_tpu/data/synthetic.py``).

A kinematic chain of rigid Gaussian clusters swings over time; each frame
is rendered by the port's own renderer from one camera of an orbit (the
D-NeRF monocular protocol) and packed into a ``Scene``. The random draws
are the JAX package's, in the same order, so one seed gives the same scene.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from .. import resolve_device
from ..ops import quaternion as quat
from ..ops import se3
from ..ops.transforms import look_at, perspective_opencv
from ..render.render import composite_background, render
from ..render.settings import GaussianInputs, RasterConfig, ViewParams
from .base import Scene, SceneMeta, build_scene, fovx_to_fovy, solid_background


class ArticulatedGT(NamedTuple):
    """Ground truth: canonical Gaussians and per-frame link transforms."""
    means: np.ndarray        # [N, 3] canonical
    scales: np.ndarray       # [N, 3]
    rotations: np.ndarray    # [N, 4]
    opacities: np.ndarray    # [N]
    colors: np.ndarray       # [N, 3]
    link_of: np.ndarray      # [N] the chain link of each Gaussian
    link_T: np.ndarray       # [F, L, 7] per-frame SE3 of each link


def make_chain_gt(rng: np.random.Generator, num_links: int = 3,
                  gauss_per_link: int = 120, num_frames: int = 24,
                  swing: float = 0.6, detail: bool = False) -> ArticulatedGT:
    """A chain along +x whose link k swings about the joint at x = k L.
    ``detail`` gives every Gaussian its own random colour and ~3x smaller
    splats."""
    f32 = np.float32
    L = 0.8
    means, link_of, colors = [], [], []
    for k in range(num_links):
        c = rng.normal(size=(gauss_per_link, 3)).astype(f32) \
            * np.array([0.25, 0.12, 0.12], f32)
        c[:, 0] += k * L + L / 2
        means.append(c)
        link_of.append(np.full(gauss_per_link, k, np.int32))
        if detail:
            colors.append(rng.uniform(0.0, 1.0, size=(gauss_per_link, 3))
                          .astype(f32))
        else:
            base = rng.uniform(0.2, 1.0, size=3).astype(f32)
            colors.append(np.tile(base, (gauss_per_link, 1))
                          + rng.normal(size=(gauss_per_link, 3)).astype(f32)
                          * 0.05)
    means = np.concatenate(means) - np.array([num_links * L / 2, 0, 0], f32)
    link_of = np.concatenate(link_of)
    colors = np.clip(np.concatenate(colors), 0, 1)
    n = means.shape[0]
    log_scale = -4.2 if detail else -3.0
    scales = np.exp(rng.normal(size=(n, 3)).astype(f32) * 0.3 + log_scale)
    q = rng.normal(size=(n, 4)).astype(f32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    opac = rng.uniform(0.6, 0.95, size=n).astype(f32)

    # per-frame link transforms: FK down the chain, joint k at x = k L - off
    link_T = np.zeros((num_frames, num_links, 7), f32)
    off = num_links * L / 2
    z_axis = torch.tensor([0.0, 0.0, 1.0])
    for fr in range(num_frames):
        t = fr / max(num_frames - 1, 1)
        angle = swing * np.sin(2 * np.pi * t)
        running = se3.se3_identity(())
        for k in range(num_links):
            if k == 0:
                local = se3.se3_identity(())
            else:
                joint = torch.tensor([k * L - off, 0.0, 0.0])
                half = 0.5 * torch.tensor(angle * (k % 2 * 2 - 1),
                                          dtype=torch.float32)
                qk = torch.cat([z_axis * torch.sin(half),
                                torch.cos(half).reshape(1)])
                local = torch.cat([joint + quat.apply(qk, -joint), qk])
            running = se3.se3_mul(running, local)
            link_T[fr, k] = running.numpy()
    return ArticulatedGT(means, scales, q, opac, colors, link_of, link_T)


def gt_frame_gaussians(gt: ArticulatedGT, frame: int,
                       device='cpu') -> GaussianInputs:
    device = torch.device(device)
    T = torch.from_numpy(gt.link_T[frame][gt.link_of]).to(device)   # [N, 7]
    put = lambda x: torch.from_numpy(np.asarray(x)).to(device)
    return GaussianInputs(
        means3d=se3.se3_act(T, put(gt.means)), scales=put(gt.scales),
        rotations=quat.multiply(T[:, 3:7], put(gt.rotations)),
        opacities=put(gt.opacities), colors=put(gt.colors))


def orbit_views(num_views: int, radius: float = 4.0, h: int = 64, w: int = 64,
                fovy: float = 0.8, elevation: float = 0.35
                ) -> Tuple[np.ndarray, float]:
    """Camera-to-world matrices [F, 4, 4] on a circle about the origin,
    looking at it (OpenCV axes), and the horizontal field of view."""
    Tv2w = []
    fovx = 2 * np.arctan(np.tan(fovy / 2) * w / h)
    for i in range(num_views):
        ang = 2 * np.pi * i / num_views
        eye = np.array([radius * np.sin(ang), radius * np.sin(elevation),
                        -radius * np.cos(ang)], np.float32)
        Tw2v = look_at(eye, np.zeros(3, np.float32),
                       np.array([0.0, -1.0, 0.0], np.float32),
                       coord='opencv').numpy()
        Tv2w.append(np.linalg.inv(Tw2v))
    return np.stack(Tv2w), float(fovx)


@torch.no_grad()
def make_synthetic_scene(seed: int = 0, num_links: int = 3,
                         gauss_per_link: int = 120, num_frames: int = 24,
                         h: int = 64, w: int = 64, background: str = 'white',
                         pair_capacity: int = 2 ** 16, chunk: int = 64,
                         detail: bool = False, device='cuda'
                         ) -> Tuple[Scene, SceneMeta, ArticulatedGT]:
    """Render the chain from an orbit, one camera per frame, on ``device``
    (CUDA unless asked otherwise: the blend kernel on the card, its plain
    version on the CPU). Raises if a frame overflows ``pair_capacity``,
    since dropped pairs would corrupt the ground truth."""
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    gt = make_chain_gt(rng, num_links, gauss_per_link, num_frames,
                       detail=detail)
    Tv2w, fovx = orbit_views(num_frames, h=h, w=w)
    fovy = fovx_to_fovy(fovx, w / h)
    cfg = RasterConfig(image_width=w, image_height=h, sh_degree=0,
                       pair_capacity=pair_capacity, chunk=chunk)
    meta = SceneMeta(background_type=background, near=0.5, far=20.0,
                     scene='synthetic_chain')
    bg = torch.as_tensor(solid_background(background)).to(device) \
        if background != 'none' else None
    Tv2c = perspective_opencv(fovy, size=(w, h), n=meta.near, f=meta.far,
                              device=device)
    tan = lambda a: torch.tensor(np.tan(a / 2), dtype=torch.float32,
                                 device=device)
    images = []
    for fr in range(num_frames):
        view = ViewParams(
            Tw2v=torch.from_numpy(np.linalg.inv(Tv2w[fr]).astype(np.float32)
                                  ).to(device),
            Tv2c=Tv2c,
            campos=torch.from_numpy(Tv2w[fr, :3, 3].copy()).to(device),
            tan_fovx=tan(fovx), tan_fovy=tan(fovy))
        out = render(gt_frame_gaussians(gt, fr, device), view, cfg)
        if bool(out['overflow']):
            raise RuntimeError(
                f'GT render overflowed pair_capacity={pair_capacity} at '
                f'frame {fr}; raise the pair budget for this scene size')
        images.append(composite_background(out['images'], out['opacity'],
                                           bg).cpu().numpy())
    times = np.linspace(0, 1, num_frames).astype(np.float32)
    scene, meta = build_scene(np.stack(images), Tv2w, fovx, times, meta,
                              device=device)
    return scene, meta, gt
