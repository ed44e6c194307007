"""Synthetic articulated scene (port of ``make_chain_gt``,
``gt_frame_gaussians``, ``orbit_views`` and ``make_synthetic_scene`` of
``sk_gs_tpu/data/synthetic.py``).

A kinematic chain of rigid Gaussian clusters swings over time; each frame
is rendered by the port's own renderer from one camera of an orbit (the
D-NeRF monocular protocol) and packed into a ``Scene``. The random draws
are the JAX package's, in the same order, so one seed gives the same scene.
"""
from __future__ import annotations

import shutil
from pathlib import Path
from typing import NamedTuple, Tuple

import numpy as np
import torch

from .. import resolve_device
from ..ops import quaternion as quat
from ..ops import se3
from ..ops.transforms import look_at, perspective_opencv
from ..render.render import composite_background, render
from ..render.settings import GaussianInputs, RasterConfig, ViewParams
from .base import DYNAMIC_BG, Scene, SceneMeta, build_scene, fovx_to_fovy


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


def cache_key(seed: int, num_links: int, gauss_per_link: int,
              num_frames: int, h: int, w: int, background: str,
              detail: bool) -> str:
    """The name of a scene's ground truth in a cache directory (the JAX
    package's, so either package reads what the other wrote)."""
    return (f'chain_s{seed}_l{num_links}_g{gauss_per_link}_f{num_frames}'
            f'_{h}x{w}_{background}' + ('_detail' if detail else ''))


@torch.no_grad()
def make_synthetic_scene(seed: int = 0, num_links: int = 3,
                         gauss_per_link: int = 120, num_frames: int = 24,
                         h: int = 64, w: int = 64, background: str = 'white',
                         pair_capacity: int = 2 ** 16, chunk: int = 64,
                         detail: bool = False, cache_dir=None, device='cuda'
                         ) -> Tuple[Scene, SceneMeta, ArticulatedGT]:
    """Render the chain from an orbit, one camera per frame, on ``device``
    (CUDA unless asked otherwise: the blend kernel on the card, its plain
    version on the CPU). Raises if a frame overflows ``pair_capacity``,
    since dropped pairs would corrupt the ground truth. A background
    composited per step (``DYNAMIC_BG``) gets unpremultiplied RGBA frames.

    ``cache_dir``: the frames are kept there as ``<cache_key>.npz``, and
    each rendered frame as ``<cache_key>.frames/f<frame>.npy`` until the
    ``.npz`` is written, so that a restart renders only what is missing."""
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    gt = make_chain_gt(rng, num_links, gauss_per_link, num_frames,
                       detail=detail)
    Tv2w, fovx = orbit_views(num_frames, h=h, w=w)
    fovy = fovx_to_fovy(fovx, w / h)
    meta = SceneMeta(background_type=background, near=0.5, far=20.0,
                     scene='synthetic_chain')
    times = np.linspace(0, 1, num_frames).astype(np.float32)
    cache = frame_dir = None
    if cache_dir is not None:
        key = cache_key(seed, num_links, gauss_per_link, num_frames, h, w,
                        background, detail)
        cache = Path(cache_dir) / f'{key}.npz'
        if cache.exists():
            with np.load(cache) as z:
                images = z['images']
            scene, meta = build_scene(images, Tv2w, fovx, times, meta,
                                      device=device)
            return scene, meta, gt
        frame_dir = Path(cache_dir) / f'{key}.frames'
        frame_dir.mkdir(parents=True, exist_ok=True)
    cfg = RasterConfig(image_width=w, image_height=h, sh_degree=0,
                       pair_capacity=pair_capacity, chunk=chunk)
    dynamic = background in DYNAMIC_BG
    bg = torch.ones(3, device=device) if background == 'white' else \
        torch.zeros(3, device=device)
    Tv2c = perspective_opencv(fovy, size=(w, h), n=meta.near, f=meta.far,
                              device=device)
    tan = lambda a: torch.tensor(np.tan(a / 2), dtype=torch.float32,
                                 device=device)
    images = []
    for fr in range(num_frames):
        fpath = None if frame_dir is None else frame_dir / f'f{fr:04d}.npy'
        if fpath is not None and fpath.exists():
            images.append(np.load(fpath))
            continue
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
        if dynamic:
            # unpremultiplied RGBA: the trainer composites the rendered
            # scene over each step's background
            a = out['opacity']
            rgb = out['images'] / torch.clamp(a, 1e-6, 1.0)[..., None]
            img = torch.cat([rgb, a[..., None]], dim=-1)
        else:
            img = composite_background(out['images'], out['opacity'], bg)
        img = img.cpu().numpy()
        if fpath is not None:
            np.save(fpath, img)
        images.append(img)
    images = np.stack(images)
    if cache is not None:
        np.savez_compressed(cache, images=images)
        shutil.rmtree(frame_dir, ignore_errors=True)
    scene, meta = build_scene(images, Tv2w, fovx, times, meta, device=device)
    return scene, meta, gt
