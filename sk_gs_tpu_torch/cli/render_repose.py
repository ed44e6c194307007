"""Render a trained SK-GS checkpoint reposed: a camera orbit, a time
sweep and per-joint pose edits, to PNG frames (port of the JAX package's
``render_repose.py``).

    python -m sk_gs_tpu_torch.cli.render_repose -c <config.yaml> \\
        --load <ckpt.npz> --out frames/ --num-frames 60 [--orbit] \\
        [--time-sweep] [--pose-json poses.json] [--device cpu]

``--pose-json``: ``{"joint_deltas": [[wx, wy, wz], ...]}`` (an so3 log per
joint) or a list of such keyframes, interpolated linearly over the frames
and resized to [M, 3] (``np.resize``: repeated or cut). Each frame renders
the ``sk`` stage at t (0, or swept over [0, 1]) with the joints' rotations
reposed by the delta (``sk_r_delta``), from camera 0 of the scene or from
its orbit about the origin, composited on white, into
``frame_XXXX.png``. The model is built at the checkpoint's capacity.
"""
from __future__ import annotations

import argparse
import json
import logging
import time
from pathlib import Path

import numpy as np
import torch

from .. import resolve_device
from ..convert import model_from_flat
from ..framework import build
from ..framework.checkpoint import capacity_of, load
from ..framework.config import make_config
from ..models.gaussian_splatting import gaussian_inputs
from ..models.sk_gs import forward_deltas
from ..ops.transforms import look_at
from ..render.render import composite_background, render
from ..utils.png import write_png

log = logging.getLogger('sk_gs_tpu_torch.render_repose')


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('-c', '--config', required=True)
    ap.add_argument('--load', required=True)
    ap.add_argument('--out', default='repose_frames')
    ap.add_argument('--num-frames', type=int, default=60)
    ap.add_argument('--orbit', action='store_true',
                    help='orbit the camera around the scene')
    ap.add_argument('--time-sweep', action='store_true',
                    help='animate t over [0, 1]')
    ap.add_argument('--pose-json', default=None)
    ap.add_argument('--set', nargs='*', default=[], dest='overrides')
    ap.add_argument('--device', default='cuda')
    return ap.parse_args(argv)


def load_poses(path) -> np.ndarray:
    """[K, J, 3] keyframes of a pose file (one keyframe or a list)."""
    with open(path) as f:
        pj = json.load(f)
    key = pj['joint_deltas'] if isinstance(pj, dict) else [
        k['joint_deltas'] if isinstance(k, dict) else k for k in pj]
    poses = np.asarray(key, np.float32)
    return poses[None] if poses.ndim == 2 else poses


def frame_delta(poses, frac: float, m: int) -> np.ndarray:
    """The [m, 3] delta at ``frac`` in [0, 1] along the keyframes."""
    kf = frac * (len(poses) - 1)
    k0 = int(np.floor(kf))
    k1 = min(k0 + 1, len(poses) - 1)
    w = kf - k0
    return np.resize((1 - w) * poses[k0] + w * poses[k1], (m, 3))


@torch.no_grad()
def render_frame(model, view, t, sk_r_delta: torch.Tensor) -> torch.Tensor:
    """The ``sk`` stage at t reposed by ``sk_r_delta``, on white."""
    cfg = model.cfg
    d = forward_deltas(cfg, model, t, 'sk', sk_r_delta=sk_r_delta,
                       training=False)
    g = gaussian_inputs(model.gauss_view(), cfg.gauss, d.d_xyz,
                        d.d_rotation, d.d_scaling)
    out = render(g, view, model.rcfg, active_sh_degree=model.active_sh_degree)
    return composite_background(out['images'], out['opacity'],
                                torch.ones(3, device=model.device))


def main(argv=None):
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    device = resolve_device(args.device)
    cfg = make_config(args.config, args.overrides)
    scene, meta, _, _pcd = build.build_scene(cfg, device)
    skcfg, rcfg = build.build_model_cfg(cfg, meta, scene.image_size)
    skcfg = skcfg._replace(gauss=skcfg.gauss._replace(
        capacity=capacity_of(args.load)))
    model = model_from_flat(load(args.load), skcfg, rcfg, device)
    poses = load_poses(args.pose_json) if args.pose_json else None
    m = skcfg.num_superpoints

    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    base_view = scene.view(0)
    campos0 = scene.campos[0].cpu().numpy()
    radius = float(np.linalg.norm(campos0))
    paths, seconds = [], []
    for i in range(args.num_frames):
        frac = i / max(args.num_frames - 1, 1)
        t = torch.tensor(frac if args.time_sweep else 0.0, device=device)
        view = base_view
        if args.orbit:
            ang = 2 * np.pi * frac
            eye = torch.tensor([radius * np.sin(ang), campos0[1],
                                -radius * np.cos(ang)], dtype=torch.float32,
                               device=device)
            view = base_view._replace(
                Tw2v=look_at(eye, [0.0, 0.0, 0.0], [0.0, -1.0, 0.0],
                             coord='opencv', device=device),
                campos=eye)
        delta = torch.zeros((m, 3), device=device) if poses is None else \
            torch.as_tensor(frame_delta(poses, frac, m), device=device)
        t0 = time.perf_counter()
        img = render_frame(model, view, t, delta).cpu().numpy()
        paths.append(write_png(out_dir / f'frame_{i:04d}.png', img))
        seconds.append(time.perf_counter() - t0)
    log.info('wrote %d frames to %s', args.num_frames, out_dir)
    # each frame's seconds: its render, the copy to the host and the PNG
    return {'paths': paths, 'seconds': seconds}


if __name__ == '__main__':
    main()
