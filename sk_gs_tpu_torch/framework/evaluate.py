"""Serving: render a trained SK-GS model at (camera, t), and score a list of
requests (port of the eval body of ``sk_gs_tpu/framework/trainer.py``:
``_render_eval_fn`` :1570-1595 and ``_eval_sums_fn`` :1540-1568)."""
from __future__ import annotations

import time
from typing import Dict, Optional, Sequence

import torch

from ..models.gaussian_splatting import gaussian_inputs
from ..models.losses import psnr, ssim
from ..models.sk_gs import SKGSModel, forward_deltas
from ..render.render import composite_background, render
from ..render.settings import RasterConfig, ViewParams


def _sync(device: torch.device):
    if device.type == 'cuda':
        torch.cuda.synchronize(device)


@torch.no_grad()
def render_eval(model: SKGSModel, view: ViewParams, t, bg,
                stage: str = 'sk', rcfg: Optional[RasterConfig] = None
                ) -> Dict[str, torch.Tensor]:
    """Render ``model`` from ``view`` at time ``t`` and composite it over
    ``bg``. Returns the render dict plus 'image' [H, W, 3], the composite.
    ``rcfg`` overrides the model's raster config (e.g. ``use_kernel``)."""
    dev = model.device
    t = torch.as_tensor(t, dtype=torch.float32, device=dev)
    out_def = forward_deltas(model.cfg, model, t, stage, time_id=None,
                             training=False)
    g = gaussian_inputs(model.gauss_view(), model.cfg.gauss,
                        d_xyz=out_def.d_xyz, d_rotation=out_def.d_rotation,
                        d_scaling=out_def.d_scaling)
    out = render(g, view, rcfg or model.rcfg,
                 active_sh_degree=model.active_sh_degree)
    out['image'] = composite_background(out['images'], out['opacity'], bg)
    return out


@torch.no_grad()
def evaluate(model: SKGSModel, views: Sequence[ViewParams], images, times,
             bg, stage: str = 'sk', rcfg: Optional[RasterConfig] = None
             ) -> Dict:
    """Serve one render per (view, image, t) request and score it.

    Returns PSNR and SSIM summed over the requests (as the JAX eval does),
    the request count, frames per second over the render time, and per
    request the render time in ms (host clock around a synchronised
    render), the pairs emitted and whether the pair capacity overflowed.
    """
    dev = model.device
    bg_t = torch.as_tensor(bg, dtype=torch.float32, device=dev)
    psnr_sum = torch.zeros((), device=dev)
    ssim_sum = torch.zeros((), device=dev)
    requests = []
    render_s = 0.0
    for view, gt, t in zip(views, images, times):
        _sync(dev)
        t0 = time.perf_counter()
        out = render_eval(model, view, t, bg_t, stage, rcfg)
        _sync(dev)
        dt = time.perf_counter() - t0
        render_s += dt
        img = out['image']
        gt = torch.as_tensor(gt, dtype=torch.float32, device=dev)
        if gt.shape[-1] == 4:
            a = gt[..., 3:4]
            gt = gt[..., :3] * a + bg_t * (1.0 - a)
        psnr_sum += psnr(img, gt)
        ssim_sum += ssim(img[..., :3], gt[..., :3])
        requests.append({'ms': dt * 1e3, 'num_pairs': int(out['num_pairs']),
                         'overflow': bool(out['overflow'])})
    n = len(requests)
    return {'PSNR': float(psnr_sum), 'SSIM': float(ssim_sum), 'count': n,
            'fps': n / render_s if render_s > 0 else float('nan'),
            'requests': requests}
