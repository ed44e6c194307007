"""Serving: render a trained SK-GS model at (camera, t), and score a list of
requests or a whole split (port of the eval body of
``sk_gs_tpu/framework/trainer.py``: ``_render_eval_fn`` :1570-1595,
``_eval_sums_fn`` :1540-1568, ``_eval_full_fn`` :1493-1538, and
``evaluate`` :1436-1491 with its post-processing)."""
from __future__ import annotations

import math
import time
from typing import Dict, Optional, Sequence

import torch

from ..models.gaussian_splatting import gaussian_inputs
from ..models.losses import psnr, ssim
from ..models.sk_gs import SKGSModel, forward_deltas
from ..render.render import composite_background, render
from ..render.settings import RasterConfig, ViewParams
from ..utils.tracing import span
from . import lpips as lpips_mod
from .metrics import ms_ssim

# the columns of the full evaluation, in the JAX trainer's order
FULL_METRICS = ('PSNR', 'SSIM', 'SSIM (border-cropped)', 'MS-SSIM',
                'LPIPS (alex)', 'LPIPS (vgg)')
SSIM_NOTE = ('SSIM > 1 comes from zero-padded conv borders on near-perfect '
             'frames (matches the reference F.conv2d padding); see SSIM '
             '(border-cropped) for the <=1 variant')


def _sync(device: torch.device):
    if device.type == 'cuda':
        torch.cuda.synchronize(device)


@torch.no_grad()
def render_eval(model: SKGSModel, view: ViewParams, t, bg,
                stage: str = 'sk', rcfg: Optional[RasterConfig] = None
                ) -> Dict[str, torch.Tensor]:
    """Render ``model`` from ``view`` at time ``t`` and composite it over
    ``bg``. Returns the render dict plus 'image' [H, W, 3], the composite.
    ``rcfg`` overrides the model's raster config (e.g. ``use_kernel``).
    The whole request is an 'sk.request' span (``utils/tracing.py``)."""
    with span('sk.request'):
        dev = model.device
        t = torch.as_tensor(t, dtype=torch.float32, device=dev)
        out_def = forward_deltas(model.cfg, model, t, stage, time_id=None,
                                 training=False)
        g = gaussian_inputs(model.gauss_view(), model.cfg.gauss,
                            d_xyz=out_def.d_xyz,
                            d_rotation=out_def.d_rotation,
                            d_scaling=out_def.d_scaling)
        out = render(g, view, rcfg or model.rcfg,
                     active_sh_degree=model.active_sh_degree)
        out['image'] = composite_background(out['images'], out['opacity'],
                                            bg)
        return out


@torch.no_grad()
def evaluate(model: SKGSModel, views: Sequence[ViewParams], images, times,
             bg, stage: str = 'sk', rcfg: Optional[RasterConfig] = None,
             full_metrics: bool = False) -> Dict:
    """Serve one render per (view, image, t) request and score it.

    Returns PSNR and SSIM summed over the requests (as the JAX eval does),
    with ``full_metrics`` also the sums of the other columns of
    ``FULL_METRICS``; the request count, frames per second over the render
    time, and per request the render time in ms (host clock around a
    synchronised render), the pairs emitted and whether the pair capacity
    overflowed.
    """
    dev = model.device
    bg_t = torch.as_tensor(bg, dtype=torch.float32, device=dev)
    names = FULL_METRICS if full_metrics else FULL_METRICS[:2]
    sums = {k: torch.zeros((), device=dev) for k in names}
    nets = {net: lpips_mod.to_device(lpips_mod.load_weights(net)[0], dev)
            for net in ('alex', 'vgg')} if full_metrics else {}
    nchw = lambda x: x.permute(2, 0, 1)[None]
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
        i3, g3 = img[..., :3], gt[..., :3]
        sums['PSNR'] += psnr(img, gt)
        sums['SSIM'] += ssim(i3, g3)
        if full_metrics:
            sums['SSIM (border-cropped)'] += ssim(i3, g3, crop_border=True)
            sums['MS-SSIM'] += ms_ssim(i3, g3)
            for net, params in nets.items():
                sums[f'LPIPS ({net})'] += torch.mean(lpips_mod.lpips_nchw(
                    params, nchw(i3), nchw(g3), net))
        requests.append({'ms': dt * 1e3, 'num_pairs': int(out['num_pairs']),
                         'overflow': bool(out['overflow'])})
    n = len(requests)
    res = {k: float(v) for k, v in sums.items()}
    res.update({'count': n,
                'fps': n / render_s if render_s > 0 else float('nan'),
                'requests': requests})
    return res


def split_metrics(model: SKGSModel, scene, bg, stage: str,
                  full_metrics: bool = False,
                  rcfg: Optional[RasterConfig] = None) -> Dict:
    """The metrics of a split, as the JAX trainer's ``evaluate`` returns
    them: each column averaged over the views; with ``full_metrics`` the
    six columns of ``FULL_METRICS``, a non-finite column dropped, the
    'LPIPS weights' mode, uncalibrated LPIPS moved to 'LPIPS (net)
    [uncalibrated]' with the calibrated column None, and the 'SSIM note'
    when SSIM exceeds 1."""
    views = [scene.view(i) for i in range(scene.num_views)]
    res = evaluate(model, views, scene.images, scene.times, bg, stage, rcfg,
                   full_metrics)
    n = max(res['count'], 1)
    names = FULL_METRICS if full_metrics else FULL_METRICS[:2]
    out = {k: res[k] / n for k in names}
    if not full_metrics:
        return out
    out = {k: v for k, v in out.items() if math.isfinite(v)}
    mode = lpips_mod.lpips_mode('alex')
    out['LPIPS weights'] = mode
    if mode == 'untrained-fallback':
        for net in ('alex', 'vgg'):
            k = f'LPIPS ({net})'
            if k in out:
                out[f'{k} [uncalibrated]'] = out[k]
                out[k] = None
    if out.get('SSIM', 0.0) > 1.0:
        out['SSIM note'] = SSIM_NOTE
    return out
