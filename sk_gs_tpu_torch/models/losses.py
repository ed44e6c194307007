"""Loss weights, image losses and metrics (port of ``LossWeights``,
``l1_loss``, ``mse_loss``, ``ssim_loss``, ``psnr`` and the separable
``ssim`` of ``sk_gs_tpu/models/losses.py``)."""
from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F


class LossWeights:
    """Scheduled per-name loss weights, evaluated on the host: each entry is
    a number, or a dict with 'lambda' and optional '_vary' ('fix', 'linear',
    'log'), '_steps', '_values'; other keys of the dict are the loss's own
    settings (``cfg``), such as the image loss's 'method'."""

    def __init__(self, cfg: Optional[dict] = None, default: float = 0.0):
        self.default = default
        self.entries: Dict[str, dict] = {}
        self._step = 0
        for name, c in (cfg or {}).items():
            if name == 'default':
                self.default = float(c)
                continue
            e = {'lambda': default, 'vary': 'fix', 'steps': [], 'values': []}
            if isinstance(c, (int, float, bool)):
                e['lambda'] = float(c)
            elif isinstance(c, dict):
                c = dict(c)
                e['lambda'] = float(c.pop('lambda', default))
                e['vary'] = c.pop('_vary', 'fix')
                e['steps'] = list(c.pop('_steps', []))
                e['values'] = [float(v) for v in c.pop('_values', [])]
                e['cfg'] = c
            self.entries[name] = e

    def set_step(self, step: int):
        self._step = step

    def cfg(self, name: str) -> dict:
        return self.entries.get(name, {}).get('cfg', {})

    def ever_nonzero(self, name: str) -> bool:
        """True if this loss can ever have weight > 0."""
        if name not in self.entries:
            return self.default > 0
        e = self.entries[name]
        return e['lambda'] > 0 or any(v > 0 for v in e['values'])

    def w(self, name: str) -> float:
        if name not in self.entries:
            return self.default
        e = self.entries[name]
        steps, values, vary = e['steps'], e['values'], e['vary']
        if not steps:
            return e['lambda']
        stage = int(np.sum(self._step >= np.asarray(steps)))
        if stage == len(steps):
            return max(0.0, values[-1])
        if stage == 0:
            return e['lambda']
        v1, v2 = values[stage - 1], values[stage]
        if v2 <= 0:
            return 0.0
        s1, s2 = steps[stage - 1], steps[stage]
        ratio = (self._step - s1) / max(s2 - s1, 1)
        if isinstance(vary, list):
            vary = vary[stage]
        if vary == 'fix':
            return v2
        if vary == 'linear':
            return v1 * (1 - ratio) + v2 * ratio
        if vary == 'log':
            return math.exp(math.log(v1) * (1 - ratio) + math.log(v2) * ratio)
        raise NotImplementedError(f'vary={vary}')


def masked_mean(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Mean of x over the elements where the (broadcast) mask is set: the
    live count, not the capacity, divides (``trainer.py:68-78``)."""
    mask_b = torch.broadcast_to(mask, x.shape).to(x.dtype)
    return torch.sum(x * mask_b) / torch.clamp(torch.sum(mask_b), min=1.0)


def l1_loss(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.abs(pred[..., :3] - gt[..., :3]))


def mse_loss(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.square(pred[..., :3] - gt[..., :3]))


def ssim_loss(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    return 1.0 - ssim(pred[..., :3], gt[..., :3])


def ssim(img1: torch.Tensor, img2: torch.Tensor, window_size: int = 11,
         crop_border: bool = False) -> torch.Tensor:
    """Mean SSIM of an [H, W, C] (or [B, H, W, C]) pair: Gaussian window
    (sigma 1.5) as two 1-D passes, zero 'SAME' padding (the reference's
    F.conv2d), one group per channel."""
    if img1.dim() == 3:
        img1, img2 = img1[None], img2[None]
    x = img1.permute(0, 3, 1, 2)
    y = img2.permute(0, 3, 1, 2)
    c = x.shape[1]
    g1 = np.exp(-((np.arange(window_size) - window_size // 2) ** 2)
                / (2.0 * 1.5 ** 2)).astype(np.float32)
    g1 /= g1.sum()
    g = torch.as_tensor(g1, device=x.device)
    wh = g.view(1, 1, window_size, 1).repeat(c, 1, 1, 1)
    ww = g.view(1, 1, 1, window_size).repeat(c, 1, 1, 1)
    pad = window_size // 2

    def conv(z):
        z = F.conv2d(z, wh, padding=(pad, 0), groups=c)
        return F.conv2d(z, ww, padding=(0, pad), groups=c)

    mu1, mu2 = conv(x), conv(y)
    mu1_sq, mu2_sq, mu12 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    s1 = conv(x * x) - mu1_sq
    s2 = conv(y * y) - mu2_sq
    s12 = conv(x * y) - mu12
    C1, C2 = 0.01 ** 2, 0.03 ** 2
    ssim_map = ((2 * mu12 + C1) * (2 * s12 + C2)) / \
        ((mu1_sq + mu2_sq + C1) * (s1 + s2 + C2))
    if crop_border:
        b = window_size // 2
        ssim_map = ssim_map[..., b:-b, b:-b]
    return torch.mean(ssim_map)


def psnr(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    mse = torch.mean(torch.square(pred[..., :3] - gt[..., :3]))
    return -10.0 * torch.log10(torch.clamp(mse, min=1e-12))
