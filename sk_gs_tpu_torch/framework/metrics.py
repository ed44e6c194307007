"""Image metrics of the full evaluation: MS-SSIM and the LPIPS mode (port
of ``ms_ssim`` and ``lpips_mode`` of ``sk_gs_tpu/framework/metrics.py``).
PSNR and SSIM (with its border-cropped form) are ``models.losses``'; LPIPS
is ``framework.lpips``, whose ``lpips_mode`` ('calibrated-npz' or
'untrained-fallback') is the port's: the JAX package's third mode, the
torch ``lpips`` package, is not a route of the port."""
from __future__ import annotations

from typing import List

import numpy as np
import torch
import torch.nn.functional as F

from .lpips import lpips_mode  # noqa: F401  (re-exported)

MSSSIM_WEIGHTS = (0.0448, 0.2856, 0.3001, 0.2363, 0.1333)


def _ssim_components(x: torch.Tensor, y: torch.Tensor,
                     window_size: int = 11):
    """(mean of l * cs, mean of cs) of NCHW x, y over the fully windowed
    interior (separable Gaussian window, sigma 1.5); NaN when the window
    does not fit, the mean of an empty map as in the JAX package."""
    if min(x.shape[2], x.shape[3]) < window_size:
        nan = torch.full((), float('nan'), device=x.device)
        return nan, nan
    c = x.shape[1]
    g1 = np.exp(-((np.arange(window_size) - window_size // 2) ** 2)
                / (2.0 * 1.5 ** 2)).astype(np.float32)
    g1 /= g1.sum()
    g = torch.as_tensor(g1, device=x.device)
    wh = g.view(1, 1, window_size, 1).repeat(c, 1, 1, 1)
    ww = g.view(1, 1, 1, window_size).repeat(c, 1, 1, 1)

    def conv(z):
        return F.conv2d(F.conv2d(z, wh, groups=c), ww, groups=c)

    mu1, mu2 = conv(x), conv(y)
    mu1_sq, mu2_sq, mu12 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    s1 = conv(x * x) - mu1_sq
    s2 = conv(y * y) - mu2_sq
    s12 = conv(x * y) - mu12
    C1, C2 = 0.01 ** 2, 0.03 ** 2
    lum = (2 * mu12 + C1) / (mu1_sq + mu2_sq + C1)
    cs = (2 * s12 + C2) / (s1 + s2 + C2)
    return torch.mean(lum * cs), torch.mean(cs)


def ms_ssim(img1: torch.Tensor, img2: torch.Tensor, levels: int = 5
            ) -> torch.Tensor:
    """Multi-scale SSIM of [H, W, C] (or [B, H, W, C]) images. The levels
    are clamped so that the coarsest scale still holds the 11 x 11 window,
    and the weights renormalised over the levels used."""
    if img1.dim() == 3:
        img1, img2 = img1[None], img2[None]
    x = img1.permute(0, 3, 1, 2)
    y = img2.permute(0, 3, 1, 2)
    min_hw = min(x.shape[2], x.shape[3])
    while levels > 1 and (min_hw >> (levels - 1)) < 11:
        levels -= 1
    weights = MSSSIM_WEIGHTS[:levels]
    wsum = sum(weights)
    weights = tuple(w / wsum for w in weights)
    vals: List[torch.Tensor] = []
    for i in range(levels):
        ssim_full, cs = _ssim_components(x, y)
        vals.append(ssim_full if i == levels - 1 else cs)
        if i < levels - 1:
            x = F.avg_pool2d(x, 2, 2)
            y = F.avg_pool2d(y, 2, 2)
    out = torch.ones((), device=x.device)
    for v, wgt in zip(vals, weights):
        out = out * torch.clamp(v, min=0.0) ** wgt
    return out

