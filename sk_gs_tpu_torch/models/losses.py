"""Image metrics (port of ``psnr`` and the separable ``ssim`` of
``sk_gs_tpu/models/losses.py``)."""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


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
