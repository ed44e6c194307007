"""LPIPS (learned perceptual image patch similarity) in PyTorch (port of
``sk_gs_tpu/framework/lpips_jax.py``).

The images, in [0, 1], are z-scored with fixed shift and scale, run
through the AlexNet or VGG16 feature stack; each tap is unit-normalised
across channels, the squared difference of the two images' taps is
weighted per channel by the "lin" calibration, averaged over space and
summed over the taps. The convolutions are ``torch.nn.functional.conv2d``:
in the JAX package they are XLA convolutions outside any Pallas kernel.

Weights (``load_weights``): ``weights/lpips_{net}.npz`` at the repo root
when present (the file the JAX package reads; mode 'calibrated-npz'), else
a fallback of the same shapes: He-initialised features drawn from a
``torch.Generator`` seeded per net and uniform 1/C calibration (mode
'untrained-fallback'). The JAX fallback draws from ``jax.random``, which
the port cannot reproduce, so the two packages' uncalibrated values differ;
fed the same arrays, they agree.
"""
from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

SHIFT = (-0.030, -0.088, -0.188)
SCALE = (0.458, 0.448, 0.450)
# conv specs (in, out, kernel, stride, padding); 'M' a max-pool, 'T' a tap
# after the ReLU before it: torchvision's .features layouts
ALEX_SPEC: Tuple = (
    (3, 64, 11, 4, 2), 'T', 'M',
    (64, 192, 5, 1, 2), 'T', 'M',
    (192, 384, 3, 1, 1), 'T',
    (384, 256, 3, 1, 1), 'T',
    (256, 256, 3, 1, 1), 'T',
)
VGG_SPEC: Tuple = (
    (3, 64, 3, 1, 1), (64, 64, 3, 1, 1), 'T', 'M',
    (64, 128, 3, 1, 1), (128, 128, 3, 1, 1), 'T', 'M',
    (128, 256, 3, 1, 1), (256, 256, 3, 1, 1), (256, 256, 3, 1, 1), 'T', 'M',
    (256, 512, 3, 1, 1), (512, 512, 3, 1, 1), (512, 512, 3, 1, 1), 'T', 'M',
    (512, 512, 3, 1, 1), (512, 512, 3, 1, 1), (512, 512, 3, 1, 1), 'T',
)
SPECS = {'alex': ALEX_SPEC, 'vgg': VGG_SPEC}
POOL = {'alex': (3, 2), 'vgg': (2, 2)}          # (kernel, stride)
N_CHANNELS = {'alex': (64, 192, 384, 256, 256),
              'vgg': (64, 128, 256, 512, 512)}
FALLBACK_SEED = {'alex': 0x5B, 'vgg': 0x5C}
WEIGHTS_DIR = Path(__file__).resolve().parents[2] / 'weights'

_cache: Dict[str, Tuple[Dict[str, np.ndarray], str]] = {}


def conv_specs(net: str) -> List[Tuple[int, int, int, int, int]]:
    return [s for s in SPECS[net] if isinstance(s, tuple)]


def init_fallback(net: str) -> Dict[str, np.ndarray]:
    """He-initialised feature weights (normal, std sqrt(2 / fan-in)), zero
    biases and uniform 1/C calibration, from a CPU generator."""
    gen = torch.Generator().manual_seed(FALLBACK_SEED[net])
    params: Dict[str, np.ndarray] = {}
    for i, (cin, cout, k, _s, _p) in enumerate(conv_specs(net)):
        std = float(np.sqrt(2.0 / (cin * k * k)))
        params[f'conv{i}_w'] = (torch.randn((cout, cin, k, k), generator=gen)
                                * std).numpy()
        params[f'conv{i}_b'] = np.zeros((cout,), np.float32)
    for j, c in enumerate(N_CHANNELS[net]):
        params[f'lin{j}_w'] = np.full((c,), 1.0 / c, np.float32)
    return params


def load_weights(net: str) -> Tuple[Dict[str, np.ndarray], str]:
    """(arrays, mode): mode 'calibrated-npz' or 'untrained-fallback'."""
    if net not in _cache:
        path = WEIGHTS_DIR / f'lpips_{net}.npz'
        if path.exists():
            with np.load(path) as z:
                params = {k: np.asarray(z[k], np.float32) for k in z.files}
            mode = 'calibrated-npz'
        else:
            params, mode = init_fallback(net), 'untrained-fallback'
        for i, (cin, cout, k, _s, _p) in enumerate(conv_specs(net)):
            shape = params[f'conv{i}_w'].shape
            if shape != (cout, cin, k, k):
                raise ValueError(f'lpips {net} conv{i}: shape {shape} != '
                                 f'{(cout, cin, k, k)}')
        _cache[net] = (params, mode)
    return _cache[net]


def lpips_mode(net: str = 'alex') -> str:
    return load_weights(net)[1]


def to_device(params, device) -> Dict[str, torch.Tensor]:
    """A float32 copy of each array on ``device``."""
    return {k: torch.tensor(np.asarray(v), dtype=torch.float32,
                            device=device) for k, v in params.items()}


def features(params: Dict[str, torch.Tensor], x: torch.Tensor, net: str
             ) -> List[torch.Tensor]:
    """The unit-normalised taps of the feature stack for z-scored NCHW x."""
    pk, ps = POOL[net]
    taps, ci = [], 0
    for s in SPECS[net]:
        if s == 'M':
            x = F.max_pool2d(x, pk, ps)
        elif s == 'T':
            norm = torch.sqrt(torch.sum(x * x, dim=1, keepdim=True))
            taps.append(x / (norm + 1e-10))
        else:
            _cin, _cout, _k, stride, pad = s
            x = F.relu(F.conv2d(x, params[f'conv{ci}_w'],
                                params[f'conv{ci}_b'], stride=stride,
                                padding=pad))
            ci += 1
    return taps


def fits(net: str, h: int, w: int) -> bool:
    """True when every tap of the stack has pixels at an h x w input (the
    JAX package's distance is the NaN mean of an empty tap otherwise)."""
    pk, ps = POOL[net]
    for s in SPECS[net]:
        if s == 'M':
            h, w = (h - pk) // ps + 1, (w - pk) // ps + 1
        elif s != 'T':
            _cin, _cout, k, stride, pad = s
            h = (h + 2 * pad - k) // stride + 1
            w = (w + 2 * pad - k) // stride + 1
        if h < 1 or w < 1:
            return False
    return True


def lpips_nchw(params: Dict[str, torch.Tensor], a: torch.Tensor,
               b: torch.Tensor, net: str) -> torch.Tensor:
    """[B] distances of two NCHW batches in [0, 1] (NaN when the images are
    too small for the stack)."""
    if not fits(net, a.shape[2], a.shape[3]):
        return torch.full((a.shape[0],), float('nan'), device=a.device)
    shift = torch.tensor(SHIFT, device=a.device).view(1, 3, 1, 1)
    scale = torch.tensor(SCALE, device=a.device).view(1, 3, 1, 1)
    fa = features(params, (a - shift) / scale, net)
    fb = features(params, (b - shift) / scale, net)
    total = torch.zeros(a.shape[0], device=a.device)
    for j, (xa, xb) in enumerate(zip(fa, fb)):
        w = params[f'lin{j}_w'].view(1, -1, 1, 1)
        total = total + torch.mean(torch.sum((xa - xb) ** 2 * w, dim=1),
                                   dim=(1, 2))
    return total

