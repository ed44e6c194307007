"""Gaussian model config, state, renderer inputs and the training helpers
the ``sk`` family reads (port of ``GaussianConfig``, ``GaussianModel``,
``gaussian_inputs``, ``expon_lr`` and ``ndc_grad_norm`` of
``sk_gs_tpu/models/gaussian_splatting.py``)."""
from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import numpy as np
import torch

from ..render.settings import GaussianInputs


class GaussianConfig(NamedTuple):
    capacity: int = 100_000
    sh_degree: int = 3
    lr: float = 1e-3
    lr_position_init: float = 0.16
    lr_position_final: float = 1.6e-3
    lr_position_delay_mult: float = 0.01
    lr_position_max_steps: int = 30_000
    lr_feature: float = 2.5
    lr_opacity: float = 50.0
    lr_scaling: float = 5.0
    lr_rotation: float = 1.0
    densify_interval: Tuple[int, int, int] = (100, 500, 25_000)
    densify_grad_threshold: float = 0.0002
    densify_percent_dense: float = 0.01
    prune_interval: Tuple[int, int, int] = (100, 500, 25_000)
    prune_opacity_threshold: float = 0.005
    prune_max_screen_size: float = 20.0
    prune_percent_dense: float = 0.1
    opacity_reset_interval: Tuple[int, int, int] = (3000, 3000, -1)
    init_densify_prune_interval: Tuple[int, int, int] = (100, 0, -1)
    init_opacity_reset_interval: Tuple[int, int, int] = (3000, 0, -1)
    background_type: str = 'white'


class GaussianModel(NamedTuple):
    """Raw (pre-activation) capacity-padded leaves and the state a render
    reads. The densification statistics of the JAX ``GaussianModel``
    (``max_radii2d``, ``xyz_grad_accum``, ``denom``) are buffers of
    ``SKGSModel``, which the trainer updates."""
    params: Dict[str, torch.Tensor]
    alive: torch.Tensor             # [Ncap] bool
    active_sh_degree: torch.Tensor  # [] int32


def num_rest(sh_degree: int) -> int:
    return (sh_degree + 1) ** 2 - 1


def expon_lr(step, lr_init, lr_final, lr_delay_steps=0, lr_delay_mult=1.0,
             max_steps=1_000_000) -> float:
    """Log-linear decay from lr_init to lr_final over max_steps, with an
    optional sine warm-up over lr_delay_steps; host-side."""
    if step < 0 or (lr_init == 0.0 and lr_final == 0.0):
        return 0.0
    if lr_delay_steps > 0:
        delay_rate = lr_delay_mult + (1 - lr_delay_mult) * np.sin(
            0.5 * np.pi * np.clip(step / lr_delay_steps, 0, 1))
    else:
        delay_rate = 1.0
    t = np.clip(step / max_steps, 0, 1)
    return float(delay_rate * np.exp(np.log(lr_init) * (1 - t)
                                     + np.log(lr_final) * t))


def ndc_grad_norm(means2d_grad: torch.Tensor, image_size,
                  eps: float = 0.0) -> torch.Tensor:
    """Per-Gaussian norm of the pixel-space position gradient in NDC units
    (times 0.5 W and 0.5 H), the units the densify threshold is set in."""
    scale = torch.tensor([image_size[0] * 0.5, image_size[1] * 0.5],
                         dtype=torch.float32, device=means2d_grad.device)
    g2 = means2d_grad[..., :2] * scale
    return torch.sqrt(torch.sum(torch.square(g2), dim=-1) + eps)


def gaussian_inputs(m: GaussianModel, cfg: GaussianConfig,
                    d_xyz=0.0, d_rotation=0.0, d_scaling=0.0
                    ) -> GaussianInputs:
    """Raw params + deformation deltas -> renderer inputs. The scale delta
    is added after exp; the rotation delta to the raw quaternion before
    normalisation (rsqrt(sum + 1e-18) keeps zero rows finite)."""
    del cfg  # the JAX signature; activations do not depend on it
    p = m.params
    scales = torch.exp(p['scaling']) + d_scaling
    rot = p['rotation'] + d_rotation
    rot = rot * torch.rsqrt(torch.sum(torch.square(rot), dim=-1, keepdim=True)
                            + 1e-18)
    sh = torch.cat([p['f_dc'], p['f_rest']], dim=1)
    return GaussianInputs(
        means3d=p['xyz'] + d_xyz,
        scales=scales,
        rotations=rot,
        opacities=torch.sigmoid(p['opacity'][:, 0]),
        sh=sh,
        mask=m.alive,
    )
