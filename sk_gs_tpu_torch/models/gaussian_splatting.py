"""Gaussian model config, state and renderer inputs (port of ``GaussianConfig``,
``GaussianModel`` and ``gaussian_inputs`` of
``sk_gs_tpu/models/gaussian_splatting.py``)."""
from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

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
    (``max_radii2d``, ``xyz_grad_accum``, ``denom``) belong to training."""
    params: Dict[str, torch.Tensor]
    alive: torch.Tensor             # [Ncap] bool
    active_sh_degree: torch.Tensor  # [] int32


def num_rest(sh_degree: int) -> int:
    return (sh_degree + 1) ** 2 - 1


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
