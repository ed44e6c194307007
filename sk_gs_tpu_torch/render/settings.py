"""Rasterizer settings and view parameters (port of
``sk_gs_tpu/render/settings.py``)."""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

TILE = 16  # pixels per tile in x; the y side is RasterConfig.tile_h
SCHEDULES = ('tile', 'chunk')


class RasterConfig(NamedTuple):
    image_width: int
    image_height: int
    sh_degree: int = 3
    pair_capacity: int = 2 ** 20  # max (tile, splat) pairs
    chunk: int = 256              # pad rows after sort_gauss (binning
    #                               layout); entries per chunk ('chunk')
    scale_modifier: float = 1.0
    near: float = 0.2             # frustum cull on view-space z
    use_kernel: bool = True       # False: the plain PyTorch blend on every
    #                               device (the JAX package's use_pallas)
    tight_culling: bool = True    # opacity-aware rects + per-pair tile cull
    tile_h: int = 16              # pixels per tile in y
    schedule: str = 'tile'        # the blend's schedule, the JAX package's
    #                               IMPL['schedule']: 'tile' (kernels #1/#2,
    #                               one block per tile) or 'chunk' (#3/#4,
    #                               one block per chunk of a tile's list)

    @property
    def chunked(self) -> bool:
        """True for the 'chunk' schedule; any value but the two raises."""
        if self.schedule not in SCHEDULES:
            raise ValueError(f'schedule {self.schedule!r} is not one of '
                             f'{SCHEDULES}')
        return self.schedule == 'chunk'

    @property
    def grid_w(self) -> int:
        return (self.image_width + TILE - 1) // TILE

    @property
    def grid_h(self) -> int:
        return (self.image_height + self.tile_h - 1) // self.tile_h

    @property
    def pix_per_tile(self) -> int:
        return TILE * self.tile_h

    @property
    def num_tiles(self) -> int:
        return self.grid_w * self.grid_h


class ViewParams(NamedTuple):
    """Per-view camera tensors (opencv convention)."""
    Tw2v: torch.Tensor      # [4, 4] world -> view
    Tv2c: torch.Tensor      # [4, 4] view -> clip
    campos: torch.Tensor    # [3]
    tan_fovx: torch.Tensor  # []
    tan_fovy: torch.Tensor  # []

    @property
    def full_proj(self) -> torch.Tensor:
        return self.Tv2c @ self.Tw2v

    def to(self, device) -> 'ViewParams':
        return ViewParams(*(torch.as_tensor(x, dtype=torch.float32).to(device)
                            for x in self))


class GaussianInputs(NamedTuple):
    """Per-Gaussian renderer inputs (capacity-padded; ``mask`` marks live
    slots). ``colors`` may replace ``sh``."""
    means3d: torch.Tensor                  # [N, 3]
    scales: torch.Tensor                   # [N, 3] (post-activation)
    rotations: torch.Tensor                # [N, 4] (x, y, z, w), normalised
    opacities: torch.Tensor                # [N] (post-sigmoid)
    sh: Optional[torch.Tensor] = None      # [N, (deg+1)^2, 3]
    colors: Optional[torch.Tensor] = None  # [N, 3]
    extras: Optional[torch.Tensor] = None  # [N, E] extra channels
    mask: Optional[torch.Tensor] = None    # [N] bool
