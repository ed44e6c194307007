"""The random SP-GS model of a cell, made from ``--seed`` on top of
``inputs.model_flat``: the same Gaussians, superpoints (the joints'
positions), LBS matrix and warp nets, with the warp net ``sp_deform``'s
three heads and the hyper features redrawn at spreads that the served
image shows.

At ``inputs.model_flat``'s own spreads (the heads at initialisation, 1e-5;
every Gaussian's hyper feature -1e-2, every superpoint's 0) the sp stage
barely moves a Gaussian and its K nearest superpoints in (xyz, hyper)
space are the xyz ones, so an image check would pass with the deformation
left out. At the spreads the configuration states, the heads turn a
superpoint by about 0.06 rad about the origin, move it by about 0.02 of
the scene's unit and change a Gaussian's scale by about 1%, and the hyper
features (a normal draw a coordinate, for the Gaussians and the
superpoints alike) change the K nearest set of about a third of the
Gaussians. ``PERF.md`` gives what a
run reads of both: the image gap of a request served with zero deltas
against the cell's limit, and the share of the live Gaussians whose K
nearest set differs from the xyz-only one.

The draws come from a second ``torch.Generator`` on the device, seeded
from the seed, so the arrays of ``inputs.model_flat`` are unchanged.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from . import inputs

# the second generator's seed: the cell's seed plus this
SEED_OFFSET = 0x5350


def model_flat(cfg: Dict, seed: int, device, nf: int
               ) -> Dict[str, np.ndarray]:
    """``inputs.model_flat`` with the ``sp_deform`` heads and the hyper
    features redrawn from ``seed`` at the spreads that the configuration's
    ``assumed`` states (``warp_head_std`` a head, ``hyper_std``); host
    arrays in the checkpoint naming."""
    flat = inputs.model_flat(cfg, seed, device, nf)
    assumed = cfg['assumed']
    gen = torch.Generator(device=device).manual_seed(int(seed) + SEED_OFFSET)

    def randn(shape, std):
        x = torch.randn(shape, generator=gen, device=device) * float(std)
        return x.cpu().numpy()

    for head, std in assumed['warp_head_std'].items():
        key = f'params/sp_deform/{head}/w'
        flat[key] = randn(flat[key].shape, std)
    for key in ('params/hyper', 'params/sp_hyper'):
        flat[key] = randn(flat[key].shape, assumed['hyper_std'])
    return flat
