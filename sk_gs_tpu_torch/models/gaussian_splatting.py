"""Gaussian model config, state, renderer inputs and the training helpers
(port of ``GaussianConfig``, ``GaussianModel``, ``init_from_pcd``,
``gaussian_inputs``, ``expon_lr``, ``ndc_grad_norm``, ``densify_and_prune``
and ``reset_opacity`` of ``sk_gs_tpu/models/gaussian_splatting.py``).

Adaptive density control works on the capacity-padded rows in place, as
the JAX package's masked row writes do: clones and splits go to dead slots
(lowest slot first), prunes clear ``alive``, and the touched rows' Adam
moments are zeroed.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from .. import resolve_device
from ..ops import quaternion as quat
from ..ops.knn import mean_knn_dist2
from ..ops.sh import rgb_to_sh
from ..render.settings import GaussianInputs
from ..utils.tracing import host_read
from . import optim


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
    reads, and the densification statistics (``SKGSModel.gauss_view`` gives
    its own tensors, so in-place edits reach the model)."""
    params: Dict[str, torch.Tensor]
    alive: torch.Tensor             # [Ncap] bool
    active_sh_degree: torch.Tensor  # [] int32
    max_radii2d: Optional[torch.Tensor] = None     # [Ncap]
    xyz_grad_accum: Optional[torch.Tensor] = None  # [Ncap]
    denom: Optional[torch.Tensor] = None           # [Ncap]

    @property
    def capacity(self) -> int:
        return self.params['xyz'].shape[0]


def num_rest(sh_degree: int) -> int:
    return (sh_degree + 1) ** 2 - 1


def inverse_sigmoid(x: torch.Tensor) -> torch.Tensor:
    return torch.log(x / (1.0 - x))


def init_from_pcd(points: np.ndarray, colors: np.ndarray, cfg: GaussianConfig,
                  device='cuda') -> GaussianModel:
    """A model from a point cloud (``gaussian_splatting.py:84-120``): log
    scales from the mean squared distance to the 3 nearest points, opacity
    0.1, identity rotations, DC colour from RGB, SH degree 0; rows past the
    points are dead (scaling -10, identity rotation, zeros elsewhere)."""
    device = resolve_device(device)
    n, cap = points.shape[0], cfg.capacity
    if n > cap:
        raise ValueError(f'init points {n} > capacity {cap}')
    pts = torch.as_tensor(np.asarray(points), dtype=torch.float32,
                          device=device)
    cols = torch.as_tensor(np.asarray(colors), dtype=torch.float32,
                           device=device)
    dist2 = torch.clamp(mean_knn_dist2(pts, k=3), min=1e-7)
    scales0 = torch.log(torch.sqrt(dist2))[:, None].repeat(1, 3)

    def pad(x, fill=0.0):
        return torch.cat([x, torch.full((cap - n, *x.shape[1:]), fill,
                                        dtype=x.dtype, device=device)])

    rot = torch.zeros((cap, 4), device=device)
    rot[:, 3] = 1.0
    params = {
        'xyz': pad(pts),
        'f_dc': pad(rgb_to_sh(cols)[:, None, :]),
        'f_rest': torch.zeros((cap, num_rest(cfg.sh_degree), 3),
                              device=device),
        'scaling': pad(scales0, fill=-10.0),
        'rotation': rot,
        'opacity': pad(torch.full((n, 1), float(inverse_sigmoid(
            torch.tensor(0.1))), device=device)),
    }
    return GaussianModel(
        params=params, alive=torch.arange(cap, device=device) < n,
        active_sh_degree=torch.zeros((), dtype=torch.int32, device=device),
        max_radii2d=torch.zeros(cap, device=device),
        xyz_grad_accum=torch.zeros(cap, device=device),
        denom=torch.zeros(cap, device=device))


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


def densify_and_prune(m: GaussianModel, opt_state: optim.AdamState,
                      cfg: GaussianConfig, extent: float,
                      generator: torch.Generator, do_densify: bool,
                      do_prune: bool, size_threshold: float
                      ) -> Dict[str, torch.Tensor]:
    """Adaptive density control (``gaussian_splatting.py:236-344``), in
    place on ``m`` and ``opt_state``, with the split noise's two
    standard-normal draws [capacity, 3] taken from ``generator`` on its own
    device and moved to the model's (a CPU generator gives the card and the
    CPU the same numbers); see ``densify_and_prune_noise``."""
    noise = [torch.randn((m.capacity, 3), generator=generator,
                         device=generator.device).to(m.alive.device)
             for _ in range(2)]
    return densify_and_prune_noise(m, opt_state, cfg, extent, *noise,
                                   do_densify, do_prune, size_threshold)


@torch.no_grad()
def densify_and_prune_noise(m: GaussianModel, opt_state: optim.AdamState,
                            cfg: GaussianConfig, extent: float,
                            noise1: torch.Tensor, noise2: torch.Tensor,
                            do_densify: bool, do_prune: bool,
                            size_threshold: float) -> Dict[str, torch.Tensor]:
    """Clone and split the live Gaussians whose mean position gradient
    reaches the threshold, then prune, in place; returns the counts
    ``n_cloned``, ``n_split``, ``n_pruned`` and ``n_dropped``.

    - clone (max scale <= percent_dense * extent) copies the row into a
      dead slot; split (larger) puts one sample, at the row's rotated
      ``noise2`` offset with its scale / 1.6, into a dead slot and replaces
      the row itself with the ``noise1`` sample. Every leaf whose first axis
      is the capacity (``sp_W``, ``hyper`` too) is copied.
    - the dead slots, in stable ``argsort(alive)`` order, go to the
      selected rows in row order; rows past the number of dead slots are
      dropped (the split still replaces its row);
    - prune: opacity < threshold, or, when ``size_threshold`` > 0, a
      screen radius or a world scale that is too large; slots filled here
      are not pruned;
    - the moments of every new slot and replaced row are zeroed, and the
      statistics are reset when anything ran.
    """
    p = m.params
    cap = m.capacity
    alive = m.alive
    grads = torch.where(m.denom > 0,
                        m.xyz_grad_accum / torch.clamp(m.denom, min=1.0),
                        torch.zeros_like(m.denom))
    scales = torch.exp(p['scaling'])
    max_scale = torch.amax(scales, dim=-1)
    opacity = torch.sigmoid(p['opacity'][:, 0])

    big_grad = (grads >= cfg.densify_grad_threshold) & alive & do_densify
    small = max_scale <= cfg.densify_percent_dense * extent
    clone_sel = big_grad & small
    split_sel = big_grad & ~small
    new_sel = clone_sel | split_sel     # each adds exactly one Gaussian
    rank = torch.cumsum(new_sel.to(torch.int64), 0) - 1
    dead_order = torch.sort(alive.to(torch.int8), stable=True).indices
    n_dead = cap - int(host_read(alive.sum()))
    has_slot = new_sel & (rank < n_dead)
    slot = dead_order[torch.clamp(rank, 0, cap - 1)][has_slot]

    rotn = p['rotation'] / torch.clamp(
        torch.linalg.norm(p['rotation'], dim=-1, keepdim=True), min=1e-12)
    off1 = quat.apply(rotn, noise1 * scales)
    off2 = quat.apply(rotn, noise2 * scales)
    split_scale = torch.log(torch.clamp(scales / (0.8 * 2.0), min=1e-10))
    sp = split_sel[:, None]
    new_xyz = torch.where(sp, p['xyz'] + off2, p['xyz'])
    new_scaling = torch.where(sp, split_scale, p['scaling'])
    row_leaves = [k for k, v in p.items() if v.dim() >= 1
                  and v.shape[0] == cap]
    for k in row_leaves:
        vals = {'xyz': new_xyz, 'scaling': new_scaling}.get(k, p[k])
        p[k][slot] = vals[has_slot]
    # a split replaces its own row with the first sample
    p['xyz'].copy_(torch.where(sp, p['xyz'] + off1, p['xyz']))
    p['scaling'].copy_(torch.where(sp, split_scale, p['scaling']))

    was_alive = alive.clone()
    filled = torch.zeros_like(alive)
    filled[slot] = True
    size_on = size_threshold > 0
    prune = (opacity < cfg.prune_opacity_threshold) \
        | ((m.max_radii2d > size_threshold) & size_on) \
        | ((max_scale > cfg.prune_percent_dense * extent) & size_on)
    prune = prune & do_prune & was_alive
    alive.copy_((was_alive | filled) & ~prune)

    touched = filled | split_sel
    for name in row_leaves:
        optim.reset_rows(opt_state, name, touched)
    if do_densify or do_prune:
        for t in (m.max_radii2d, m.xyz_grad_accum, m.denom):
            t.zero_()
    return {'n_cloned': torch.sum(clone_sel & has_slot),
            'n_split': torch.sum(split_sel & has_slot),
            'n_pruned': torch.sum(prune),
            'n_dropped': torch.sum(new_sel & ~has_slot)}


@torch.no_grad()
def reset_opacity(m: GaussianModel, opt_state: optim.AdamState):
    """opacity <- inverse_sigmoid(min(sigmoid(opacity), 0.01)) on the live
    rows, and the leaf's moments zeroed (``gaussian_splatting.py:347-355``),
    in place."""
    op = m.params['opacity']
    new_op = inverse_sigmoid(torch.clamp(torch.sigmoid(op), max=0.01))
    op.copy_(torch.where(m.alive[:, None], new_op, op))
    optim.reset_leaf(opt_state, 'opacity')
