"""SK-GS stage transitions and superpoint adjustment (port of the parts of
``sk_gs_tpu/models/sk_gs_ops.py`` that the ``init`` and ``sp`` families
run).

Each function edits the model and the Adam state in place, between steps
(the JAX package returns new pytrees): ``init_superpoints`` (the FPS at
``init_sampling_step``), ``reinit_gaussians_at_sp_fix`` (the point-cloud
restart before ``sp_fix``), ``compute_sp_transforms_all_frames``, and
``superpoint_prune_split`` / ``superpoint_merge`` (the ``sp`` stage's
masked edits of the M-capacity superpoint buffers).
"""
from __future__ import annotations

import math
from typing import Dict, Iterable

import numpy as np
import torch

from ..ops.knn import furthest_point_sampling
from . import optim, superpoints
from .deform import DeformNet, deform_net_apply
from .gaussian_splatting import GaussianConfig, init_from_pcd
from .sk_gs import (SKGSConfig, SKGSModel, lbs_weights, sp_cache_row,
                    sp_net_outputs)

GAUSS_LEAVES = ('xyz', 'f_dc', 'f_rest', 'scaling', 'rotation', 'opacity',
                'hyper')
# the superpoint leaves a prune / split copies row by row
SP_ROW_LEAVES = ('sp_points', 'joints', 'sp_hyper', 'sp_radius', 'sp_weight')


def _gather_rows(params, names: Iterable[str], idx: torch.Tensor,
                 valid: torch.Tensor):
    """params[name][i] <- params[name][idx[i]] where ``valid``, else zeros
    (identity quaternions for 'rotation'), in place."""
    for name in names:
        if name not in params:
            continue
        x = params[name]
        g = x[idx]
        m = valid.reshape(valid.shape[0], *([1] * (x.dim() - 1)))
        fill = superpoints.rot_bias(g).expand_as(g) if name == 'rotation' \
            else torch.zeros_like(g)
        x.copy_(torch.where(m, g, fill))


def _linspace(n: int, device) -> torch.Tensor:
    """n times from 0 to 1 as ``jnp.linspace`` rounds them in float32
    (i times the float32 step)."""
    step = np.float32(1.0) / np.float32(max(n - 1, 1))
    return torch.arange(n, dtype=torch.float32, device=device) * float(step)


@torch.no_grad()
def sample_trajectories(cfg: SKGSConfig, model: SKGSModel) -> torch.Tensor:
    """[N, T * 3]: every Gaussian warped by ``sp_deform`` at
    ``init_num_times`` times in [0, 1], the FPS feature space."""
    xyz = model.params['xyz']
    outs = [deform_net_apply(model.sp_deform, cfg.net, xyz, t)['d_xyz'] + xyz
            for t in _linspace(cfg.init_num_times, xyz.device)]
    return torch.stack(outs, dim=1).reshape(xyz.shape[0], -1)


@torch.no_grad()
def init_superpoints(cfg: SKGSConfig, model: SKGSModel,
                     opt_state: optim.AdamState) -> torch.Tensor:
    """At ``init_sampling_step``: pick M Gaussians by FPS over their
    trajectories and replace the Gaussian set by them (rows 0..M-1, the
    rest dead), as the superpoints' positions too; ``hyper`` and
    ``sp_hyper`` 1e-2, ``sp_radius`` / ``sp_weight`` reset where present,
    the moments of those leaves zeroed, SH degree and statistics reset.
    Returns the picked rows [M]."""
    m = cfg.num_superpoints
    params = model.params
    idx = furthest_point_sampling(sample_trajectories(cfg, model), m,
                                  model.alive)
    n_cap = params['xyz'].shape[0]
    dev = idx.device
    rows = torch.arange(n_cap, device=dev)
    valid = rows < m
    sp_pts = params['xyz'][idx].clone()
    _gather_rows(params, GAUSS_LEAVES, idx[torch.clamp(rows, 0, m - 1)],
                 valid)
    params['hyper'].copy_(torch.where(valid[:, None], 1e-2, 0.0)
                          .expand_as(params['hyper']))
    params['sp_points'].copy_(sp_pts)
    params['sp_hyper'].fill_(1e-2)
    scene_range = torch.max(sp_pts) - torch.min(sp_pts)
    if 'sp_radius' in params:
        params['sp_radius'].copy_(torch.log(0.1 * scene_range + 1e-7)
                                  .expand_as(params['sp_radius']))
    if 'sp_weight' in params:
        params['sp_weight'].zero_()
    for name in GAUSS_LEAVES + ('sp_points', 'sp_hyper', 'sp_radius',
                                'sp_weight'):
        if name in params:
            optim.reset_leaf(opt_state, name)
    model.alive.copy_(valid)
    model.sp_alive.fill_(True)
    _reset_gaussian_state(model)
    return idx


def _reset_gaussian_state(model: SKGSModel):
    model.active_sh_degree.zero_()
    for name in ('max_radii2d', 'xyz_grad_accum', 'denom'):
        getattr(model, name).zero_()


@torch.no_grad()
def reinit_gaussians_at_sp_fix(cfg: SKGSConfig, model: SKGSModel,
                               opt_state: optim.AdamState,
                               pcd_points: np.ndarray,
                               pcd_colors: np.ndarray):
    """Before the last ``init`` step (``stages['sp_fix'][0]``): the live
    superpoints move to the first M Gaussians' positions (the set
    ``init_superpoints`` left); the Gaussians restart from the point cloud
    (``init_from_pcd``) with ``hyper`` -1e-2; ``sp_W`` becomes one-hot on
    each Gaussian's nearest live superpoint, times log(9 (K - 1)); the
    moments of those leaves are zeroed, SH degree and statistics reset."""
    m = cfg.num_superpoints
    params = model.params
    n_cap = params['xyz'].shape[0]
    sp_pts = torch.where(model.sp_alive[:, None], params['xyz'][:m],
                         params['sp_points'][..., :3])
    params['sp_points'].copy_(sp_pts)
    base = init_from_pcd(pcd_points, pcd_colors,
                         GaussianConfig(capacity=n_cap,
                                        sh_degree=cfg.gauss.sh_degree),
                         device=model.device)
    for name in ('xyz', 'f_dc', 'f_rest', 'scaling', 'rotation', 'opacity'):
        params[name].copy_(base.params[name])
    params['hyper'].fill_(-1e-2)
    if 'sp_W' in params:
        d2 = torch.sum((params['xyz'][:, None, :] - sp_pts[None]) ** 2, -1)
        d2 = torch.where(model.sp_alive[None, :], d2,
                         torch.full_like(d2, float('inf')))
        p2sp = torch.argmin(d2, dim=-1)
        scale = float(np.log(9.0 * max(cfg.num_knn - 1, 1)))
        params['sp_W'].copy_(torch.nn.functional.one_hot(p2sp, m)
                             .to(torch.float32) * scale)
    for name in GAUSS_LEAVES + ('sp_W', 'sp_points'):
        if name in params:
            optim.reset_leaf(opt_state, name)
    model.alive.copy_(base.alive)
    _reset_gaussian_state(model)


@torch.no_grad()
def compute_sp_transforms_all_frames(cfg: SKGSConfig, net: DeformNet,
                                     sp_points: torch.Tensor,
                                     times: torch.Tensor) -> torch.Tensor:
    """``sp_cache`` rows [T, M, sp_cache_dim] of the superpoints
    ``sp_points`` [M, 3] under the warp net ``net`` at every time of
    ``times``."""
    sp_pts = sp_points[..., :3]
    rows = []
    for t in times:
        d_xyz, d_rot, g_rot, d_scale = sp_net_outputs(cfg, net, sp_pts, t)
        spT = superpoints.sp_transforms(d_xyz, d_rot, sp_pts,
                                        cfg.warp_method)
        rows.append(sp_cache_row(cfg, spT, g_rot, d_scale))
    return torch.stack(rows)


def _copy_rows(x: torch.Tensor, src: torch.Tensor, dst: torch.Tensor,
               dim: int = 0, vals: torch.Tensor = None) -> torch.Tensor:
    """A copy of ``x`` whose slices ``dst`` along ``dim`` hold the slices
    ``src`` of ``vals`` (default ``x`` as it was)."""
    vals = x if vals is None else vals
    out = x.clone()
    out.index_copy_(dim, dst, vals.index_select(dim, src))
    return out


@torch.no_grad()
def superpoint_prune_split(cfg: SKGSConfig, model: SKGSModel,
                           opt_state: optim.AdamState
                           ) -> Dict[str, torch.Tensor]:
    """Prune the superpoints with too little LBS weight and split the ones
    with a large position gradient or weight mass
    (``superpoint_prune_split_masks``): each split copies its superpoint
    into a dead slot, in stable ``argsort(sp_alive)`` order, at the
    weighted mean of its Gaussians; splits beyond the dead slots are
    dropped. The copy takes the source's rows of the superpoint leaves,
    its ``sp_W`` column, its ``joint_pos`` / ``joint_cost`` rows and then
    columns, and its ``sp_cache`` entries, all as they were before the
    event; the new slots' moments are zeroed (``joint_pos``: rows). Returns
    the counts ``n_pruned`` and ``n_split``."""
    m_cap = cfg.num_superpoints
    params = model.params
    weights, indices = lbs_weights(cfg, params, model.sp_alive,
                                   params['xyz'])
    weights = weights * model.alive[:, None]
    prune, split, new_pos = superpoints.superpoint_prune_split_masks(
        weights, indices, model.sp_alive, model.xyz_grad_accum, model.denom,
        params['xyz'], cfg.sp_prune_threshold, cfg.sp_split_threshold, m_cap)

    alive = model.sp_alive & ~prune
    rank = torch.cumsum(split.to(torch.int64), 0) - 1
    dead_order = torch.sort(alive.to(torch.int8), stable=True).indices
    n_dead = m_cap - alive.sum()
    has_slot = split & (rank < n_dead)
    src = torch.nonzero(has_slot)[:, 0]
    dst = dead_order[rank[src]]

    for name in SP_ROW_LEAVES:
        if name not in params:
            continue
        x = params[name]
        vals = torch.where(split[:, None], new_pos, x[..., :3]) \
            if name in ('sp_points', 'joints') else x
        x.copy_(_copy_rows(x, src, dst, vals=vals))
    if 'sp_W' in params:
        params['sp_W'].copy_(_copy_rows(params['sp_W'], src, dst, dim=1))
    for x in (params['joint_pos'], model.joint_cost):
        x.copy_(_copy_rows(_copy_rows(x, src, dst), src, dst, dim=1))
    model.sp_cache.copy_(_copy_rows(model.sp_cache, src, dst, dim=1))

    touched = torch.zeros_like(alive)
    touched[dst] = True
    model.sp_alive.copy_(alive | touched)
    for name in SP_ROW_LEAVES + ('joint_pos',):
        if name in params:
            optim.reset_rows(opt_state, name, touched)
    return {'n_pruned': prune.sum(), 'n_split': has_slot.sum()}


@torch.no_grad()
def superpoint_merge(cfg: SKGSConfig, model: SKGSModel
                     ) -> Dict[str, torch.Tensor]:
    """Refresh ``sp_cache`` at every train frame, then retire superpoints
    whose cached motion stays within ``sp_merge_threshold`` of a
    neighbour's: the pairs, by increasing difference, taken greedily on
    the host so that no superpoint is in two. Returns ``n_merged``."""
    sp_cache = compute_sp_transforms_all_frames(
        cfg, model.sp_deform, model.params['sp_points'], model.train_times)
    model.sp_cache.copy_(sp_cache)
    min_diff, min_index = superpoints.superpoint_merge_masks(
        model.params['sp_points'][..., :3], model.sp_alive, sp_cache,
        cfg.num_knn)
    removed = torch.as_tensor(_merge_pairs(
        min_diff.cpu().numpy(), min_index.cpu().numpy(),
        model.sp_alive.cpu().numpy(), cfg.sp_merge_threshold),
        device=model.sp_alive.device)
    model.sp_alive.copy_(model.sp_alive & ~removed)
    return {'n_merged': removed.sum()}


def _merge_pairs(min_diff: np.ndarray, min_index: np.ndarray,
                 alive: np.ndarray, threshold: float) -> np.ndarray:
    """The superpoints a greedy non-overlapping merge removes: by
    increasing difference, i joins its neighbour j unless either is dead
    or already in a pair."""
    m = min_diff.shape[0]
    merged = np.zeros(m, bool)
    removed = np.zeros(m, bool)
    for i in np.argsort(min_diff):
        if not math.isfinite(min_diff[i]) or min_diff[i] >= threshold:
            break
        j = int(min_index[i])
        if merged[i] or merged[j] or not alive[i] or not alive[j]:
            continue
        removed[i] = True
        merged[i] = True
        merged[j] = True
    return removed
