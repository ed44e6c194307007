"""SK-GS stage transitions and superpoint adjustment (port of
``sk_gs_tpu/models/sk_gs_ops.py``).

Each function edits the model and the Adam state in place, between steps
(the JAX package returns new pytrees): ``init_superpoints`` (the FPS at
``init_sampling_step``), ``reinit_gaussians_at_sp_fix`` (the point-cloud
restart before ``sp_fix``), ``compute_sp_transforms_all_frames``,
``superpoint_prune_split`` / ``superpoint_merge`` (the ``sp`` stage's
masked edits of the M-capacity superpoint buffers), and ``init_skeleton``,
the sp -> sk transition before the first sk-family step: the frozen LBS
(``freeze_lbs``), the joint pivots' Adam loop (``optimize_joint_pos``), the
joint tree (``finalize_joints``) and the skeleton net's distillation
(``distill_sk_deform``).

The JAX package runs each of the two loops as one jitted ``lax.scan`` and
draws each iteration's frame from its key; here they are Python loops of
torch ops on the model's device that take the frame ids as a device tensor
and never read a value on the host inside the loop.
"""
from __future__ import annotations

import math
from typing import Dict, Iterable

import numpy as np
import torch

from ..ops import se3
from ..ops.knn import furthest_point_sampling
from ..utils.tracing import host_read
from . import optim, skeleton, superpoints
from .deform import DeformNet, deform_net_apply
from .gaussian_splatting import GaussianConfig, init_from_pcd
from .losses import masked_mean
from .sk_gs import (SKGSConfig, SKGSModel, lbs_weights, sk_stage,
                    sp_cache_row, sp_net_outputs, split_sp_cache, take_frame)

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
        host_read(min_diff).numpy(), host_read(min_index).numpy(),
        host_read(model.sp_alive).numpy(), cfg.sp_merge_threshold),
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


# ---------------------------------------------------------------- skeleton

# the leaves the distillation trains besides the skeleton net, where the
# model has them (``sk_gs_ops.py:290-293``)
DISTILL_LEAVES = ('sk_deform', 'joints', 'global_tr', 'sp_radius',
                  'sp_weight', 'sp_W', 'sk_feature')
# the two loops' Adam: lr and eps (``sk_gs_ops.py:237-238, 338``)
INIT_LR = 1e-3
INIT_EPS = 1e-8


@torch.no_grad()
def freeze_lbs(cfg: SKGSConfig, model: SKGSModel):
    """Steps 1-2 of the skeleton initialisation: ``sp_cache`` at every
    train frame, and the Gaussians' LBS weights and superpoints frozen into
    ``sp_weights`` / ``sp_knn``, with ``p2sp`` their heaviest superpoint."""
    params = model.params
    model.sp_cache.copy_(compute_sp_transforms_all_frames(
        cfg, model.sp_deform, params['sp_points'], model.train_times))
    w, idx = lbs_weights(cfg, params, model.sp_alive, params['xyz'])
    model.sp_weights.copy_(w)
    model.sp_knn.copy_(idx)
    model.p2sp.copy_(torch.gather(idx, 1,
                                  torch.argmax(w, -1, keepdim=True))[:, 0])


def joint_pos_init_midpoint(params) -> torch.Tensor:
    """joint_pos[a, b] = the midpoint of superpoints a and b."""
    sp = params['sp_points'][..., :3]
    return 0.5 * (sp[:, None] + sp[None, :])


def joint_pos_loss(joint_pos: torch.Tensor, spT: torch.Tensor,
                   sp_alive: torch.Tensor):
    """(loss, cost): the joint cost [M, M] at the superpoint transforms
    ``spT`` with non-finite entries 0, and the loss, the mean over rows of
    each row's smallest positive cost (1e6 for a row without one, with no
    gradient) plus the mean cost. The smallest is the first of a stable
    sort, so a tie sends its gradient to one entry, as JAX's sort does."""
    cost = skeleton.joint_cost_matrix(joint_pos, spT, sp_alive)
    cost = torch.where(torch.isfinite(cost), cost, torch.zeros_like(cost))
    pos = torch.where(cost > 0, cost, torch.full_like(cost, float('inf')))
    best = torch.sort(pos, dim=-1, stable=True).values[:, 0]
    return torch.clamp(best, 0.0, 1e6).mean() + cost.mean(), cost


def optimize_joint_pos(cfg: SKGSConfig, model: SKGSModel,
                       tids: torch.Tensor, lr: float = INIT_LR
                       ) -> torch.Tensor:
    """Adam on ``joint_pos`` over ``joint_pos_loss`` at the cached
    superpoint transforms of frame ``tids[i]`` in iteration i, the joint
    cost's running mean (``sk_momentum``) updated every iteration; both
    written back to the model. Returns the losses [len(tids)]."""
    jp = model.params['joint_pos'].detach().clone().requires_grad_(True)
    opt = optim.adam_init({'jp': jp.detach()})
    cost_mean = model.joint_cost.clone()
    mom = cfg.sk_momentum
    losses = []
    for i in range(tids.shape[0]):
        spT = take_frame(model.sp_cache, tids[i])[:, :7]
        with torch.enable_grad():
            loss, cost = joint_pos_loss(jp, spT, model.sp_alive)
            g, = torch.autograd.grad(loss, jp)
        with torch.no_grad():
            cost_mean = cost_mean * mom + cost * (1.0 - mom)
        opt = optim.adam_update({'jp': g}, opt, {'jp': jp}, {'jp': lr},
                                eps=INIT_EPS)
        losses.append(loss.detach())
    with torch.no_grad():
        model.params['joint_pos'].copy_(jp)
        model.joint_cost.copy_(cost_mean)
    return torch.stack(losses)


@torch.no_grad()
def finalize_joints(cfg: SKGSConfig, model: SKGSModel) -> torch.Tensor:
    """The joint tree from the joint cost (``skeleton.update_joint``, an
    MST on the host); each live non-root joint moves to its pivot with its
    parent, the root and dead joints to their superpoints; ``global_tr``
    takes the root superpoint's cached transform at every frame. Returns
    the root."""
    params = model.params
    sp_pts = params['sp_points'][..., :3]
    parents, depth, root = skeleton.update_joint(
        model.joint_cost, sp_pts, model.sp_alive, cfg.sk_knn_num)
    a = torch.arange(cfg.num_superpoints, device=sp_pts.device)
    b = parents[:, 0].to(torch.int64)
    keep = ((a == root) | ~model.sp_alive)[:, None]
    params['joints'].copy_(torch.where(keep, sp_pts,
                                       params['joint_pos'][a, b]))
    params['global_tr'].copy_(model.sp_cache.index_select(
        1, root.reshape(1).to(torch.int64))[:, 0, :7])
    model.joint_parents.copy_(parents)
    model.joint_depth.copy_(depth)
    model.joint_root.copy_(root)
    return root


def distill_sk_deform(cfg: SKGSConfig, model: SKGSModel,
                      tids: torch.Tensor, lr: float = INIT_LR
                      ) -> torch.Tensor:
    """Fit the skeleton net, ``joints``, ``global_tr`` and the LBS leaves
    the model has (``DISTILL_LEAVES``) to the cached superpoint motion at
    frame ``tids[i]`` in iteration i, with a fresh Adam: 0.01 cmp_t (the
    SE3 log distance of the joint transforms to the superpoints') + cmp_p
    (the squared distance of the Gaussians warped by the skeleton to where
    the frozen LBS of ``sp_cache`` takes them) + 0.01 cmp_r + 0.01 cmp_s
    (the net's rotation and scale deltas to the cached ones), each a mean
    over the live rows. The model's leaves are updated in place; no
    ``.grad`` is left on them. Returns the losses [len(tids)]."""
    params = model.params
    points_c = params['xyz'].detach()
    sp_w, sp_k = model.sp_weights, model.sp_knn
    largest = cfg.warp_method == 'largest'
    dense_sp_w = None if largest else superpoints.dense_lbs_rows(
        sp_w, sp_k, cfg.num_superpoints)
    empty = points_c.new_zeros((cfg.num_superpoints, 0))
    leaves = {k: p for k, p in model.leaves().items()
              if k.split('/')[0] in DISTILL_LEAVES}
    opt = optim.adam_init({k: p.detach() for k, p in leaves.items()})
    lrs = {k: lr for k in leaves}
    sp_alive, alive = model.sp_alive, model.alive
    losses = []
    for i in range(tids.shape[0]):
        tid = tids[i]
        t = take_frame(model.train_times, tid)
        sp_tr, sp_d_rot, sp_d_scale = split_sp_cache(
            cfg, take_frame(model.sp_cache, tid))
        with torch.no_grad():
            if largest:
                d1 = superpoints.warp_points(points_c, sp_tr, sp_w, sp_k,
                                             cfg.warp_method, model.p2sp)
            else:
                d1 = superpoints.warp_blend_dense(points_c, sp_tr, dense_sp_w,
                                                  empty, empty)[0]
            points_t1 = points_c + d1
        with torch.enable_grad():
            out = sk_stage(cfg, model, points_c, t, time_id=tid,
                           training=True)
            diff = se3.se3_log(se3.se3_mul(se3.se3_inv(sp_tr),
                                           out.aux['skT']))
            cmp_t = masked_mean(skeleton._safe_norm(diff), sp_alive)
            cmp_p = masked_mean(torch.square(points_t1
                                             - (points_c + out.d_xyz)),
                                alive[:, None])
            cmp_r = masked_mean(torch.square(out.aux['sk_rot'] - sp_d_rot),
                                sp_alive[:, None])
            cmp_s = masked_mean(torch.square(out.aux['sk_scale']
                                             - sp_d_scale), sp_alive[:, None])
            loss = 0.01 * cmp_t + cmp_p + 0.01 * cmp_r + 0.01 * cmp_s
            grads = torch.autograd.grad(loss, list(leaves.values()),
                                        allow_unused=True)
        opt = optim.adam_update(dict(zip(leaves, grads)), opt, leaves, lrs,
                                eps=INIT_EPS)
        losses.append(loss.detach())
    return torch.stack(losses)


def init_skeleton(cfg: SKGSConfig, model: SKGSModel,
                  joint_tids: torch.Tensor, distill_tids: torch.Tensor
                  ) -> Dict[str, torch.Tensor]:
    """The sp -> sk transition (``sk_gs_ops.py:355-384``), in place:
    ``freeze_lbs``, the pivots at the superpoint midpoints, then
    ``optimize_joint_pos`` over the frames ``joint_tids``,
    ``finalize_joints`` and ``distill_sk_deform`` over ``distill_tids``
    (integer tensors on the model's device; the JAX package draws them
    from its key). Returns both loops' losses, 'joint_loss' and
    'distill_loss'."""
    freeze_lbs(cfg, model)
    with torch.no_grad():
        model.params['joint_pos'].copy_(joint_pos_init_midpoint(model.params))
    joint_loss = optimize_joint_pos(cfg, model, joint_tids)
    finalize_joints(cfg, model)
    distill_loss = distill_sk_deform(cfg, model, distill_tids)
    return {'joint_loss': joint_loss, 'distill_loss': distill_loss}
