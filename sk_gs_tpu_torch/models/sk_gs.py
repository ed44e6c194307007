"""SK-GS: skeleton-driven dynamic Gaussian splatting (port of ``SKGSConfig``,
the model state, ``init_model``, ``init_stage``, ``sp_stage``, ``sk_stage``
and ``forward_deltas`` of ``sk_gs_tpu/models/sk_gs.py``).

Ported: the ``static`` stage (zero deltas); the ``init`` family, one warp
field (``sp_deform``) on all Gaussians, where ``init_fix`` detaches its
output; the ``sp`` family, the warp net run on the superpoints and blended
onto the Gaussians by their K-nearest LBS weights (``sp_fix`` detaches the
three deltas, not the weights); and the ``sk`` family, served by running
the skeleton net at time t with the per-frame root transform interpolated
between the two neighbouring train frames, and trained at a train frame's
own root transform (``time_id``), where ``sk_fix`` detaches the skeleton's
outputs and the net's output row is returned for the ``sk_cache``. The
``sk_init`` stage runs the ``sk`` warp undetached; its losses read the
frozen LBS ``sp_weights`` / ``sp_knn`` that the skeleton initialisation
writes (``sk_gs_ops.init_skeleton``). Served with ``test_time_interpolate``,
the ``sk`` family reads the skeleton net's outputs from the per-frame
``sk_cache`` instead of running the net; ``sk_r_delta`` reposes the joints.
Nets that are not ``is_blender`` (real captures) train the ``init`` and
``sp`` families at a noisy time t + n dt s, n a standard normal draw the
caller hands in and s the annealed ``smooth_scale`` of the step. Served
on a card, the sk and sp families run as one CUDA graph replay
(``forward_deltas``, ``models/deform_graph.py``).
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch import nn

from .. import resolve_device
from ..ops import quaternion as quat
from ..ops import se3
from ..render.settings import RasterConfig
from ..utils.tracing import span
from . import skeleton, superpoints
from .deform import (DeformNet, DeformNetConfig, SkeletonNetConfig,
                     deform_net_apply, deform_net_init, skeleton_net_apply,
                     skeleton_net_init)
from .deform_graph import DeformGraph
from .gaussian_splatting import GaussianConfig, GaussianModel

STAGE_NAMES = ('static', 'init_fix', 'init', 'sp_fix', 'sp', 'sk_init',
               'sk_fix', 'sk')
SK_STAGES = ('sk_init', 'sk_fix', 'sk')
SP_STAGES = ('sp_fix', 'sp')


class SKGSConfig(NamedTuple):
    """Every field of the JAX ``SKGSConfig``, so that a configuration maps
    one to one; serving reads the model widths, ``LBS_method`` and
    ``test_time_interpolate``, and the rest waits for training."""
    gauss: GaussianConfig = GaussianConfig()
    net: DeformNetConfig = DeformNetConfig()
    sk_net: SkeletonNetConfig = SkeletonNetConfig()
    train_schedule: Tuple[Tuple[str, int], ...] = (
        ('static', 0), ('init_fix', 2000), ('init', 8000), ('sp_fix', 3000),
        ('sp', 27000), ('sk_init', 0), ('sk_fix', 0), ('sk', 40000))
    num_superpoints: int = 512     # M capacity
    num_knn: int = 5
    hyper_dim: int = 8
    which_rotation: str = 'quaternion'
    sk_feature_dim: int = 0
    LBS_method: str = 'W'
    warp_method: str = 'LBS'
    sep_rot: bool = False
    num_frames: int = 50
    canonical_time_id: int = 0
    use_canonical_net: bool = True
    canonical_replace_steps: Tuple[int, ...] = (20000,)
    sk_knn_num: int = 6
    sk_momentum: float = 0.9
    joint_update_interval: Tuple[int, int, int] = (1000, 20000, 40000)
    joint_init_steps: int = 10000
    init_num_times: int = 16
    init_sampling_step: int = 7500
    node_max_num_ratio_during_init: int = 16
    sp_prune_threshold: float = 1e-3
    sp_split_threshold: float = 0.0002
    sp_merge_threshold: float = 0.0005
    sp_adjust_interval: Tuple[int, int, int] = (100, 10_000, 20_000)
    sp_merge_interval: Tuple[int, int, int] = (100, 20_000, 30_000)
    sp_guided_detach: bool = True
    guided_step_start: int = 40000
    f_s: float = 0.1
    annealing_steps: int = 20000
    test_time_interpolate: bool = False
    lr_deform_scale: float = 1.0
    lr_feature_scale: float = 2.5
    lr_deform_max_steps: int = 40000
    lr_joints: float = 0.1

    @property
    def stages(self) -> Dict[str, Tuple[int, int, int]]:
        """(start, end, length) of every stage, in schedule order."""
        sched = dict(self.train_schedule)
        out = {}
        step = 0
        for name in STAGE_NAMES:  # every stage present, possibly empty
            n = int(sched.get(name, 0))
            out[name] = (step, step + n, n)
            step += n
        return out

    @property
    def total_steps(self) -> int:
        return sum(n for _, n in self.train_schedule)

    @property
    def time_interval(self) -> float:
        return 1.0 / self.num_frames

    def stage_at(self, step: int) -> str:
        """The stage whose (start, end] holds ``step``; 'sk' past the end."""
        for name, (start, end, _) in self.stages.items():
            if start < step <= end:
                return name
        return 'sk'

    @property
    def sp_cache_dim(self) -> int:
        """Width of an ``sp_cache`` row: the SE3 (7), the separate rotation
        (4) with ``sep_rot``, the scale delta (3)."""
        return 14 if self.sep_rot else 10


class StageOutputs(NamedTuple):
    d_xyz: torch.Tensor
    d_rotation: torch.Tensor
    d_scaling: torch.Tensor
    aux: Dict[str, torch.Tensor]


# The parameter leaves the serving path reads, besides the skeleton net.
GAUSS_LEAVES = ('xyz', 'f_dc', 'f_rest', 'scaling', 'rotation', 'opacity')
SK_LEAVES = ('joints', 'global_tr', 'sp_W', 'sp_radius', 'sp_weight',
             'sk_feature')
# Leaves of the superpoint families, carried through every stage as the JAX
# model carries them (the init family leaves them untouched).
SP_LEAVES = ('hyper', 'sp_points', 'sp_hyper', 'joint_pos')
# The warp nets: ``sp_deform`` (the init and sp families) and the
# ``canonical`` net of the consistency loss.
DEFORM_NETS = ('sp_deform', 'canonical')
AUX_BUFFERS = ('alive', 'active_sh_degree', 'sp_alive', 'joint_parents',
               'joint_root', 'train_times')
# Training state: the densification statistics, the per-frame caches of the
# skeleton net's outputs ([frames, M, sum(sk_net.out_dims)]) and of the
# superpoint transforms ([frames, M, sp_cache_dim]), the joint cost's
# running mean [M, M], the heaviest superpoint of each Gaussian [N]
# (``warp_method`` 'largest'), and the LBS weights [N, K] and superpoints
# [N, K] that the skeleton initialisation freezes for the sk stages.
# ``joint_depth`` [M] is each joint's depth in the tree, which the port
# keeps for the checkpoint and reads nowhere.
STAT_BUFFERS = ('max_radii2d', 'xyz_grad_accum', 'denom', 'sk_cache',
                'sp_cache', 'joint_cost', 'p2sp', 'sp_weights', 'sp_knn',
                'joint_depth')
INT_BUFFERS = ('p2sp', 'sp_knn', 'joint_depth')


class SKGSModel(nn.Module):
    """An SK-GS model on one device: capacity-padded Gaussian leaves
    (``alive`` marks live slots), the skeleton (joints, per-frame root
    transforms, parents table, LBS matrix), the skeleton net, the warp nets
    ``sp_deform`` and ``canonical`` when the model has them, and the
    training statistics. Built by ``convert.model_from_flat`` or
    ``init_model``. Frozen unless ``trainable``: then every leaf and the
    nets' weights require grad."""

    def __init__(self, cfg: SKGSConfig, rcfg: RasterConfig,
                 params: Dict[str, torch.Tensor], sk_deform: nn.Module,
                 buffers: Dict[str, torch.Tensor], trainable: bool = False,
                 sp_deform: Optional[DeformNet] = None,
                 canonical: Optional[DeformNet] = None):
        super().__init__()
        self.cfg = cfg
        self.rcfg = rcfg
        self.params = nn.ParameterDict(
            {k: nn.Parameter(v, requires_grad=trainable)
             for k, v in params.items()})
        self.sk_deform = sk_deform.requires_grad_(trainable)
        for name, net in (('sp_deform', sp_deform), ('canonical', canonical)):
            setattr(self, name,
                    None if net is None else net.requires_grad_(trainable))
        for name in AUX_BUFFERS:
            self.register_buffer(name, buffers[name])
        self.deform_graph = DeformGraph()
        xyz = params['xyz']
        n, m = xyz.shape[0], params['joints'].shape[0]
        zeros = {'max_radii2d': (n,), 'xyz_grad_accum': (n,), 'denom': (n,),
                 'sk_cache': (cfg.num_frames, m, sum(cfg.sk_net.out_dims)),
                 'sp_cache': (cfg.num_frames, m, cfg.sp_cache_dim),
                 'joint_cost': (m, m), 'p2sp': (n,),
                 'sp_weights': (n, cfg.num_knn), 'sp_knn': (n, cfg.num_knn),
                 'joint_depth': (m,)}
        for name in STAT_BUFFERS:
            buf = buffers.get(name)
            if buf is None:
                buf = torch.zeros(zeros[name], device=xyz.device,
                                  dtype=torch.int32 if name in INT_BUFFERS
                                  else torch.float32)
            self.register_buffer(name, buf)

    @property
    def device(self) -> torch.device:
        return self.params['xyz'].device

    def gauss_view(self) -> GaussianModel:
        """The Gaussian leaves, ``alive`` and the statistics, as the model's
        own tensors (in-place edits reach the model)."""
        return GaussianModel(params=dict(self.params), alive=self.alive,
                             active_sh_degree=self.active_sh_degree,
                             max_radii2d=self.max_radii2d,
                             xyz_grad_accum=self.xyz_grad_accum,
                             denom=self.denom)

    def nets(self) -> Dict[str, nn.Module]:
        """The nets the model has, by their JAX leaf names."""
        nets = {'sk_deform': self.sk_deform, 'sp_deform': self.sp_deform,
                'canonical': self.canonical}
        return {k: v for k, v in nets.items() if v is not None}

    def leaves(self) -> Dict[str, nn.Parameter]:
        """Every trainable leaf by its JAX name: the params (``xyz``, ...)
        and the nets' weights (``sk_deform/layers/0/w``,
        ``sp_deform/trunk/0/w``, ...)."""
        out = dict(self.params.items())
        for net_name, net in self.nets().items():
            for name, p in net.named_parameters():
                out[net_name + '/' + name.replace('.', '/')] = p
        return out


def init_model(cfg: SKGSConfig, rcfg: RasterConfig, base: GaussianModel,
               train_times: np.ndarray, seed: int = 0, device='cuda',
               trainable: bool = True) -> SKGSModel:
    """The SK-GS state around a freshly initialised ``GaussianModel``
    (``sk_gs.py:158-209``): hyper features at -1e-2, random superpoints,
    ``sp_W`` ones (LBS_method 'W'), zero joints and joint pivots, identity
    root transforms, the warp nets (``sp_deform``; ``canonical`` when the
    config uses it) and the skeleton net freshly initialised, every
    superpoint alive. The random draws come from a CPU generator seeded
    with ``seed`` and are moved to ``device``, so a CPU and a card model of
    one seed are equal (the JAX package's random stream is not matched)."""
    device = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    n_cap, m, nf = base.capacity, cfg.num_superpoints, cfg.num_frames

    def randn(*shape):
        return torch.randn(shape, generator=gen).to(device)

    params = {k: v.detach().clone().to(device)
              for k, v in base.params.items()}
    params['hyper'] = torch.full((n_cap, cfg.hyper_dim), -1e-2,
                                 device=device)
    params['sp_points'] = randn(m, 3)
    params['sp_hyper'] = torch.zeros((m, cfg.hyper_dim), device=device)
    if cfg.LBS_method == 'W':
        params['sp_W'] = torch.ones((n_cap, m), device=device)
    if cfg.LBS_method in ('kernel', 'weighted_kernel'):
        params['sp_radius'] = randn(m)
    if cfg.LBS_method == 'weighted_kernel':
        params['sp_weight'] = torch.zeros(m, device=device)
    params['joints'] = torch.zeros((m, 3), device=device)
    params['joint_pos'] = torch.zeros((m, m, 3), device=device)
    params['global_tr'] = se3.se3_identity((nf,), device=device)
    sp_deform = deform_net_init(cfg.net, gen).to(device)
    canonical = (deform_net_init(cfg.net, gen).to(device)
                 if cfg.use_canonical_net and cfg.canonical_time_id >= 0
                 else None)
    sk_deform = skeleton_net_init(cfg.sk_net, gen).to(device)
    if cfg.sk_feature_dim > 0:
        params['sk_feature'] = randn(m, cfg.sk_feature_dim)
    buffers = {
        'alive': base.alive.to(device),
        'active_sh_degree': base.active_sh_degree.to(device),
        'sp_alive': torch.ones(m, dtype=torch.bool, device=device),
        'joint_parents': torch.zeros((m, skeleton.MAX_LEVELS),
                                     dtype=torch.int32, device=device),
        'joint_root': torch.zeros((), dtype=torch.int32, device=device),
        'train_times': torch.as_tensor(np.asarray(train_times),
                                       dtype=torch.float32, device=device),
    }
    for name in ('max_radii2d', 'xyz_grad_accum', 'denom'):
        if getattr(base, name) is not None:
            buffers[name] = getattr(base, name).to(device)
    return SKGSModel(cfg, rcfg, params, sk_deform, buffers,
                     trainable=trainable, sp_deform=sp_deform,
                     canonical=canonical)


def smooth_scale(cfg: SKGSConfig, step: int) -> float:
    """The time noise's scale at ``step`` (``sk_gs.py:234-246``): ``f_s``
    falling linearly to 1e-15 over ``annealing_steps``, counted from the
    start of ``sp_fix`` once it has started. Host-side."""
    sp_fix_start = cfg.stages['sp_fix'][0]
    s = step if step <= sp_fix_start else step - sp_fix_start
    lr_init, lr_final = cfg.f_s, 1e-15
    lr_delay_steps, lr_delay_mult = 0.01, 1.0
    if s < 0 or (lr_init == 0.0 and lr_final == 0.0):
        return 0.0
    delay_rate = lr_delay_mult + (1 - lr_delay_mult) * np.sin(
        0.5 * np.pi * np.clip(s / lr_delay_steps, 0, 1))
    t = np.clip(s / cfg.annealing_steps, 0, 1)
    return float(delay_rate * (lr_init * (1 - t) + lr_final * t))


def noisy_time(cfg: SKGSConfig, t: torch.Tensor,
               noise: Optional[torch.Tensor], noise_scale: float
               ) -> torch.Tensor:
    """t + noise * time_interval * noise_scale for a net that is not
    ``is_blender``, given a draw ``noise`` and a scale > 0; else t."""
    if not cfg.net.is_blender and noise is not None and noise_scale > 0:
        return t + noise * cfg.time_interval * noise_scale
    return t


def init_stage(cfg: SKGSConfig, model: SKGSModel, points: torch.Tensor,
               t: torch.Tensor, use_canonical: bool = False,
               noise: Optional[torch.Tensor] = None,
               noise_scale: float = 0.0) -> StageOutputs:
    """One warp field on all Gaussians (``sk_gs.py:293-302``): the
    ``sp_deform`` net (or ``canonical``) at (points, ``noisy_time``), the
    points detached. The rotation and scale deltas are zero."""
    t = noisy_time(cfg, t, noise, noise_scale)
    net = model.canonical if use_canonical else model.sp_deform
    if net is None:
        raise ValueError('the model has no '
                         + ('canonical' if use_canonical else 'sp_deform')
                         + ' net')
    d_xyz = deform_net_apply(net, cfg.net, points.detach(), t)['d_xyz']
    zero = torch.zeros((), device=points.device)
    return StageOutputs(d_xyz, zero, zero, {})


def lbs_weights(cfg: SKGSConfig, params, sp_alive: torch.Tensor,
                points: torch.Tensor):
    """(weights [N, K], indices [N, K]) of ``points`` over the live
    superpoints, in (xyz, hyper) space when the model has hyper features."""
    hyper = cfg.hyper_dim > 0
    return superpoints.calc_lbs_weight(
        points, params['sp_points'][..., :3], sp_alive, cfg.num_knn,
        cfg.LBS_method,
        hyper=params['hyper'] if hyper else None,
        sp_hyper=params['sp_hyper'] if hyper else None,
        sp_W=params['sp_W'] if 'sp_W' in params else None,
        sp_radius_raw=params['sp_radius'] if 'sp_radius' in params else None,
        sp_weight_raw=params['sp_weight'] if 'sp_weight' in params else None)


def sp_net_outputs(cfg: SKGSConfig, net: DeformNet, sp_points: torch.Tensor,
                   t: torch.Tensor):
    """The warp net at the (detached) superpoints: (d_xyz, the rotation
    normalised after the identity bias, the separate rotation likewise or
    None, d_scaling)."""
    outs = deform_net_apply(net, cfg.net, sp_points.detach(), t)
    bias = superpoints.rot_bias(outs['d_rotation'])
    d_rot = quat.normalize(outs['d_rotation'] + bias)
    g_rot = quat.normalize(outs['g_rotation'] + bias) if cfg.sep_rot else None
    return outs['d_xyz'], d_rot, g_rot, outs['d_scaling']


def sp_cache_row(cfg: SKGSConfig, spT: torch.Tensor,
                 g_rot: Optional[torch.Tensor], d_scale: torch.Tensor
                 ) -> torch.Tensor:
    """[M, sp_cache_dim]: the SE3, the separate rotation with ``sep_rot``,
    the scale delta."""
    parts = [spT] + ([g_rot] if cfg.sep_rot else []) + [d_scale]
    return torch.cat(parts, dim=-1)


def split_sp_cache(cfg: SKGSConfig, row: torch.Tensor):
    """An ``sp_cache`` row -> (the SE3 [..., 7], the rotation [..., 4]: the
    separate one with ``sep_rot``, else the SE3's own, the scale delta
    [..., 3])."""
    if cfg.sep_rot:
        return row[..., :7], row[..., 7:11], row[..., 11:14]
    return row[..., :7], row[..., 3:7], row[..., 7:10]


def take_frame(x: torch.Tensor, time_id) -> torch.Tensor:
    """``x[time_id]`` for an int or a 0-d integer tensor; a tensor index
    goes through ``index_select``, so that the host never reads it (a 0-d
    tensor subscript reads its value on the host, a device sync, which a
    CUDA graph cannot capture)."""
    if isinstance(time_id, torch.Tensor):
        return x.index_select(0, time_id.reshape(1).to(torch.int64))[0]
    return x[time_id]


def sp_stage(cfg: SKGSConfig, model: SKGSModel, points: torch.Tensor,
             t: torch.Tensor, use_canonical: bool = False,
             frozen_weights: Optional[torch.Tensor] = None,
             frozen_knn: Optional[torch.Tensor] = None,
             sp_points: Optional[torch.Tensor] = None,
             noise: Optional[torch.Tensor] = None,
             noise_scale: float = 0.0) -> StageOutputs:
    """Superpoint-driven LBS warp (``sk_gs.py:305-352``): the warp net
    (``canonical`` with ``use_canonical``, which needs the frozen weights)
    at the superpoints (``sp_points`` when given) and time t
    (``noisy_time``) gives one SE3
    per superpoint; the points (detached) take the blend of their K
    superpoints' transforms by their LBS weights, or their heaviest
    superpoint's alone with ``warp_method`` 'largest'. ``frozen_weights``
    / ``frozen_knn`` reuse another pass's weights on the same points: the
    weights do not depend on t. The aux holds the transforms 'spT', the
    weights 'knn_w' / 'knn_i', the superpoints' 'sp_rot' / 'sp_scale', the
    assignment 'p2sp' and the ``sp_cache`` row 'cache_row'. The warp net is
    an 'sk.deform.net' span, the LBS weights and the blend an
    'sk.deform.lbs' span."""
    params = model.params
    points = points.detach()
    sp_points_ = params['sp_points'][..., :3] if sp_points is None \
        else sp_points
    t = noisy_time(cfg, t, noise, noise_scale)
    name = 'canonical' if use_canonical else 'sp_deform'
    net = getattr(model, name)
    if net is None:
        raise ValueError(f'the model has no {name} net')
    with span('sk.deform.net'):
        d_xyz_sp, d_rot_sp, g_rot, d_scale_sp = sp_net_outputs(
            cfg, net, sp_points_, t)
    spT = superpoints.sp_transforms(d_xyz_sp, d_rot_sp, sp_points_,
                                    cfg.warp_method)
    rot_attr = g_rot if g_rot is not None else d_rot_sp
    with span('sk.deform.lbs'):
        if use_canonical or frozen_weights is not None:
            weights, indices = frozen_weights, frozen_knn
        else:
            weights, indices = lbs_weights(cfg, params, model.sp_alive,
                                           points)
        idx = indices.to(torch.int64)
        p2sp = torch.gather(idx, 1, torch.argmax(weights, dim=-1,
                                                 keepdim=True))[:, 0]
        if cfg.warp_method == 'largest':
            d_points = superpoints.warp_points(points, spT, weights, indices,
                                               cfg.warp_method, p2sp)
            d_rotation = superpoints.blend_attr(rot_attr, weights, indices)
            d_scaling = superpoints.blend_attr(d_scale_sp, weights, indices)
        else:
            dense_w = superpoints.dense_lbs_rows(weights, indices,
                                                 spT.shape[0])
            d_points, d_rotation, d_scaling = superpoints.warp_blend_dense(
                points, spT, dense_w, rot_attr, d_scale_sp)
    aux = {'spT': spT, 'knn_w': weights, 'knn_i': indices,
           'sp_rot': rot_attr, 'sp_scale': d_scale_sp,
           'p2sp': p2sp.to(torch.int32),
           'cache_row': sp_cache_row(cfg, spT, g_rot, d_scale_sp)}
    return StageOutputs(d_points, d_rotation, d_scaling, aux)


def skeleton_net_input(params, joints: torch.Tensor) -> torch.Tensor:
    """Joints, plus the learned per-joint features when the model has them."""
    if 'sk_feature' in params:
        return torch.cat([joints, params['sk_feature']], dim=-1)
    return joints


def sk_rot_activation(sk_r: torch.Tensor, biased: bool = False
                      ) -> torch.Tensor:
    """Raw rotation head -> unit quaternion: a 4-dim head gets the identity
    bias and is normalised; a 3-dim head is an axis-angle through so3_exp.
    ``biased`` marks rows that already carry the bias (``sk_cache`` rows):
    they are normalised only."""
    if sk_r.shape[-1] == 4:
        if biased:
            return quat.normalize(sk_r)
        # made on the device: a host tensor's copy would synchronise
        bias = torch.eye(4, dtype=sk_r.dtype, device=sk_r.device)[3]
        return quat.normalize(sk_r + bias)
    return se3.so3_exp(sk_r)


def frame_weight(train_times: torch.Tensor, t: torch.Tensor):
    """(idx1, idx2, w) of time ``t`` between the train frames: the frames
    around t (clamped to the first and last pair) and t's offset from idx1
    as a share of their gap, unclipped. The frames' times are taken on the
    device (``take_frame``): no host sync."""
    t0 = t.reshape(())
    idx2 = torch.clamp(torch.searchsorted(train_times, t0.reshape(1)), 1,
                       train_times.shape[0] - 1)[0]
    idx1 = idx2 - 1
    t1, t2 = take_frame(train_times, idx1), take_frame(train_times, idx2)
    w = (t0 - t1) / torch.clamp(t2 - t1, min=1e-8)
    return idx1, idx2, w


def sk_stage(cfg: SKGSConfig, model: SKGSModel, points: torch.Tensor,
             t: torch.Tensor, time_id=None, sk_r_delta=None,
             detach: bool = False, training: bool = False) -> StageOutputs:
    """Skeleton-driven warp via forward kinematics and dense LBS.
    ``time_id`` (an int or a 0-d integer tensor) takes that train frame's
    root transform; ``detach`` (the ``sk_fix`` stage) cuts the gradient of
    the joint transforms and the net's rotation and scale deltas;
    ``sk_r_delta`` [M, 3 | 4] reposes each joint's rotation. The aux
    'cache_row' [M, sum(out_dims)] is what the trainer stores in
    ``sk_cache``: the normalised quaternion (the raw axis-angle in lie
    mode), then the rotation and scale deltas; 'sk_rot' / 'sk_scale' are
    the net's per-joint rotation and scale deltas [M, .].

    Served (``training`` False) with ``cfg.test_time_interpolate``, the
    net's outputs come from ``sk_cache``: the row of ``time_id``, or the
    rows of the two train frames around t blended linearly, the weight
    clipped to [0, 1] (the root transform's is not clipped). The JAX
    package's ``training`` defaults to True; the port's to False, so a
    caller that trains says so."""
    params = model.params
    points = points.detach()
    joints = params['joints']

    if time_id is not None:
        g_tr = take_frame(params['global_tr'], time_id)
    else:
        idx1, idx2, w = frame_weight(model.train_times, t)
        g_tr = se3.se3_interpolate(take_frame(params['global_tr'], idx1),
                                   take_frame(params['global_tr'], idx2), w)

    if not training and cfg.test_time_interpolate:
        if time_id is not None:
            row = take_frame(model.sk_cache, time_id)
        else:
            w = torch.clamp(w, 0.0, 1.0)
            row = (1.0 - w) * take_frame(model.sk_cache, idx1) \
                + w * take_frame(model.sk_cache, idx2)
        dims = tuple(cfg.sk_net.out_dims)
        d_rot = row[:, dims[0]:dims[0] + dims[1]]
        d_scale = row[:, dims[0] + dims[1]:]
        sk_r = sk_rot_activation(row[:, :dims[0]], biased=True)
        cache_row = row
    else:
        x_in = skeleton_net_input(params, joints)
        sk_r_raw, d_rot, d_scale = skeleton_net_apply(
            model.sk_deform, cfg.sk_net, x_in, t)
        sk_r = sk_rot_activation(sk_r_raw)
        cached_r = sk_r if sk_r_raw.shape[-1] == 4 else sk_r_raw
        cache_row = torch.cat([cached_r, d_rot, d_scale], dim=-1)
    with span('sk.deform.fk'):
        sk_T = skeleton.kinematic_transforms(joints, sk_r, g_tr,
                                             model.joint_parents,
                                             model.joint_root, sk_r_delta)
    if detach:
        sk_T, d_rot, d_scale = sk_T.detach(), d_rot.detach(), d_scale.detach()
    with span('sk.deform.lbs'):
        weights, indices = superpoints.calc_lbs_weight(
            points, joints, model.sp_alive, cfg.num_knn, cfg.LBS_method,
            sp_W=params.get('sp_W'), sp_radius_raw=params.get('sp_radius'),
            sp_weight_raw=params.get('sp_weight'))
        dense_w = superpoints.dense_lbs_rows(weights, indices, sk_T.shape[0])
        d_xyz, d_rotation, d_scaling = superpoints.warp_blend_dense(
            points, sk_T, dense_w, d_rot, d_scale)
    aux = {'skT': sk_T, 'knn_w': weights, 'knn_i': indices, 'g_tr': g_tr,
           'sk_rot': d_rot, 'sk_scale': d_scale, 'cache_row': cache_row}
    return StageOutputs(d_xyz, d_rotation, d_scaling, aux)


def forward_deltas(cfg: SKGSConfig, model: SKGSModel, t: torch.Tensor,
                   stage: str, time_id=None, sk_r_delta=None,
                   training: bool = False,
                   noise: Optional[torch.Tensor] = None,
                   noise_scale: float = 0.0) -> StageOutputs:
    """Stage-dispatched deformation deltas; ``noise`` / ``noise_scale``
    are the time noise of the init and sp families (``noisy_time``). The
    whole of it is an 'sk.deform' span.

    A served sk or sp stage is one CUDA graph replay (``model.deform_graph``,
    ``models/deform_graph.py``) when the model lies on a CUDA device,
    ``time_id`` is None, ``training`` is False, ``noise`` is None and
    autograd records nothing (grad off, or no input requiring grad); the
    first such call, and every call after a model tensor the stage reads was
    replaced, captures the eager code below first. A replay hands out the
    three deltas as fresh tensors, but the aux entries are the graph's
    buffers: valid until the next call on the model. It makes an
    'sk.deform.replay' span (a capture an 'sk.deform.capture'), and no
    'sk.deform.fk' / 'sk.deform.net' / 'sk.deform.lbs'. Every other call
    (the CPU, the trainer's steps, time noise, the static and init
    families) runs the eager code."""
    with span('sk.deform'):
        graph = model.deform_graph
        if stage in SK_STAGES and graph.engages(
                model, t, time_id, sk_r_delta, training, stage):
            return graph(
                cfg, model, stage, t, sk_r_delta,
                lambda t_, delta: sk_stage(
                    cfg, model, model.params['xyz'], t_, None, delta,
                    detach=stage == 'sk_fix'))
        if stage in SP_STAGES and noise is None and graph.engages(
                model, t, time_id, None, training, stage):
            return graph(
                cfg, model, stage, t, None,
                lambda t_, _: sp_stage(cfg, model, model.params['xyz'], t_))
        if stage == 'static':
            zero = torch.zeros((), device=model.device)
            return StageOutputs(zero, zero, zero, {})
        if stage in ('init', 'init_fix'):
            out = init_stage(cfg, model, model.params['xyz'], t, noise=noise,
                             noise_scale=noise_scale)
            if stage == 'init_fix':
                out = out._replace(d_xyz=out.d_xyz.detach())
            return out
        if stage in SP_STAGES:
            out = sp_stage(cfg, model, model.params['xyz'], t, noise=noise,
                           noise_scale=noise_scale)
            if stage == 'sp_fix':
                out = out._replace(d_xyz=out.d_xyz.detach(),
                                   d_rotation=out.d_rotation.detach(),
                                   d_scaling=out.d_scaling.detach())
            return out
        if stage in SK_STAGES:
            return sk_stage(cfg, model, model.params['xyz'], t, time_id,
                            sk_r_delta, detach=stage == 'sk_fix',
                            training=training)
        raise ValueError(f'unknown stage {stage!r}')
