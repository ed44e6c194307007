"""SK-GS: skeleton-driven dynamic Gaussian splatting, serving side (port of
``SKGSConfig``, the model state, ``sk_stage`` and ``forward_deltas`` of
``sk_gs_tpu/models/sk_gs.py``).

Ported: the ``static`` stage (zero deltas) and the ``sk`` family evaluated
by running the skeleton net at time t, with the per-frame root transform
interpolated between the two neighbouring train frames. Not ported yet, and
raising ``NotImplementedError``: the ``init`` and ``sp`` families, the
``test_time_interpolate`` branch over the cached skeleton outputs, and
``sk_r_delta`` reposing.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch
from torch import nn

from ..ops import quaternion as quat
from ..ops import se3
from ..render.settings import RasterConfig
from . import skeleton, superpoints
from .deform import DeformNetConfig, SkeletonNetConfig, skeleton_net_apply
from .gaussian_splatting import GaussianConfig, GaussianModel

STAGE_NAMES = ('static', 'init_fix', 'init', 'sp_fix', 'sp', 'sk_init',
               'sk_fix', 'sk')
SK_STAGES = ('sk_init', 'sk_fix', 'sk')


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


class StageOutputs(NamedTuple):
    d_xyz: torch.Tensor
    d_rotation: torch.Tensor
    d_scaling: torch.Tensor
    aux: Dict[str, torch.Tensor]


# The parameter leaves the serving path reads, besides the skeleton net.
GAUSS_LEAVES = ('xyz', 'f_dc', 'f_rest', 'scaling', 'rotation', 'opacity')
SK_LEAVES = ('joints', 'global_tr', 'sp_W', 'sp_radius', 'sp_weight',
             'sk_feature')
AUX_BUFFERS = ('alive', 'active_sh_degree', 'sp_alive', 'joint_parents',
               'joint_root', 'train_times')


class SKGSModel(nn.Module):
    """A trained SK-GS model on one device: capacity-padded Gaussian leaves
    (``alive`` marks live slots), the skeleton (joints, per-frame root
    transforms, parents table, LBS matrix) and the skeleton net. Built by
    ``convert.model_from_flat``; the weights are frozen (serving)."""

    def __init__(self, cfg: SKGSConfig, rcfg: RasterConfig,
                 params: Dict[str, torch.Tensor], sk_deform: nn.Module,
                 buffers: Dict[str, torch.Tensor]):
        super().__init__()
        self.cfg = cfg
        self.rcfg = rcfg
        self.params = nn.ParameterDict(
            {k: nn.Parameter(v, requires_grad=False) for k, v in params.items()})
        self.sk_deform = sk_deform.requires_grad_(False)
        for name in AUX_BUFFERS:
            self.register_buffer(name, buffers[name])

    @property
    def device(self) -> torch.device:
        return self.params['xyz'].device

    def gauss_view(self) -> GaussianModel:
        return GaussianModel(params=dict(self.params), alive=self.alive,
                             active_sh_degree=self.active_sh_degree)


def skeleton_net_input(params, joints: torch.Tensor) -> torch.Tensor:
    """Joints, plus the learned per-joint features when the model has them."""
    if 'sk_feature' in params:
        return torch.cat([joints, params['sk_feature']], dim=-1)
    return joints


def sk_rot_activation(sk_r: torch.Tensor) -> torch.Tensor:
    """Raw rotation head -> unit quaternion: a 4-dim head gets the identity
    bias and is normalised; a 3-dim head is an axis-angle through so3_exp."""
    if sk_r.shape[-1] == 4:
        bias = torch.tensor([0.0, 0.0, 0.0, 1.0], device=sk_r.device)
        return quat.normalize(sk_r + bias)
    return se3.so3_exp(sk_r)


def sk_stage(cfg: SKGSConfig, model: SKGSModel, points: torch.Tensor,
             t: torch.Tensor, time_id: Optional[int] = None,
             sk_r_delta=None, training: bool = False) -> StageOutputs:
    """Skeleton-driven warp via forward kinematics and dense LBS."""
    if sk_r_delta is not None:
        raise NotImplementedError('sk_r_delta reposing is not ported yet')
    if not training and cfg.test_time_interpolate:
        raise NotImplementedError(
            'test_time_interpolate (the sk_cache branch) is not ported yet')
    params = model.params
    points = points.detach()
    joints = params['joints']

    if time_id is not None:
        g_tr = params['global_tr'][time_id]
    else:
        tt = model.train_times
        t0 = t.reshape(())
        idx2 = torch.clamp(torch.searchsorted(tt, t0.reshape(1)), 1,
                           tt.shape[0] - 1)[0]
        idx1 = idx2 - 1
        w = (t0 - tt[idx1]) / torch.clamp(tt[idx2] - tt[idx1], min=1e-8)
        g_tr = se3.se3_interpolate(params['global_tr'][idx1],
                                   params['global_tr'][idx2], w)

    x_in = skeleton_net_input(params, joints)
    sk_r_raw, d_rot, d_scale = skeleton_net_apply(model.sk_deform, cfg.sk_net,
                                                  x_in, t)
    sk_r = sk_rot_activation(sk_r_raw)
    sk_T = skeleton.kinematic_transforms(joints, sk_r, g_tr,
                                         model.joint_parents,
                                         model.joint_root)
    weights, indices = superpoints.calc_lbs_weight(
        points, joints, model.sp_alive, cfg.num_knn, cfg.LBS_method,
        sp_W=params['sp_W'] if 'sp_W' in params else None,
        sp_radius_raw=params['sp_radius'] if 'sp_radius' in params else None,
        sp_weight_raw=params['sp_weight'] if 'sp_weight' in params else None)
    dense_w = superpoints.dense_lbs_rows(weights, indices, sk_T.shape[0])
    d_xyz, d_rotation, d_scaling = superpoints.warp_blend_dense(
        points, sk_T, dense_w, d_rot, d_scale)
    aux = {'skT': sk_T, 'knn_w': weights, 'knn_i': indices, 'g_tr': g_tr}
    return StageOutputs(d_xyz, d_rotation, d_scaling, aux)


def forward_deltas(cfg: SKGSConfig, model: SKGSModel, t: torch.Tensor,
                   stage: str, time_id: Optional[int] = None,
                   sk_r_delta=None, training: bool = False) -> StageOutputs:
    """Stage-dispatched deformation deltas."""
    if stage == 'static':
        zero = torch.zeros((), device=model.device)
        return StageOutputs(zero, zero, zero, {})
    if stage in SK_STAGES:
        # sk_fix only detaches its outputs during training: same values
        return sk_stage(cfg, model, model.params['xyz'], t, time_id,
                        sk_r_delta, training)
    if stage in STAGE_NAMES:
        raise NotImplementedError(f'stage {stage!r} is not ported yet')
    raise ValueError(f'unknown stage {stage!r}')
