"""Deformation network configs and the skeleton joint net (port of
``sk_gs_tpu/models/deform.py``). The per-Gaussian warp net (``DeformNetConfig``)
is carried as configuration only: the ``sk`` serving path does not run it.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from ..ops.encoders import FreqEncoder
from ..ops.mlp import MLP, mlp_apply


class DeformNetConfig(NamedTuple):
    depth: int = 8
    width: int = 256
    pos_degree: int = 10
    t_degree: int = 6
    is_blender: bool = True
    sep_rot: bool = False
    max_d_scale: float = -1.0
    time_out: int = 30
    compute_dtype: str = 'float32'

    @property
    def skips(self) -> Tuple[int, ...]:
        return (self.depth // 2,)


class SkeletonNetConfig(NamedTuple):
    out_dims: Tuple[int, ...] = (4, 4, 3)  # (R_dim, d_rot, d_scale)
    width: int = 256
    depth: int = 8
    skips: Tuple[int, ...] = (4,)
    pos_degree: int = 10
    t_degree: int = 6
    p_in_channels: int = 3
    compute_dtype: str = 'float32'

    @property
    def pos_enc(self) -> FreqEncoder:
        return FreqEncoder(input_dim=self.p_in_channels, degree=self.pos_degree)

    @property
    def t_enc(self) -> FreqEncoder:
        return FreqEncoder(input_dim=1, degree=self.t_degree)


def skeleton_net(cfg: SkeletonNetConfig, device=None) -> MLP:
    """The joint net's module (weights zero; load them with ``convert``)."""
    if cfg.compute_dtype != 'float32':
        raise NotImplementedError('the port computes the skeleton net in float32')
    return MLP(cfg.pos_enc.output_dim + cfg.t_enc.output_dim, cfg.width,
               cfg.depth, out_channels=cfg.out_dims, skips=cfg.skips,
               device=device)


def skeleton_net_apply(params: MLP, cfg: SkeletonNetConfig,
                       joints: torch.Tensor, t: torch.Tensor):
    """joints [M, C] + scalar t -> (R, d_rot, d_scale) per joint."""
    t = torch.broadcast_to(torch.reshape(t, (-1, 1)), (joints.shape[0], 1))
    inp = torch.cat([cfg.pos_enc(joints), cfg.t_enc(t)], dim=-1)
    return mlp_apply(params, inp, skips=cfg.skips, multi_head=True)
