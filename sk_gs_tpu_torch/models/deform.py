"""Deformation networks (port of ``sk_gs_tpu/models/deform.py``): the
per-Gaussian warp net (``DeformNet``, the ``init`` family's ``sp_deform``
and ``canonical``) and the skeleton joint net.

Weights keep the JAX layout ([in, out]) and the JAX leaf names
(``timenet/0/w``, ``trunk/3/b``, ``warp/w``, ...), so that a state dict maps
one to one onto the JAX leaves. Initial weights come from a
``torch.Generator`` with the JAX package's distributions (its random
streams cannot be matched).

``compute_dtype`` 'bfloat16' is the JAX package's mixed precision
(``deform.py:98-123, 164-175``): the weights stay float32 (the optimizer's
master copy) and are cast to bfloat16 inside the forward, the frequency
encoders run in float32 (sin(2^k x) needs the input's whole mantissa) and
their output is cast, the trunk and heads compute in bfloat16 (bias adds,
ReLUs and concatenations included: explicit casts, not ``torch.autocast``,
which would keep some of them in float32), and the outputs are returned in
float32.
"""
from __future__ import annotations

import math
from typing import Dict, NamedTuple, Tuple

import torch
from torch import nn

from ..ops.encoders import FreqEncoder
from ..ops.mlp import MLP, Linear, linear_apply, mlp_apply

COMPUTE_DTYPES = {'float32': torch.float32, 'bfloat16': torch.bfloat16}


def compute_dtype(name: str) -> torch.dtype:
    if name not in COMPUTE_DTYPES:
        raise ValueError(f'compute_dtype {name!r}: one of '
                         f'{sorted(COMPUTE_DTYPES)}')
    return COMPUTE_DTYPES[name]


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

    @property
    def pos_enc(self) -> FreqEncoder:
        return FreqEncoder(input_dim=3, degree=self.pos_degree)

    @property
    def t_enc(self) -> FreqEncoder:
        return FreqEncoder(input_dim=1, degree=self.t_degree)


# the heads' weight spread at initialisation (deform.py:84-87)
HEAD_STD = {'warp': 1e-5, 'scaling': 1e-8, 'rotation': 1e-5,
            'local_rotation': 1e-4}
HEAD_DIMS = {'warp': 3, 'scaling': 3, 'rotation': 4, 'local_rotation': 4}


class DeformNet(nn.Module):
    """The warp field (x, t) -> deltas: a blender timenet (two layers, no
    activation after the second) on the encoded time, a ReLU trunk with the
    skip concat [x_emb, t_emb, h] after layer depth // 2, and linear heads.
    Weights zero; ``deform_net_init`` or ``convert`` fills them."""

    def __init__(self, cfg: DeformNetConfig, device=None):
        super().__init__()
        compute_dtype(cfg.compute_dtype)
        self.cfg = cfg
        p_dim = cfg.pos_enc.output_dim
        t_dim = cfg.time_out if cfg.is_blender else cfg.t_enc.output_dim
        in_dim = p_dim + t_dim
        if cfg.is_blender:
            self.timenet = nn.ModuleList([
                Linear(cfg.t_enc.output_dim, 256, device),
                Linear(256, cfg.time_out, device)])
        trunk, cin = [], in_dim
        for i in range(cfg.depth):
            trunk.append(Linear(cin, cfg.width, device))
            cin = cfg.width + (in_dim if i in cfg.skips else 0)
        self.trunk = nn.ModuleList(trunk)
        heads = ('warp', 'scaling', 'rotation') + (
            ('local_rotation',) if cfg.sep_rot else ())
        for name in heads:
            setattr(self, name, Linear(cin, HEAD_DIMS[name], device))

    def forward(self, x: torch.Tensor, t: torch.Tensor):
        return deform_net_apply(self, self.cfg, x, t)


def deform_net_init(cfg: DeformNetConfig, generator: torch.Generator,
                    device=None) -> DeformNet:
    """``deform_net_init`` (``deform.py:53-88``): kaiming-uniform weights
    (bound sqrt(6 / fan_in)) and zero biases on the timenet and the trunk;
    normal heads of tiny spread (``HEAD_STD``) with zero biases."""
    net = DeformNet(cfg, device)
    gdev = generator.device
    with torch.no_grad():
        for name, p in net.named_parameters():
            head = name.split('.')[0]
            if name.endswith('.b'):
                continue                      # zero
            if head in HEAD_STD:
                w = torch.randn(p.shape, generator=generator, device=gdev) \
                    * HEAD_STD[head]
            else:
                bound = math.sqrt(6.0 / p.shape[0])
                w = (torch.rand(p.shape, generator=generator, device=gdev)
                     * 2.0 - 1.0) * bound
            p.copy_(w)
    return net


def deform_net_apply(net: DeformNet, cfg: DeformNetConfig, x: torch.Tensor,
                     t: torch.Tensor) -> Dict[str, torch.Tensor]:
    """x [N, 3], t a scalar or [N, 1] -> {'d_xyz', 'd_rotation',
    'd_scaling', 'hidden'} (and 'g_rotation' with ``sep_rot``), float32,
    computed in ``cfg.compute_dtype``. A float64 ``x`` with a float64 copy
    of the net computes and returns float64 (the float64 twin that
    ``chip_smoke.py`` measures the float32 rounding against)."""
    dt = compute_dtype(cfg.compute_dtype)
    if x.dtype == torch.float64:
        dt = torch.float64
    t = torch.broadcast_to(torch.reshape(t, (-1, 1)), (x.shape[0], 1))
    t_emb = cfg.t_enc(t).to(dt)
    if cfg.is_blender:
        h = torch.relu(linear_apply(net.timenet[0], t_emb))
        t_emb = linear_apply(net.timenet[1], h)
    x_emb = cfg.pos_enc(x).to(dt)
    h = torch.cat([x_emb, t_emb], dim=-1)
    for i, layer in enumerate(net.trunk):
        h = torch.relu(linear_apply(layer, h))
        if i in cfg.skips:
            h = torch.cat([x_emb, t_emb, h], dim=-1)
    scaling = linear_apply(net.scaling, h)
    if cfg.max_d_scale > 0:
        scaling = torch.tanh(scaling) * math.log(cfg.max_d_scale)
    out = {'d_xyz': linear_apply(net.warp, h),
           'd_rotation': linear_apply(net.rotation, h),
           'd_scaling': scaling, 'hidden': h}
    if hasattr(net, 'local_rotation'):
        out['g_rotation'] = linear_apply(net.local_rotation, h)
    if dt not in (torch.float32, torch.float64):
        out = {k: v.to(torch.float32) for k, v in out.items()}
    return out


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
    compute_dtype(cfg.compute_dtype)
    return MLP(cfg.pos_enc.output_dim + cfg.t_enc.output_dim, cfg.width,
               cfg.depth, out_channels=cfg.out_dims, skips=cfg.skips,
               device=device)


def skeleton_net_init(cfg: SkeletonNetConfig, generator: torch.Generator,
                      device=None) -> MLP:
    """``skeleton_net_init`` (``deform.py:152-158``): torch.nn.Linear's
    uniform init (bound 1 / sqrt(fan_in), weights and biases) on the trunk,
    normal heads of spread 1e-6 with zero biases."""
    net = skeleton_net(cfg, device)
    gdev = generator.device
    with torch.no_grad():
        for lin in net.layers:
            bound = 1.0 / math.sqrt(lin.w.shape[0])
            for p in (lin.w, lin.b):
                p.copy_((torch.rand(p.shape, generator=generator, device=gdev)
                         * 2.0 - 1.0) * bound)
        for head in net.heads:
            head.w.copy_(torch.randn(head.w.shape, generator=generator,
                                     device=gdev) * 1e-6)
            head.b.zero_()
    return net


def skeleton_net_apply(params: MLP, cfg: SkeletonNetConfig,
                       joints: torch.Tensor, t: torch.Tensor):
    """joints [M, C] + scalar t -> (R, d_rot, d_scale) per joint, float32,
    computed in ``cfg.compute_dtype`` (the encoders in float32)."""
    dt = compute_dtype(cfg.compute_dtype)
    t = torch.broadcast_to(torch.reshape(t, (-1, 1)), (joints.shape[0], 1))
    inp = torch.cat([cfg.pos_enc(joints), cfg.t_enc(t)], dim=-1).to(dt)
    outs = mlp_apply(params, inp, skips=cfg.skips, multi_head=True)
    if dt != torch.float32:
        outs = tuple(o.to(torch.float32) for o in outs)
    return outs
