"""Named model presets, carried in code (the port reads no YAML).

``synthetic_fullscale`` is what ``configs/synthetic_fullscale.yaml`` on top
of ``configs/default.yaml`` gives through the JAX package's
``train.build_model_cfg`` (48 frames, 400 x 400 images): Gaussian capacity
100,352, SH degree 3, M = 512 joints, K = 5 LBS neighbours, LBS_method 'W',
hyper_dim 8, skeleton net depth 8 width 256 skip 4, pair capacity 2^20.
Every other field keeps its default, which equals the YAML's value.
"""
from __future__ import annotations

from typing import Tuple

from ..models.deform import DeformNetConfig, SkeletonNetConfig
from ..models.gaussian_splatting import GaussianConfig
from ..models.sk_gs import SKGSConfig
from ..render.settings import RasterConfig


def synthetic_fullscale() -> Tuple[SKGSConfig, RasterConfig]:
    cfg = SKGSConfig(
        gauss=GaussianConfig(capacity=100_352, sh_degree=3, lr=1e-3),
        net=DeformNetConfig(depth=8, width=256, pos_degree=10, t_degree=6),
        sk_net=SkeletonNetConfig(out_dims=(4, 4, 3), width=256, depth=8,
                                 skips=(4,), pos_degree=10, t_degree=6,
                                 p_in_channels=3),
        num_superpoints=512,
        num_knn=5,
        hyper_dim=8,
        LBS_method='W',
        warp_method='LBS',
        num_frames=48,
    )
    rcfg = RasterConfig(image_width=400, image_height=400, sh_degree=3,
                        pair_capacity=2 ** 20, chunk=128, tile_h=16)
    return cfg, rcfg
