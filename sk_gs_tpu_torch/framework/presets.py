"""Named model presets, carried in code (``framework/build.py`` builds the
same from the YAML; a test holds the two equal).

``synthetic_fullscale`` is what ``configs/synthetic_fullscale.yaml`` on top
of ``configs/default.yaml`` gives through the JAX package's
``train.build_model_cfg`` (48 frames, 400 x 400 images): Gaussian capacity
100,352, SH degree 3, M = 512 joints, K = 5 LBS neighbours, LBS_method 'W',
hyper_dim 8, skeleton net depth 8 width 256 skip 4, pair capacity 2^20.
Every other field keeps its default, which equals the YAML's value. The
train settings are the YAMLs' too: the loss weights (the l1 + SSIM image
loss 0.8 / 0.2, the canonical-net consistency 1.0, and the terms of the
later families), lr 1e-3, Adam, no gradient clipping, seed 0, 2,000 initial
points, and the synthetic scene the YAML names (a 3-link chain of 250
Gaussians a link, 48 frames, 400 px, white), rendered with the pair budget
``train.py:build_scene`` gives it. ``flagship_point_cloud`` draws the
initial points as ``train.py:315-318`` does when the dataset has none.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import numpy as np

from ..models.deform import DeformNetConfig, SkeletonNetConfig
from ..models.gaussian_splatting import GaussianConfig
from ..models.sk_gs import SKGSConfig
from ..render.settings import RasterConfig


class SyntheticScene(NamedTuple):
    """Arguments of ``data.synthetic.make_synthetic_scene``."""
    num_links: int = 3
    gauss_per_link: int = 120
    num_frames: int = 24
    image_size: int = 64
    background: str = 'white'
    gt_pair_capacity: int = 2 ** 16


class TrainSettings(NamedTuple):
    loss: Dict
    lr: float
    optimizer: str
    clip_norm: float
    seed: int
    dataset: SyntheticScene
    num_init_points: int = 2000


def flagship_point_cloud(train: TrainSettings) -> Tuple[np.ndarray,
                                                       np.ndarray]:
    """(points [n, 3], colours [n, 3]) float32: uniform in [-1.3, 1.3]^3 and
    in [0, 1], from ``np.random.default_rng(seed)``."""
    rng = np.random.default_rng(train.seed)
    pts = rng.uniform(-1.3, 1.3, size=(train.num_init_points, 3))
    cols = rng.uniform(size=(train.num_init_points, 3))
    return pts.astype(np.float32), cols.astype(np.float32)


def synthetic_fullscale() -> Tuple[SKGSConfig, RasterConfig, TrainSettings]:
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
    train = TrainSettings(
        loss={'image': {'method': 'l1', 'lambda': 0.8}, 'ssim': 0.2,
              'sparse': 0.1, 'smooth': 0.1, 'joint': 1.0, 'joint_all': 1.0,
              'c_net': 1.0, 'cmp_p': 1.0, 'cmp_t': 0.01, 'cmp_r': 0.01,
              'cmp_s': 0.01},
        lr=1e-3, optimizer='adam', clip_norm=0.0, seed=0,
        num_init_points=2000,
        dataset=SyntheticScene(num_links=3, gauss_per_link=250,
                               num_frames=48, image_size=400,
                               background='white',
                               gt_pair_capacity=2 ** 17))
    return cfg, rcfg, train
