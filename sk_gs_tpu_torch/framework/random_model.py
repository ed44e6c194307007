"""A random SK-GS model and orbit cameras, made from a seed with numpy.

``random_model_flat`` writes the arrays of a trained model in the JAX
package's flat checkpoint naming (``params/xyz``,
``params/sk_deform/layers/0/w``, ``params/sp_deform/trunk/0/w``, ``alive``,
...), so that it goes through ``convert.model_from_flat`` as a real
checkpoint would: every leaf a model carries through the stages, the warp
nets ``sp_deform`` and ``canonical`` included. The scene is an articulated
cloud: joints scattered in a ball, a random tree over the live joints, and
each live Gaussian placed near one joint.
"""
from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch

from .. import resolve_device
from ..convert import deform_net_from_flat
from ..models.deform import HEAD_STD as WARP_HEAD_STD
from ..models.deform import DeformNet
from ..models.gaussian_splatting import num_rest
from ..models.sk_gs import SKGSConfig
from ..models.sk_gs_ops import compute_sp_transforms_all_frames
from ..models.skeleton import MAX_LEVELS, parents_table
from ..ops.transforms import look_at, perspective_opencv
from ..render.settings import ViewParams


# the live share of the joint slots, and the weight spread of the skeleton
# net's three heads (rotation, rotation delta, scale delta): enough motion to
# exercise the warp without throwing the cloud out of view
JOINT_ALIVE_FRAC = 0.95
HEAD_STD = (2e-2, 1e-2, 1e-4)
# orbit camera: distance to the origin and vertical field of view (radians)
ORBIT_RADIUS = 4.0
ORBIT_FOVY = 0.7


def _unit_quats(rng: np.random.Generator, n: int) -> np.ndarray:
    q = rng.normal(size=(n, 4))
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def random_model_flat(cfg: SKGSConfig, seed: int, n_alive: int,
                      log_scale_mean: float = -3.4,
                      sp_stage: bool = False) -> Dict[str, np.ndarray]:
    """Flat ``{path: ndarray}`` of a random model with ``cfg``'s widths:
    ``n_alive`` of ``cfg.gauss.capacity`` slots live, a random tree over the
    live joints, ``cfg.num_frames`` train times in [0, 1]. The Gaussians'
    log-scales centre on ``log_scale_mean`` (-3.4 puts ~0.72M pairs in a
    400 x 400 view of 80,000 of them).

    ``sp_stage`` gives a model inside the ``sp`` stages: every superpoint
    live at the joints (the Gaussians sit around them), the hyper features
    of the restart (-1e-2, the superpoints' 1e-2), pivots ``joint_pos``
    [M, M, 3] at the pair midpoints plus noise, a positive ``joint_cost``,
    and ``sp_cache`` filled by ``compute_sp_transforms_all_frames`` from the
    random ``sp_deform`` net (run on the CPU)."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    n, m, nf = cfg.gauss.capacity, cfg.num_superpoints, cfg.num_frames
    if not 0 < n_alive <= n:
        raise ValueError(f'n_alive {n_alive} outside (0, {n}]')
    if cfg.LBS_method != 'W':
        raise ValueError("the random model carries LBS_method 'W' (sp_W)")

    sp_alive = rng.uniform(size=m) < JOINT_ALIVE_FRAC
    sp_alive[0] = True
    if sp_stage:
        sp_alive[:] = True
    live_j = np.flatnonzero(sp_alive)
    joints = rng.normal(size=(m, 3)) * 0.45
    # random recursive tree over the live joints; dead joints hang off the root
    order = rng.permutation(live_j)
    root = int(order[0])
    parent = np.full(m, root, np.int32)
    for i in range(1, order.size):
        parent[order[i]] = order[rng.integers(0, i)]

    alive = np.zeros(n, bool)
    alive[rng.permutation(n)[:n_alive]] = True
    anchor = rng.choice(live_j, size=n)
    xyz = joints[anchor] + rng.normal(size=(n, 3)) * 0.18

    flat = {
        'params/xyz': xyz.astype(f32),
        'params/f_dc': (rng.normal(size=(n, 1, 3)) * 0.8).astype(f32),
        'params/f_rest': (rng.normal(size=(n, num_rest(cfg.gauss.sh_degree), 3))
                          * 0.1).astype(f32),
        'params/scaling': (log_scale_mean
                           + rng.normal(size=(n, 3)) * 0.4).astype(f32),
        'params/rotation': _unit_quats(rng, n).astype(f32),
        'params/opacity': rng.normal(loc=0.5, scale=1.5, size=(n, 1)).astype(f32),
        'params/joints': joints.astype(f32),
        'params/sp_W': rng.normal(size=(n, m)).astype(f32),
        'alive': alive,
        'active_sh_degree': np.asarray(cfg.gauss.sh_degree, np.int32),
        'sp_alive': sp_alive,
        'joint_parents': parents_table(parent, root, MAX_LEVELS),
        'joint_root': np.asarray(root, np.int32),
        'train_times': np.linspace(0.0, 1.0, nf).astype(f32),
    }
    g_q = _unit_quats(rng, nf) * 0.05
    g_q[:, 3] = 1.0
    g_q /= np.linalg.norm(g_q, axis=-1, keepdims=True)
    flat['params/global_tr'] = np.concatenate(
        [rng.normal(size=(nf, 3)) * 0.05, g_q], axis=-1).astype(f32)

    # skeleton net: torch.nn.Linear's default uniform init on the trunk
    net = cfg.sk_net
    fan_in = net.pos_enc.output_dim + net.t_enc.output_dim
    in0, cin = fan_in, fan_in
    for i in range(net.depth):
        bound = 1.0 / math.sqrt(cin)
        flat[f'params/sk_deform/layers/{i}/w'] = rng.uniform(
            -bound, bound, size=(cin, net.width)).astype(f32)
        flat[f'params/sk_deform/layers/{i}/b'] = rng.uniform(
            -bound, bound, size=(net.width,)).astype(f32)
        cin = net.width + (in0 if i in net.skips else 0)
    for j, (oc, std) in enumerate(zip(net.out_dims, HEAD_STD)):
        flat[f'params/sk_deform/heads/{j}/w'] = (
            rng.normal(size=(cin, oc)) * std).astype(f32)
        flat[f'params/sk_deform/heads/{j}/b'] = np.zeros(oc, f32)

    # the superpoint families' leaves and the warp nets
    flat['params/hyper'] = np.full((n, cfg.hyper_dim), -1e-2, f32)
    flat['params/sp_points'] = joints.astype(f32)
    flat['params/sp_hyper'] = np.zeros((m, cfg.hyper_dim), f32)
    flat['params/joint_pos'] = np.zeros((m, m, 3), f32)
    for name in ('sp_deform', 'canonical'):
        flat.update(_warp_net_flat(cfg, rng, f'params/{name}/'))
    if sp_stage:
        flat['params/sp_hyper'] = np.full((m, cfg.hyper_dim), 1e-2, f32)
        mid = 0.5 * (joints[:, None] + joints[None, :])
        flat['params/joint_pos'] = (mid + rng.normal(size=(m, m, 3))
                                    * 0.02).astype(f32)
        flat['joint_cost'] = rng.uniform(0.05, 0.5, (m, m)).astype(f32)
        net = deform_net_from_flat(flat, cfg.net, 'params/sp_deform/',
                                   device='cpu')
        flat['sp_cache'] = compute_sp_transforms_all_frames(
            cfg, net, torch.from_numpy(flat['params/sp_points']),
            torch.from_numpy(flat['train_times'])).numpy()
    return flat


def _warp_net_flat(cfg: SKGSConfig, rng: np.random.Generator, prefix: str):
    """A warp net's leaves, named and shaped as ``DeformNet`` has them, with
    ``deform_net_init``'s distributions: kaiming-uniform timenet and trunk,
    zero biases, heads of tiny spread."""
    out = {}
    for name, p in DeformNet(cfg.net).named_parameters():
        head = name.split('.')[0]
        if name.endswith('.b'):
            w = np.zeros(p.shape)
        elif head in WARP_HEAD_STD:
            w = rng.normal(size=p.shape) * WARP_HEAD_STD[head]
        else:
            bound = math.sqrt(6.0 / p.shape[0])
            w = rng.uniform(-bound, bound, size=p.shape)
        out[prefix + name.replace('.', '/')] = w.astype(np.float32)
    return out


def orbit_view(angle: float, width: int, height: int, elevation: float = 0.3,
               device='cuda') -> ViewParams:
    """OpenCV camera on a circle around the origin, looking at it (y down)."""
    device = resolve_device(device)
    r, fovy = ORBIT_RADIUS, ORBIT_FOVY
    eye = [r * math.sin(angle) * math.cos(elevation), -r * math.sin(elevation),
           -r * math.cos(angle) * math.cos(elevation)]
    fovx = 2.0 * math.atan(math.tan(fovy / 2.0) * width / height)
    return ViewParams(
        Tw2v=look_at(eye, [0.0, 0.0, 0.0], [0.0, -1.0, 0.0], coord='opencv',
                     device=device),
        Tv2c=perspective_opencv(fovy, size=(width, height), device=device),
        campos=torch.tensor(eye, dtype=torch.float32, device=device),
        tan_fovx=torch.tensor(math.tan(fovx / 2.0), device=device),
        tan_fovy=torch.tensor(math.tan(fovy / 2.0), device=device))
