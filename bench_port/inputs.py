"""The benchmark's inputs, made from ``--seed``: a random SK-GS model in the
port's flat checkpoint naming, the cameras and times of a configuration's
scene layout, and the order and sample of the requests.

The model's arrays are drawn on the device by one ``torch.Generator`` in a
few large calls (the same seed gives the same arrays on the same kind of
device), then handed to ``convert.model_from_flat`` as host arrays, as a
checkpoint would be. Their distributions follow the port's random serving
model (``framework/random_model.py``, copied here so that a change there
cannot move the yardstick): joints in a ball, a random tree over the live
joints, each live Gaussian near a joint, the skeleton net at
``torch.nn.Linear``'s init with heads of spread ``SK_HEAD_STD``, and the
superpoint leaves and warp nets a model carries from the earlier stages.

Cameras are fixed by the configuration (a generator seeded with the
layout's own ``camera_seed``), so every seed renders the same set of views;
the seed only orders the requests (``traffic``).
"""
from __future__ import annotations

import math
from typing import Dict, List, Sequence

import numpy as np
import torch

# the live share of the joint slots, and the spread of the skeleton net's
# three heads (rotation, rotation delta, scale delta)
JOINT_ALIVE_FRAC = 0.95
SK_HEAD_STD = (2e-2, 1e-2, 1e-4)
# the warp nets' heads at initialisation (models/deform.py:HEAD_STD)
WARP_HEAD_STD = {'warp': 1e-5, 'scaling': 1e-8, 'rotation': 1e-5}
WARP_HEAD_DIMS = {'warp': 3, 'scaling': 3, 'rotation': 4}
MAX_LEVELS = 10
JOINT_SPREAD = 0.45
GAUSS_SPREAD = 0.18
LOG_SCALE_MEAN = -3.4
LOG_SCALE_STD = 0.4


def freq_dim(input_dim: int, degree: int) -> int:
    """Output width of the NeRF frequency encoder with the input kept."""
    return input_dim + input_dim * degree * 2


def _unit_quats(gen, n: int, device) -> torch.Tensor:
    q = torch.randn((n, 4), generator=gen, device=device)
    return q / torch.linalg.norm(q, dim=-1, keepdim=True)


def _parents_table(parent: torch.Tensor, root: int) -> torch.Tensor:
    """[M, MAX_LEVELS] int32: column l is the 2^l-th ancestor, clamped at
    the root (the layout of ``joint_parents``)."""
    parent = parent.clone()
    parent[root] = root
    cols = [parent]
    for _ in range(1, MAX_LEVELS):
        cols.append(cols[-1][cols[-1]])
    return torch.stack(cols, dim=1).to(torch.int32)


def widths(cfg: Dict) -> Dict:
    """The model's widths from a configuration's ``model`` section (the
    YAML's keys): the skeleton net takes the warp net's depth and width,
    its skip after depth // 2, the encoders' 10 and 6 bands and the heads
    (rotation 4, rotation delta 4, scale delta 3), as
    ``framework/build.py:build_model_cfg`` builds it."""
    m = cfg['model']
    net = m['net']
    return {'capacity': m['capacity'], 'sh_degree': m['sh_degree'],
            'num_superpoints': m['num_superpoints'], 'num_knn': m['num_knn'],
            'hyper_dim': m['hyper_dim'], 'net': net,
            'sk_net': {'depth': net['depth'], 'width': net['width'],
                       'skips': [max(1, net['depth'] // 2)],
                       'pos_degree': 10, 't_degree': 6,
                       'out_dims': [4, 4, 3]}}


def train_times(scene: Dict, nf: int) -> np.ndarray:
    """The times of the layout's ``nf`` train frames: i / (nf - 1) for a
    D-NeRF split, frame / nf for ZJU-MoCap (``data/zju.py``)."""
    if scene['layout'] == 'zju':
        return (np.arange(nf) / nf).astype(np.float32)
    return (np.arange(nf) / max(nf - 1, 1)).astype(np.float32)


def model_flat(cfg: Dict, seed: int, device, nf: int
               ) -> Dict[str, np.ndarray]:
    """The flat arrays of a random model with the widths of ``cfg``,
    ``cfg['bench']['n_alive']`` live slots and ``nf`` train frames of the
    layout, drawn on ``device`` from ``seed``; returned as host arrays in
    the checkpoint naming."""
    m_cfg = widths(cfg)
    n, m = m_cfg['capacity'], m_cfg['num_superpoints']
    n_alive = cfg['bench']['n_alive']
    gen = torch.Generator(device=device).manual_seed(int(seed))
    f32 = torch.float32

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=device)

    def rand(*shape):
        return torch.rand(shape, generator=gen, device=device)

    sp_alive = rand(m) < JOINT_ALIVE_FRAC
    sp_alive[0] = True
    live = torch.nonzero(sp_alive)[:, 0]
    joints = randn(m, 3) * JOINT_SPREAD
    # a random recursive tree over the live joints; dead joints hang off
    # the root
    order = live[torch.randperm(live.numel(), generator=gen, device=device)]
    root = int(order[0])
    pick = (rand(order.numel()) * torch.arange(order.numel(), device=device)
            ).to(torch.int64)
    parent = torch.full((m,), root, dtype=torch.int64, device=device)
    parent[order[1:]] = order[pick[1:]]

    alive = torch.zeros(n, dtype=torch.bool, device=device)
    alive[torch.randperm(n, generator=gen, device=device)[:n_alive]] = True
    anchor = live[(rand(n) * live.numel()).to(torch.int64)
                  .clamp(max=live.numel() - 1)]
    xyz = joints[anchor] + randn(n, 3) * GAUSS_SPREAD
    n_rest = (m_cfg['sh_degree'] + 1) ** 2 - 1

    flat = {
        'params/xyz': xyz,
        'params/f_dc': randn(n, 1, 3) * 0.8,
        'params/f_rest': randn(n, n_rest, 3) * 0.1,
        'params/scaling': LOG_SCALE_MEAN + randn(n, 3) * LOG_SCALE_STD,
        'params/rotation': _unit_quats(gen, n, device),
        'params/opacity': 0.5 + randn(n, 1) * 1.5,
        'params/joints': joints,
        'params/sp_W': randn(n, m),
        'alive': alive,
        'active_sh_degree': torch.tensor(m_cfg['sh_degree'],
                                         dtype=torch.int32),
        'sp_alive': sp_alive,
        'joint_parents': _parents_table(parent, root),
        'joint_root': torch.tensor(root, dtype=torch.int32),
        'train_times': torch.as_tensor(train_times(cfg['scene'], nf)),
    }
    g_q = _unit_quats(gen, nf, device) * 0.05
    g_q[:, 3] = 1.0
    g_q = g_q / torch.linalg.norm(g_q, dim=-1, keepdim=True)
    flat['params/global_tr'] = torch.cat([randn(nf, 3) * 0.05, g_q], dim=-1)

    sk = m_cfg['sk_net']
    in0 = freq_dim(3, sk['pos_degree']) + freq_dim(1, sk['t_degree'])
    cin = in0
    for i in range(sk['depth']):
        bound = 1.0 / math.sqrt(cin)
        flat[f'params/sk_deform/layers/{i}/w'] = (rand(cin, sk['width'])
                                                  * 2 - 1) * bound
        flat[f'params/sk_deform/layers/{i}/b'] = (rand(sk['width'])
                                                  * 2 - 1) * bound
        cin = sk['width'] + (in0 if i in sk['skips'] else 0)
    for j, (oc, std) in enumerate(zip(sk['out_dims'], SK_HEAD_STD)):
        flat[f'params/sk_deform/heads/{j}/w'] = randn(cin, oc) * std
        flat[f'params/sk_deform/heads/{j}/b'] = torch.zeros(oc, device=device)

    hyper = m_cfg['hyper_dim']
    flat['params/hyper'] = torch.full((n, hyper), -1e-2, device=device)
    flat['params/sp_points'] = joints.clone()
    flat['params/sp_hyper'] = torch.zeros((m, hyper), device=device)
    flat['params/joint_pos'] = torch.zeros((m, m, 3), device=device)
    for name in ('sp_deform', 'canonical'):
        flat.update(_warp_net_flat(m_cfg['net'],
                                   cfg['model'].get('is_blender', True),
                                   rand, randn, f'params/{name}/', device))
    return {k: v.to(f32).cpu().numpy() if v.is_floating_point()
            else v.cpu().numpy() for k, v in flat.items()}


def _warp_net_flat(net: Dict, blender: bool, rand, randn, prefix: str,
                   device):
    """A warp net's leaves (``models/deform.py:DeformNet``): the timenet of
    a blender net and the trunk kaiming-uniform, zero biases, heads of tiny
    spread."""
    out = {}
    p_dim = freq_dim(3, net['pos_degree'])
    t_in, time_out = freq_dim(1, net['t_degree']), 30
    shapes = []
    if blender:
        in_dim = p_dim + time_out
        shapes = [('timenet/0', t_in, 256), ('timenet/1', 256, time_out)]
    else:
        in_dim = p_dim + t_in
    cin = in_dim
    skip = net['depth'] // 2
    for i in range(net['depth']):
        shapes.append((f'trunk/{i}', cin, net['width']))
        cin = net['width'] + (in_dim if i == skip else 0)
    for head, dim in WARP_HEAD_DIMS.items():
        shapes.append((head, cin, dim))
    for name, fan_in, fan_out in shapes:
        head = name.split('/')[0]
        if head in WARP_HEAD_STD:
            w = randn(fan_in, fan_out) * WARP_HEAD_STD[head]
        else:
            w = (rand(fan_in, fan_out) * 2 - 1) * math.sqrt(6.0 / fan_in)
        out[prefix + name + '/w'] = w
        out[prefix + name + '/b'] = torch.zeros(fan_out, device=device)
    return out


# ---------------------------------------------------------------- cameras


def look_at_c2w(eye: np.ndarray, at=(0.0, 0.0, 0.0)) -> np.ndarray:
    """An OpenCV camera-to-world matrix [4, 4] (x right, y down, z forward)
    at ``eye`` looking at ``at``, world z up."""
    eye = np.asarray(eye, np.float64)
    z = np.asarray(at, np.float64) - eye
    z /= np.linalg.norm(z)
    up = np.array([0.0, 0.0, 1.0])
    x = np.cross(z, up)
    x /= np.linalg.norm(x)
    y = np.cross(z, x)
    c2w = np.eye(4)
    c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = x, y, z, eye
    return c2w


def split_cameras(scene: Dict, split: str) -> Dict[str, np.ndarray]:
    """The views of one split of the layout: OpenCV camera-to-world
    matrices [V, 4, 4] (float64), times [V] and frame ids [V].

    'dnerf': one camera a time (the monocular protocol), on a sphere of
    ``radius`` around the origin at elevations in ``elevation``, the train
    split's times i / (views - 1), the test split's drawn in [0, 1].
    'zju': a ring of ``cameras`` at ``radius`` and ``height``, the train
    cameras ``train_cameras`` and the rest for test, at the frames
    ``test_frames`` of ``num_frames`` (test) or every frame (train)."""
    rng = np.random.default_rng(scene['camera_seed']
                                + (0 if split == 'train' else 1))
    if scene['layout'] == 'dnerf':
        n = scene['train_views' if split == 'train' else 'test_views']
        az = rng.uniform(0.0, 2.0 * math.pi, n)
        el = rng.uniform(*scene['elevation'], n)
        r = scene['radius']
        eyes = np.stack([r * np.cos(el) * np.cos(az),
                         r * np.cos(el) * np.sin(az), r * np.sin(el)], -1)
        times = (train_times(scene, n) if split == 'train'
                 else np.sort(rng.uniform(0.0, 1.0, n)))
        c2w = np.stack([look_at_c2w(e) for e in eyes])
        return {'c2w': c2w, 'times': times.astype(np.float32),
                'frame_ids': np.arange(n)}
    if scene['layout'] == 'zju':
        cams = [c for c in range(scene['cameras'])
                if (c in scene['train_cameras']) == (split == 'train')]
        frames = (range(scene['num_frames']) if split == 'train'
                  else scene['test_frames'])
        ang = 2.0 * math.pi * np.arange(scene['cameras']) / scene['cameras']
        c2w, times, fids = [], [], []
        for f in frames:
            for c in cams:
                eye = [scene['radius'] * math.cos(ang[c]),
                       scene['radius'] * math.sin(ang[c]), scene['height']]
                c2w.append(look_at_c2w(eye))
                times.append(f / scene['num_frames'])
                fids.append(f)
        return {'c2w': np.stack(c2w), 'times': np.asarray(times, np.float32),
                'frame_ids': np.asarray(fids)}
    raise ValueError(f"unknown layout {scene['layout']!r}")


def view_arrays(scene: Dict, c2w: np.ndarray) -> Dict[str, np.ndarray]:
    """The camera tensors a render takes, as float32 arrays: world-to-view
    [V, 4, 4], the OpenCV projection [4, 4] (``ops/transforms.py:
    perspective_opencv`` with the layout's near and far), the camera
    centres [V, 3] and the half-angle tangents."""
    size = scene['image_size']
    fovx = scene['camera_angle_x']
    tan_x = math.tan(fovx * 0.5)
    tan_y = tan_x  # square frames
    near, far = scene['near'], scene['far']
    P = np.zeros((4, 4), np.float32)
    P[0, 0] = np.float32(1.0) / np.float32(tan_x)
    P[1, 1] = np.float32(1.0) / np.float32(tan_y)
    P[2, 2] = (far + near) / (far - near)
    P[2, 3] = -(2.0 * far * near) / (far - near)
    P[3, 2] = 1.0
    return {'Tw2v': np.linalg.inv(c2w).astype(np.float32), 'Tv2c': P,
            'campos': c2w[:, :3, 3].astype(np.float32),
            'tan_fovx': np.float32(tan_x), 'tan_fovy': np.float32(tan_y),
            'size': size}


# ---------------------------------------------------------------- order


def seeded_order(n: int, seed: int) -> np.ndarray:
    """A permutation of range(n) from ``seed``: the order in which every
    seed visits the same set."""
    return np.random.default_rng(int(seed)).permutation(n)


def sample_ids(pool: Sequence[int], k: int, seed: int) -> List[int]:
    """``k`` distinct members of ``pool`` drawn from ``seed`` (all of them
    when the pool is smaller)."""
    pool = list(pool)
    rng = np.random.default_rng((int(seed), 7))
    pick = rng.choice(len(pool), size=min(k, len(pool)), replace=False)
    return sorted(pool[i] for i in pick)
