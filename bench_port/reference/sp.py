"""The plain reference of SP-GS's superpoint stage: from the model's arrays
to the renderer's per-Gaussian inputs at a time t.

Plain PyTorch, float32, no kernel, cache or batching; imports nothing of
the port. It follows SP-GS (Wan et al., ICML 2024) as the JAX package
defines it (``sk_gs_tpu/models/sk_gs.py:sp_stage`` and what it calls):

- the warp net on the superpoints: a blender timenet (t's 6 frequency
  bands -> 256, ReLU -> 30), the points' 10 bands, an 8 x 256 ReLU trunk
  over [x_emb, t_emb] with [x_emb, t_emb, h] after layer 4, three linear
  heads (warp 3, rotation 4, scaling 3);
- each superpoint's rotation, the head plus the identity quaternion,
  normalised; its SE3 per ``warp_method``: 'LBS' takes the warp head as the
  translation (a rotation about the origin), 'LBS_c' rotates about the
  superpoint;
- the LBS weights: the K nearest live superpoints of each Gaussian in the
  joint (xyz, hyper) space (squared distance, ties to the lower index,
  computed in blocks), softmax of its ``sp_W`` row there;
- the blend as one product of the dense [N, M] weights with the
  superpoints' [M, 19] rows (rotation matrix, translation, rotation, scale
  delta), each point moved by its blended transform;
- the activations of ``reference/sk.py:gaussians``.

Departures from the published description, each the JAX package's own:
a Gaussian's rotation is its raw quaternion plus the blended superpoint
quaternions, normalised, where the paper's text composes the rotations;
the superpoints' rotation matrices are the quaternion formula of the
normalised rotation. Not referenced: ``warp_method`` 'largest' (one
superpoint a Gaussian) and the time noise of nets that are not
``is_blender`` (a training option).
"""
from __future__ import annotations

from typing import Dict

import torch

from ..inputs import widths
from .sk import F32, Products, freq_encode, qmatrix, qnormalize, qrotate

WARP_HEADS = ('warp', 'rotation', 'scaling')
# float32 products, as the configuration states (no TF32 on the card)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def warp_net(P: Dict[str, torch.Tensor], net: Dict, blender: bool,
             x: torch.Tensor, t: torch.Tensor, prefix: str = 'sp_deform/',
             mm: Products = torch.matmul) -> Dict[str, torch.Tensor]:
    """The warp net's heads at (x [M, 3], t)."""
    m = x.shape[0]
    t_emb = freq_encode(t.reshape(1, 1).expand(m, 1), net['t_degree'])
    if blender:
        h = torch.relu(mm(t_emb, P[prefix + 'timenet/0/w'])
                       + P[prefix + 'timenet/0/b'])
        t_emb = mm(h, P[prefix + 'timenet/1/w']) + P[prefix + 'timenet/1/b']
    x_emb = freq_encode(x, net['pos_degree'])
    h = torch.cat([x_emb, t_emb], dim=-1)
    for i in range(net['depth']):
        h = torch.relu(mm(h, P[f'{prefix}trunk/{i}/w'])
                       + P[f'{prefix}trunk/{i}/b'])
        if i == net['depth'] // 2:
            h = torch.cat([x_emb, t_emb, h], dim=-1)
    return {k: mm(h, P[prefix + k + '/w']) + P[prefix + k + '/b']
            for k in WARP_HEADS}


def superpoint_transforms(P: Dict[str, torch.Tensor], cfg: Dict,
                          t: torch.Tensor, mm: Products = torch.matmul):
    """(SE3 of each superpoint [M, 7], its scale delta [M, 3])."""
    model = cfg['model']
    sp = P['sp_points'][:, :3]
    out = warp_net(P, model['net'], model.get('is_blender', True), sp, t,
                   mm=mm)
    ident = torch.zeros(4, dtype=F32, device=sp.device)
    ident[3] = 1.0
    rot = qnormalize(out['rotation'] + ident)
    method = model['warp_method']
    if method == 'LBS':
        trans = out['warp']
    elif method == 'LBS_c':
        trans = out['warp'] + sp + qrotate(rot, -sp)
    else:
        raise ValueError(f'warp_method {method!r} has no reference')
    return torch.cat([trans, rot], dim=-1), out['scaling']


def knn(P: Dict[str, torch.Tensor], k: int, hyper: bool = True,
        block: int = 16384) -> torch.Tensor:
    """The ids [N, K] of each Gaussian's K nearest live superpoints, in
    (xyz, hyper) space (xyz alone without ``hyper``)."""
    pts, keys = P['xyz'], P['sp_points'][:, :3]
    if hyper:
        pts = torch.cat([pts, P['hyper']], dim=-1)
        keys = torch.cat([keys, P['sp_hyper']], dim=-1)
    live = P['sp_alive']
    ids = []
    for s in range(0, pts.shape[0], block):
        q = pts[s:s + block]
        d2 = torch.square(q[:, None, 0] - keys[None, :, 0])
        for j in range(1, q.shape[1]):
            d2 = d2 + torch.square(q[:, None, j] - keys[None, :, j])
        d2 = torch.where(live[None, :], d2, torch.full_like(d2, float('inf')))
        ids.append(torch.sort(d2, dim=1, stable=True).indices[:, :k])
    return torch.cat(ids)


def gaussians(P: Dict[str, torch.Tensor], cfg: Dict, t: float,
              mm: Products = torch.matmul) -> Dict[str, torch.Tensor]:
    """The renderer's inputs of every slot at time ``t``: means, scales,
    unit rotations, opacities, SH coefficients and the live mask. ``mm``
    computes the products (``sk.tf32_matmul`` for the control)."""
    m_cfg = widths(cfg)
    dev = P['xyz'].device
    t = torch.as_tensor(t, dtype=F32, device=dev)
    T, d_scale = superpoint_transforms(P, cfg, t, mm)
    ids = knn(P, m_cfg['num_knn'], hyper=m_cfg['hyper_dim'] > 0)
    w = torch.softmax(torch.gather(P['sp_W'], 1, ids), dim=-1)
    dense = torch.zeros((w.shape[0], T.shape[0]), dtype=F32, device=dev)
    dense = dense.scatter_add(1, ids, w)
    table = torch.cat([qmatrix(T[:, 3:]), T[:, :3], T[:, 3:], d_scale],
                      dim=-1)
    b = mm(dense, table)
    p = P['xyz']
    Rb = b[:, :9].reshape(-1, 3, 3)
    d_xyz = torch.einsum('nij,nj->ni', Rb, p) + b[:, 9:12] - p
    rot = P['rotation'] + b[:, 12:16]
    rot = rot * torch.rsqrt(torch.sum(rot * rot, dim=-1, keepdim=True)
                            + 1e-18)
    return {'means': P['xyz'] + d_xyz,
            'scales': torch.exp(P['scaling']) + b[:, 16:19],
            'rotations': rot,
            'opacities': torch.sigmoid(P['opacity'][:, 0]),
            'sh': torch.cat([P['f_dc'], P['f_rest']], dim=1),
            'alive': P['alive']}
