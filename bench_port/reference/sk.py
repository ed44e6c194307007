"""The plain reference of SK-GS's skeleton stage: from the model's arrays to
the renderer's per-Gaussian inputs at a time t.

Plain PyTorch, float32, no kernel, cache or batching; imports nothing of
the port. It follows the SK-GS model as the JAX package defines it
(``sk_gs_tpu/models/sk_gs.py:sk_stage`` and what it calls):

- the skeleton net: frequency encodings of the joints (10 bands) and of t
  (6 bands), an 8 x 256 ReLU MLP with the input concatenated after layer
  4, three linear heads (rotation 4, rotation delta 4, scale delta 3);
- each joint's rotation, the head plus the identity quaternion,
  normalised; its local transform a rotation about the joint; forward
  kinematics down the tree from the root (whose own local transform is
  the identity), then the root transform at t, between the two train
  frames around it (translation lerp, rotation slerp);
- the LBS weights: the K nearest live joints of each Gaussian (squared
  distance, ties to the lower index), softmax of its ``sp_W`` row there;
- the blend as one product of the dense [N, M] weights with the joints'
  [M, 19] rows (rotation matrix, translation, rotation delta, scale delta),
  each point moved by its blended transform;
- activations: exp scales plus the scale delta, the rotation plus its
  delta normalised, sigmoid opacity, the SH coefficients.
"""
from __future__ import annotations

from typing import Callable, Dict

import torch

from ..inputs import widths

F32 = torch.float32
Products = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to TF32's 10 mantissa bits (to nearest), as the
    tensor cores read a float32 operand with TF32 on."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def tf32_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """A product in TF32: operands rounded, float32 accumulation. The
    control of the comparisons: the reference one precision below the
    configuration's float32 with TF32 off."""
    return torch.matmul(tf32(a), tf32(b))


def freq_encode(x: torch.Tensor, degree: int) -> torch.Tensor:
    outs = [x]
    for k in range(degree):
        xf = x * float(2.0 ** k)
        outs += [torch.sin(xf), torch.cos(xf)]
    return torch.cat(outs, dim=-1)


def qnormalize(q: torch.Tensor) -> torch.Tensor:
    return q / torch.sqrt(torch.sum(q * q, dim=-1, keepdim=True) + 1e-24)


def qmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamilton product in (x, y, z, w): rotate by b, then by a."""
    x1, y1, z1, w1 = a.unbind(-1)
    x2, y2, z2, w2 = b.unbind(-1)
    return torch.stack([w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
                        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
                        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
                        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2], dim=-1)


def qrotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    u, w = q[..., :3], q[..., 3:4]
    u, v = torch.broadcast_tensors(u, v)
    uv = torch.linalg.cross(u, v)
    return v + 2.0 * (w * uv + torch.linalg.cross(u, uv))


def qmatrix(q: torch.Tensor) -> torch.Tensor:
    """[..., 9] row-major matrix of the raw quaternion formula."""
    x, y, z, w = q.unbind(-1)
    return torch.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
    ], dim=-1)


def se3_compose(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a b)(x) = a(b(x)) on (t, q) rows [..., 7]."""
    return torch.cat([a[..., :3] + qrotate(a[..., 3:], b[..., :3]),
                      qmul(a[..., 3:], b[..., 3:])], dim=-1)


def slerp(q1: torch.Tensor, q2: torch.Tensor, t: torch.Tensor
          ) -> torch.Tensor:
    q1, q2 = qnormalize(q1), qnormalize(q2)
    dot = torch.sum(q1 * q2)
    q2 = torch.where(dot < 0, -q2, q2)
    dot = torch.abs(dot)
    theta = torch.arccos(torch.clamp(dot, -1.0, 1.0))
    s = torch.sin(theta)
    if float(s) < 1e-7:
        w1, w2 = 1.0 - t, t
    else:
        w1 = torch.sin((1.0 - t) * theta) / s
        w2 = torch.sin(t * theta) / s
    return qnormalize(w1 * q1 + w2 * q2)


def root_transform(P: Dict[str, torch.Tensor], t: torch.Tensor
                   ) -> torch.Tensor:
    g = P['global_tr']
    tt = P['train_times']
    i2 = int(torch.searchsorted(tt, t.reshape(1)).clamp(1, tt.numel() - 1))
    i1 = i2 - 1
    w = (t - tt[i1]) / torch.clamp(tt[i2] - tt[i1], min=1e-8)
    trans = (1.0 - w) * g[i1, :3] + w * g[i2, :3]
    return torch.cat([trans, slerp(g[i1, 3:], g[i2, 3:], w)])


def skeleton_net(P: Dict[str, torch.Tensor], sk: Dict, joints: torch.Tensor,
                 t: torch.Tensor, mm: Products = torch.matmul):
    m = joints.shape[0]
    inp = torch.cat([freq_encode(joints, sk['pos_degree']),
                     freq_encode(t.reshape(1, 1).expand(m, 1),
                                 sk['t_degree'])], dim=-1)
    h = inp
    for i in range(sk['depth']):
        h = torch.relu(mm(h, P[f'sk_deform/layers/{i}/w'])
                       + P[f'sk_deform/layers/{i}/b'])
        if i in sk['skips']:
            h = torch.cat([h, inp], dim=-1)
    return [mm(h, P[f'sk_deform/heads/{j}/w']) + P[f'sk_deform/heads/{j}/b']
            for j in range(len(sk['out_dims']))]


def depth_order(parent: torch.Tensor, root: int):
    """Joints grouped by depth below the root (host lists of indices)."""
    par = parent.tolist()
    depth = {root: 0}

    def d(j):
        chain = []
        while j not in depth:
            chain.append(j)
            j = par[j]
        base = depth[j]
        for k, c in enumerate(reversed(chain)):
            depth[c] = base + k + 1
        return depth[chain[0]] if chain else base

    for j in range(len(par)):
        d(j)
    levels: Dict[int, list] = {}
    for j, k in depth.items():
        levels.setdefault(k, []).append(j)
    return [levels[k] for k in sorted(levels) if k > 0]


def joint_transforms(P: Dict[str, torch.Tensor], sk: Dict, t: torch.Tensor,
                     mm: Products = torch.matmul):
    """(global SE3 of each joint [M, 7], rotation delta [M, 4], scale delta
    [M, 3])."""
    joints = P['joints']
    r_raw, d_rot, d_scale = skeleton_net(P, sk, joints, t, mm)
    ident = torch.zeros(4, dtype=F32, device=joints.device)
    ident[3] = 1.0
    rot = qnormalize(r_raw + ident)
    local = torch.cat([joints + qrotate(rot, -joints), rot], dim=-1)
    root = int(P['joint_root'])
    parent = P['joint_parents'][:, 0].to(torch.int64)
    glob = [None] * joints.shape[0]
    identity = torch.cat([torch.zeros(3, dtype=F32, device=joints.device),
                          ident])
    glob[root] = identity
    for level in depth_order(parent.cpu(), root):
        idx = torch.tensor(level, device=joints.device)
        par_rows = torch.stack([glob[int(p)] for p in parent[idx].tolist()])
        rows = se3_compose(par_rows, local[idx])
        for k, j in enumerate(level):
            glob[j] = rows[k]
    G = torch.stack(glob)
    G = se3_compose(root_transform(P, t)[None], G)
    return G, d_rot, d_scale


def lbs_weights(P: Dict[str, torch.Tensor], k: int, block: int = 16384):
    """(weights [N, K], joint ids [N, K]) over the live joints."""
    pts = P['xyz']
    keys = P['joints']
    live = P['sp_alive']
    ids = []
    for s in range(0, pts.shape[0], block):
        q = pts[s:s + block]
        d2 = torch.square(q[:, None, 0] - keys[None, :, 0])
        for j in (1, 2):
            d2 = d2 + torch.square(q[:, None, j] - keys[None, :, j])
        d2 = torch.where(live[None, :], d2, torch.full_like(d2, float('inf')))
        ids.append(torch.sort(d2, dim=1, stable=True).indices[:, :k])
    ids = torch.cat(ids)
    w = torch.softmax(torch.gather(P['sp_W'], 1, ids), dim=-1)
    return w, ids


def gaussians(P: Dict[str, torch.Tensor], cfg: Dict, t: float,
              mm: Products = torch.matmul) -> Dict[str, torch.Tensor]:
    """The renderer's inputs of every slot at time ``t``: means, scales,
    unit rotations, opacities, SH coefficients and the live mask. ``mm``
    computes the products (``tf32_matmul`` for the control)."""
    m_cfg = widths(cfg)
    dev = P['xyz'].device
    t = torch.as_tensor(t, dtype=F32, device=dev)
    G, d_rot, d_scale = joint_transforms(P, m_cfg['sk_net'], t, mm)
    w, ids = lbs_weights(P, m_cfg['num_knn'])
    dense = torch.zeros((w.shape[0], G.shape[0]), dtype=F32, device=dev)
    dense = dense.scatter_add(1, ids, w)
    table = torch.cat([qmatrix(G[:, 3:]), G[:, :3], d_rot, d_scale], dim=-1)
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


def params_from_flat(flat: Dict, device) -> Dict[str, torch.Tensor]:
    """The flat arrays on ``device`` under their leaf names (``params/``
    dropped)."""
    return {(k[len('params/'):] if k.startswith('params/') else k):
            torch.as_tensor(v).to(device).clone() for k, v in flat.items()}
