"""Forward kinematics over a joint tree, joint discovery and the joint
cost (port of ``skeleton_fk``, ``kinematic_transforms``,
``joint_discovery_host``, ``update_joint`` and ``joint_cost_matrix`` of
``sk_gs_tpu/models/skeleton.py``), plus the binary-lifting parents table.

Joint discovery is the JAX package's numpy algorithm, copied: Kruskal's
MST over the live block of the cost matrix, a root chosen by peeling the
leaves, parents by breadth-first search from it. It runs on the host
between steps, as in the JAX package.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..ops import quaternion as quat
from ..ops import se3
from ..utils.tracing import host_read

MAX_LEVELS = 10  # chains up to 2^10 deep (M <= 1024)


def parents_table(parent: np.ndarray, root: int,
                  max_levels: int = MAX_LEVELS) -> np.ndarray:
    """[M, max_levels] int32 table, column l = the 2^l-th ancestor, clamped
    at the root. ``parent[j]`` is j's parent; the root's own entry and dead
    joints' entries should be ``root``."""
    parent = np.asarray(parent, np.int32).copy()
    parent[root] = root
    table = np.empty((parent.shape[0], max_levels), np.int32)
    table[:, 0] = parent
    for lv in range(1, max_levels):
        table[:, lv] = table[table[:, lv - 1], lv - 1]
    return table


def joint_discovery_host(cost: np.ndarray, alive: np.ndarray,
                         max_levels: int = MAX_LEVELS
                         ) -> Tuple[np.ndarray, np.ndarray, int]:
    """(parents [M, max_levels] int32, depth [M] int32, root) of the MST
    over the live sub-block of ``cost``: Kruskal over the edges sorted by
    cost, then re-rooted at the node that leaf peeling reaches last. Dead
    joints get parent = root and depth 0."""
    m = cost.shape[0]
    alive_idx = np.flatnonzero(alive)
    parents = np.full((m, max_levels), 0, dtype=np.int32)
    depth = np.zeros(m, dtype=np.int32)
    if len(alive_idx) == 0:
        return parents, depth, 0
    if len(alive_idx) == 1:
        r = int(alive_idx[0])
        parents[:] = r
        return parents, depth, r

    sub = cost[np.ix_(alive_idx, alive_idx)].astype(np.float64)
    k = len(alive_idx)
    np.fill_diagonal(sub, np.inf)
    comp = np.arange(k)
    edges = []

    def find(x):
        while comp[x] != x:
            comp[x] = comp[comp[x]]
            x = comp[x]
        return x

    for flat in np.argsort(sub, axis=None):
        if len(edges) == k - 1:
            break
        a, b = divmod(int(flat), k)
        if not np.isfinite(sub[a, b]):
            continue
        ra, rb = find(a), find(b)
        if ra == rb:
            continue
        comp[ra] = rb
        edges.append((a, b))

    adj = [[] for _ in range(k)]
    for a, b in edges:
        adj[a].append(b)
        adj[b].append(a)
    deg = np.array([len(a) for a in adj])
    que = [i for i in range(k) if deg[i] <= 1]
    i = 0
    while i < len(que):
        now = que[i]
        i += 1
        for nxt in adj[now]:
            if deg[nxt] > 1:
                deg[nxt] -= 1
                if deg[nxt] == 1:
                    que.append(nxt)
    root_local = que[-1] if que else 0

    par = np.full(k, root_local, dtype=np.int32)
    dep = np.zeros(k, dtype=np.int32)
    seen = np.zeros(k, dtype=bool)
    seen[root_local] = True
    que = [root_local]
    i = 0
    while i < len(que):
        now = que[i]
        i += 1
        for nxt in adj[now]:
            if not seen[nxt]:
                par[nxt] = now
                dep[nxt] = dep[now] + 1
                seen[nxt] = True
                que.append(nxt)

    root = int(alive_idx[root_local])
    parents[:] = root
    parents[alive_idx, 0] = alive_idx[par]
    depth[alive_idx] = dep
    for lv in range(1, max_levels):
        parents[:, lv] = parents[parents[:, lv - 1], lv - 1]
    return parents, depth, root


@torch.no_grad()
def update_joint(cost: torch.Tensor, sp_points: torch.Tensor,
                 sp_alive: torch.Tensor, sk_knn_num: int
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The joint tree of the cost matrix restricted to each superpoint's
    ``sk_knn_num`` nearest live superpoints (the farther pairs cost
    max|finite cost| + 1 more), by ``joint_discovery_host`` on the host.
    Returns (parents [M, L] int32, depth [M] int32, root [] int32) on the
    cost's device."""
    if sk_knn_num > 0:
        d = torch.linalg.norm(sp_points[:, None] - sp_points[None, :], dim=-1)
        inf = torch.tensor(float('inf'), device=d.device)
        d = torch.where(sp_alive[None, :], d, inf)
        col = torch.minimum(torch.tensor(sk_knn_num, device=d.device),
                            sp_alive.sum() - 1)
        kth = torch.sort(d, dim=-1).values[:, col]
        finite = torch.where(torch.isfinite(cost), cost,
                             torch.zeros_like(cost))
        big = torch.abs(torch.max(finite)) + 1.0
        cost = torch.where(d > kth[:, None], cost + big, cost)
    parents, depth, root = joint_discovery_host(
        host_read(cost).numpy(), host_read(sp_alive).numpy())
    dev = cost.device
    return (torch.as_tensor(parents, dtype=torch.int32, device=dev),
            torch.as_tensor(depth, dtype=torch.int32, device=dev),
            torch.tensor(root, dtype=torch.int32, device=dev))


def _safe_norm(x: torch.Tensor, dim: int = -1, eps: float = 1e-12
               ) -> torch.Tensor:
    """A norm with a finite gradient at 0."""
    return torch.sqrt(torch.sum(torch.square(x), dim=dim) + eps)


def joint_cost_matrix(joint_pos: torch.Tensor, spT: torch.Tensor,
                      sp_alive: torch.Tensor) -> torch.Tensor:
    """cost[a, b] = |T_b(j_ab) - T_a(j_ab)| + |T_a(j_ab) - T_b(j_ba)| for
    the pivots ``joint_pos`` [M, M, 3] and the superpoint transforms
    ``spT`` [M, 7]; +inf where a or b is dead."""
    ja_by_b = se3.se3_act(spT[None, :, :], joint_pos)
    ja_by_a = se3.se3_act(spT[:, None, :], joint_pos)
    c1 = _safe_norm(ja_by_b - ja_by_a)
    c2 = _safe_norm(ja_by_a - torch.swapaxes(ja_by_a, 0, 1))
    cost = c1 + c2
    valid = sp_alive[:, None] & sp_alive[None, :]
    return torch.where(valid, cost, torch.full_like(cost, float('inf')))


def skeleton_fk(local_T: torch.Tensor, global_T: Optional[torch.Tensor],
                parents: torch.Tensor, root) -> torch.Tensor:
    """Compose local SE3s [M, 7] along the parent chains in log2 depth
    steps; the root's local transform is replaced by identity, and
    ``global_T`` [7] is applied at the root afterwards."""
    m = local_T.shape[0]
    is_root = (torch.arange(m, device=local_T.device) == root)[:, None]
    out = torch.where(is_root, se3.se3_identity((m,), local_T.dtype,
                                                local_T.device), local_T)
    par = parents.to(torch.int64)
    for level in range(par.shape[1]):
        out = se3.se3_mul(out[par[:, level]], out)
    if global_T is not None:
        out = se3.se3_mul(global_T[None, :], out)
    return out


def kinematic_transforms(joints: torch.Tensor, sk_r: torch.Tensor,
                         g_tr: Optional[torch.Tensor], parents: torch.Tensor,
                         root, sk_r_delta: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """Per-joint rotation about the joint -> global SE3s via FK. A repose
    delta ``sk_r_delta`` [M, 3] (an so3 log, through ``so3_exp``) or [M, 4]
    (a quaternion) is composed before each joint's rotation."""
    if sk_r_delta is not None:
        dq = se3.so3_exp(sk_r_delta) if sk_r_delta.shape[-1] == 3 \
            else sk_r_delta
        sk_r = quat.multiply(dq, sk_r)
    sk_t = joints + quat.apply(sk_r, -joints)
    local = torch.cat([sk_t, sk_r], dim=-1)
    return skeleton_fk(local, g_tr, parents, root)
