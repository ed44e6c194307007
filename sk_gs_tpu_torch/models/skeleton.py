"""Forward kinematics over a joint tree (port of ``skeleton_fk`` and
``kinematic_transforms`` of ``sk_gs_tpu/models/skeleton.py``), plus the
binary-lifting parents table that the JAX package's joint discovery builds.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..ops import quaternion as quat
from ..ops import se3

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
    """Per-joint rotation about the joint -> global SE3s via FK."""
    if sk_r_delta is not None:
        raise NotImplementedError('sk_r_delta reposing is not ported yet')
    sk_t = joints + quat.apply(sk_r, -joints)
    local = torch.cat([sk_t, sk_r], dim=-1)
    return skeleton_fk(local, g_tr, parents, root)
