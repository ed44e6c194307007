"""Adam with per-leaf learning rates (port of ``AdamState``, ``adam_init``,
``adam_update`` and ``clip_by_global_norm`` of ``sk_gs_tpu/models/optim.py``).

Plain tensor functions in the JAX form, not ``torch.optim.Adam``: each step
takes a learning rate per leaf from the caller, the update is
``p - lr * m_hat / (sqrt(v_hat) + eps)`` with ``eps = 1e-15`` outside the
square root, and a leaf whose rate is 0 stays bit-identical (its moments
still move). Leaves are dicts of tensors keyed by name; the update writes
parameters and moments in place (no second copy of the 100k x 512 leaves).
"""
from __future__ import annotations

from typing import Dict, NamedTuple

import torch


class AdamState(NamedTuple):
    mu: Dict[str, torch.Tensor]   # first moments, keyed like the params
    nu: Dict[str, torch.Tensor]   # second moments
    count: int                    # steps taken


def adam_init(params: Dict[str, torch.Tensor]) -> AdamState:
    return AdamState(mu={k: torch.zeros_like(v) for k, v in params.items()},
                     nu={k: torch.zeros_like(v) for k, v in params.items()},
                     count=0)


def clip_by_global_norm(grads: Dict[str, torch.Tensor], max_norm: float):
    """Scale every gradient by min(1, max_norm / global norm); returns the
    scaled dict and the norm."""
    total = sum(torch.sum(torch.square(g)) for g in grads.values())
    gnorm = torch.sqrt(total + 1e-20)
    scale = torch.clamp(max_norm / gnorm, max=1.0)
    return {k: g * scale for k, g in grads.items()}, gnorm


@torch.no_grad()
def adam_update(grads: Dict[str, torch.Tensor], state: AdamState,
                params: Dict[str, torch.Tensor], lrs: Dict[str, float],
                b1: float = 0.9, b2: float = 0.999, eps: float = 1e-15,
                clip_norm: float = 0.0) -> AdamState:
    """One Adam step over every leaf of ``params``, in place. ``lrs`` holds
    a host float per leaf; a leaf without a gradient in ``grads`` steps on
    a zero gradient, as the JAX package's dense gradient trees do."""
    grads = {k: grads[k] if grads.get(k) is not None
             else torch.zeros_like(p) for k, p in params.items()}
    if clip_norm and clip_norm > 0:
        grads, _ = clip_by_global_norm(grads, clip_norm)
    count = state.count + 1
    bc1 = 1.0 - b1 ** count
    bc2 = 1.0 - b2 ** count
    for k, p in params.items():
        g, m, v = grads[k], state.mu[k], state.nu[k]
        m.mul_(b1).add_((1 - b1) * g)
        v.mul_(b2).add_((1 - b2) * g * g)
        p.sub_(lrs[k] * (m / bc1) / (torch.sqrt(v / bc2) + eps))
    return AdamState(mu=state.mu, nu=state.nu, count=count)

