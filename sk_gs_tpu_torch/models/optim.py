"""Optimizers with per-leaf learning rates (port of the state types, the
updates, the registry and the surgery of ``sk_gs_tpu/models/optim.py``):
Adam, AdamW, SGD and Adan.

Plain tensor functions in the JAX form, not ``torch.optim``: each step
takes a learning rate per leaf from the caller, and a leaf whose rate is 0
stays bit-identical (its moments still move). Adam's update is
``p - lr * m_hat / (sqrt(v_hat) + eps)`` with ``eps = 1e-15`` outside the
square root. Leaves are dicts of tensors keyed by name; every update writes
parameters and state in place (no second copy of the 100k x 512 leaves) and
returns the state with its step count advanced. The state types keep the
JAX field names (``mu``, ``nu``, ``delta``, ``prev_grad``, ``count``), so a
checkpoint's ``opt/<field>/<leaf>`` arrays map one to one.
"""
from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Tuple

import torch

Tree = Dict[str, torch.Tensor]


class AdamState(NamedTuple):
    mu: Tree       # first moments, keyed like the params
    nu: Tree       # second moments
    count: int     # steps taken


class SGDState(NamedTuple):
    mu: Tree       # momentum buffers
    count: int


class AdanState(NamedTuple):
    mu: Tree         # EMA of the gradients
    delta: Tree      # EMA of the gradient differences
    nu: Tree         # EMA of the squared (g + (1 - b2) diff)
    prev_grad: Tree  # the last step's gradients
    count: int


def _zeros(params: Tree) -> Tree:
    return {k: torch.zeros_like(v) for k, v in params.items()}


def adam_init(params: Tree) -> AdamState:
    return AdamState(mu=_zeros(params), nu=_zeros(params), count=0)


def sgd_init(params: Tree) -> SGDState:
    return SGDState(mu=_zeros(params), count=0)


def adan_init(params: Tree) -> AdanState:
    return AdanState(mu=_zeros(params), delta=_zeros(params),
                     nu=_zeros(params), prev_grad=_zeros(params), count=0)


def clip_by_global_norm(grads: Tree, max_norm: float):
    """Scale every gradient by min(1, max_norm / global norm); returns the
    scaled dict and the norm."""
    total = sum(torch.sum(torch.square(g)) for g in grads.values())
    gnorm = torch.sqrt(total + 1e-20)
    scale = torch.clamp(max_norm / gnorm, max=1.0)
    return {k: g * scale for k, g in grads.items()}, gnorm


def _dense_grads(grads: Tree, params: Tree, clip_norm: float) -> Tree:
    """A gradient for every leaf of ``params`` (zeros where ``grads`` has
    none, as the JAX package's dense gradient trees), clipped by the global
    norm when ``clip_norm`` > 0."""
    grads = {k: grads[k] if grads.get(k) is not None
             else torch.zeros_like(p) for k, p in params.items()}
    if clip_norm and clip_norm > 0:
        grads, _ = clip_by_global_norm(grads, clip_norm)
    return grads


@torch.no_grad()
def adam_update(grads: Tree, state: AdamState, params: Tree,
                lrs: Dict[str, float], b1: float = 0.9, b2: float = 0.999,
                eps: float = 1e-15, clip_norm: float = 0.0) -> AdamState:
    """One Adam step over every leaf of ``params``, in place. ``lrs`` holds
    a host float per leaf."""
    grads = _dense_grads(grads, params, clip_norm)
    count = state.count + 1
    bc1 = 1.0 - b1 ** count
    bc2 = 1.0 - b2 ** count
    for k, p in params.items():
        g, m, v = grads[k], state.mu[k], state.nu[k]
        m.mul_(b1).add_((1 - b1) * g)
        v.mul_(b2).add_((1 - b2) * g * g)
        p.sub_(lrs[k] * (m / bc1) / (torch.sqrt(v / bc2) + eps))
    return AdamState(mu=state.mu, nu=state.nu, count=count)


@torch.no_grad()
def adamw_update(grads: Tree, state: AdamState, params: Tree,
                 lrs: Dict[str, float], b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-15, weight_decay: float = 1e-2,
                 clip_norm: float = 0.0) -> AdamState:
    """Adam, then the decoupled weight decay ``p -= lr * wd * p_before``
    (``optim.py:150-159``)."""
    decay = {k: lrs[k] * weight_decay * p for k, p in params.items()}
    state = adam_update(grads, state, params, lrs, b1=b1, b2=b2, eps=eps,
                        clip_norm=clip_norm)
    for k, p in params.items():
        p.sub_(decay[k])
    return state


@torch.no_grad()
def sgd_update(grads: Tree, state: SGDState, params: Tree,
               lrs: Dict[str, float], momentum: float = 0.9,
               nesterov: bool = False, weight_decay: float = 0.0,
               clip_norm: float = 0.0) -> SGDState:
    """SGD with momentum ``mu <- momentum * mu + g`` (g + wd * p with weight
    decay), Nesterov's ``momentum * mu + g`` as the step when asked
    (``optim.py:133-147``)."""
    grads = _dense_grads(grads, params, clip_norm)
    for k, p in params.items():
        g = grads[k]
        if weight_decay:
            g = g + weight_decay * p
        mu = state.mu[k]
        mu.mul_(momentum).add_(g)
        step = momentum * mu + g if nesterov else mu
        p.sub_(lrs[k] * step)
    return SGDState(mu=state.mu, count=state.count + 1)


@torch.no_grad()
def adan_update(grads: Tree, state: AdanState, params: Tree,
                lrs: Dict[str, float], b1: float = 0.98, b2: float = 0.92,
                b3: float = 0.99, eps: float = 1e-8,
                weight_decay: float = 0.0, clip_norm: float = 0.0
                ) -> AdanState:
    """Adan (``optim.py:177-209``): the gradient difference is 0 at the
    first step; mu, delta and nu are EMAs with the weights b1, b2, b3 on the
    new value, bias-corrected by 1 - (1 - b)^count; the step is
    (mu_hat + (1 - b2) delta_hat) / (sqrt(nu_hat) + eps), and with weight
    decay the parameter is divided by 1 + lr * wd after it."""
    grads = _dense_grads(grads, params, clip_norm)
    count = state.count + 1
    first = count <= 1
    bc1 = 1.0 - (1 - b1) ** count
    bc2 = 1.0 - (1 - b2) ** count
    bc3 = 1.0 - (1 - b3) ** count
    for k, p in params.items():
        g = grads[k]
        diff = torch.zeros_like(g) if first else g - state.prev_grad[k]
        m, d, v = state.mu[k], state.delta[k], state.nu[k]
        m.mul_(1 - b1).add_(b1 * g)
        d.mul_(1 - b2).add_(b2 * diff)
        update_g = g + (1 - b2) * diff
        v.mul_(1 - b3).add_(b3 * update_g * update_g)
        denom = torch.sqrt(v / bc3) + eps
        p.sub_(lrs[k] * ((m / bc1 + (1 - b2) * d / bc2) / denom))
        if weight_decay:
            p.div_(1.0 + lrs[k] * weight_decay)
        state.prev_grad[k].copy_(g)
    return AdanState(mu=state.mu, delta=state.delta, nu=state.nu,
                     prev_grad=state.prev_grad, count=count)


OPTIMIZERS: Dict[str, Tuple[Callable, Callable]] = {
    'adam': (adam_init, adam_update),
    'adamw': (adam_init, adamw_update),
    'sgd': (sgd_init, sgd_update),
    'adan': (adan_init, adan_update),
}


def make_optimizer(name: str) -> Tuple[Callable, Callable]:
    """(init_fn, update_fn) of the optimizer ``name``."""
    if name not in OPTIMIZERS:
        raise KeyError(f'unknown optimizer {name!r}; have {list(OPTIMIZERS)}')
    return OPTIMIZERS[name]


def moment_fields(state) -> Tuple[str, ...]:
    """The fields of ``state`` that hold a tensor per leaf (Adam mu / nu,
    SGD mu, Adan mu / delta / nu / prev_grad); ``count`` is not one."""
    return tuple(f for f in state._fields
                 if isinstance(getattr(state, f), dict))


@torch.no_grad()
def reset_rows(state, name: str, row_mask: torch.Tensor):
    """Zero every moment field of leaf ``name`` at the rows ``row_mask``
    [rows] selects, in place (the surgery for replaced, cloned or split
    rows, ``optim.py:66-90``)."""
    for f in moment_fields(state):
        x = getattr(state, f)[name]
        x.masked_fill_(row_mask.reshape(-1, *([1] * (x.dim() - 1))), 0.0)


@torch.no_grad()
def reset_leaf(state, name: str):
    """Zero every moment field of leaf ``name``, in place
    (``optim.py:93-95``)."""
    for f in moment_fields(state):
        getattr(state, f)[name].zero_()
