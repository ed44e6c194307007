"""Learning-rate multipliers by name (port of
``sk_gs_tpu/framework/lr_schedules.py``, the reference's ``_lr_methods``):
each maps a step (a number or a tensor) to a float32 tensor multiplier of
a base rate, 'fix', 'step', 'exp', 'exp2', 'poly', 'cos' and 'triangle'."""
from __future__ import annotations

import math
from typing import Callable, Dict

import torch

LR_SCHEDULES: Dict[str, Callable] = {}


def register(name):
    def deco(fn):
        LR_SCHEDULES[name] = fn
        return fn
    return deco


def _f32(s) -> torch.Tensor:
    return torch.as_tensor(s, dtype=torch.float32)


@register('fix')
def fix(s, **kw):
    return torch.ones_like(_f32(s))


@register('step')
def step_decay(s, step_size: int = 1000, gamma: float = 0.1, **kw):
    return torch.pow(_f32(gamma), torch.floor(_f32(s) / step_size))


@register('exp')
def exp_decay(s, gamma: float = 0.999, **kw):
    return torch.pow(_f32(gamma), _f32(s))


@register('exp2')
def exp2_decay(s, final_mult: float = 0.01, max_steps: int = 30000, **kw):
    """Log-linear from 1 to ``final_mult`` over ``max_steps``."""
    t = torch.clamp(_f32(s) / max_steps, 0.0, 1.0)
    return torch.exp(t * math.log(final_mult))


@register('poly')
def poly_decay(s, power: float = 0.9, max_steps: int = 30000, **kw):
    t = torch.clamp(_f32(s) / max_steps, 0.0, 1.0)
    return torch.pow(1.0 - t, power)


@register('cos')
def cos_decay(s, max_steps: int = 30000, final_mult: float = 0.0, **kw):
    t = torch.clamp(_f32(s) / max_steps, 0.0, 1.0)
    c = 0.5 * (1.0 + torch.cos(math.pi * t))
    return final_mult + (1.0 - final_mult) * c


@register('triangle')
def triangle(s, period: int = 2000, low: float = 0.1, **kw):
    t = torch.remainder(_f32(s), period) / period
    tri = 1.0 - torch.abs(2.0 * t - 1.0)
    return low + (1.0 - low) * tri


def lr_multiplier(name: str, s, **kw):
    if name not in LR_SCHEDULES:
        raise KeyError(f'unknown lr schedule {name!r}; have '
                       f'{sorted(LR_SCHEDULES)}')
    return LR_SCHEDULES[name](s, **kw)
