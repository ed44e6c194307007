"""MLPs with input skips (port of ``sk_gs_tpu/ops/mlp.py``).

The JAX package keeps each net as ``{'layers': [{'w', 'b'}, ...], 'heads':
[...] | None}`` with ``w`` laid out [in, out] and ``y = x @ w + b``. The
modules here keep that layout, so a state dict maps one to one onto the
JAX leaves (``layers/0/w`` <-> ``layers.0.w``).
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn


class Linear(nn.Module):
    """y = x @ w + b with w [in, out] (the JAX layout, not nn.Linear's)."""

    def __init__(self, fan_in: int, fan_out: int, device=None):
        super().__init__()
        self.w = nn.Parameter(torch.zeros(fan_in, fan_out, device=device))
        self.b = nn.Parameter(torch.zeros(fan_out, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return linear_apply(self, x)


def linear_apply(p, x: torch.Tensor) -> torch.Tensor:
    """x @ w + b in the dtype of ``x``: float32 weights are cast to it (the
    float32 master weights of a bfloat16 net)."""
    w, b = p.w, p.b
    if w.dtype != x.dtype:
        w, b = w.to(x.dtype), b.to(x.dtype)
    return x @ w + b


class MLP(nn.Module):
    """Trunk of ReLU layers, the input concatenated after each layer in
    ``skips``, and zero, one or several linear heads."""

    def __init__(self, in_channels: int, dim_hidden: int, num_layers: int,
                 out_channels: Sequence[int] = (), skips: Sequence[int] = (),
                 device=None):
        super().__init__()
        self.skips = tuple(skips)
        layers = []
        cin = in_channels
        for i in range(num_layers):
            layers.append(Linear(cin, dim_hidden, device))
            cin = dim_hidden + (in_channels if i in self.skips else 0)
        self.layers = nn.ModuleList(layers)
        self.heads: Optional[nn.ModuleList] = (
            nn.ModuleList([Linear(cin, oc, device) for oc in out_channels])
            if out_channels else None)

    def forward(self, x: torch.Tensor, multi_head: bool = False):
        return mlp_apply(self, x, self.skips, multi_head)


def mlp_apply(params: MLP, x: torch.Tensor, skips: Sequence[int] = (),
              multi_head: bool = False):
    skips = tuple(skips)
    inputs = x
    for i, layer in enumerate(params.layers):
        x = torch.relu(linear_apply(layer, x))
        if i in skips:
            x = torch.cat([x, inputs], dim=-1)
    if params.heads is None:
        return x
    if multi_head:
        return tuple(linear_apply(h, x) for h in params.heads)
    return linear_apply(params.heads[0], x)
