"""NeRF frequency encoder (port of ``sk_gs_tpu/ops/encoders.py:FreqEncoder``):
[x, sin(f_k x), cos(f_k x)] over log-sampled bands 2^0..2^(degree-1)."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch


@dataclass(frozen=True)
class FreqEncoder:
    input_dim: int
    degree: int = 4
    include_input: bool = True
    scale: float = 1.0
    log_sampling: bool = True

    @property
    def output_dim(self) -> int:
        d = self.input_dim if self.include_input else 0
        return d + self.input_dim * self.degree * 2

    @property
    def freq_bands(self) -> Tuple[float, ...]:
        if self.degree == 0:
            return ()
        if self.log_sampling:
            bands = 2.0 ** np.linspace(0.0, self.degree - 1, self.degree)
        else:
            bands = np.linspace(1.0, 2.0 ** (self.degree - 1), self.degree)
        return tuple(float(b) * self.scale for b in bands)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        outs = [x] if self.include_input else []
        for f in self.freq_bands:
            xf = x * f
            outs.append(torch.sin(xf))
            outs.append(torch.cos(xf))
        if not outs:
            return x
        return torch.cat(outs, dim=-1)
