"""Step-keyed view sampler (a copy of ``UniformSampler`` of
``sk_gs_tpu/data/sampler.py``).

``sample(step)`` draws from a numpy generator seeded with (seed, step,
draw#), so a run picks the same views as the JAX trainer with the same seed,
and a resumed run the same views as an uninterrupted one.
"""
from __future__ import annotations

import numpy as np


class UniformSampler:
    """Uniform view index per step; repeated calls at one step advance the
    draw counter."""

    def __init__(self, num_views: int, seed: int = 0):
        self.num_views = num_views
        self.seed = int(seed)
        self._last_step = None
        self._draw = 0

    def _rng(self, step: int) -> np.random.Generator:
        if step != self._last_step:
            self._last_step = step
            self._draw = 0
        rng = np.random.default_rng((self.seed, int(step), self._draw))
        self._draw += 1
        return rng

    def sample(self, step: int) -> int:
        return int(self._rng(step).integers(0, self.num_views))
