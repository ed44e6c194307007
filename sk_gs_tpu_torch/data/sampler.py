"""Step-keyed view samplers (a copy of ``sk_gs_tpu/data/sampler.py``).

``sample(step)`` draws from a numpy generator seeded with (seed, step,
draw#), so a run picks the same views as the JAX trainer with the same seed,
and a resumed run the same views as an uninterrupted one: no sampler state
goes into a checkpoint. ``UniformSampler`` draws any view;
``TimeIncrementalSampler`` only views whose time lies in a window that
widens with training progress; ``CanonicalSampler`` oversamples the
canonical frame with an annealed probability.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np


class _StepKeyed:
    """Deterministic per-(seed, step, draw) generator; repeated calls at
    one step advance the draw counter."""

    def __init__(self, seed: int):
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


class UniformSampler(_StepKeyed):
    """A uniform view index per step."""

    def __init__(self, num_views: int, seed: int = 0):
        super().__init__(seed)
        self.num_views = num_views

    def sample(self, step: int) -> int:
        return int(self._rng(step).integers(0, self.num_views))


class TimeIncrementalSampler(_StepKeyed):
    """At progress p in [0, 1] only views with time <= max(t_min, p)."""

    def __init__(self, times: np.ndarray, total_steps: int,
                 warmup_steps: int = 0, t_min: float = 0.1, seed: int = 0):
        super().__init__(seed)
        self.times = np.asarray(times)
        self.total_steps = max(total_steps, 1)
        self.warmup_steps = warmup_steps
        self.t_min = t_min

    def sample(self, step: int) -> int:
        if step <= self.warmup_steps:
            window = self.t_min
        else:
            p = (step - self.warmup_steps) / max(
                self.total_steps - self.warmup_steps, 1)
            window = max(self.t_min, min(p, 1.0))
        eligible = np.flatnonzero(self.times <= window + 1e-9)
        if len(eligible) == 0:
            eligible = np.asarray([int(np.argmin(self.times))])
        return int(self._rng(step).choice(eligible))


class CanonicalSampler(_StepKeyed):
    """A canonical view with probability p0 (1 - step / anneal_steps), else
    a uniform one."""

    def __init__(self, num_views: int, canonical_ids: Sequence[int],
                 p0: float = 0.3, anneal_steps: int = 10000, seed: int = 0):
        super().__init__(seed)
        self.num_views = num_views
        self.canonical_ids = np.asarray(list(canonical_ids))
        self.p0 = p0
        self.anneal_steps = max(anneal_steps, 1)

    def sample(self, step: int) -> int:
        rng = self._rng(step)
        p = self.p0 * max(0.0, 1.0 - step / self.anneal_steps)
        if len(self.canonical_ids) and rng.random() < p:
            return int(rng.choice(self.canonical_ids))
        return int(rng.integers(0, self.num_views))


def make_sampler(kind: str, num_views: int, times: Optional[np.ndarray] = None,
                 canonical_ids: Sequence[int] = (), total_steps: int = 1,
                 seed: int = 0, **kwargs):
    kind = (kind or 'uniform').lower()
    if kind in ('uniform', 'iterable', 'shuffle'):
        return UniformSampler(num_views, seed)
    if kind in ('time_incremental', 'ti'):
        return TimeIncrementalSampler(times, total_steps, seed=seed, **kwargs)
    if kind == 'canonical':
        return CanonicalSampler(num_views, canonical_ids, seed=seed, **kwargs)
    raise KeyError(f'unknown sampler {kind}')
