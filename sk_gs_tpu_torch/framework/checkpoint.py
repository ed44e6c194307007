"""Checkpoints: one ``.npz`` of '/'-joined keys per save, in the JAX
package's layout (``state/model/params/xyz``, ``state/opt/mu/...``,
``state/flags/...``, ``meta/step``), with interval saving, ``max_keep``
rotation and pinned names (port of ``save_pytree`` and
``CheckpointManager`` of ``sk_gs_tpu/framework/checkpoint.py``).

A checkpoint of either package loads into the other: the port writes every
leaf of the JAX trainer's ``ckpt_state()`` (``convert.trainer_state_to_flat``)
and its own state under ``state/port/...``, which the JAX loader skips; the
port reads the JAX names through ``convert``. A checkpoint holds its own
capacity: ``load`` gives its arrays as they are, and a model is built at
that capacity (``capacity_of``). ``pad_capacity`` pads the per-Gaussian
arrays, named one by one, to a larger capacity with dead rows.
"""
from __future__ import annotations

import logging
from pathlib import Path
from typing import Callable, Dict, List, Mapping, Optional, Union

import numpy as np

from ..models.sk_gs import GAUSS_LEAVES

log = logging.getLogger(__name__)

Flat = Dict[str, np.ndarray]
# the model arrays with one row per Gaussian slot (besides GAUSS_LEAVES)
PER_GAUSSIAN = ('params/hyper', 'params/sp_W', 'alive', 'max_radii2d',
                'xyz_grad_accum', 'denom', 'sp_weights', 'sp_knn', 'p2sp')


def save_flat(flat: Mapping[str, np.ndarray], path) -> Path:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez(path, **{k: np.asarray(v) for k, v in flat.items()})
    return path


def load(path) -> Flat:
    with np.load(Path(path), allow_pickle=False) as z:
        return {k: z[k] for k in z.files}


def step_of(flat: Mapping[str, np.ndarray]) -> int:
    return int(np.asarray(flat.get('meta/step', 0)))


def capacity_of(path) -> int:
    """The Gaussian capacity of a checkpoint (its ``xyz`` rows), read
    without loading the other arrays."""
    with np.load(Path(path), allow_pickle=False) as z:
        for k in z.files:
            if k.endswith('model/params/xyz'):
                return int(z[k].shape[0])
    raise KeyError(f'{path}: no model/params/xyz array')


def per_gaussian_keys(flat: Mapping[str, np.ndarray]) -> List[str]:
    """The keys of ``flat`` with one row per Gaussian slot: the model's
    (under ``state/model/``), their optimizer state and the smooth loss's
    KNN."""
    names = tuple('params/' + k for k in GAUSS_LEAVES) + PER_GAUSSIAN
    leaves = {n.split('/', 1)[1] for n in names if n.startswith('params/')}
    out = []
    for k in flat:
        rest = k.split('state/', 1)[-1]
        if rest.startswith('model/') and rest[len('model/'):] in names:
            out.append(k)
        elif rest.startswith('opt/') and rest.count('/') >= 2 and \
                rest.split('/', 2)[2] in leaves:
            out.append(k)
        elif rest == 'flags/gs_knn_index':
            out.append(k)
    return out


def pad_capacity(flat: Mapping[str, np.ndarray], capacity: int) -> Flat:
    """``flat`` with its per-Gaussian arrays padded to ``capacity`` rows:
    dead slots (``alive`` False), zeros elsewhere, as a row the densify
    frees; raises for a larger checkpoint."""
    out = dict(flat)
    for k in per_gaussian_keys(flat):
        arr = np.asarray(flat[k])
        n = arr.shape[0]
        if n > capacity:
            raise ValueError(f'{k}: {n} rows exceed the capacity {capacity}')
        if n < capacity:
            pad = np.zeros((capacity - n,) + arr.shape[1:], arr.dtype)
            if k.endswith('params/scaling'):
                pad[:] = -10.0   # a dead slot's log-scale (init_from_pcd)
            if k.endswith('params/rotation'):
                pad[:, 3] = 1.0
            out[k] = np.concatenate([arr, pad], axis=0)
    return out


class CheckpointManager:
    """``save(state, step)`` writes ``<prefix>_<step:08d>.npz`` when ``step``
    is a multiple of ``interval`` (any step with ``force``), keeping the
    last ``max_keep`` of them; a ``name`` pins a file outside the rotation.
    ``state`` is the flat trainer state (``SKGSTrainer.ckpt_state()``) or a
    callable that returns it, called only when a file is written."""

    def __init__(self, directory, interval: int = 5000, max_keep: int = 2,
                 prefix: str = 'checkpoint'):
        self.dir = Path(directory)
        self.interval = interval
        self.max_keep = max_keep
        self.prefix = prefix
        self._managed: List[Path] = []

    def path_for(self, step: int) -> Path:
        return self.dir / f'{self.prefix}_{step:08d}.npz'

    def save(self, state: Union[Flat, Callable[[], Flat]], step: int,
             force: bool = False, name: Optional[str] = None,
             manage: bool = True) -> Optional[Path]:
        if not force and (self.interval <= 0 or step % self.interval != 0):
            return None
        if callable(state):
            state = state()
        path = (self.dir / name) if name else self.path_for(step)
        flat = {'state/' + k: v for k, v in state.items()}
        flat['meta/step'] = np.asarray(step, np.int64)
        save_flat(flat, path)
        if manage and name is None:
            self._managed.append(path)
            while len(self._managed) > self.max_keep:
                self._managed.pop(0).unlink(missing_ok=True)
        log.info('saved checkpoint %s', path)
        return path

    def load(self, path=None) -> Flat:
        """The arrays of ``path``, or of the newest rotated checkpoint."""
        if path is None:
            cands = sorted(self.dir.glob(f'{self.prefix}_*.npz'))
            if not cands:
                raise FileNotFoundError(f'no checkpoints in {self.dir}')
            path = cands[-1]
        return load(path)

    def latest_step(self) -> int:
        cands = sorted(self.dir.glob(f'{self.prefix}_*.npz'))
        if not cands:
            return 0
        return int(cands[-1].stem.split('_')[-1])
