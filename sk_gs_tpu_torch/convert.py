"""Turn the JAX package's SK-GS model arrays into the port's ``SKGSModel``.

Input is a flat ``{'/'-joined path: ndarray}`` dict in the naming of
``sk_gs_tpu/framework/checkpoint.py:_flatten``: ``params/xyz``,
``params/sk_deform/layers/0/w``, ``alive``, ... A checkpoint ``.npz`` written
by ``save_pytree`` loads with numpy alone (``load_npz``); its model arrays
sit under ``state/model/``, which is found and stripped here.

Weights keep the JAX layout (linear ``w`` is [in, out]), so the skeleton
net's leaves map one to one: ``params/sk_deform/layers/3/w`` ->
``sk_deform.layers.3.w``. ``adam_from_flat`` reads a trainer checkpoint's
Adam moments (``state/opt/mu/...``, ``state/opt/nu/...``,
``state/opt/count``) and ``model_to_flat`` writes the port's model back in
the JAX names.

Carried: the leaves the ``sk`` family reads (``SKGSModel.leaves``), the
buffers it reads (``AUX_BUFFERS``) and the training state it updates
(``STAT_BUFFERS``: ``max_radii2d``, ``xyz_grad_accum``, ``denom``,
``sk_cache``; zeros when the checkpoint has none). Not carried: the leaves
of the other stage families (``hyper``, ``sp_points``, ``sp_hyper``,
``joint_pos``, ``sp_deform``, ``canonical``) and their moments, and the
model fields only they use; they stay in the JAX checkpoint.
"""
from __future__ import annotations

from pathlib import Path
from typing import Dict, Mapping

import numpy as np
import torch

from . import resolve_device
from .models.deform import SkeletonNetConfig, skeleton_net
from .models.optim import AdamState
from .models.sk_gs import (AUX_BUFFERS, GAUSS_LEAVES, SK_LEAVES, STAT_BUFFERS,
                           SKGSConfig, SKGSModel)
from .ops.mlp import MLP
from .render.settings import RasterConfig

_BUFFER_DTYPES = {'alive': torch.bool, 'active_sh_degree': torch.int32,
                  'sp_alive': torch.bool, 'joint_parents': torch.int32,
                  'joint_root': torch.int32, 'train_times': torch.float32}


def _tensor(arr, device, dtype=torch.float32) -> torch.Tensor:
    """A copy of ``arr`` on ``device`` (``np.load`` arrays are read-only)."""
    return torch.tensor(np.asarray(arr), dtype=dtype, device=device)


def load_npz(path) -> Dict[str, np.ndarray]:
    with np.load(Path(path), allow_pickle=False) as data:
        return {k: data[k] for k in data.files}


def model_prefix(flat: Mapping[str, np.ndarray]) -> str:
    """'' for a bare model, 'state/model/' for a trainer checkpoint."""
    for prefix in ('', 'state/model/'):
        if prefix + 'params/xyz' in flat:
            return prefix
    raise KeyError('no params/xyz leaf (at the top or under "state/model/")')


def model_from_flat(flat: Mapping[str, np.ndarray], cfg: SKGSConfig,
                    rcfg: RasterConfig, device='cuda',
                    trainable: bool = False) -> SKGSModel:
    """Build the model on ``device`` (CUDA unless asked otherwise), frozen
    for serving unless ``trainable``."""
    device = resolve_device(device)
    pre = model_prefix(flat)

    def get(key: str) -> np.ndarray:
        if pre + key not in flat:
            raise KeyError(f'missing model array {pre + key!r}')
        return np.asarray(flat[pre + key])

    params = {k: _tensor(get('params/' + k), device) for k in GAUSS_LEAVES}
    for k in SK_LEAVES:
        if pre + 'params/' + k in flat:
            params[k] = _tensor(flat[pre + 'params/' + k], device)
    for k in ('joints', 'global_tr'):
        if k not in params:
            raise KeyError(f'missing model array {pre}params/{k!r}')
    if cfg.LBS_method == 'W' and 'sp_W' not in params:
        raise KeyError("LBS_method 'W' needs params/sp_W")

    net = skeleton_net_from_flat(flat, cfg.sk_net, pre + 'params/sk_deform/',
                                 device)
    buffers = {k: _tensor(get(k), device, _BUFFER_DTYPES[k])
               for k in AUX_BUFFERS}
    for k in STAT_BUFFERS:
        if pre + k in flat:
            buffers[k] = _tensor(flat[pre + k], device)
    return SKGSModel(cfg, rcfg, params, net, buffers, trainable=trainable)


def adam_from_flat(flat: Mapping[str, np.ndarray],
                   model: SKGSModel) -> AdamState:
    """The Adam state of a trainer checkpoint for the leaves ``model``
    holds, on the model's device."""
    if model_prefix(flat) != 'state/model/':
        raise KeyError('no trainer checkpoint (arrays under "state/model/")')
    leaves = {k: p.detach() for k, p in model.leaves().items()}
    moments = {}
    for moment in ('mu', 'nu'):
        moments[moment] = {}
        for name, p in leaves.items():
            key = f'state/opt/{moment}/{name}'
            if key not in flat:
                raise KeyError(f'missing optimizer array {key!r}')
            moments[moment][name] = _tensor(flat[key], p.device)
    return AdamState(mu=moments['mu'], nu=moments['nu'],
                     count=int(np.asarray(flat['state/opt/count'])))


def model_to_flat(model: SKGSModel) -> Dict[str, np.ndarray]:
    """A copy of the model's leaves and buffers as numpy arrays in the JAX
    names (``params/xyz``, ``params/sk_deform/layers/0/w``, ``alive``,
    ...)."""
    out = {'params/' + k: np.array(p.detach().cpu())
           for k, p in model.leaves().items()}
    for k in AUX_BUFFERS + STAT_BUFFERS:
        out[k] = np.array(getattr(model, k).cpu())
    return out


def skeleton_net_from_flat(flat: Mapping[str, np.ndarray],
                           cfg: SkeletonNetConfig, prefix: str,
                           device='cuda') -> MLP:
    """The skeleton net whose leaves sit under ``prefix`` (``.../layers/0/w``,
    ``.../heads/2/b``, ...), shapes checked against ``cfg``."""
    device = resolve_device(device)
    net = skeleton_net(cfg, device)
    state = {}
    for name, ref in net.state_dict().items():
        key = prefix + name.replace('.', '/')
        if key not in flat:
            raise KeyError(f'missing model array {key!r}')
        arr = np.asarray(flat[key])
        if tuple(arr.shape) != tuple(ref.shape):
            raise ValueError(f'{key}: shape {arr.shape} != '
                             f'{tuple(ref.shape)} of the configured net')
        state[name] = _tensor(arr, device)
    net.load_state_dict(state)
    return net
