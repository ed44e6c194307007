"""Turn the JAX package's SK-GS model arrays into the port's ``SKGSModel``.

Input is a flat ``{'/'-joined path: ndarray}`` dict in the naming of
``sk_gs_tpu/framework/checkpoint.py:_flatten``: ``params/xyz``,
``params/sk_deform/layers/0/w``, ``alive``, ... A checkpoint ``.npz`` written
by ``save_pytree`` loads with numpy alone (``load_npz``); its model arrays
sit under ``state/model/``, which is found and stripped here.

Weights keep the JAX layout (linear ``w`` is [in, out]), so the skeleton
net's leaves map one to one: ``params/sk_deform/layers/3/w`` ->
``sk_deform.layers.3.w``.
"""
from __future__ import annotations

from pathlib import Path
from typing import Dict, Mapping

import numpy as np
import torch

from . import resolve_device
from .models.deform import SkeletonNetConfig, skeleton_net
from .models.sk_gs import AUX_BUFFERS, GAUSS_LEAVES, SK_LEAVES, SKGSConfig, SKGSModel
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
                    rcfg: RasterConfig, device='cuda') -> SKGSModel:
    """Build the serving model on ``device`` (CUDA unless asked otherwise)."""
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
    return SKGSModel(cfg, rcfg, params, net, buffers)


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
