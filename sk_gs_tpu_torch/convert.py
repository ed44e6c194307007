"""Turn the JAX package's SK-GS model arrays into the port's ``SKGSModel``.

Input is a flat ``{'/'-joined path: ndarray}`` dict in the naming of
``sk_gs_tpu/framework/checkpoint.py:_flatten``: ``params/xyz``,
``params/sk_deform/layers/0/w``, ``alive``, ... A checkpoint ``.npz`` written
by ``save_pytree`` loads with numpy alone (``load_npz``); its model arrays
sit under ``state/model/``, which is found and stripped here.

Weights keep the JAX layout (linear ``w`` is [in, out]), so the skeleton
net's leaves map one to one: ``params/sk_deform/layers/3/w`` ->
``sk_deform.layers.3.w``. ``optimizer_from_flat`` reads a trainer
checkpoint's optimizer state in the JAX names (``state/opt/<field>/<leaf>``
for each of the state's fields: Adam and AdamW ``mu`` / ``nu``, SGD ``mu``,
Adan ``mu`` / ``delta`` / ``nu`` / ``prev_grad``; and
``state/opt/count``) and ``optimizer_to_flat`` writes it;
``model_to_flat``
writes the port's model back in the JAX names. ``trainer_flags_from_flat``
reads a trainer checkpoint's stage flags and the smooth loss's KNN
(``state/flags/...``) as the JAX trainer's ``restore`` does, so that a run
taken inside the ``sp`` or ``sk`` stages resumes in the port, and
``trainer_state_to_flat`` writes a trainer's whole state in the layout of
the JAX trainer's ``ckpt_state()`` (every leaf of it), plus the port's own
keys under ``port/``, which the JAX loader skips.

Carried: every leaf of ``SKGSModel.leaves`` (the Gaussian and skeleton
leaves, ``hyper``, ``sp_points``, ``sp_hyper`` and ``joint_pos`` when the
arrays have them, the skeleton net, and the warp nets ``sp_deform`` and
``canonical`` under ``params/sp_deform/...`` and ``params/canonical/...``
when present) and their optimizer state, the buffers the port reads
(``AUX_BUFFERS``) and the training state it updates (``STAT_BUFFERS``:
``max_radii2d``, ``xyz_grad_accum``, ``denom``, ``sk_cache``, ``sp_cache``,
``joint_cost``, ``p2sp``, the frozen LBS of the sk stages, ``sp_weights``
/ ``sp_knn``, which the skeleton initialisation writes, and the joints'
tree depth ``joint_depth``; zeros when the checkpoint has none), both ways.
"""
from __future__ import annotations

from pathlib import Path
from typing import Dict, Mapping

import numpy as np
import torch

from . import resolve_device
from torch import nn

from .models.deform import (DeformNet, DeformNetConfig, SkeletonNetConfig,
                            skeleton_net)
from .models.optim import make_optimizer
from .models.sk_gs import (AUX_BUFFERS, DEFORM_NETS, GAUSS_LEAVES, SK_LEAVES,
                           SP_LEAVES, STAT_BUFFERS, SKGSConfig, SKGSModel)
from .ops.knn import live_knn_index
from .ops.mlp import MLP
from .render.settings import RasterConfig

_BUFFER_DTYPES = {'alive': torch.bool, 'active_sh_degree': torch.int32,
                  'sp_alive': torch.bool, 'joint_parents': torch.int32,
                  'joint_root': torch.int32, 'train_times': torch.float32,
                  'p2sp': torch.int32, 'sp_knn': torch.int32,
                  'joint_depth': torch.int32}
# the trainer's stage flags in a JAX ``ckpt_state()``
TRAINER_FLAGS = ('sp_initialized', 'reinit_done', 'skeleton_initialized')
# the port's own trainer state: the CPU generator of the split noise and of
# the skeleton initialisation's frames, the training device's generators of
# the backgrounds, of the time noise and of the regularizers' draws, and a
# mark that the smooth loss's KNN is the trainer's own (an all-zero one
# included, which the JAX ``restore`` would rebuild as a checkpoint's that
# lacks it)
NOISE_GEN_KEY = 'port/noise_gen_state'
BG_GEN_KEY = 'port/bg_gen_state'
TIME_GEN_KEY = 'port/time_gen_state'
REG_GEN_KEY = 'port/reg_gen_state'
KNN_OWN_KEY = 'port/gs_knn_index_own'


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
    for k in SK_LEAVES + SP_LEAVES:
        if pre + 'params/' + k in flat:
            params[k] = _tensor(flat[pre + 'params/' + k], device)
    for k in ('joints', 'global_tr'):
        if k not in params:
            raise KeyError(f'missing model array {pre}params/{k!r}')
    if cfg.LBS_method == 'W' and 'sp_W' not in params:
        raise KeyError("LBS_method 'W' needs params/sp_W")

    net = skeleton_net_from_flat(flat, cfg.sk_net, pre + 'params/sk_deform/',
                                 device)
    warp_nets = {}
    for name in DEFORM_NETS:
        prefix = f'{pre}params/{name}/'
        if any(k.startswith(prefix) for k in flat):
            warp_nets[name] = deform_net_from_flat(flat, cfg.net, prefix,
                                                   device)
    buffers = {k: _tensor(get(k), device, _BUFFER_DTYPES[k])
               for k in AUX_BUFFERS}
    for k in STAT_BUFFERS:
        if pre + k in flat:
            buffers[k] = _tensor(flat[pre + k], device,
                                 _BUFFER_DTYPES.get(k, torch.float32))
    return SKGSModel(cfg, rcfg, params, net, buffers, trainable=trainable,
                     **warp_nets)


def optimizer_from_flat(flat: Mapping[str, np.ndarray], model: SKGSModel,
                        optimizer: str):
    """The state of the optimizer ``optimizer`` (a name of
    ``optim.OPTIMIZERS``) in a trainer checkpoint, for the leaves ``model``
    holds, on the model's device."""
    if model_prefix(flat) != 'state/model/':
        raise KeyError('no trainer checkpoint (arrays under "state/model/")')
    leaves = {k: p.detach() for k, p in model.leaves().items()}
    template = make_optimizer(optimizer)[0]({})
    fields = {}
    for field in template._fields:
        if field == 'count':
            fields[field] = int(np.asarray(flat['state/opt/count']))
            continue
        fields[field] = {}
        for name, p in leaves.items():
            key = f'state/opt/{field}/{name}'
            if key not in flat:
                raise KeyError(f'missing optimizer array {key!r}')
            fields[field][name] = _tensor(flat[key], p.device)
    return type(template)(**fields)


def trainer_flags_from_flat(flat: Mapping[str, np.ndarray], cfg: SKGSConfig,
                            step: int, device='cuda') -> Dict:
    """``SKGSTrainer`` keyword arguments to resume a JAX trainer checkpoint
    taken after step ``step``, read as the JAX trainer's ``restore`` reads
    it (``trainer.py:1338-1372``): each of ``sp_initialized``,
    ``reinit_done`` and ``skeleton_initialized`` in ``state/flags`` or set
    by the schedule at ``step`` (a checkpoint without flags is an older
    one), and the smooth loss's KNN ``gs_knn_index``, rebuilt on ``device``
    from the checkpoint's Gaussians when it is all zeros or missing and
    ``step`` lies in ``sp_fix`` or ``sp``, unless the port wrote it (its
    ``port/gs_knn_index_own`` mark: a resumed run then keeps the KNN of an
    uninterrupted one, zeros before the schedule's first rebuild)."""
    from .framework.trainer import SKGSTrainer
    if model_prefix(flat) != 'state/model/':
        raise KeyError('no trainer checkpoint (arrays under "state/model/")')
    device = resolve_device(device)
    stage = cfg.stage_at(max(step, 1))
    saved = {k: bool(np.asarray(flat.get('state/flags/' + k, False)))
             for k in TRAINER_FLAGS}
    out = {
        'skeleton_initialized': saved['skeleton_initialized']
        or stage in ('sk_init', 'sk_fix', 'sk'),
        'sp_initialized': saved['sp_initialized']
        or step >= cfg.init_sampling_step,
        'reinit_done': saved['reinit_done']
        or 0 < cfg.stages['sp_fix'][0] <= step}
    index = flat.get('state/flags/gs_knn_index')
    own = bool(np.asarray(flat.get('state/' + KNN_OWN_KEY, False)))
    if stage in ('sp_fix', 'sp') and not own and (
            index is None or not np.any(index)):
        xyz = _tensor(flat['state/model/params/xyz'], device)
        alive = _tensor(flat['state/model/alive'], device, torch.bool)
        out['gs_knn_index'] = live_knn_index(xyz, alive,
                                             SKGSTrainer.gs_knn_num)
    elif index is not None:
        out['gs_knn_index'] = torch.as_tensor(np.asarray(index),
                                              dtype=torch.int64)
    return out


def model_to_flat(model: SKGSModel) -> Dict[str, np.ndarray]:
    """A copy of the model's leaves and buffers as numpy arrays in the JAX
    names (``params/xyz``, ``params/sk_deform/layers/0/w``, ``alive``,
    ...)."""
    out = {'params/' + k: np.array(p.detach().cpu())
           for k, p in model.leaves().items()}
    for k in AUX_BUFFERS + STAT_BUFFERS:
        out[k] = np.array(getattr(model, k).cpu())
    return out


def optimizer_to_flat(state) -> Dict[str, np.ndarray]:
    """``opt/<field>/<leaf>`` for each per-leaf field of an optimizer state
    and ``opt/count`` (int32), as the JAX state types flatten."""
    out = {f'opt/{field}/{k}': np.array(v.detach().cpu())
           for field in state._fields if field != 'count'
           for k, v in getattr(state, field).items()}
    out['opt/count'] = np.asarray(state.count, np.int32)
    return out


def jax_key(seed: int) -> np.ndarray:
    """The JAX package's ``PRNGKey(seed)`` (threefry): [seed >> 32, seed
    & 0xFFFFFFFF] uint32."""
    return np.asarray([(seed >> 32) & 0xFFFFFFFF, seed & 0xFFFFFFFF],
                      np.uint32)


def trainer_state_to_flat(model: SKGSModel, opt_state, flags: Mapping,
                          gs_knn_index: torch.Tensor,
                          generators: Mapping[str, torch.Generator],
                          seed: int) -> Dict[str, np.ndarray]:
    """A trainer's state in the layout of the JAX trainer's ``ckpt_state()``
    (``model/...``, ``opt/...``, ``flags/...``: the three stage flags,
    ``best_psnr``, ``key`` and ``gs_knn_index``, in the JAX dtypes) and the
    port's own keys (``port/...``: the state of each of ``generators``, by
    its key). ``flags/key`` is the JAX key of ``seed``: the port draws
    nothing from it."""
    out = {'model/' + k: v for k, v in model_to_flat(model).items()}
    out.update(optimizer_to_flat(opt_state))
    for k in TRAINER_FLAGS:
        out['flags/' + k] = np.asarray(bool(flags[k]))
    out['flags/best_psnr'] = np.asarray(flags['best_psnr'], np.float32)
    out['flags/key'] = jax_key(seed)
    out['flags/gs_knn_index'] = np.array(gs_knn_index.cpu(), np.int32)
    for key, gen in generators.items():
        out[key] = gen.get_state().numpy().copy()
    out[KNN_OWN_KEY] = np.asarray(True)
    return out


def skeleton_net_from_flat(flat: Mapping[str, np.ndarray],
                           cfg: SkeletonNetConfig, prefix: str,
                           device='cuda') -> MLP:
    """The skeleton net whose leaves sit under ``prefix`` (``.../layers/0/w``,
    ``.../heads/2/b``, ...), shapes checked against ``cfg``."""
    device = resolve_device(device)
    return _load_net(skeleton_net(cfg, device), flat, prefix, device)


def deform_net_from_flat(flat: Mapping[str, np.ndarray], cfg: DeformNetConfig,
                         prefix: str, device='cuda') -> DeformNet:
    """The warp net whose leaves sit under ``prefix`` (``.../timenet/0/w``,
    ``.../trunk/3/b``, ``.../warp/w``, ...), shapes checked against
    ``cfg``."""
    device = resolve_device(device)
    return _load_net(DeformNet(cfg, device), flat, prefix, device)


def _load_net(net: nn.Module, flat: Mapping[str, np.ndarray], prefix: str,
              device) -> nn.Module:
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
