"""From a config dict to the objects a run needs: the scene, the model and
raster configs, the initial point cloud, the sampler, and the trainer's
settings (port of ``build_scene``, ``build_model_cfg`` and the set-up of
``main`` in the JAX package's ``train.py``).

The YAML keys map one to one onto the same fields as in the JAX package.
``raster.use_pallas`` becomes ``RasterConfig.use_kernel``: 'auto' (and
true) is the kernel on CUDA tensors and the plain version on CPU tensors,
false the plain version everywhere.

``train.precision`` bf16 (or bfloat16) computes the warp and skeleton nets
in bfloat16 (``compute_dtype``), as the JAX package's ``train.py`` does;
``train.optimizer``, ``train.batch_views`` and a ``train.parallel`` mesh
go to the trainer (a mesh to ``parallel.trainer.MeshTrainer``).
``train.capacity_buckets``
(recompile-driven capacity buckets, a TPU choice) is logged and ignored:
a bucketed run and a padded one compute the same function.
"""
from __future__ import annotations

import logging
from typing import Any, Dict, Tuple

import numpy as np
import torch.distributed as dist

from ..data.colmap import load_colmap
from ..data.dnerf import load_dnerf
from ..data.sampler import make_sampler
from ..data.synthetic import make_synthetic_scene
from ..data.wim import load_wim
from ..data.zju import load_zju, load_zju_pickled
from ..models.deform import DeformNetConfig, SkeletonNetConfig
from ..models.gaussian_splatting import GaussianConfig
from ..models.sk_gs import SKGSConfig
from ..parallel.mesh import make_mesh
from ..render.settings import RasterConfig

log = logging.getLogger(__name__)

GAUSS_INTERVAL_KEYS = ('densify_interval', 'prune_interval',
                       'opacity_reset_interval', 'init_densify_prune_interval',
                       'init_opacity_reset_interval')
GAUSS_FLOAT_KEYS = ('densify_grad_threshold', 'densify_percent_dense',
                    'prune_opacity_threshold', 'prune_max_screen_size',
                    'prune_percent_dense')
SK_INTERVAL_KEYS = ('sp_adjust_interval', 'sp_merge_interval')


def build_scene(cfg: Dict[str, Any], device='cuda'):
    """(scene, meta, eval_scene, pcd) of ``cfg['dataset']`` on ``device``
    (``train.py:build_scene``): the synthetic scene (rendered on
    ``device``, its frames cached under ``dataset.root``) and COLMAP are
    evaluated on their train split, the others on their test split, or on
    the train split when it has no file; pcd is COLMAP's point cloud, else
    None."""
    d = cfg['dataset']
    kind = d.get('kind', 'synthetic')
    if kind == 'synthetic':
        hw = int(d.get('image_size', 64))
        # the ground truth renders the chain's Gaussians only: a small pair
        # budget, as in train.py
        gt_pairs = int(d.get('gt_pair_capacity',
                             min(int(cfg['raster']['pair_capacity']),
                                 2 ** 17)))
        scene, meta, _gt = make_synthetic_scene(
            seed=int(cfg['train'].get('seed', 0)),
            num_links=int(d.get('num_links', 3)),
            gauss_per_link=int(d.get('gauss_per_link', 120)),
            num_frames=int(d.get('num_frames', 24)),
            h=hw, w=hw, background=d.get('background', 'white'),
            detail=bool(d.get('detail', False)), pair_capacity=gt_pairs,
            chunk=int(cfg['raster']['chunk']), cache_dir=d.get('root'),
            device=device)
        return scene, meta, scene, None
    ds = float(d.get('downscale', 1))
    bg = d.get('background', 'white')
    if kind == 'colmap':
        scene, meta, pts, cols = load_colmap(
            d['root'], images_dir=d.get('images_dir', 'images'),
            downscale=ds, background=bg, device=device)
        return scene, meta, scene, (pts, cols)
    if kind == 'dnerf':
        load = lambda split: load_dnerf(d['root'], d['scene'], split,
                                        downscale=ds, background=bg,
                                        device=device)
        splits = ('train', 'val')
    elif kind == 'wim':
        fr = tuple(d.get('frame_ranges', (0, 50)))
        load = lambda split: load_wim(d['root'], d['scene'], split,
                                      downscale=ds, background=bg,
                                      frame_ranges=fr, device=device)
        splits = ('train', 'test')
    elif kind == 'zju_pickled':
        load = lambda pickle: load_zju_pickled(
            d['root'], str(d['scene']), pickle_path=pickle,
            frame_ranges=tuple(d.get('frame_ranges', (-1, -1))),
            image_size=int(d.get('image_size', 512)),
            compression=bool(d.get('compression', True)), background=bg,
            device=device)
        splits = (d.get('pickle_path', 'cache_train.pickle'),
                  d.get('eval_pickle_path', 'cache_test.pickle'))
    elif kind == 'zju':
        load = lambda split: load_zju(d['root'], str(d['scene']), split,
                                      downscale=int(ds), background=bg,
                                      device=device)
        splits = ('train', 'test')
    else:
        raise NotImplementedError(f'dataset kind {kind}')
    scene, meta = load(splits[0])
    try:
        eval_scene, _ = load(splits[1])
    except FileNotFoundError:
        eval_scene = scene
    return scene, meta, eval_scene, None


def use_kernel(cfg: Dict[str, Any]) -> bool:
    setting = cfg['raster'].get('use_pallas', 'auto')
    return True if setting == 'auto' else bool(setting)


def build_model_cfg(cfg: Dict[str, Any], meta, image_size: Tuple[int, int]
                    ) -> Tuple[SKGSConfig, RasterConfig]:
    """(SKGSConfig, RasterConfig) of ``cfg``, field for field as the JAX
    package's ``train.build_model_cfg``; ``meta.num_frames`` sets the frame
    count, ``image_size`` = (W, H)."""
    m = cfg['model']
    sched = tuple((k, int(v)) for k, v in cfg['train_schedule'].items())
    ac = dict(cfg.get('adaptive_control', {}))
    gauss_ac = {k: tuple(int(v) for v in ac.pop(k))
                for k in GAUSS_INTERVAL_KEYS if k in ac}
    gauss_ac.update({k: float(ac.pop(k)) for k in GAUSS_FLOAT_KEYS
                     if k in ac})
    sk_ac = {k: tuple(int(v) for v in ac.pop(k))
             for k in SK_INTERVAL_KEYS if k in ac}
    if ac:
        raise KeyError(f'unknown adaptive_control keys: {sorted(ac)}')
    precision = str(cfg['train'].get('precision', 'f32'))
    cdt = 'bfloat16' if precision in ('bf16', 'bfloat16') else 'float32'
    net_cfg = m['net']
    depth = int(net_cfg.get('depth', 8))
    width = int(net_cfg.get('width', 256))
    net = DeformNetConfig(
        depth=depth, width=width,
        pos_degree=int(net_cfg.get('pos_degree', 10)),
        t_degree=int(net_cfg.get('t_degree', 6)),
        is_blender=bool(m.get('is_blender', True)),
        sep_rot=bool(m.get('sep_rot', False)), compute_dtype=cdt)
    which_rotation = str(m.get('which_rotation', 'quaternion'))
    r_dim = {'lie': 3, 'quaternion': 4}[which_rotation]
    sk_feature_dim = int(m.get('sk_feature_dim', 0))
    skcfg = SKGSConfig(
        gauss=GaussianConfig(capacity=int(m['capacity']),
                             sh_degree=int(m['sh_degree']),
                             lr=float(cfg['train'].get('lr', 1e-3)),
                             **gauss_ac),
        net=net,
        sk_net=SkeletonNetConfig(
            out_dims=(r_dim, 4, 3), width=width, depth=depth,
            skips=(max(1, depth // 2),), p_in_channels=3 + sk_feature_dim,
            compute_dtype=cdt),
        which_rotation=which_rotation,
        sk_feature_dim=sk_feature_dim,
        train_schedule=sched,
        num_superpoints=int(m['num_superpoints']),
        num_knn=int(m['num_knn']),
        hyper_dim=int(m['hyper_dim']),
        LBS_method=m.get('LBS_method', 'W'),
        warp_method=m.get('warp_method', 'LBS'),
        sep_rot=bool(m.get('sep_rot', False)),
        num_frames=int(meta.num_frames),
        canonical_time_id=int(m.get('canonical_time_id', 0)),
        use_canonical_net=bool(m.get('use_canonical_net', True)),
        canonical_replace_steps=tuple(m.get('canonical_replace_steps', ())),
        sk_knn_num=int(m.get('sk_knn_num', 6)),
        sk_momentum=float(m.get('sk_momentum', 0.9)),
        joint_update_interval=tuple(m.get('joint_update_interval',
                                          (1000, 20000, 40000))),
        joint_init_steps=int(m.get('joint_init_steps', 10000)),
        init_num_times=int(m.get('init_num_times', 16)),
        init_sampling_step=int(m.get('init_sampling_step', 7500)),
        sp_prune_threshold=float(m.get('sp_prune_threshold', 1e-3)),
        sp_split_threshold=float(m.get('sp_split_threshold', 2e-4)),
        sp_merge_threshold=float(m.get('sp_merge_threshold', 5e-4)),
        guided_step_start=int(m.get('guided_step_start', 40000)),
        test_time_interpolate=bool(m.get('test_time_interpolate', False)),
        lr_deform_scale=float(m.get('lr_deform_scale', 1.0)),
        lr_feature_scale=float(m.get('lr_feature_scale', 2.5)),
        lr_deform_max_steps=int(m.get('lr_deform_max_steps', 40000)),
        lr_joints=float(m.get('lr_joints', 0.1)),
        **sk_ac)
    w, h = image_size
    r = cfg['raster']
    rcfg = RasterConfig(image_width=w, image_height=h,
                        sh_degree=int(m['sh_degree']),
                        pair_capacity=int(r['pair_capacity']),
                        chunk=int(r['chunk']), tile_h=int(r.get('tile_h', 16)),
                        use_kernel=use_kernel(cfg))
    return skcfg, rcfg


def initial_point_cloud(cfg: Dict[str, Any], ds_pcd=None
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """(points [n, 3], colours [n, 3]) float32 of the first Gaussians: the
    ``init_ply`` file, else the dataset's point cloud, else
    ``num_init_points`` uniform in [-1.3, 1.3]^3 (colours in [0, 1]) from
    ``np.random.default_rng(seed)``."""
    init_ply = cfg['train'].get('init_ply') or cfg['dataset'].get('init_ply')
    if init_ply:
        from ..utils.ply import load_point_ply
        pts, cols = load_point_ply(init_ply)
        log.info('init point cloud from %s (%d points)', init_ply, len(pts))
        return pts, cols
    if ds_pcd is not None:
        log.info('init point cloud from the dataset (%d points)',
                 len(ds_pcd[0]))
        return ds_pcd
    rng = np.random.default_rng(int(cfg['train'].get('seed', 0)))
    n0 = int(cfg['train'].get('num_init_points', 2000))
    pts = rng.uniform(-1.3, 1.3, size=(n0, 3)).astype(np.float32)
    cols = rng.uniform(size=(n0, 3)).astype(np.float32)
    return pts, cols


def build_sampler(cfg: Dict[str, Any], scene, skcfg: SKGSConfig):
    """The view sampler ``train.sampler`` names (a kind, or a dict with
    'kind' and its keyword arguments)."""
    samp = cfg['train'].get('sampler', 'uniform')
    if isinstance(samp, str):
        kind, kw = samp, {}
    else:
        kw = dict(samp)
        kind = kw.pop('kind', 'uniform')
    time_ids = scene.time_ids.cpu().numpy()
    return make_sampler(kind, scene.num_views,
                        times=scene.times.cpu().numpy(),
                        canonical_ids=np.flatnonzero(
                            time_ids == skcfg.canonical_time_id),
                        total_steps=skcfg.total_steps,
                        seed=int(cfg['train'].get('seed', 0)), **kw)


def trainer_options(cfg: Dict[str, Any]) -> Dict[str, Any]:
    """The trainer's keyword arguments of ``cfg['train']`` (seed,
    gradient clipping, views a step, optimizer, and ``MeshTrainer``'s
    device mesh of ``train.parallel: {n_view, n_gs}`` when it has more than
    one rank: the process group must hold n_view x n_gs processes, as many
    as a launch gives); logs that capacity buckets are not carried."""
    t = cfg['train']
    par = t.get('parallel') or {}
    n_view, n_gs = int(par.get('n_view', 1)), int(par.get('n_gs', 1))
    if bool(t.get('capacity_buckets', False)):
        log.info('train.capacity_buckets: the port keeps the full capacity '
                 '(the buckets are a TPU recompile choice; same function)')
    opts = {'seed': int(t.get('seed', 0)),
            'clip_norm': float(t.get('clip_norm', 0.0)),
            'batch_views': int(t.get('batch_views', 1)),
            'optimizer': t.get('optimizer', 'adam')}
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != n_view * n_gs:
        raise ValueError(
            f'train.parallel {n_view}x{n_gs} needs {n_view * n_gs} '
            f'processes (torchrun --nproc_per_node {n_view * n_gs}); this '
            f'run has {world}')
    if n_view * n_gs > 1:
        opts['mesh'] = make_mesh(n_view, n_gs)
    return opts
