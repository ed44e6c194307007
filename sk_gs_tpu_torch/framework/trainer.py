"""SK-GS training, the ``static``, ``init``, ``sp``, ``sk_init`` and ``sk``
families (port of ``sk_gs_tpu/framework/trainer.py:SKGSTrainer`` for every
stage of the schedule).

One step (``train_step``, ``trainer.py:1376-1436``) runs the stage events
due before it, rebuilds the smooth loss's Gaussian KNN on its interval
(``sp`` steps), samples ``batch_views`` views with the step-keyed sampler,
runs the step body (``_core``, single device: ``trainer.py:595-984``), updates
the joint tree on its interval (``sp`` steps), and then runs the adaptive
control due after it. The body: the stage's deltas (none for ``static``;
the ``sp_deform`` warp net for the ``init`` family, detached in
``init_fix``; the superpoint LBS warp for the ``sp`` family, its deltas
detached in ``sp_fix``; the skeleton warp at the view's own train frame for
the ``sk_init`` and ``sk`` families), activations (the ``init`` family
renders every Gaussian at the live mean of the log-scales), a render whose
blend goes
through ``TileBlend`` or ``ChunkBlend`` (the hand-written kernels on the
card) by ``RasterConfig.schedule``, l1 (or mse) and SSIM image losses; for
the ``sp`` family the LBS weights' sparsity and smoothness, the joint
costs, the superpoint regularizers (``re_pos``, ``jp_dist``, ``sp_arap_t``,
``sp_arap_ct``) and the guided skeleton losses; for ``sk_init`` the image
losses and the colours and opacities detached, and the skeleton's deltas
held to the frozen LBS blend of the cached superpoint motion (``cmp_t``,
``cmp_r``, ``cmp_s``); the point ARAP ``arap_p`` (``init`` family); the
motion regularizers ``elastic``, ``acc`` and ``arap`` on the warp net's
trajectories of the superpoints (``sp``) or of ``num_superpoints`` random
live Gaussians (``init``); the canonical-net consistency ``c_net``
(``init`` and ``sp``); ``backward``. Each loss is computed only when its
weight is ever non-zero, as the JAX step builds it. With ``batch_views`` K
> 1 the body runs K forwards and backwards, each on its own view,
background and time noise, and divides the summed loss, parameter
gradients and means2d gradient by K (``trainer.py:866-893``). Then, once:
non-finite gradient entries zeroed and counted (``n_bad_grad``), the
optimizer (``optimizer``: 'adam', 'adamw', 'sgd' or 'adan', per-leaf
learning rates), the densification statistics of the K views (any seen,
max radius, summed count), the per-frame cache rows of the K frames
(``sp_cache`` or ``sk_cache``), the ``p2sp`` assignment of the last view
('largest') and the joint cost's running mean of the mean of the K costs;
the metrics are means over the K views (max / any for the counts).

Stage events (``maybe_stage_events``, ``trainer.py:1061-1155``): the
superpoint initialisation before ``init_sampling_step``, the restart from
the point cloud ``pcd`` before ``stages['sp_fix'][0]`` (skipped without
one, as in the JAX trainer), and the canonical-net replacement before each
of ``canonical_replace_steps``, and the skeleton initialisation before the
first ``sk_init`` / ``sk_fix`` / ``sk`` step; each fires once, when its
flag is unset. A trainer built at a later step takes the flags
(``convert.trainer_flags_from_flat`` reads them from a JAX checkpoint).

Adaptive control (``maybe_adaptive_control``, ``trainer.py:1165-1214``):
the ``static`` and ``init`` stages densify and prune every
``init_densify_prune_interval`` steps and reset the opacity every
``init_opacity_reset_interval`` steps, before ``init_sampling_step``; the
``sp`` family prunes / splits and merges superpoints (``sp`` only),
densifies and prunes, and resets the opacity, on the stage-relative
intervals. The split noise comes from a CPU ``torch.Generator`` seeded
with ``seed`` (so the card and the CPU draw the same numbers; the JAX key
stream is not matched). The ``sk`` family has none
(``trainer.py:1188-1189``).

Checkpoints (``ckpt_state``, ``restore``, ``trainer.py:1319-1372``): the
trainer's whole state in the JAX trainer's layout, and back; a resumed run
takes the steps an uninterrupted one takes. ``snapshot_fn(name)``, when
set, is called with 'init.npz' after the restart from the point cloud and
with 'sk_init.npz' after the skeleton initialisation. ``evaluate`` scores a
split (``framework.evaluate.split_metrics``).

Random draws come from the trainer's generators, on the training device
(no host sync) and carried in the checkpoint: ``time_gen``, the standard
normal time noise of a net that is not ``is_blender`` (``init`` and ``sp``
families, one draw a view: ``sk_gs.noisy_time``; ``draw_time_noise``);
``reg_gen``, the uniforms of the motion regularizers, drawn once a step and
shared by its views as the JAX step shares its key (the init family's
random live rows, the times of ``elastic`` and ``arap``:
``regularizer_draws``).

The trainer is one process on one device. What a device mesh changes in
the step is the methods under 'seams', here the one-device code;
``parallel.trainer.MeshTrainer`` overrides them.

RGBA targets (the background types of ``data.base.DYNAMIC_BG``): each step
composites the target and the render over one background
(``data.base.sample_background``: a uniform colour a pixel or one uniform
colour drawn from ``bg_gen``, a generator on the training device seeded
with ``seed``; the target's own RGB; the checkerboard), as the JAX step
does with its key (``trainer.py:626-640, 704-705``); the evaluation
composites them over ``bg``, white or black (the board for 'checker').
"""
from __future__ import annotations

import logging
from typing import Callable, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from .. import convert, resolve_device
from ..data.base import Scene, SceneMeta, sample_background
from ..data.sampler import UniformSampler
from ..models.gaussian_splatting import (densify_and_prune, expon_lr,
                                         gaussian_inputs, ndc_grad_norm,
                                         reset_opacity)
from ..models import regularizers as reg
from ..models import sk_gs_ops
from ..models.deform import deform_net_apply, skeleton_net_apply
from ..models.losses import (LossWeights, l1_loss, masked_mean, mse_loss,
                             psnr, ssim_loss)
from ..models.optim import make_optimizer
from ..models.sk_gs import (DEFORM_NETS, SK_STAGES, SKGSConfig, SKGSModel,
                            forward_deltas, init_stage, skeleton_net_input,
                            sk_rot_activation, smooth_scale, sp_stage,
                            split_sp_cache, take_frame)
from ..models.superpoints import (blend_attr, calc_lbs_weight,
                                  dense_lbs_rows, get_superpoint_features,
                                  masked_knn, warp_blend_dense, warp_points)
from ..models.skeleton import (joint_cost_matrix, kinematic_transforms,
                               update_joint)
from ..ops import se3
from ..ops.knn import knn, live_knn_index
from ..render.render import composite_background, render
from ..render.settings import GaussianInputs, RasterConfig
from ..utils.tracing import host_read, span
from .evaluate import render_eval, split_metrics

log = logging.getLogger(__name__)

FAMILY = {'static': 'static', 'init_fix': 'init', 'init': 'init',
          'sp_fix': 'sp', 'sp': 'sp', 'sk_init': 'sk_init', 'sk_fix': 'sk',
          'sk': 'sk'}
# the iterations of each of the skeleton initialisation's two loops are
# min(joint_init_steps, this) (trainer.py:1115-1116)
INIT_SKELETON_MAX_STEPS = 2000
# the JAX trainer's default loss weights (trainer.py:247-251)
DEFAULT_LOSS = {'image': {'method': 'l1', 'lambda': 0.8}, 'ssim': 0.2,
                'sparse': 0.1, 'smooth': 0.1, 'joint': 1.0,
                'joint_all': 1.0, 'c_net': 1.0, 'cmp_p': 1.0, 'cmp_t': 0.01,
                'cmp_r': 0.01, 'cmp_s': 0.01}
# losses gated to 0 before joint_update_interval[1] (trainer.py:1395-1401)
JOINT_LOSSES = ('joint', 'joint_all', 'jp_dist')
# the motion regularizers of the init and sp families (trainer.py:508-556)
MOTION_LOSSES = ('elastic', 'acc', 'arap')
# the sp family's superpoint regularizers (trainer.py:429-472)
SP_EXTRA_LOSSES = ('re_pos', 'jp_dist', 'sp_arap_t', 'sp_arap_ct')
# the time samples of elastic and arap, and the neighbours of arap's graph
ELASTIC_SAMPLES = 8
ARAP_SAMPLES = 2
ARAP_KNN = 10


def smooth_loss(w: torch.Tensor, index: torch.Tensor, alive: torch.Tensor,
                table: Optional[torch.Tensor] = None,
                mean=masked_mean) -> torch.Tensor:
    """The mean (``mean``) of |w_i - w_j| over each live row i of the LBS
    weights ``w`` [N, K] and its neighbours j in ``index`` [N, k] (the
    ``smooth`` loss), the neighbours' rows taken from ``table`` (``w``
    itself by default; on a mesh's ``gs`` axis the gathered weights of
    every rank, of which ``w`` is this rank's slice). The rows are
    gathered by ``index_select``, whose backward is one ``index_add_``; an
    advanced index's backward sorts the indices and sums equal ones one
    after another, which on the all-zero index before the first rebuild is
    one serial sum of N k rows."""
    table = w if table is None else table
    n, k = index.shape
    nb = table.index_select(0, index.reshape(-1)).view(n, k, w.shape[-1])
    return mean(torch.abs(w[:, None] - nb), alive[:, None, None])


def check_interval_v2(step: int, interval: int, start: int, end: int,
                      close: str = '()') -> bool:
    """(every, start, end) interval logic (``trainer.py:55-63``); end < 0
    means no end."""
    if interval is None or interval <= 0:
        return False
    lo_ok = step >= start if close[0] == '[' else step > start
    hi_ok = True if end < 0 else (step <= end if close[1] == ']'
                                  else step < end)
    return lo_ok and hi_ok and (step - start) % interval == 0


class SKGSTrainer:
    """Host-side loop over ``train_step(step)`` for the ``static``,
    ``init``, ``sp`` and ``sk`` families.

    ``model`` must be trainable (``convert.model_from_flat(...,
    trainable=True)`` or ``sk_gs.init_model``); it and ``scene`` are moved
    to ``device`` (CUDA unless asked otherwise). ``optimizer`` names an
    entry of ``optim.OPTIMIZERS``; ``opt_state`` resumes its state
    (``convert.optimizer_from_flat``), fresh otherwise. ``batch_views``
    views are averaged a step. ``pcd`` =
    (points, colours) is the point cloud of the restart before ``sp_fix``.
    The flags ``sp_initialized``, ``reinit_done`` and
    ``skeleton_initialized`` mean what the JAX trainer's do: a trainer
    built inside or past a stage event's step passes them set.
    ``gs_knn_index`` [N, gs_knn_num] is the smooth loss's Gaussian KNN
    (zeros until the first rebuild, as in the JAX trainer), rebuilt on
    ``sp`` steps every ``gs_knn_update_interval`` = (every, after) steps
    and at step 1. ``last_event`` holds the counts of the events after the
    last step. ``eval_scene`` is the split ``evaluate`` scores (the train
    split when None); ``best_psnr`` is the best eval PSNR a caller has
    recorded, kept in the checkpoint.
    """

    # the smooth loss's KNN: neighbours of a Gaussian, and the rebuild
    # interval (the JAX trainer's defaults, trainer.py:195-196)
    gs_knn_num = 20
    gs_knn_update_interval = (1000, 3000)

    def __init__(self, cfg: SKGSConfig, rcfg: RasterConfig, scene: Scene,
                 meta: SceneMeta, model: SKGSModel,
                 loss_weights: Optional[LossWeights] = None, sampler=None,
                 seed: int = 0, clip_norm: float = 0.0,
                 batch_views: int = 1, optimizer: str = 'adam',
                 opt_state=None,
                 pcd: Optional[Tuple[np.ndarray, np.ndarray]] = None,
                 gs_knn_index: Optional[torch.Tensor] = None,
                 sp_initialized: bool = False, reinit_done: bool = False,
                 skeleton_initialized: bool = False,
                 eval_scene: Optional[Scene] = None, device='cuda'):
        if batch_views < 1:
            raise ValueError(f'batch_views {batch_views} < 1')
        self.opt_init, self.opt_update = make_optimizer(optimizer)
        self.optimizer = optimizer
        self.batch_views = batch_views
        self.device = resolve_device(device)
        self.cfg = cfg
        self.rcfg = rcfg
        self.model = model.to(self.device)
        leaves = self.model.leaves()
        if not all(p.requires_grad for p in leaves.values()):
            raise ValueError('the model is frozen: build it with '
                             'convert.model_from_flat(..., trainable=True)')
        self.scene = scene.to(self.device)
        self.eval_scene = None if eval_scene is None else \
            eval_scene.to(self.device)
        self.meta = meta
        self.loss_w = loss_weights or LossWeights(DEFAULT_LOSS)
        self.sampler = sampler or UniformSampler(scene.num_views, seed)
        self.clip_norm = clip_norm
        self.opt_state = opt_state or self.opt_init(
            {k: p.detach() for k, p in leaves.items()})
        self.seed = seed
        self.noise_gen = torch.Generator().manual_seed(seed)
        bg = meta.background
        if bg is None:
            bg = np.ones(3, np.float32) if meta.background_type == 'white' \
                else np.zeros(3, np.float32)
        self.bg = torch.as_tensor(bg, dtype=torch.float32).to(self.device)
        # the backgrounds of RGBA targets, the time noise and the
        # regularizers' uniforms, drawn on the device
        self.bg_gen = torch.Generator(self.device).manual_seed(seed)
        self.time_gen = torch.Generator(self.device).manual_seed(seed + 1)
        self.reg_gen = torch.Generator(self.device).manual_seed(seed + 2)
        self.step = 0
        self.best_psnr = -1.0
        self.snapshot_fn: Optional[Callable[[str], None]] = None
        self.last_event: Dict[str, torch.Tensor] = {}
        self.pcd = pcd
        self.sp_initialized = sp_initialized
        self.reinit_done = reinit_done
        self.skeleton_initialized = skeleton_initialized
        n = self.model.alive.shape[0]
        self.gs_knn_index = (
            torch.zeros((n, self.gs_knn_num), dtype=torch.int64,
                        device=self.device)
            if gs_knn_index is None else
            torch.as_tensor(gs_knn_index, dtype=torch.int64).to(self.device))

    # ------------------------------------------------------------ checkpoint

    def ckpt_state(self) -> Dict[str, np.ndarray]:
        """A copy of the whole state as numpy arrays in the layout of the
        JAX trainer's ``ckpt_state()`` (``model/...``, ``opt/...``,
        ``flags/...``), plus the port's generators (``port/...``)."""
        flags = {'skeleton_initialized': self.skeleton_initialized,
                 'sp_initialized': self.sp_initialized,
                 'reinit_done': self.reinit_done,
                 'best_psnr': self.best_psnr}
        return convert.trainer_state_to_flat(
            self.model, self.opt_state, flags, self.gs_knn_index,
            self.generators(), self.seed)

    def generators(self) -> Dict[str, torch.Generator]:
        """The trainer's generators by their checkpoint keys."""
        return {convert.NOISE_GEN_KEY: self.noise_gen,
                convert.BG_GEN_KEY: self.bg_gen,
                convert.TIME_GEN_KEY: self.time_gen,
                convert.REG_GEN_KEY: self.reg_gen}

    def restore(self, flat: Mapping[str, np.ndarray], step: int):
        """Resume from a checkpoint's arrays (``framework.checkpoint.load``;
        written by either package) taken after step ``step``, as the JAX
        trainer's ``restore`` does: the model at the checkpoint's capacity,
        the optimizer's state (fresh when the checkpoint has none), the
        stage flags OR-ed with what the schedule implies at ``step``,
        ``best_psnr``, and the smooth loss's KNN (rebuilt when a JAX
        checkpoint's is all zeros inside ``sp_fix`` / ``sp``:
        ``convert.trainer_flags_from_flat``); the port's generators when
        the checkpoint has them."""
        self.model = convert.model_from_flat(flat, self.cfg, self.rcfg,
                                             self.device, trainable=True)
        leaves = {k: p.detach() for k, p in self.model.leaves().items()}
        self.opt_state = convert.optimizer_from_flat(
            flat, self.model, self.optimizer) \
            if 'state/opt/count' in flat else self.opt_init(leaves)
        kw = convert.trainer_flags_from_flat(flat, self.cfg, step,
                                             self.device)
        for k in convert.TRAINER_FLAGS:
            setattr(self, k, kw[k])
        n = self.model.alive.shape[0]
        index = kw.get('gs_knn_index')
        self.gs_knn_index = torch.zeros(
            (n, self.gs_knn_num), dtype=torch.int64, device=self.device) \
            if index is None else index.to(self.device, torch.int64)
        if 'state/flags/best_psnr' in flat:
            self.best_psnr = float(flat['state/flags/best_psnr'])
        for key, gen in self.generators().items():
            state = flat.get('state/' + key)
            if state is None:
                continue
            if state.shape != tuple(gen.get_state().shape):
                # a generator of the other device type (a card run resumed
                # on the CPU, or back): its stream restarts from the seed
                log.info('%s: the checkpoint holds another device type\'s '
                         'generator; drawing from the seed again', key)
                continue
            gen.set_state(torch.from_numpy(np.array(state)))
        self.step = step

    # ------------------------------------------------------------ eval

    def evaluate(self, scene: Optional[Scene] = None,
                 stage: Optional[str] = None,
                 full_metrics: bool = False) -> Dict:
        """The metrics of ``scene`` (the eval split, else the train split)
        at ``stage`` (the current step's): PSNR and SSIM, or with
        ``full_metrics`` the six columns and their post-processing
        (``trainer.py:1436-1491``)."""
        scene = scene or self.eval_scene or self.scene
        stage = stage or self.cfg.stage_at(max(self.step, 1))
        return split_metrics(self.model, scene, self.bg, stage, full_metrics,
                             self.rcfg)

    def render_view(self, scene: Scene, i: int, stage: str) -> torch.Tensor:
        """View ``i`` of ``scene`` at its time, composited: [H, W, 3]."""
        return render_eval(self.model, scene.view(i), scene.times[i],
                           self.bg, stage, self.rcfg)['image']

    # ------------------------------------------------------------ lr

    def stage_rel_step(self, step: int) -> int:
        stages = self.cfg.stages
        if step <= stages['sp_fix'][0]:
            return step
        if step <= stages['sp'][1]:
            return step - stages['sp_fix'][0]
        return step - stages['sk_init'][0]

    def lr_trees(self, step: int) -> Dict[str, float]:
        """Per-leaf learning rates, host floats (``trainer.py:288-331``):
        stage-relative decays for ``xyz`` and the nets, ``joints`` at
        ``lr_joints`` of the deform base, ``global_tr`` frozen (0)."""
        cfg = self.cfg
        g = cfg.gauss
        s = self.stage_rel_step(step)
        spatial = 5.0
        lr = g.lr
        xyz_lr = expon_lr(s, lr * g.lr_position_init * spatial,
                          lr * g.lr_position_final * spatial,
                          lr_delay_mult=g.lr_position_delay_mult,
                          max_steps=g.lr_position_max_steps)
        deform_base = cfg.lr_deform_scale * lr * spatial * g.lr_position_init
        deform_lr = expon_lr(s, deform_base,
                             lr * g.lr_position_final * cfg.lr_deform_scale,
                             lr_delay_mult=g.lr_position_delay_mult,
                             max_steps=cfg.lr_deform_max_steps)
        lr_f = lr * cfg.lr_feature_scale
        flat = {
            'xyz': xyz_lr, 'f_dc': lr * g.lr_feature,
            'f_rest': lr * g.lr_feature / 20.0,
            'opacity': lr * g.lr_opacity, 'scaling': lr * g.lr_scaling,
            'rotation': lr * g.lr_rotation,
            'hyper': lr_f, 'sp_hyper': lr_f,
            'sp_points': deform_base, 'sp_W': deform_base,
            'sp_radius': deform_base, 'sp_weight': deform_base,
            'joint_pos': deform_base, 'global_tr': 0.0,
            'joints': deform_base * cfg.lr_joints,
            'sk_feature': lr,
        }
        nets = ('sk_deform',) + DEFORM_NETS
        return {name: deform_lr if name.split('/')[0] in nets
                else flat.get(name, 0.0) for name in self.model.leaves()}

    # ------------------------------------------------------------ step

    def update_sh_degree(self, step: int):
        """The SH degree grows by one every 1000 steps after sp_fix starts."""
        sp_fix_start = self.cfg.stages['sp_fix'][0]
        m = self.model
        if (step > sp_fix_start and (step - sp_fix_start) % 1000 == 0
                and int(host_read(m.active_sh_degree))
                < self.cfg.gauss.sh_degree):
            m.active_sh_degree.add_(1)

    def family(self, stage: str) -> str:
        """The step family of ``stage``."""
        return FAMILY[stage]

    def maybe_stage_events(self, step: int):
        """The stage events due before step ``step`` (``trainer.py:
        1061-1108``), each once: the superpoint initialisation at
        ``init_sampling_step``, the restart from the point cloud at
        ``stages['sp_fix'][0]`` (the last ``init`` step; none without
        ``pcd``), the canonical-net replacement at each of
        ``canonical_replace_steps`` after ``sp_fix`` starts, the skeleton
        initialisation before the first sk-family step (``_init_skeleton``).
        ``snapshot_fn`` takes 'init.npz' after the restart and 'sk_init.npz'
        after the skeleton initialisation. Returns the names of the events
        that ran."""
        cfg = self.cfg
        stages = cfg.stages
        has_sp = stages['sp_fix'][2] > 0 or stages['sp'][2] > 0
        fired = []
        if (not self.sp_initialized and step == cfg.init_sampling_step
                and has_sp):
            self._init_superpoints()
            self.sp_initialized = True
            fired.append('init_superpoints')
        if (not self.reinit_done and step == stages['sp_fix'][0] and has_sp
                and stages['sp_fix'][0] > 0 and self.pcd is not None):
            self._reinit_from_pcd()
            self.reinit_done = True
            fired.append('reinit_from_pcd')
            if self.snapshot_fn is not None:
                self.snapshot_fn('init.npz')
        if (cfg.use_canonical_net and self.model.canonical is not None
                and step > stages['sp_fix'][0]
                and step in cfg.canonical_replace_steps):
            self._canonical_replace()
            fired.append('canonical_replace')
        if cfg.stage_at(step) in SK_STAGES and not self.skeleton_initialized:
            self._init_skeleton()
            self.skeleton_initialized = True
            fired.append('init_skeleton')
            if self.snapshot_fn is not None:
                self.snapshot_fn('sk_init.npz')
        return fired

    def _init_skeleton(self) -> Dict[str, torch.Tensor]:
        """``sk_gs_ops.init_skeleton`` with min(``joint_init_steps``,
        ``INIT_SKELETON_MAX_STEPS``) iterations in each loop, their frames
        drawn from the trainer's CPU generator (joint loop first) and
        uploaded once; then the non-finite check of ``joints``,
        ``global_tr`` and the skeleton net (``trainer.py:1119-1130``). The
        Adam state of the trainer is kept. Returns the loops' losses."""
        cfg, model = self.cfg, self.model
        n = min(cfg.joint_init_steps, INIT_SKELETON_MAX_STEPS)
        tids = torch.randint(0, model.sp_cache.shape[0], (2, n),
                             generator=self.noise_gen).to(self.device)
        out = sk_gs_ops.init_skeleton(cfg, model, tids[0], tids[1])
        checked = {'joints': [model.params['joints']],
                   'global_tr': [model.params['global_tr']],
                   'sk_deform': list(model.sk_deform.parameters())}
        for name, leaves in checked.items():
            bad = int(host_read(sum((~torch.isfinite(x)).sum()
                                     for x in leaves)))
            if bad:
                raise FloatingPointError(
                    f"init_skeleton produced {bad} non-finite values in "
                    f"params['{name}']: the sk stages would train on a "
                    "broken skeleton")
        return out

    def _init_superpoints(self) -> torch.Tensor:
        """The FPS picks [M] of the superpoint initialisation."""
        return sk_gs_ops.init_superpoints(self.cfg, self.model,
                                          self.opt_state)

    def _reinit_from_pcd(self):
        sk_gs_ops.reinit_gaussians_at_sp_fix(self.cfg, self.model,
                                             self.opt_state, *self.pcd)

    @torch.no_grad()
    def _canonical_replace(self):
        """Move the Gaussians and the superpoints to the canonical frame and
        make ``sp_deform`` a copy of the ``canonical`` net (its own storage:
        the in-place Adam must not move both)."""
        cfg, model = self.cfg, self.model
        params = model.params
        tc = model.train_times[cfg.canonical_time_id]
        out_c = sp_stage(cfg, model, params['xyz'], tc)
        new_sp = se3.se3_act(out_c.aux['spT'], params['sp_points'][..., :3])
        params['xyz'].add_(out_c.d_xyz)
        params['sp_points'].copy_(new_sp)
        canonical = dict(model.canonical.named_parameters())
        for name, p in model.sp_deform.named_parameters():
            p.copy_(canonical[name])

    def update_gs_knn(self, step: int):
        """Rebuild the smooth loss's KNN over the live Gaussians (dead rows
        pushed 1e12 away) at step 1 and every ``gs_knn_update_interval``
        steps (``trainer.py:1297-1309``)."""
        if not check_interval_v2(step, *self.gs_knn_update_interval, -1) \
                and step != 1:
            return False
        self.gs_knn_index = live_knn_index(self.model.params['xyz'],
                                           self.model.alive, self.gs_knn_num)
        return True

    def _update_joint(self) -> torch.Tensor:
        """The joint tree from the joint cost's running mean (MST on the
        host); returns the root."""
        m = self.model
        parents, depth, root = update_joint(
            m.joint_cost, m.params['sp_points'][..., :3].detach(), m.sp_alive,
            self.cfg.sk_knn_num)
        m.joint_parents.copy_(parents)
        m.joint_depth.copy_(depth)
        m.joint_root.copy_(root)
        return root

    def train_step(self, step: int) -> Dict[str, torch.Tensor]:
        """Run training step ``step`` (1-based). Metrics stay 0-d tensors
        on the device (reading one synchronises). The events before the
        views and those after them are 'sk.train.events' spans."""
        cfg = self.cfg
        stage = cfg.stage_at(step)
        family = self.family(stage)
        with span('sk.train.events'):
            fired = self.maybe_stage_events(step)
            self.loss_w.set_step(step)
            self.update_sh_degree(step)
            if stage == 'sp' and self.update_gs_knn(step):
                fired.append('update_gs_knn')
            self.after_events(fired)
        idxs = [self.sampler.sample(step) for _ in range(self.batch_views)]
        metrics = self._step(stage, idxs, self.lr_trees(step), step)
        event, after = {}, []
        with span('sk.train.events'):
            if stage == 'sp' and check_interval_v2(
                    step, *cfg.joint_update_interval, close='[)'):
                event['joint_root'] = self._update_joint()
                after.append('update_joint')
            control = self.maybe_adaptive_control(step, family)
            if control:
                event.update(control)
                after.append('adaptive_control')
            self.after_events(after)
        self.last_event = event
        self.step = step
        return metrics

    # ------------------------------------------------------------ seams
    # what a device mesh changes in the step (parallel.trainer.MeshTrainer)

    def after_events(self, events):
        """What follows the events ``events`` (names) of a step: nothing on
        one device."""

    def pass_model(self) -> SKGSModel:
        """The model whose rows the main pass computes."""
        return self.model

    def own_rows(self, x: torch.Tensor) -> torch.Tensor:
        """The rows of the per-point tensor ``x`` that this process
        computes."""
        return x

    def all_rows(self, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """Every process's ``own_rows`` of ``x``, in order along ``dim``."""
        return x

    def live_mean(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """The mean of ``x`` over the live rows ``mask`` of the whole
        capacity."""
        return masked_mean(x, mask)

    def render_pass(self, g: GaussianInputs, view, m2d_off: torch.Tensor
                    ) -> Dict[str, torch.Tensor]:
        """The main pass's render of ``view``, the means2d offset
        ``m2d_off`` added (its gradient feeds the statistics)."""
        return render(g, view, self.rcfg,
                      active_sh_degree=self.model.active_sh_degree,
                      means2d_offset=m2d_off)

    def local_views(self, k: int) -> range:
        """The positions among a step's ``k`` views that this process
        computes."""
        return range(k)

    def view_rows(self, k: int, rows: Dict[str, torch.Tensor]
                  ) -> Dict[str, torch.Tensor]:
        """The step's ``k`` views' rows that ``_update`` reads, from those of
        this process's views ``rows``."""
        return rows

    def merge(self, maxes, sums, grads):
        """``maxes``, ``sums`` and ``grads`` of the step's views, from this
        process's."""
        return maxes, sums, grads

    # ------------------------------------------------------------ losses

    def loss_weight(self, name: str, step: int) -> float:
        """The weight of loss ``name`` at ``step``, with the JAX trainer's
        gates (``trainer.py:1395-1408``): the joint losses are 0 before
        ``joint_update_interval[1]``, the consistency loss after the last
        canonical replacement + 5 steps."""
        cfg = self.cfg
        if name in JOINT_LOSSES and step < cfg.joint_update_interval[1]:
            return 0.0
        if name == 'c_net' and cfg.canonical_replace_steps and \
                step > max(cfg.canonical_replace_steps) + 5:
            return 0.0
        return self.loss_w.w(name)

    def draw_time_noise(self) -> torch.Tensor:
        """A standard normal 0-d draw of ``time_gen`` on the device."""
        return torch.randn((), generator=self.time_gen, device=self.device)

    def draw_uniform(self, n: int) -> torch.Tensor:
        """n uniform draws in [0, 1) of ``reg_gen`` on the device."""
        return torch.rand(n, generator=self.reg_gen, device=self.device)

    def regularizer_draws(self, family: str) -> Optional[Dict]:
        """The motion regularizers' draws of one step (``trainer.py:
        516-550``), None when none has weight: the init family's uniform
        per capacity row ('rows'), elastic's ('elastic') and arap's
        ('arap') time samples, in that order, each when it is used."""
        lw = self.loss_w
        if family not in ('init', 'sp') or not any(
                lw.ever_nonzero(n) for n in MOTION_LOSSES):
            return None
        draws = {}
        if family == 'init':
            draws['rows'] = self.draw_uniform(self.model.alive.shape[0])
        if lw.ever_nonzero('elastic'):
            draws['elastic'] = self.draw_uniform(ELASTIC_SAMPLES)
        if lw.ever_nonzero('arap'):
            draws['arap'] = self.draw_uniform(ARAP_SAMPLES)
        return draws

    def _losses(self, stage: str, idx: int, m2d_off: torch.Tensor,
                step: Optional[int] = None, draws: Optional[Dict] = None):
        """Forward from the deltas to the losses for view ``idx`` at step
        ``step`` (the step gates the weights and sets the time noise's
        scale; ``self.step + 1`` when None): returns (losses, deltas,
        render outputs, composited image, target). An RGBA target and the
        render are composited over the view's background
        (``trainer.py:626-640, 704-705``); a net that is not ``is_blender``
        warps at a noisy time (one ``draw_time_noise`` a view). ``draws``
        are the step's ``regularizer_draws`` (drawn here when None)."""
        cfg, scene = self.cfg, self.scene
        family = self.family(stage)
        step = self.step + 1 if step is None else step
        if draws is None:
            draws = self.regularizer_draws(family)
        image, bg, noise, noise_scale = self.view_target(family, idx, step)
        t = scene.times[idx]
        m = self.pass_model()
        with span('sk.train.forward'):
            d = forward_deltas(cfg, m, t, stage, time_id=scene.time_ids[idx],
                               training=True, noise=noise,
                               noise_scale=noise_scale)
            g = self.render_inputs(family, d)
            out = self.render_pass(g, scene.view(idx), m2d_off)
            img = composite_background(out['images'], out['opacity'], bg)
        with span('sk.train.losses'):
            method = self.loss_w.cfg('image').get('method', 'l1')
            img_loss = mse_loss if method == 'mse' else l1_loss
            losses = {'rgb': self.loss_w.w('image') * img_loss(img, image),
                      'ssim': self.loss_w.w('ssim') * ssim_loss(img, image)}
            if family == 'sp':
                losses.update(self.sp_losses(d, t, step))
            if family == 'sk_init':
                losses = {k: v.detach() for k, v in losses.items()}
                losses.update(self.sk_init_losses(d, scene.time_ids[idx],
                                                  step))
            if family == 'init' and self.loss_w.ever_nonzero('arap_p'):
                losses['arap_p'] = self.loss_weight('arap_p', step) \
                    * self.points_arap(d)
            if draws is not None:
                losses.update(self.motion_reg_losses(family, t, draws, step))
            if family in ('init', 'sp') and cfg.use_canonical_net \
                    and self.loss_w.ever_nonzero('c_net'):
                points_out = m.params['xyz'] + d.d_xyz
                c_net = self.cnet_loss(t, points_out) if family == 'init' \
                    else self.cnet_loss_sp(t, points_out, d.aux)
                losses['c_net'] = self.loss_weight('c_net', step) * c_net
        return losses, d, out, img, image

    def view_target(self, family: str, idx: int, step: int):
        """View ``idx``'s target and its draws at step ``step``: (target,
        background, time noise or None, the noise's scale). An RGBA target
        is composited over a background drawn from ``bg_gen``; a net that
        is not ``is_blender`` warps at a noisy time (one
        ``draw_time_noise``) in the ``init`` and ``sp`` families."""
        image, bg = self.scene.images[idx], self.bg
        if image.shape[-1] == 4:
            bg = sample_background(self.meta.background_type, self.bg_gen,
                                   image.shape[0], image.shape[1],
                                   checker=self.bg,
                                   reference_rgb=image[..., :3])
            alpha = image[..., 3:4]
            image = image[..., :3] * alpha + bg * (1.0 - alpha)
        noise, noise_scale = None, 0.0
        if family in ('init', 'sp') and not self.cfg.net.is_blender:
            noise_scale = smooth_scale(self.cfg, step)
            if noise_scale > 0:
                noise = self.draw_time_noise()
        return image, bg, noise, noise_scale

    def sp_losses(self, d, t: torch.Tensor, step: int
                  ) -> Dict[str, torch.Tensor]:
        """The ``sp`` family's losses on the main pass ``d``
        (``trainer.py:294-349``): the entropy of the LBS weights over the
        live rows (``sparse``), their difference to the KNN Gaussians' in
        ``gs_knn_index`` (``smooth``, autograd of the plain form), the
        joint costs (``joint`` over the tree's edges, ``joint_all`` over
        every live pair; the superpoint transforms detached with
        ``sp_guided_detach``), and, when they have weight, the superpoint
        regularizers (``sp_extra_losses``) and the guided skeleton losses
        ``g_cmp_*``. The cost matrix goes into ``d.aux`` as
        'joint_cost_now' for the running mean. The sparsity and smoothness
        take the main pass's rows, the latter against ``all_rows`` of the
        weights (``trainer.py:705-729``)."""
        cfg, model = self.cfg, self.model
        params = model.params
        lw = lambda name: self.loss_weight(name, step)
        alive, sp_alive = self.own_rows(model.alive), model.sp_alive
        w = d.aux['knn_w']
        ent = -(w * torch.log(w + 1e-7) + (1 - w) * torch.log(1 - w + 1e-7))
        out = {'sparse': lw('sparse') * self.live_mean(ent, alive[:, None])}
        out['smooth'] = lw('smooth') * smooth_loss(
            w, self.own_rows(self.gs_knn_index), alive, self.all_rows(w),
            self.live_mean)
        spT = d.aux['spT']
        cost = joint_cost_matrix(params['joint_pos'],
                                 spT.detach() if cfg.sp_guided_detach
                                 else spT, sp_alive)
        cost_f = torch.where(torch.isfinite(cost), cost,
                             torch.zeros_like(cost))
        a = torch.arange(cfg.num_superpoints, device=cost.device)
        b = model.joint_parents[:, 0].to(torch.int64)
        is_root = a == model.joint_root
        pair_cost = torch.where(is_root | ~sp_alive,
                                torch.zeros_like(a, dtype=cost.dtype),
                                0.5 * (cost_f[a, b] + cost_f[b, a]))
        out['joint'] = lw('joint') * masked_mean(pair_cost,
                                                 ~is_root & sp_alive)
        out['joint_all'] = lw('joint_all') * masked_mean(
            cost_f, sp_alive[:, None] & sp_alive[None, :])
        d.aux['joint_cost_now'] = cost_f.detach()
        if any(self.loss_w.ever_nonzero(n) for n in SP_EXTRA_LOSSES):
            out.update(self.sp_extra_losses(d, a, b, is_root, step))
        if cfg.guided_step_start >= 0 and any(
                self.loss_w.ever_nonzero(n) for n in ('cmp_t', 'cmp_r',
                                                      'cmp_s')):
            out.update(self.guided_losses(d, t, step))
        return out

    def sp_extra_losses(self, d, a: torch.Tensor, b: torch.Tensor,
                        is_root: torch.Tensor, step: int
                        ) -> Dict[str, torch.Tensor]:
        """The sp family's superpoint regularizers (``trainer.py:429-472``),
        each when its weight is ever non-zero (``sp_arap_t`` and
        ``sp_arap_ct`` together): ``re_pos``, each live superpoint's
        warped position against the LBS-weighted mean of its warped
        Gaussians (``get_superpoint_features``); ``jp_dist``, each joint
        pivot ``joint_pos[a, b]`` warped by its parent b against both ends'
        warped (detached) superpoints, the root and dead superpoints left
        out; ``sp_arap_t``, the SE3 log of each superpoint's transform
        relative to its ``sk_knn_num`` nearest live neighbours' (canonical
        KNN), and ``sp_arap_ct``, the change of their squared distances.
        ``re_pos`` reads ``all_rows`` of the warped Gaussians and their
        weights (``trainer.py:749-765``)."""
        cfg, model = self.cfg, self.model
        params = model.params
        lw = lambda name: self.loss_weight(name, step)
        ever = self.loss_w.ever_nonzero
        spT = d.aux['spT']
        sp_pts = params['sp_points'][..., :3]
        alive = model.sp_alive
        out = {}
        if ever('re_pos'):
            points_t = self.all_rows(self.own_rows(params['xyz']) + d.d_xyz)
            re_sp = get_superpoint_features(
                points_t, self.all_rows(d.aux['knn_i']),
                self.all_rows(d.aux['knn_w']), cfg.num_superpoints)
            sp_t = se3.se3_act(spT, sp_pts)
            out['re_pos'] = lw('re_pos') * masked_mean(
                torch.square(sp_t - re_sp), alive[:, None])
        if ever('jp_dist'):
            sp_t = se3.se3_act(spT, sp_pts).detach()
            joints_w = se3.se3_act(spT[b], params['joint_pos'][a, b])
            mask_j = (alive & ~is_root)[:, None]
            out['jp_dist'] = lw('jp_dist') * (
                masked_mean(torch.square(joints_w - sp_t[a]), mask_j)
                + masked_mean(torch.square(joints_w - sp_t[b]), mask_j))
        if ever('sp_arap_t') or ever('sp_arap_ct'):
            sp_c = sp_pts.detach()
            _, nn = masked_knn(sp_c, sp_c, alive, cfg.sk_knn_num + 1)
            nn = nn[:, 1:].to(torch.int64)                # self dropped
            rel = se3.se3_mul(se3.se3_inv(spT[:, None]), spT[nn])
            pair_alive = alive[:, None] & alive[nn]
            out['sp_arap_t'] = lw('sp_arap_t') * masked_mean(torch.sqrt(
                torch.sum(torch.square(se3.se3_log(rel)), -1) + 1e-12),
                pair_alive)
            sp_t = se3.se3_act(spT, sp_c)
            d_c = torch.sum(torch.square(sp_c[:, None] - sp_c[nn]), -1)
            d_t = torch.sum(torch.square(sp_t[:, None] - sp_t[nn]), -1)
            out['sp_arap_ct'] = lw('sp_arap_ct') * masked_mean(
                torch.abs(d_c - d_t), pair_alive)
        return out

    def points_arap(self, d) -> torch.Tensor:
        """The point ARAP of the init family (``trainer.py:800-823``): the
        squared distances of each live Gaussian to its ``gs_knn_num``
        nearest warped live Gaussians (KNN over the whole capacity, dead
        rows pushed 1e6 away, detached) kept through the warp; the warped
        rows are ``all_rows`` of the main pass's."""
        model = self.model
        xyz, alive = model.params['xyz'], model.alive
        pts_t = self.all_rows(self.pass_model().params['xyz'] + d.d_xyz)
        with torch.no_grad():
            far = torch.where(alive[:, None], pts_t, pts_t + 1e6)
            _, nn = knn(far, far, self.gs_knn_num + 1)
        return reg.points_arap_loss(xyz, pts_t, nn[:, 1:], alive)

    def motion_reg_losses(self, family: str, t: torch.Tensor, draws: Dict,
                          step: int) -> Dict[str, torch.Tensor]:
        """``elastic``, ``acc`` and ``arap`` (``trainer.py:508-556``), each
        when its weight is ever non-zero, on the ``sp_deform`` net's
        trajectories of the (detached) superpoints, or in the init family
        of ``num_superpoints`` live Gaussians picked by the smallest of
        ``draws['rows']`` (dead rows + 1e9). ``elastic``: the edge-length
        variance over 8 times uniform in t +- dt / 2 on the 2 nearest
        nodes in (xyz, sp_hyper) space; ``acc``: the acceleration at (t -
        3 dt, t, t + 3 dt); ``arap``: the ARAP energy between 2 such times
        on a 10-NN graph of the first. The warp net runs once over all the
        times of a loss (a [times x M] batch)."""
        cfg, model = self.cfg, self.model
        params = model.params
        lw = lambda name: self.loss_weight(name, step)
        ever = self.loss_w.ever_nonzero
        if family == 'init':
            r = draws['rows'] + torch.where(model.alive, 0.0, 1e9)
            idx = torch.argsort(r, stable=True)[:cfg.num_superpoints]
            sp_pts = params['xyz'].detach()[idx]
            mask = model.alive[idx]
        else:
            sp_pts = params['sp_points'][..., :3].detach()
            mask = model.sp_alive
        m, dt = sp_pts.shape[0], cfg.time_interval
        tq = t.reshape(())

        def warp_at(ts: torch.Tensor) -> torch.Tensor:        # [S, M, 3]
            s = ts.shape[0]
            x = sp_pts.repeat(s, 1)
            out = deform_net_apply(model.sp_deform, cfg.net, x,
                                   ts.repeat_interleave(m)[:, None])
            return out['d_xyz'].reshape(s, m, 3) + sp_pts

        out = {}
        if ever('elastic'):
            ts = draws['elastic'] * dt + tq - 0.5 * dt
            nodes_t = warp_at(ts).transpose(0, 1)               # [M, S, 3]
            w_e, idx_e = calc_lbs_weight(
                sp_pts, sp_pts, mask, 3, 'dist', hyper=params['sp_hyper'],
                sp_hyper=params['sp_hyper'])
            out['elastic'] = lw('elastic') * reg.elastic_loss(
                nodes_t, idx_e[:, 1:], w_e[:, 1:])
        if ever('acc'):
            dt3 = 3.0 * dt
            nodes3 = warp_at(torch.stack([tq - dt3, tq, tq + dt3]))
            out['acc'] = lw('acc') * reg.acc_loss(nodes3.transpose(0, 1),
                                                  mask.to(torch.float32))
        if ever('arap'):
            ts = draws['arap'] * dt + tq - 0.5 * dt
            nodes_seq = warp_at(ts)
            nn_idx, w_a, _ = reg.arap_connectivity(nodes_seq[0], mask,
                                                   k=ARAP_KNN)
            out['arap'] = lw('arap') * reg.arap_error(nodes_seq, nn_idx, w_a)
        return out

    def guided_losses(self, d, t: torch.Tensor, step: int
                      ) -> Dict[str, torch.Tensor]:
        """The skeleton net and FK on the tree's pivots, held to the
        (detached) superpoint transforms, rotations and scales
        (``trainer.py:474-506``), gated on step > ``guided_step_start``:
        computed whatever the gate, so a closed gate gives the skeleton
        net exact zero gradients."""
        cfg, model = self.cfg, self.model
        params = model.params
        sp_tr = d.aux['spT'].detach()
        sp_rot = d.aux['sp_rot'].detach()
        sp_scale = d.aux['sp_scale'].detach()
        a = torch.arange(cfg.num_superpoints, device=sp_tr.device)
        b = model.joint_parents[:, 0].to(torch.int64)
        joints = params['joint_pos'][a, b]
        sk_r, sk_d_rot, sk_d_scale = skeleton_net_apply(
            model.sk_deform, cfg.sk_net, skeleton_net_input(params, joints), t)
        root = model.joint_root.to(torch.int64)
        sk_T = kinematic_transforms(joints, sk_rot_activation(sk_r),
                                    sp_tr[root], model.joint_parents, root)
        rel = se3.se3_mul(se3.se3_inv(sp_tr), sk_T)
        gate = float(step > cfg.guided_step_start)
        sp_alive = model.sp_alive
        lw = lambda name: gate * self.loss_weight(name, step)
        return {
            'g_cmp_t': lw('cmp_t') * masked_mean(torch.sqrt(torch.sum(
                torch.square(se3.se3_log(rel)), -1) + 1e-12), sp_alive),
            'g_cmp_r': lw('cmp_r') * masked_mean(
                torch.square(sk_d_rot - sp_rot), sp_alive[:, None]),
            'g_cmp_s': lw('cmp_s') * masked_mean(
                torch.square(sk_d_scale - sp_scale), sp_alive[:, None]),
        }

    def sk_init_losses(self, d, time_id: torch.Tensor, step: int
                       ) -> Dict[str, torch.Tensor]:
        """The ``sk_init`` family's losses (``trainer.py:769-800``): the
        skeleton's deltas ``d`` held to the blend of the cached superpoint
        motion at the view's frame under the frozen LBS ``sp_weights`` /
        ``sp_knn`` (each superpoint's own with ``warp_method``
        'largest'), squared, over the live rows of the main pass's model
        (``live_mean``)."""
        cfg = self.cfg
        m = self.pass_model()
        sp_tr, sp_rot, sp_scale = split_sp_cache(
            cfg, take_frame(m.sp_cache, time_id))
        points = m.params['xyz'].detach()
        w, knn = m.sp_weights, m.sp_knn
        if cfg.warp_method == 'largest':
            sp_xyz = warp_points(points, sp_tr, w, knn, cfg.warp_method,
                                 m.p2sp)
            sp_rot_b = blend_attr(sp_rot, w, knn)
            sp_scale_b = blend_attr(sp_scale, w, knn)
        else:
            sp_xyz, sp_rot_b, sp_scale_b = warp_blend_dense(
                points, sp_tr, dense_lbs_rows(w, knn, sp_tr.shape[0]), sp_rot,
                sp_scale)
        am = m.alive[:, None]
        lw = lambda name: self.loss_weight(name, step)
        mean = self.live_mean
        return {
            'cmp_t': lw('cmp_t') * mean(torch.square(d.d_xyz - sp_xyz), am),
            'cmp_r': lw('cmp_r') * mean(
                torch.square(d.d_rotation - sp_rot_b), am),
            'cmp_s': lw('cmp_s') * mean(
                torch.square(d.d_scaling - sp_scale_b), am)}

    def render_inputs(self, family: str, d) -> GaussianInputs:
        """The renderer's inputs from the deltas ``d`` of the main pass's
        rows; the ``init`` family renders every Gaussian at the live mean
        log-scale of the whole model (get_scaling, ``trainer.py:658-664``),
        ``sk_init`` with the colours and opacities detached
        (``trainer.py:672-675``)."""
        model = self.model
        gv = self.pass_model().gauss_view()
        if family in ('init', 'sk_init'):
            p = dict(gv.params)
            if family == 'init':
                p['scaling'] = torch.broadcast_to(
                    masked_mean(model.params['scaling'],
                                model.alive[:, None]),
                    p['scaling'].shape)
            else:
                for name in ('f_dc', 'f_rest', 'opacity'):
                    p[name] = p[name].detach()
            gv = gv._replace(params=p)
        return gaussian_inputs(gv, self.cfg.gauss, d.d_xyz, d.d_rotation,
                               d.d_scaling)

    def cnet_loss(self, t: torch.Tensor, points_out: torch.Tensor):
        """Canonical-net consistency, the init branch of ``cnet_loss``
        (``trainer.py:558-593``): the Gaussians of the main pass's model
        taken to the canonical frame by ``sp_deform`` (detached) and on to
        time t by the ``canonical`` net land where the main pass put them
        (detached); ``live_mean``."""
        cfg = self.cfg
        model = self.pass_model()
        xyz = model.params['xyz']
        tc = model.train_times[cfg.canonical_time_id]
        points_c = init_stage(cfg, model, xyz, tc).d_xyz.detach() + xyz
        points_t = init_stage(cfg, model, points_c, t,
                              use_canonical=True).d_xyz + points_c
        return self.live_mean(torch.square(points_t - points_out.detach()),
                              model.alive[:, None])

    def cnet_loss_sp(self, t: torch.Tensor, points_out: torch.Tensor, aux):
        """The ``sp`` branch of ``cnet_loss`` (``trainer.py:574-590``): the
        same with both passes through ``sp_stage`` on the main pass's LBS
        weights ``aux`` (they do not depend on t), the second from the
        superpoints taken to the canonical frame (detached)."""
        cfg = self.cfg
        model = self.pass_model()
        xyz = model.params['xyz']
        tc = model.train_times[cfg.canonical_time_id]
        out_c = sp_stage(cfg, model, xyz, tc, frozen_weights=aux['knn_w'],
                         frozen_knn=aux['knn_i'])
        points_c = out_c.d_xyz.detach() + xyz
        sp_points_c = se3.se3_act(out_c.aux['spT'],
                                  model.params['sp_points'][..., :3]).detach()
        out_t = sp_stage(cfg, model, points_c, t, use_canonical=True,
                         frozen_weights=out_c.aux['knn_w'],
                         frozen_knn=out_c.aux['knn_i'], sp_points=sp_points_c)
        points_t = out_t.d_xyz + points_c
        return self.live_mean(torch.square(points_t - points_out.detach()),
                              model.alive[:, None])

    def _step(self, stage: str, idxs, lrs: Dict[str, float],
              step: Optional[int] = None) -> Dict[str, torch.Tensor]:
        """The forward and backward of each view of ``idxs`` this process
        computes (``local_views``), the gradients summed into the leaves
        and the means2d offset, then ``_update``. A view of another process
        takes its draws here (``view_target``) and nothing else."""
        family = FAMILY[stage]
        m2d_off = self.zero_grads()
        draws = self.regularizer_draws(family)
        mine = self.local_views(len(idxs))
        views = []
        for i, idx in enumerate(idxs):
            if i not in mine:
                self.view_target(family, idx, self.step + 1 if step is None
                                 else step)
                continue
            losses, d, out, img, target = self._losses(stage, idx, m2d_off,
                                                       step, draws)
            total = sum(losses.values())
            with span('sk.train.backward'):
                total.backward()
            views.append(self._view_record(family, idx, total, losses, d,
                                           out, img, target))
        with span('sk.train.update'):
            return self._update(family, lrs, views, m2d_off, len(idxs))

    def _view_record(self, family: str, idx: int, total: torch.Tensor,
                     losses, d, out, img, target) -> Dict:
        """What ``_update`` reads of one view's forward, detached (the
        largest warp over the live ``own_rows``)."""
        alive = self.own_rows(self.model.alive)
        rec = {'loss': total.detach(),
               'losses': {k: v.detach() for k, v in losses.items()},
               'psnr': psnr(img, target), 'radii': out['radii'],
               'overflow': out['overflow'], 'num_pairs': out['num_pairs'],
               'dxyz_max': torch.amax(torch.abs(torch.where(
                   alive[:, None], d.d_xyz, torch.zeros_like(d.d_xyz)))),
               'time_id': self.scene.time_ids[idx]}
        for key in ('cache_row', 'p2sp', 'joint_cost_now'):
            if key in d.aux:
                rec[key] = d.aux[key].detach()
        return rec

    def zero_grads(self) -> torch.Tensor:
        """Clear the leaves' gradients; returns a fresh zero means2d offset
        that requires grad."""
        for p in self.model.leaves().values():
            p.grad = None
        return torch.zeros((self.model.alive.shape[0], 2), device=self.device,
                           requires_grad=True)

    @torch.no_grad()
    def _update(self, family: str, lrs: Dict[str, float], views,
                m2d_off: torch.Tensor, k: Optional[int] = None
                ) -> Dict[str, torch.Tensor]:
        """After the backward of this process's views ``views`` of a
        ``family`` step of ``k`` views (``len(views)`` by default): the
        rows of the step's views (``view_rows``: the radii, the pairs, the
        cache rows and the last view's ``p2sp``), what the views give
        (``merge``), the gradients divided by k, sanitised, the optimizer,
        the statistics, the cache rows (``sp_cache`` for the ``sp`` family,
        ``sk_cache`` for ``sk``, in view order), the ``sp`` family's
        ``p2sp`` of the last view ('largest') and joint cost mean, and the
        metrics (``trainer.py:909-957``)."""
        model = self.model
        leaves = model.leaves()
        k = len(views) if k is None else k
        stack = lambda key: torch.stack([v[key] for v in views])
        cache = {'sp': model.sp_cache, 'sk': model.sk_cache}.get(family)
        rows = {'radii': stack('radii'), 'num_pairs': stack('num_pairs')}
        if cache is not None:
            rows.update(cache_row=stack('cache_row'),
                        time_id=stack('time_id'))
        if family == 'sp' and self.cfg.warp_method == 'largest':
            rows['p2sp'] = views[-1]['p2sp']
        rows = self.view_rows(k, rows)
        radii = rows['radii']
        maxes = {'radii': radii.amax(0).to(torch.float32),
                 'overflow': stack('overflow').any(),
                 'num_pairs': rows['num_pairs'].amax(),
                 'n_vis': ((radii > 0) & model.alive).sum(1).amax(),
                 'dxyz_max': stack('dxyz_max').amax()}
        sums = {'n_seen': (radii > 0).sum(0).to(torch.float32),
                'loss': stack('loss').sum(0),
                'psnr': stack('psnr').sum(0),
                **{'losses/' + name: torch.stack(
                    [v['losses'][name] for v in views]).sum(0)
                   for name in views[0]['losses']}}
        if cache is not None:
            sums['cache_rows'], sums['time_ids'] = rows['cache_row'], \
                rows['time_id']
        if family == 'sp':
            sums['joint_cost'] = stack('joint_cost_now').sum(0)
            if 'p2sp' in rows:
                sums['p2sp'] = rows['p2sp']
        grads = {name: p.grad for name, p in leaves.items()}
        grads['means2d'] = m2d_off.grad
        maxes, sums, grads = self.merge(maxes, sums, grads)
        m2d_grad = grads.pop('means2d')
        # a degenerate splat can give a non-finite gradient entry: zero the
        # entries, count them, keep every healthy gradient
        n_bad = torch.zeros((), dtype=torch.int64, device=self.device)
        for name, p in leaves.items():
            if grads[name] is None:
                # a leaf this family does not read steps on a zero gradient,
                # as in the JAX package's dense gradient trees
                p.grad = torch.zeros_like(p)
                continue
            p.grad = grads[name]
            if k > 1:
                p.grad.div_(k)
            bad = ~torch.isfinite(p.grad)
            n_bad += bad.sum()
            p.grad.masked_fill_(bad, 0.0)
        grads = {name: p.grad for name, p in leaves.items()}
        self.opt_state = self.opt_update(grads, self.opt_state, leaves, lrs,
                                         clip_norm=self.clip_norm)
        # sk_init has no image gradient: its statistics take a zero one
        m2d_grad = torch.zeros_like(m2d_off) if m2d_grad is None \
            else m2d_grad / k
        self._stats_update(maxes['radii'], sums['n_seen'], m2d_grad)
        if cache is not None:
            rows, tids = sums['cache_rows'], sums['time_ids']
            for i in range(k):
                cache.index_copy_(0, tids[i].reshape(1).to(torch.int64),
                                  rows[i][None])
        if family == 'sp':
            if self.cfg.warp_method == 'largest':
                model.p2sp.copy_(sums['p2sp'])
            mom = self.cfg.sk_momentum
            model.joint_cost.copy_(model.joint_cost * mom
                                   + sums['joint_cost'] / k * (1 - mom))
        return {
            'loss': sums['loss'] / k,
            'psnr': sums['psnr'] / k,
            'overflow': maxes['overflow'],
            'num_pairs': maxes['num_pairs'],
            'n_vis': maxes['n_vis'],
            'n_bad_grad': n_bad,
            'dxyz_max': maxes['dxyz_max'],
            **{name: sums['losses/' + name] / k
               for name in views[0]['losses']},
        }

    def _stats_update(self, radii_max: torch.Tensor, n_seen: torch.Tensor,
                      m2d_grad: torch.Tensor):
        """max screen radius, NDC position-gradient norm and view count of
        every Gaussian the views saw, from the views' largest radius
        ``radii_max`` [N], the number of views that saw each ``n_seen``
        [N] and the mean means2d gradient (``trainer.py:986-1002``)."""
        m = self.model
        seen = radii_max > 0
        m.max_radii2d.copy_(torch.where(
            seen, torch.maximum(m.max_radii2d, radii_max), m.max_radii2d))
        gnorm = ndc_grad_norm(m2d_grad, (self.rcfg.image_width,
                                         self.rcfg.image_height), eps=1e-24)
        m.xyz_grad_accum.copy_(torch.where(seen, m.xyz_grad_accum + gnorm,
                                           m.xyz_grad_accum))
        m.denom.add_(n_seen)

    # ------------------------------------------------------------ control

    def maybe_adaptive_control(self, step: int, family: str
                               ) -> Dict[str, torch.Tensor]:
        """The adaptive control due after step ``step``
        (``trainer.py:1165-1214``); returns the event's counts (empty when
        nothing ran). ``static`` / ``init``: densify / prune and the opacity
        reset on their intervals before ``init_sampling_step``. ``sp``
        family, on the step relative to ``stages['sp_fix'][0]``: the
        superpoint prune / split (``n_pruned_sp``, ``n_split_sp``) and
        merge (``n_merged_sp``) in ``sp`` only, densify / prune (the size
        threshold after ``opacity_reset_interval[1]``), and the opacity
        reset every ``opacity_reset_interval[0]`` steps and, on a white
        background, at ``densify_interval[1]``."""
        cfg = self.cfg
        g = cfg.gauss
        event: Dict[str, torch.Tensor] = {}
        if family in ('static', 'init'):
            if step < cfg.init_sampling_step and check_interval_v2(
                    step, *g.init_densify_prune_interval):
                # the size threshold starts after the first opacity reset
                size_thr = g.prune_max_screen_size \
                    if step > g.opacity_reset_interval[0] else 0.0
                do_dens = True
                cap = cfg.num_superpoints \
                    * cfg.node_max_num_ratio_during_init
                if not cfg.net.is_blender and \
                        int(host_read(self.model.alive.sum())) > cap:
                    do_dens = False   # real-capture nets cap the init growth
                event.update(self._densify_prune(do_dens, size_thr))
            if step < cfg.init_sampling_step and check_interval_v2(
                    step, *g.init_opacity_reset_interval):
                event.update(self._reset_opacity())
            return event
        if family != 'sp':
            return event   # sk_densify_gs defaults False (sk_gs.py:1983)
        rel = step - cfg.stages['sp_fix'][0]
        if cfg.stage_at(step) == 'sp':
            if check_interval_v2(rel, *cfg.sp_adjust_interval, close='[)'):
                event.update(self._sp_prune_split())
            if check_interval_v2(rel, *cfg.sp_merge_interval, close='[)'):
                event.update(self._sp_merge())
        if check_interval_v2(rel, *g.densify_interval):
            size_thr = g.prune_max_screen_size \
                if rel > g.opacity_reset_interval[1] else 0.0
            event.update(self._densify_prune(True, size_thr))
        if (rel > 1 and (rel - 1) % g.opacity_reset_interval[0] == 0) or (
                self.meta.background_type == 'white'
                and rel == g.densify_interval[1]):
            event.update(self._reset_opacity())
        return event

    def _densify_prune(self, do_densify: bool, size_thr: float
                       ) -> Dict[str, torch.Tensor]:
        """``trainer.py:1216-1229``, in place on the model and Adam."""
        return densify_and_prune(
            self.model.gauss_view(), self.opt_state, self.cfg.gauss,
            self.meta.cameras_extent, self.noise_gen, do_densify, True,
            size_thr)

    def _reset_opacity(self) -> Dict[str, torch.Tensor]:
        reset_opacity(self.model.gauss_view(), self.opt_state)
        return {'opacity_reset': torch.ones((), dtype=torch.bool)}

    def _sp_prune_split(self) -> Dict[str, torch.Tensor]:
        st = sk_gs_ops.superpoint_prune_split(self.cfg, self.model,
                                              self.opt_state)
        return {'n_pruned_sp': st['n_pruned'], 'n_split_sp': st['n_split']}

    def _sp_merge(self) -> Dict[str, torch.Tensor]:
        st = sk_gs_ops.superpoint_merge(self.cfg, self.model)
        return {'n_merged_sp': st['n_merged']}
