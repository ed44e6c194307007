"""SK-GS training, the ``static``, ``init`` and ``sk`` families (port of
the parts of ``sk_gs_tpu/framework/trainer.py:SKGSTrainer`` that the stages
``static``, ``init_fix``, ``init``, ``sk_fix`` and ``sk`` run).

One step (``train_step``, ``trainer.py:1376-1436``) runs the stage events
due before it, samples a view with the step-keyed sampler, runs the step
body (``_core``, single device, one view: ``trainer.py:595-984``), and
then the adaptive density control due after it. The body: the stage's
deltas (none for ``static``; the ``sp_deform`` warp net for the ``init``
family, detached in ``init_fix``; the skeleton warp at the view's own train
frame for the ``sk`` family), activations (the ``init`` family renders
every Gaussian at the live mean of the log-scales), a render whose blend
goes through ``TileBlend`` or ``ChunkBlend`` (the hand-written kernels on
the card) by ``RasterConfig.schedule``, l1 (or mse) and SSIM image losses,
the canonical-net consistency ``c_net`` (``init`` family), ``backward``,
non-finite gradient entries zeroed and counted (``n_bad_grad``), Adam with
per-leaf learning rates, the densification statistics, and, for the ``sk``
family, the skeleton net's output row written into ``sk_cache``.

Adaptive control (``maybe_adaptive_control``, ``trainer.py:1165-1185``):
the ``static`` and ``init`` stages densify and prune every
``init_densify_prune_interval`` steps and reset the opacity every
``init_opacity_reset_interval`` steps, before ``init_sampling_step``; the
split noise comes from a CPU ``torch.Generator`` seeded with ``seed`` (so
the card and the CPU draw the same numbers; the JAX key stream is not
matched). The ``sk`` family has none (``trainer.py:1188-1189``) and the
skeleton is assumed initialised, as in a run restored inside the sk stages.

Not ported, and raising ``NotImplementedError``: the ``sp`` and ``sk_init``
families and the superpoint initialisation at ``init_sampling_step`` when
the schedule has sp stages; the ``elastic``, ``acc``, ``arap`` and
``arap_p`` losses (zero in the default weights); the time noise of nets
that are not ``is_blender``; ``batch_views > 1``, a device mesh,
backgrounds composited per step, optimizers other than Adam. The trainer
takes no point cloud, so the re-initialisation from it at the start of
``sp_fix`` is not run (as in a JAX trainer given ``pcd=None``).
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from .. import resolve_device
from ..data.base import DYNAMIC_BG, Scene, SceneMeta
from ..data.sampler import UniformSampler
from ..models.gaussian_splatting import (densify_and_prune, expon_lr,
                                         gaussian_inputs, ndc_grad_norm,
                                         reset_opacity)
from ..models.losses import (LossWeights, l1_loss, masked_mean, mse_loss,
                             psnr, ssim_loss)
from ..models.optim import AdamState, adam_init, adam_update
from ..models.sk_gs import (DEFORM_NETS, SKGSConfig, SKGSModel,
                            forward_deltas, init_stage)
from ..render.render import composite_background, render
from ..render.settings import GaussianInputs, RasterConfig

FAMILY = {'static': 'static', 'init_fix': 'init', 'init': 'init',
          'sk_fix': 'sk', 'sk': 'sk'}
# the JAX trainer's default loss weights (trainer.py:247-251)
DEFAULT_LOSS = {'image': {'method': 'l1', 'lambda': 0.8}, 'ssim': 0.2,
                'sparse': 0.1, 'smooth': 0.1, 'joint': 1.0,
                'joint_all': 1.0, 'c_net': 1.0, 'cmp_p': 1.0, 'cmp_t': 0.01,
                'cmp_r': 0.01, 'cmp_s': 0.01}
# losses of the init family the port does not compute
UNPORTED_INIT_LOSSES = ('elastic', 'acc', 'arap', 'arap_p')


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
    ``init`` and ``sk`` families.

    ``model`` must be trainable (``convert.model_from_flat(...,
    trainable=True)`` or ``sk_gs.init_model``); it and ``scene`` are moved
    to ``device`` (CUDA unless asked otherwise). ``opt_state`` resumes Adam
    (``convert.adam_from_flat``); fresh moments otherwise. ``last_event``
    holds the counts of the last adaptive-control event.
    """

    def __init__(self, cfg: SKGSConfig, rcfg: RasterConfig, scene: Scene,
                 meta: SceneMeta, model: SKGSModel,
                 loss_weights: Optional[LossWeights] = None, sampler=None,
                 seed: int = 0, clip_norm: float = 0.0,
                 batch_views: int = 1, optimizer: str = 'adam', mesh=None,
                 opt_state: Optional[AdamState] = None, device='cuda'):
        if batch_views != 1:
            raise NotImplementedError('batch_views > 1 is not ported yet')
        if mesh is not None:
            raise NotImplementedError('training on a device mesh is not '
                                      'ported yet')
        if optimizer != 'adam':
            raise NotImplementedError(f'optimizer {optimizer!r} is not ported '
                                      "yet (only 'adam')")
        if meta.background_type in DYNAMIC_BG or scene.images.shape[-1] != 3:
            raise NotImplementedError('backgrounds composited per step (RGBA '
                                      'targets) are not ported yet')
        self.device = resolve_device(device)
        self.cfg = cfg
        self.rcfg = rcfg
        self.model = model.to(self.device)
        leaves = self.model.leaves()
        if not all(p.requires_grad for p in leaves.values()):
            raise ValueError('the model is frozen: build it with '
                             'convert.model_from_flat(..., trainable=True)')
        self.scene = scene.to(self.device)
        self.meta = meta
        self.loss_w = loss_weights or LossWeights(DEFAULT_LOSS)
        self.sampler = sampler or UniformSampler(scene.num_views, seed)
        self.clip_norm = clip_norm
        self.opt_state = opt_state or adam_init(
            {k: p.detach() for k, p in leaves.items()})
        self.noise_gen = torch.Generator().manual_seed(seed)
        bg = meta.background
        if bg is None:
            bg = np.ones(3, np.float32) if meta.background_type == 'white' \
                else np.zeros(3, np.float32)
        self.bg = torch.as_tensor(bg, dtype=torch.float32).to(self.device)
        self.step = 0
        self.last_event: Dict[str, torch.Tensor] = {}

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
                and int(m.active_sh_degree) < self.cfg.gauss.sh_degree):
            m.active_sh_degree.add_(1)

    def family(self, stage: str) -> str:
        """The ported step family of ``stage``; raises for the others."""
        if stage not in FAMILY:
            raise NotImplementedError(
                f'stage {stage!r} is not ported yet: the trainer runs the '
                f'stages {tuple(FAMILY)} (the sp and sk_init families are '
                'missing)')
        family = FAMILY[stage]
        if family == 'init':
            if not self.cfg.net.is_blender:
                raise NotImplementedError(
                    'the time noise of nets that are not is_blender '
                    '(smooth_scale) is not ported yet')
            bad = [n for n in UNPORTED_INIT_LOSSES
                   if self.loss_w.ever_nonzero(n)]
            if bad:
                raise NotImplementedError(f'the init-family losses {bad} '
                                          'are not ported yet')
        return family

    def maybe_stage_events(self, step: int):
        """The stage events due before step ``step`` (``trainer.py:
        1061-1124``) that the ported families meet: the superpoint
        initialisation at ``init_sampling_step`` is not ported."""
        stages = self.cfg.stages
        has_sp = stages['sp_fix'][2] > 0 or stages['sp'][2] > 0
        if step == self.cfg.init_sampling_step and has_sp:
            raise NotImplementedError(
                f'step {step}: the superpoint initialisation at '
                'init_sampling_step (init_superpoints) is not ported yet')

    def train_step(self, step: int) -> Dict[str, torch.Tensor]:
        """Run training step ``step`` (1-based). Metrics stay 0-d tensors
        on the device (reading one synchronises)."""
        self.maybe_stage_events(step)
        stage = self.cfg.stage_at(step)
        family = self.family(stage)
        self.loss_w.set_step(step)
        self.update_sh_degree(step)
        idx = self.sampler.sample(step)
        metrics = self._step(stage, idx, self.lr_trees(step), step)
        self.last_event = self.maybe_adaptive_control(step, family)
        self.step = step
        return metrics

    def c_net_weight(self, step: int) -> float:
        """The consistency weight, 0 after the last canonical replacement
        (+ 5 steps, ``trainer.py:1406-1408``)."""
        cfg = self.cfg
        if cfg.canonical_replace_steps and \
                step > max(cfg.canonical_replace_steps) + 5:
            return 0.0
        return self.loss_w.w('c_net')

    def _losses(self, stage: str, idx: int, m2d_off: torch.Tensor,
                step: Optional[int] = None):
        """Forward from the deltas to the losses for view ``idx`` at step
        ``step`` (the step gates ``c_net``; ``self.step + 1`` when None):
        returns (losses, deltas, render outputs, composited image)."""
        cfg, model, scene = self.cfg, self.model, self.scene
        family = self.family(stage)
        step = self.step + 1 if step is None else step
        image = scene.images[idx]
        d = forward_deltas(cfg, model, scene.times[idx], stage,
                           time_id=scene.time_ids[idx], training=True)
        g = self.render_inputs(family, d)
        out = render(g, scene.view(idx), self.rcfg,
                     active_sh_degree=model.active_sh_degree,
                     means2d_offset=m2d_off)
        img = composite_background(out['images'], out['opacity'], self.bg)
        method = self.loss_w.cfg('image').get('method', 'l1')
        img_loss = mse_loss if method == 'mse' else l1_loss
        losses = {'rgb': self.loss_w.w('image') * img_loss(img, image),
                  'ssim': self.loss_w.w('ssim') * ssim_loss(img, image)}
        if family == 'init' and cfg.use_canonical_net \
                and self.loss_w.ever_nonzero('c_net'):
            losses['c_net'] = self.c_net_weight(step) * self.cnet_loss(
                scene.times[idx], model.params['xyz'] + d.d_xyz)
        return losses, d, out, img

    def render_inputs(self, family: str, d) -> GaussianInputs:
        """The renderer's inputs from the deltas ``d``; the ``init`` family
        renders every Gaussian at the live mean log-scale (get_scaling,
        ``trainer.py:658-664``)."""
        model = self.model
        gv = model.gauss_view()
        if family == 'init':
            p = dict(gv.params)
            p['scaling'] = torch.broadcast_to(
                masked_mean(p['scaling'], model.alive[:, None]),
                p['scaling'].shape)
            gv = gv._replace(params=p)
        return gaussian_inputs(gv, self.cfg.gauss, d.d_xyz, d.d_rotation,
                               d.d_scaling)

    def cnet_loss(self, t: torch.Tensor, points_out: torch.Tensor):
        """Canonical-net consistency, the init branch of ``cnet_loss``
        (``trainer.py:558-593``): the Gaussians taken to the canonical
        frame by ``sp_deform`` (detached) and on to time t by the
        ``canonical`` net land where the main pass put them (detached)."""
        cfg, model = self.cfg, self.model
        xyz = model.params['xyz']
        tc = model.train_times[cfg.canonical_time_id]
        points_c = init_stage(cfg, model, xyz, tc).d_xyz.detach() + xyz
        points_t = init_stage(cfg, model, points_c, t,
                              use_canonical=True).d_xyz + points_c
        return masked_mean(torch.square(points_t - points_out.detach()),
                           model.alive[:, None])

    def _step(self, stage: str, idx: int, lrs: Dict[str, float],
              step: Optional[int] = None) -> Dict[str, torch.Tensor]:
        m2d_off = self.zero_grads()
        fwd = self._losses(stage, idx, m2d_off, step)
        total = sum(fwd[0].values())
        total.backward()
        return self._update(idx, lrs, total, fwd, m2d_off)

    def zero_grads(self) -> torch.Tensor:
        """Clear the leaves' gradients; returns a fresh zero means2d offset
        that requires grad."""
        for p in self.model.leaves().values():
            p.grad = None
        return torch.zeros((self.model.alive.shape[0], 2), device=self.device,
                           requires_grad=True)

    @torch.no_grad()
    def _update(self, idx: int, lrs: Dict[str, float], total: torch.Tensor,
                fwd, m2d_off: torch.Tensor) -> Dict[str, torch.Tensor]:
        """After the backward: sanitise the gradients, Adam, statistics,
        the sk_cache row, and the metrics."""
        losses, d, out, img = fwd
        model = self.model
        leaves = model.leaves()
        # a degenerate splat can give a non-finite gradient entry: zero the
        # entries, count them, keep every healthy gradient
        n_bad = torch.zeros((), dtype=torch.int64, device=self.device)
        for p in leaves.values():
            if p.grad is None:
                # a leaf this family does not read steps on a zero gradient,
                # as in the JAX package's dense gradient trees
                p.grad = torch.zeros_like(p)
            else:
                bad = ~torch.isfinite(p.grad)
                n_bad += bad.sum()
                p.grad.masked_fill_(bad, 0.0)
        grads = {k: p.grad for k, p in leaves.items()}
        self.opt_state = adam_update(grads, self.opt_state, leaves, lrs,
                                     clip_norm=self.clip_norm)
        self._stats_update(out['radii'], m2d_off.grad)
        if 'cache_row' in d.aux:
            model.sk_cache[self.scene.time_ids[idx]] = d.aux['cache_row']
        alive = model.alive
        return {
            'loss': total.detach(),
            'psnr': psnr(img, self.scene.images[idx]),
            'overflow': out['overflow'],
            'num_pairs': out['num_pairs'],
            'n_vis': torch.sum((out['radii'] > 0) & alive),
            'n_bad_grad': n_bad,
            'dxyz_max': torch.amax(torch.abs(torch.where(
                alive[:, None], d.d_xyz, torch.zeros_like(d.d_xyz)))),
            **{k: v.detach() for k, v in losses.items()},
        }

    def _stats_update(self, radii: torch.Tensor, m2d_grad: torch.Tensor):
        """max screen radius, NDC position-gradient norm and view count of
        every Gaussian the view saw (``trainer.py:986-1002``)."""
        m = self.model
        seen = radii > 0
        m.max_radii2d.copy_(torch.where(
            seen, torch.maximum(m.max_radii2d, radii.to(torch.float32)),
            m.max_radii2d))
        gnorm = ndc_grad_norm(m2d_grad, (self.rcfg.image_width,
                                         self.rcfg.image_height), eps=1e-24)
        m.xyz_grad_accum.copy_(torch.where(seen, m.xyz_grad_accum + gnorm,
                                           m.xyz_grad_accum))
        m.denom.add_(seen.to(torch.float32))

    # ------------------------------------------------------------ control

    def maybe_adaptive_control(self, step: int, family: str
                               ) -> Dict[str, torch.Tensor]:
        """Densify / prune and the opacity reset due after step ``step``
        (the static / init branch of ``trainer.py:1165-1185``); returns the
        event's counts (empty when nothing ran)."""
        if family not in ('static', 'init'):
            return {}   # sk_densify_gs defaults False (sk_gs.py:1983)
        cfg = self.cfg
        g = cfg.gauss
        event: Dict[str, torch.Tensor] = {}
        if step < cfg.init_sampling_step and check_interval_v2(
                step, *g.init_densify_prune_interval):
            # the size threshold starts after the first opacity reset
            size_thr = g.prune_max_screen_size \
                if step > g.opacity_reset_interval[0] else 0.0
            do_dens = True
            if not cfg.net.is_blender and int(self.model.alive.sum()) > (
                    cfg.num_superpoints * cfg.node_max_num_ratio_during_init):
                do_dens = False   # real-capture nets cap the init growth
            # trainer.py:1216-1229, in place on the model and Adam
            event.update(densify_and_prune(
                self.model.gauss_view(), self.opt_state, g,
                self.meta.cameras_extent, self.noise_gen, do_dens, True,
                size_thr))
        if step < cfg.init_sampling_step and check_interval_v2(
                step, *g.init_opacity_reset_interval):
            reset_opacity(self.model.gauss_view(), self.opt_state)
            event['opacity_reset'] = torch.ones((), dtype=torch.bool)
        return event
