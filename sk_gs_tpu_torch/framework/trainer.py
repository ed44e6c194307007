"""SK-GS training, the ``sk`` family (port of the parts of
``sk_gs_tpu/framework/trainer.py:SKGSTrainer`` that stages ``sk_fix`` and
``sk`` run).

One step (``train_step``, ``trainer.py:1376-1436``) samples a view with the
step-keyed sampler, runs the step body (``_core`` for ``family == 'sk'``,
single device, one view: ``trainer.py:595-984``), writes the skeleton net's
output row into ``sk_cache`` at the view's frame, and returns the metrics.
The body: deltas of the skeleton warp at the view's own train frame,
activations, a render whose blend goes through ``TileBlend`` (the
hand-written kernels on the card), l1 (or mse) and SSIM image losses,
``backward``, non-finite gradient entries zeroed and counted
(``n_bad_grad``), Adam with per-leaf learning rates, and the densification
statistics.

The ``sk`` family has no adaptive control (``trainer.py:1188-1189``) and
the skeleton is assumed initialised, as in a run restored inside the sk
stages. Not ported, and raising: the other stages, ``batch_views > 1``, a
device mesh, backgrounds composited per step, optimizers other than Adam.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from .. import resolve_device
from ..data.base import DYNAMIC_BG, Scene, SceneMeta
from ..data.sampler import UniformSampler
from ..models.gaussian_splatting import (expon_lr, gaussian_inputs,
                                         ndc_grad_norm)
from ..models.losses import LossWeights, l1_loss, mse_loss, psnr, ssim_loss
from ..models.optim import AdamState, adam_init, adam_update
from ..models.sk_gs import SKGSConfig, SKGSModel, forward_deltas
from ..render.render import composite_background, render
from ..render.settings import RasterConfig

SK_FAMILY = ('sk_fix', 'sk')
DEFAULT_LOSS = {'image': {'method': 'l1', 'lambda': 0.8}, 'ssim': 0.2}


class SKGSTrainer:
    """Host-side loop over ``train_step(step)`` for the ``sk`` family.

    ``model`` must be trainable (``convert.model_from_flat(...,
    trainable=True)``); it and ``scene`` are moved to ``device`` (CUDA
    unless asked otherwise). ``opt_state`` resumes Adam
    (``convert.adam_from_flat``); fresh moments otherwise.
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
        bg = meta.background
        if bg is None:
            bg = np.ones(3, np.float32) if meta.background_type == 'white' \
                else np.zeros(3, np.float32)
        self.bg = torch.as_tensor(bg, dtype=torch.float32).to(self.device)
        self.step = 0

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
        stage-relative decays for ``xyz`` and the skeleton net, ``joints``
        at ``lr_joints`` of the deform base, ``global_tr`` frozen (0)."""
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
        flat = {
            'xyz': xyz_lr, 'f_dc': lr * g.lr_feature,
            'f_rest': lr * g.lr_feature / 20.0,
            'opacity': lr * g.lr_opacity, 'scaling': lr * g.lr_scaling,
            'rotation': lr * g.lr_rotation,
            'sp_W': deform_base, 'sp_radius': deform_base,
            'sp_weight': deform_base, 'global_tr': 0.0,
            'joints': deform_base * cfg.lr_joints,
            'sk_feature': lr,
        }
        return {name: deform_lr if name.startswith('sk_deform/')
                else flat.get(name, 0.0) for name in self.model.leaves()}

    # ------------------------------------------------------------ step

    def update_sh_degree(self, step: int):
        """The SH degree grows by one every 1000 steps after sp_fix starts."""
        sp_fix_start = self.cfg.stages['sp_fix'][0]
        m = self.model
        if (step > sp_fix_start and (step - sp_fix_start) % 1000 == 0
                and int(m.active_sh_degree) < self.cfg.gauss.sh_degree):
            m.active_sh_degree.add_(1)

    def train_step(self, step: int) -> Dict[str, torch.Tensor]:
        """Run training step ``step`` (1-based). Metrics stay 0-d tensors
        on the device (reading one synchronises)."""
        stage = self.cfg.stage_at(step)
        if stage not in SK_FAMILY:
            raise NotImplementedError(
                f'stage {stage!r} (step {step}) is not ported yet: the '
                f'trainer runs the sk family {SK_FAMILY}')
        self.loss_w.set_step(step)
        self.update_sh_degree(step)
        idx = self.sampler.sample(step)
        metrics = self._step(stage, idx, self.lr_trees(step))
        self.step = step
        return metrics

    def _losses(self, stage: str, idx: int, m2d_off: torch.Tensor):
        """Forward from the deltas to the losses for view ``idx``: returns
        (losses, deltas, render outputs, composited image)."""
        cfg, model, scene = self.cfg, self.model, self.scene
        image = scene.images[idx]
        d = forward_deltas(cfg, model, scene.times[idx], stage,
                           time_id=scene.time_ids[idx], training=True)
        g = gaussian_inputs(model.gauss_view(), cfg.gauss, d.d_xyz,
                            d.d_rotation, d.d_scaling)
        out = render(g, scene.view(idx), self.rcfg,
                     active_sh_degree=model.active_sh_degree,
                     means2d_offset=m2d_off)
        img = composite_background(out['images'], out['opacity'], self.bg)
        method = self.loss_w.cfg('image').get('method', 'l1')
        img_loss = mse_loss if method == 'mse' else l1_loss
        losses = {'rgb': self.loss_w.w('image') * img_loss(img, image),
                  'ssim': self.loss_w.w('ssim') * ssim_loss(img, image)}
        return losses, d, out, img

    def _step(self, stage: str, idx: int, lrs: Dict[str, float]
              ) -> Dict[str, torch.Tensor]:
        m2d_off = self.zero_grads()
        fwd = self._losses(stage, idx, m2d_off)
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
        grads = {k: p.grad for k, p in leaves.items()}
        n_bad = torch.zeros((), dtype=torch.int64, device=self.device)
        for g in grads.values():
            if g is not None:
                bad = ~torch.isfinite(g)
                n_bad += bad.sum()
                g.masked_fill_(bad, 0.0)
        self.opt_state = adam_update(grads, self.opt_state, leaves, lrs,
                                     clip_norm=self.clip_norm)
        self._stats_update(out['radii'], m2d_off.grad)
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
