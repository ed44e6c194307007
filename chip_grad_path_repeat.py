#!/usr/bin/env python3
"""Repeat chip_smoke.py's ``grad_path`` check of the ``sk`` path on one GPU.

    python3 chip_grad_path_repeat.py [REPEATS]

Each repeat trains a fresh full-width ``sk`` trainer (chip_smoke's random
model, 80,000 alive) over steps 40,001-40,011 and then takes step 40,012's
leaf gradients through kernels #1/#2 and through the plain blend on the
card, on the same model and view. The training itself differs between
repeats at rounding level (kernel #2's atomics land in another order), so
the repeats sample the states that ``grad_path`` meets. One JSON line a
repeat: the worst error over the leaf's max for the leaves the check reads
most, the means2d gradient's, and the pixel channels where the l1 loss's
sign(image - target) differs between the two routes (the l1 kink: where one
route renders the target exactly, its cotangent is 0 and the other's is
+-w/n). A repeat over ``chip_smoke.GRAD_PATH_TOL`` also reports its worst
pixel and holds kernel #2 against its plain version on that step's own
inputs (``phase_kernel_bwd``). The last line sums the repeats. Exits
non-zero without a CUDA device.
"""
from __future__ import annotations

import json
import sys

import torch

import chip_smoke as cs

LEAVES = ('xyz', 'sp_W', 'f_dc', 'opacity', 'scaling')


def route_grads(trainer, step: int, idx: int):
    """(leaf gradients, means2d gradient, composited image) of ``step`` at
    view ``idx``."""
    trainer.loss_w.set_step(step)
    m2d = trainer.zero_grads()
    losses, _, _, img = trainer._losses(trainer.cfg.stage_at(step), idx, m2d,
                                        step)
    sum(losses.values()).backward()
    grads = {k: p.grad.detach().clone()
             for k, p in trainer.model.leaves().items() if p.grad is not None}
    return grads, m2d.grad.clone(), img.detach()


def worst(got: torch.Tensor, ref: torch.Tensor) -> dict:
    err = (got - ref).abs().reshape(ref.shape[0], -1).amax(-1)
    row = int(err.argmax())
    return {'err_over_max': float(err[row]) / float(ref.abs().max()),
            'row': row}


def repeat(cfg, rcfg, train, s0: int, rep: int) -> dict:
    trainer = cs.fullscale_trainer(cfg, rcfg, train)
    for step in range(s0, s0 + 1 + cs.N_STEPS):
        trainer.train_step(step)
    step = s0 + 1 + cs.N_STEPS
    idx = cs.first_view(trainer, step)
    plain = cs.SKGSTrainer(cfg, rcfg._replace(use_kernel=False),
                           trainer.scene, trainer.meta, trainer.model,
                           trainer.loss_w, opt_state=trainer.opt_state,
                           skeleton_initialized=True, device='cuda')
    g_k, m_k, img_k = route_grads(trainer, step, idx)
    g_p, m_p, img_p = route_grads(plain, step, idx)
    target = trainer.scene.images[idx][..., :3]
    flips = torch.sign(img_k[..., :3] - target) != \
        torch.sign(img_p[..., :3] - target)
    rec = {'rep': rep, 'step': step, 'view': idx,
           'image_max_diff': float((img_k - img_p).abs().max()),
           'l1_sign_flips': int(flips.sum()),
           'leaves': {k: worst(g_k[k], g_p[k]) for k in LEAVES},
           'means2d': worst(m_k, m_p)}
    rec['fail'] = max(v['err_over_max'] for v in rec['leaves'].values()) \
        > cs.GRAD_PATH_TOL
    if rec['fail']:
        diff = (img_k - img_p).abs().amax(-1)
        p = int(diff.argmax())
        rec['image_worst_pixel'] = [p // diff.shape[1], p % diff.shape[1]]
        try:
            cs.phase_kernel_bwd(trainer, step)
            rec['kernel_bwd_same_inputs'] = 'passed'
        except AssertionError as e:
            rec['kernel_bwd_same_inputs'] = str(e)[:300]
    return rec


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    repeats = int(argv[0]) if argv else 20
    if not torch.cuda.is_available():
        print('chip_grad_path_repeat: no CUDA device', file=sys.stderr)
        return 2
    cs.build_all([k.library for k in cs.KERNELS])
    cfg, rcfg, train = cs.synthetic_fullscale()
    s0 = cfg.stages['sk'][0] + 1
    recs = []
    for rep in range(repeats):
        recs.append(repeat(cfg, rcfg, train, s0, rep))
        cs.emit(recs[-1])
    failed = [r for r in recs if r['fail']]
    cs.emit({'repeats': repeats, 'failed': len(failed),
             'failed_with_l1_sign_flips': sum(r['l1_sign_flips'] > 0
                                              for r in failed),
             'passed_with_l1_sign_flips': sum(r['l1_sign_flips'] > 0
                                              for r in recs
                                              if not r['fail']),
             'tolerance': cs.GRAD_PATH_TOL,
             'device': torch.cuda.get_device_name(0),
             'nvidia_smi': cs.nvidia_smi_line()})
    return 0


if __name__ == '__main__':
    sys.exit(main())
