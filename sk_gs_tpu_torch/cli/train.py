"""Train SK-GS from a YAML config (port of the JAX package's ``train.py``).

    python -m sk_gs_tpu_torch.cli.train -c configs/synthetic_smoke.yaml \\
        [--set train.lr=2e-3 ...] [--steps N] [--resume CKPT] [--device cpu]
        [--profile FIRST:LAST]

Writes into ``<output_dir>/<exp_name>``: ``config.yaml`` (the merged
config), ``metrics.jsonl`` (every ``log_interval`` steps, with the ms a
step over the window since the last line), ``checkpoints/`` (a rotated
``checkpoint_<step>.npz`` every ``checkpoint_interval`` steps, and the
pinned ``init.npz``, ``sk_init.npz``, ``best.npz``, ``last.npz`` and, on a
non-finite loss, ``crash.npz``), ``vis/step_<step>.png`` every
``vis_interval`` steps (prediction | target | 5 x difference of eval view
0), ``results.json`` (the full metrics of the eval split, ``best_PSNR``
and ``train_time_s``) and ``last.ply`` (the live Gaussians). ``--resume``
continues from a checkpoint of either package; ``--steps`` stops early.
``--profile FIRST:LAST`` runs steps FIRST to LAST (rank 0's) under
``torch.profiler`` (the host and, on the card, its kernels) and writes
``profile_<FIRST>_<LAST>.json``, a Chrome trace in which the port's layer
spans (``utils/tracing.py``: 'sk.train.events', 'sk.train.forward' with
'sk.deform' and the render's spans inside, 'sk.train.losses',
'sk.train.backward', 'sk.train.update', 'sk.sync', 'py.gc') and the
kernels share one clock.

Several processes train one model on a ``train.parallel: {n_view, n_gs}``
mesh, one process a rank: data parallel over ``view`` (n_view dividing
``train.batch_views``), and over ``gs`` each rank computing its 1/n_gs of
the capacity and a band of the image (n_gs dividing the capacity and the
tile rows: at 16-pixel tiles a 48-pixel image has 3, so
``raster.tile_h=8`` gives 6). Launch n_view x n_gs ranks by ``torchrun
--nproc_per_node <n_view x n_gs> -m sk_gs_tpu_torch.cli.train ...`` or
with ``MASTER_ADDR`` / ``MASTER_PORT`` / ``WORLD_SIZE`` / ``RANK`` set by
hand (``parallel.init_distributed``). A run of one process trains the
one-device ``framework.trainer.SKGSTrainer``, each rank of a mesh a
``parallel.trainer.MeshTrainer``. Each rank drives ``cuda:<LOCAL_RANK>``
over NCCL; ``--device cuda:0 --dist-backend gloo`` puts every rank on one
card (NCCL takes one card a rank), and ``--device cpu`` runs the ranks
over gloo on the CPU. Every rank reads ``--resume``; rank 0 alone writes
the files and runs the evaluations.

Left out, as TPU matters: the dispatch-queue depth control (the port
synchronises only where it logs, evaluates or saves) and the JAX
compilation cache.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import logging
import os
import time
from pathlib import Path
from typing import Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.profiler import ProfilerActivity

from .. import resolve_device
from ..framework import build
from ..framework.checkpoint import CheckpointManager, load, step_of
from ..framework.config import make_config, save_config
from ..framework.trainer import SKGSTrainer
from ..models import sk_gs
from ..models.gaussian_splatting import init_from_pcd
from ..models.losses import LossWeights
from ..parallel import init_distributed
from ..parallel.trainer import MeshTrainer
from ..utils.ply import save_gaussian_ply
from ..utils.png import write_png

log = logging.getLogger('sk_gs_tpu_torch.train')
# the step metrics written beside loss and PSNR when the step has them
LOGGED = ('n_vis', 'dxyz_max', 'rgb', 'ssim', 'smooth', 'sparse', 'c_net',
          'cmp_p', 'n_bad_grad')
PLY_LEAVES = ('xyz', 'f_dc', 'f_rest', 'opacity', 'scaling', 'rotation')


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('-c', '--config', required=True)
    ap.add_argument('--set', nargs='*', default=[], dest='overrides')
    ap.add_argument('--steps', type=int, default=None,
                    help='stop after this step (truncates the schedule)')
    ap.add_argument('--resume', default=None, help='checkpoint to resume')
    ap.add_argument('--scene', default=None,
                    help='shortcut for --set dataset.scene=...')
    ap.add_argument('--device', default='cuda',
                    help="'cuda' (each rank its cuda:<LOCAL_RANK>), "
                    "'cuda:<i>' or 'cpu'")
    ap.add_argument('--dist-backend', default=None, choices=('nccl', 'gloo'),
                    help='the process group of a multi-process launch: '
                    'nccl on the card, gloo on the CPU by default')
    ap.add_argument('--profile', default=None, type=step_window,
                    metavar='FIRST:LAST',
                    help='run steps FIRST to LAST under torch.profiler and '
                    'write profile_<FIRST>_<LAST>.json beside the metrics')
    args = ap.parse_args(argv)
    if args.scene:
        args.overrides = list(args.overrides) + [f'dataset.scene={args.scene}']
    return args


def step_window(text: str) -> Tuple[int, int]:
    """(FIRST, LAST) of 'FIRST:LAST', 1 <= FIRST <= LAST."""
    try:
        first, last = (int(x) for x in text.split(':'))
    except ValueError:
        raise argparse.ArgumentTypeError(
            f'{text!r} is not FIRST:LAST') from None
    if not 1 <= first <= last:
        raise argparse.ArgumentTypeError(
            f'{text!r}: need 1 <= FIRST <= LAST')
    return first, last


def save_vis_triplet(trainer: SKGSTrainer, vis_dir: Path, step: int):
    """prediction | target | 5 x |difference| of eval view 0."""
    scene = trainer.eval_scene or trainer.scene
    stage = trainer.cfg.stage_at(max(step, 1))
    img = trainer.render_view(scene, 0, stage)
    gt = scene.images[0]
    if gt.shape[-1] == 4:
        gt = gt[..., :3] * gt[..., 3:4] + trainer.bg * (1.0 - gt[..., 3:4])
    diff = torch.clamp(torch.abs(img - gt) * 5.0, 0, 1)
    strip = torch.cat([torch.clamp(img, 0, 1), gt, diff], dim=1)
    vis_dir.mkdir(parents=True, exist_ok=True)
    write_png(vis_dir / f'step_{step:07d}.png', strip.cpu().numpy())


def peak_memory_mb(device: torch.device) -> float:
    if device.type != 'cuda':
        return 0.0
    return torch.cuda.max_memory_allocated(device) / 2 ** 20


def rank_device(device: str) -> torch.device:
    """The device of this process: 'cuda' is ``cuda:<LOCAL_RANK>`` in a
    multi-process launch (``cuda`` alone otherwise)."""
    if device == 'cuda' and int(os.environ.get('WORLD_SIZE', '1')) > 1:
        device = f"cuda:{int(os.environ.get('LOCAL_RANK', '0'))}"
    device = resolve_device(device)
    if device.type == 'cuda' and device.index is not None:
        if device.index >= torch.cuda.device_count():
            raise ValueError(
                f'{device} on a machine with {torch.cuda.device_count()} '
                'card(s): pass --device cuda:0 --dist-backend gloo to run '
                'several ranks on one card')
        torch.cuda.set_device(device)
    return device


def main(argv=None):
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO,
                        format='%(asctime)s %(levelname)s %(message)s')
    device = rank_device(args.device)
    backend = args.dist_backend or ('gloo' if device.type == 'cpu'
                                    else 'nccl')
    dist_info = init_distributed(backend=backend)
    lead = dist_info['process_index'] == 0
    if dist_info['process_count'] > 1:
        log.info('process %d of %d on %s over %s',
                 dist_info['process_index'], dist_info['process_count'],
                 device, backend)
    cfg = make_config(args.config, args.overrides)
    out_dir = Path(cfg.get('output_dir', 'results')) / cfg.get('exp_name',
                                                                'run')
    if lead:
        out_dir.mkdir(parents=True, exist_ok=True)
        save_config(cfg, out_dir / 'config.yaml')

    # rank 0 makes the scene first: a synthetic scene caches its frames
    if not lead:
        dist.barrier()
    scene, meta, eval_scene, ds_pcd = build.build_scene(cfg, device)
    if lead and dist.is_initialized():
        dist.barrier()
    skcfg, rcfg = build.build_model_cfg(cfg, meta, scene.image_size)
    opts = build.trainer_options(cfg)
    pts, cols = build.initial_point_cloud(cfg, ds_pcd)
    base = init_from_pcd(pts, cols, skcfg.gauss, device=device)
    model = sk_gs.init_model(skcfg, rcfg, base, meta.train_times,
                             seed=opts['seed'], device=device)
    trainer_cls = MeshTrainer if 'mesh' in opts else SKGSTrainer
    trainer = trainer_cls(skcfg, rcfg, scene, meta, model,
                          loss_weights=LossWeights(cfg.get('loss', {})),
                          sampler=build.build_sampler(cfg, scene, skcfg),
                          pcd=(pts, cols), eval_scene=eval_scene,
                          device=device, **opts)
    t = cfg['train']
    ckpt = CheckpointManager(out_dir / 'checkpoints',
                             interval=int(t.get('checkpoint_interval', 5000)))
    if lead:
        trainer.snapshot_fn = lambda name: ckpt.save(
            trainer.ckpt_state, trainer.step, force=True, name=name,
            manage=False)
    total = args.steps or skcfg.total_steps
    eval_interval = int(t.get('eval_interval', 5000))
    log_interval = int(t.get('log_interval', 100))
    vis_interval = int(t.get('vis_interval', 0))

    start, best = 1, -1.0
    if args.resume:
        loaded = load(args.resume)
        start = step_of(loaded) + 1
        trainer.restore(loaded, start - 1)
        best = trainer.best_psnr
        log.info('resumed from step %d (stage %s, sk_init=%s)', start - 1,
                 skcfg.stage_at(max(start - 1, 1)),
                 trainer.skeleton_initialized)

    prof = None
    t0 = time.time()
    win_t0, win_step = time.time(), start - 1
    with (out_dir / 'metrics.jsonl').open('a') if lead else \
            contextlib.nullcontext() as metrics_log:
        for step in range(start, total + 1):
            if lead and args.profile and step == args.profile[0]:
                acts = [ProfilerActivity.CPU] + (
                    [ProfilerActivity.CUDA] if device.type == 'cuda' else [])
                prof = torch.profiler.profile(activities=acts)
                prof.start()
            metrics = trainer.train_step(step)
            if prof is not None and step in (args.profile[1], total):
                if device.type == 'cuda':
                    torch.cuda.synchronize(device)
                prof.stop()
                first, last = args.profile
                prof.export_chrome_trace(
                    str(out_dir / f'profile_{first}_{last}.json'))
                prof = None
            if not lead:
                # the replicas' metrics are rank 0's: a non-finite loss
                # stops every rank
                if (step % log_interval == 0 or step == total) and \
                        not np.isfinite(float(metrics['loss'])):
                    raise FloatingPointError(
                        f'non-finite loss at step {step}')
                continue
            if step % log_interval == 0 or step == total:
                loss_f, psnr_f = float(metrics['loss']), float(metrics['psnr'])
                now = time.time()
                dt = (now - win_t0) / max(step - win_step, 1)
                win_t0, win_step = now, step
                eta = dt * (total - step)
                log.info('step %d/%d stage=%s loss=%.4f psnr=%.2f '
                         '(%.0f ms/step, eta %dm%02ds)', step, total,
                         skcfg.stage_at(step), loss_f, psnr_f, dt * 1e3,
                         int(eta // 60), int(eta % 60))
                if not np.isfinite(loss_f):
                    ckpt.save(trainer.ckpt_state, step, force=True,
                              name='crash.npz', manage=False)
                    raise FloatingPointError(
                        f'non-finite loss {loss_f} at step {step} (stage '
                        f'{skcfg.stage_at(step)}); crash.npz saved')
                if bool(metrics['overflow']):
                    log.warning('pair capacity overflow at step %d: splats '
                                'are dropped; raise raster.pair_capacity',
                                step)
                extra = {k: round(float(metrics[k]), 6) for k in LOGGED
                         if k in metrics}
                if extra.get('n_bad_grad', 0) > 0:
                    log.warning('step %d: %d non-finite gradient entries '
                                'dropped', step, int(extra['n_bad_grad']))
                metrics_log.write(json.dumps(
                    {'step': step, 'stage': skcfg.stage_at(step),
                     'loss': loss_f, 'psnr': psnr_f,
                     'ms_per_step': round(dt * 1e3, 1), **extra}) + '\n')
                metrics_log.flush()
            if vis_interval and (step % vis_interval == 0 or step == total):
                save_vis_triplet(trainer, out_dir / 'vis', step)
            if step % eval_interval == 0 or step == total:
                result = trainer.evaluate()
                mem = peak_memory_mb(device)
                log.info('eval @%d: PSNR=%.3f SSIM=%.4f%s', step,
                         result['PSNR'], result['SSIM'],
                         f' mem={mem:.0f}MB' if mem else '')
                if result['PSNR'] > best:
                    best = result['PSNR']
                    trainer.best_psnr = best
                    ckpt.save(trainer.ckpt_state, step, force=True,
                              name='best.npz', manage=False)
            ckpt.save(trainer.ckpt_state, step)

    if not lead:
        dist.destroy_process_group()
        return None
    result = trainer.evaluate(full_metrics=True)
    result['best_PSNR'] = best
    result['train_time_s'] = time.time() - t0
    with (out_dir / 'results.json').open('w') as f:
        json.dump(result, f, indent=2)
    m = trainer.model
    save_gaussian_ply(out_dir / 'last.ply',
                      {k: m.params[k].detach().cpu().numpy()
                       for k in PLY_LEAVES}, m.alive.cpu().numpy())
    ckpt.save(trainer.ckpt_state, total, force=True, name='last.npz',
              manage=False)
    log.info('done: %s', result)
    if dist.is_initialized():
        dist.destroy_process_group()
    return result


if __name__ == '__main__':
    main()
