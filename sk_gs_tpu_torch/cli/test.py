"""Evaluate a trained SK-GS checkpoint: the split's full metrics and FPS
(port of the JAX package's ``test.py``).

    python -m sk_gs_tpu_torch.cli.test -c results/<exp>/config.yaml \\
        --load results/<exp>/checkpoints/best.npz [--fps-sweep] \\
        [--out results.json] [--device cpu]

The model is built at the checkpoint's Gaussian capacity (a bucketed JAX
checkpoint holds fewer slots than its config), or at the config's with
``--full-capacity`` (the checkpoint padded with dead slots);
``--pair-capacity`` overrides the raster's pair budget. The trainer resumes
the checkpoint at its step (the schedule's last when it has none), and the
split is evaluated at that step's stage: once to warm up (the kernels'
build and first launches stay out of the timing), then timed. ``FPS`` is
the views over the wall time of that full evaluation, as in the JAX
package. ``--fps-sweep`` renders view 0 1,000 times at t in [0, 1], timed
by CUDA events around the sweep (the host clock on the CPU):
``FPS_sweep``. ``results.json`` (beside the config unless ``--out``) has
the JAX package's keys.
"""
from __future__ import annotations

import argparse
import json
import logging
import time
from pathlib import Path

import torch

from .. import resolve_device
from ..framework import build
from ..framework.checkpoint import capacity_of, load, pad_capacity, step_of
from ..framework.config import make_config
from ..framework.evaluate import render_eval
from ..framework.trainer import SKGSTrainer
from ..convert import model_from_flat

log = logging.getLogger('sk_gs_tpu_torch.test')
N_SWEEP = 1000
SWEEP_WARMUP = 10


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('-c', '--config', required=True)
    ap.add_argument('--load', required=True)
    ap.add_argument('--set', nargs='*', default=[], dest='overrides')
    ap.add_argument('--fps-sweep', action='store_true',
                    help='1,000 renders of view 0 at t in [0, 1]')
    ap.add_argument('--out', default=None)
    ap.add_argument('--full-capacity', action='store_true',
                    help="evaluate at the config's capacity instead of the "
                         "checkpoint's")
    ap.add_argument('--pair-capacity', type=int, default=0,
                    help='override raster.pair_capacity')
    ap.add_argument('--scene', default=None,
                    help='shortcut for --set dataset.scene=...')
    ap.add_argument('--device', default='cuda')
    args = ap.parse_args(argv)
    if args.scene:
        args.overrides = list(args.overrides) + [f'dataset.scene={args.scene}']
    return args


def fps_sweep(model, view, bg, stage: str, rcfg, n: int = N_SWEEP) -> float:
    """Renders a second of ``view`` at n times evenly in [0, 1], over
    ``bg`` (white, as the JAX sweep)."""
    ts = torch.linspace(0.0, 1.0, n, device=model.device)
    for t in ts[:SWEEP_WARMUP]:
        render_eval(model, view, t, bg, stage, rcfg)
    cuda = model.device.type == 'cuda'
    if cuda:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize(model.device)
        start.record()
    t0 = time.perf_counter()
    for t in ts:
        render_eval(model, view, t, bg, stage, rcfg)
    if cuda:
        end.record()
        torch.cuda.synchronize(model.device)
        return n / (start.elapsed_time(end) / 1e3)
    return n / (time.perf_counter() - t0)


def main(argv=None):
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    device = resolve_device(args.device)
    cfg = make_config(args.config, args.overrides)
    scene, meta, eval_scene, _pcd = build.build_scene(cfg, device)
    skcfg, rcfg = build.build_model_cfg(cfg, meta, scene.image_size)
    flat = load(args.load)
    if args.full_capacity:
        flat = pad_capacity(flat, skcfg.gauss.capacity)
    cap = capacity_of(args.load) if not args.full_capacity else \
        skcfg.gauss.capacity
    if cap != skcfg.gauss.capacity:
        log.info('model capacity from checkpoint: %d (config %d)', cap,
                 skcfg.gauss.capacity)
        skcfg = skcfg._replace(gauss=skcfg.gauss._replace(capacity=cap))
    if args.pair_capacity:
        rcfg = rcfg._replace(pair_capacity=int(args.pair_capacity))

    trainer = SKGSTrainer(
        skcfg, rcfg, scene, meta,
        model_from_flat(flat, skcfg, rcfg, device, trainable=True),
        eval_scene=eval_scene, device=device)
    trainer.restore(flat, step_of(flat) or skcfg.total_steps)
    model = trainer.model
    stage = skcfg.stage_at(trainer.step)
    trainer.evaluate(eval_scene, stage=stage, full_metrics=True)
    if device.type == 'cuda':
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    result = trainer.evaluate(eval_scene, stage=stage, full_metrics=True)
    if device.type == 'cuda':
        torch.cuda.synchronize(device)
    result['FPS'] = eval_scene.num_views / (time.perf_counter() - t0)
    result['stage'] = stage
    result['step'] = trainer.step
    result['capacity'] = skcfg.gauss.capacity
    result['pair_capacity'] = rcfg.pair_capacity
    result['n_alive'] = int(model.alive.sum())
    if args.fps_sweep:
        with torch.no_grad():
            result['FPS_sweep'] = fps_sweep(
                model, eval_scene.view(0), torch.ones(3, device=device),
                stage, rcfg)
    out_path = Path(args.out) if args.out else \
        Path(args.config).parent / 'results.json'
    with out_path.open('w') as f:
        json.dump(result, f, indent=2)
    log.info('results: %s -> %s', result, out_path)
    return result


if __name__ == '__main__':
    main()
