#!/usr/bin/env python3
"""Chip smoke run of the PyTorch/CUDA port (sk_gs_tpu_torch) on one GPU.

    python3 chip_smoke.py [--profile]

Drives the port's two paths at full width (the ``synthetic_fullscale``
preset: 100,352 Gaussian slots, 80,000 alive, 512 joints, 400 x 400, random
weights from seed 0) through the entry points a user calls, and checks
them: serving through ``framework.evaluate``, and training through
``framework.trainer.SKGSTrainer.train_step`` (the ``sk`` stage) on the
preset's synthetic scene, made on the card. Phases, one JSON line each:

1. device: the card, the device count and its power limit;
2. build: every hand-written kernel compiled from ``sk_gs_tpu_torch/csrc``
   (one nvcc each, started together), with ptxas' register and shared
   memory lines;
3. kernel: the forward kernel against its plain PyTorch version on the
   inputs of the first request, error and CUDA-event times;
4. slice: the launch counts set to 0, 10 renders served at
   distinct (orbit camera, t), the counts read back; per request the
   synchronised time, the pairs and the overflow flag; PSNR / SSIM against
   the same requests rendered by the plain path;
5. reference: a small model rendered on the card and by the plain path on
   the CPU;
6. kernel_bwd: the backward kernel against its plain version on the first
   training step's inputs and cotangents, error per column group, CUDA-event
   times of the kernel, the plain version and the ``index_add_`` that sums
   its rows onto the Gaussians;
7. train: one warm-up step, the launch counts set to 0, 10 steps, the
   counts read back; per step the synchronised time and the metrics; the
   loss on the first step's view before and after; the peak memory;
8. grad_path: one step's leaf gradients through the kernels against the
   plain forward and backward on the card, on the same sample;
9. train_reference: a small model trained 2 steps on the card and on the
   CPU (plain versions), losses, gradients and parameters compared;
10. with ``--profile`` only: one request's and one training step's stages
   timed with CUDA events, and torch.profiler windows over a few requests
   and steps (device time by kernel, device busy share).

Then a ``kernels`` line (every ported kernel with its launches on the
training path and on each path, error, times and bound), the card's name
and power limit as nvidia-smi prints them, and last ``{"ok": true,
"device": {...}}``. Any failure raises and exits non-zero; with no CUDA
device it exits non-zero before printing any result, and without the port
beside it the import fails.
"""
from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time

import numpy as np
import torch

from sk_gs_tpu_torch import convert
from sk_gs_tpu_torch.cuda_build import build_all
from sk_gs_tpu_torch.data.sampler import UniformSampler
from sk_gs_tpu_torch.data.synthetic import make_synthetic_scene
from sk_gs_tpu_torch.framework.evaluate import evaluate, render_eval
from sk_gs_tpu_torch.framework.presets import synthetic_fullscale
from sk_gs_tpu_torch.framework.random_model import orbit_view, random_model_flat
from sk_gs_tpu_torch.framework.trainer import SKGSTrainer
from sk_gs_tpu_torch.models.gaussian_splatting import gaussian_inputs
from sk_gs_tpu_torch.models.losses import LossWeights, l1_loss, ssim_loss
from sk_gs_tpu_torch.models.sk_gs import forward_deltas
from sk_gs_tpu_torch.render import prepare_blend
from sk_gs_tpu_torch.render.binning import build_tile_lists
from sk_gs_tpu_torch.render.blend import (assemble_image, blend_backward_plain,
                                          blend_forward_plain)
from sk_gs_tpu_torch.render.preprocess import preprocess
from sk_gs_tpu_torch.render.render import blend_tiles, composite_background
from sk_gs_tpu_torch.render.tile_kernel import (KERNELS, rows_from_entries,
                                                tile_blend_bwd, tile_blend_fwd)

# published H100 SXM peaks (NVIDIA data sheet): float32 outside the tensor
# cores, and HBM3 bandwidth
PEAK_FP32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12
# operations of one (entry, pixel) evaluation of the forward blend, counting
# only what every evaluation does: dx, dy (2), the quadratic form (9),
# min(power, 0), exp, o * g, min(0.99, .) and the two skip tests (6). A kept
# entry does ~10 more; leaving them out keeps the bound a least time.
BLEND_OPS_PER_EVAL = 17
# operations the backward adds for an (entry, pixel) pair that adds to the
# pixel: 1 - alpha, T (1 - alpha), w, B (2 ch - 1), the running sum (2),
# 1 / (1 - alpha), g_alpha (7), g_power, the six conic / position /
# opacity terms (18), w g_color (ch), and the 6 + ch sums over the pixels
# (at ch = 3; counted per adding pair, a least count)
BWD_OPS_PER_ADD = 49
KERNEL_TOL = 1e-4
BWD_TOL = 3e-4          # of each column group's max magnitude
GRAD_PATH_TOL = 1e-3    # of each leaf's max magnitude
SEED = 0
N_REQUESTS = 10
N_STEPS = 10
GROUPS = {'xy': slice(0, 2), 'conic': slice(2, 5), 'opacity': slice(5, 6),
          'colour': slice(6, None)}


def emit(obj):
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, iters: int, warmup: int) -> float:
    """Mean milliseconds per call of ``fn`` by CUDA events, after warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def nvidia_smi_line() -> str:
    out = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def requests(n: int, width: int, height: int, device):
    """n distinct (orbit camera, t): t between the train frames."""
    views = [orbit_view(2.0 * math.pi * k / n, width, height,
                        elevation=0.3 * math.cos(k), device=device)
             for k in range(n)]
    times = [(k + 0.37) / n for k in range(n)]
    return views, times


def phase_kernel(model, view, t):
    """Kernel vs plain version on the first request's binned inputs."""
    cfg, rcfg = model.cfg, model.rcfg
    with torch.no_grad():
        d = forward_deltas(cfg, model, torch.tensor(t, device=model.device),
                           'sk')
        g = gaussian_inputs(model.gauss_view(), cfg.gauss, d.d_xyz,
                            d.d_rotation, d.d_scaling)
        inp = prepare_blend(g, view, rcfg, model.active_sh_degree)
        b = inp.binned
        args = (inp.geo, inp.col, b.sort_gauss, b.tile_start, b.tile_count,
                rcfg)
        color, alpha = tile_blend_fwd.launch(*args)
        torch.cuda.synchronize()
        stats = {}
        p_color, p_alpha = blend_forward_plain(*args, stats=stats)
        torch.cuda.synchronize()
        err_c = float((color - p_color).abs().max())
        err_a = float((alpha - p_alpha).abs().max())
        above = int(((color - p_color).abs().amax(-1) > 3e-5).sum()
                    + ((alpha - p_alpha).abs() > 3e-5).sum())
        finite = bool(torch.isfinite(color).all() and torch.isfinite(alpha).all())
        ms = cuda_ms(lambda: tile_blend_fwd.launch(*args), iters=20, warmup=3)
        plain_ms = cuda_ms(lambda: blend_forward_plain(*args), iters=3,
                           warmup=1)

    pairs = int(b.num_pairs)
    T, P, ch = rcfg.num_tiles, rcfg.pix_per_tile, inp.col.shape[1]
    evals = stats['evaluations']
    ops = evals * BLEND_OPS_PER_EVAL
    nbytes = (4 * (pairs + 2 * T) + 4 * inp.geo.numel() + 4 * inp.col.numel()
              + 4 * T * P * (ch + 1))
    t_ops, t_bytes = ops / PEAK_FP32_FLOPS, nbytes / PEAK_HBM_BYTES
    row = {
        'name': tile_blend_fwd.name, 'route': tile_blend_fwd.route,
        'source': tile_blend_fwd.source, 'replaces': tile_blend_fwd.replaces,
        'max_abs_err': max(err_c, err_a), 'ms': ms, 'plain_ms': plain_ms,
        'bound_ms': 1e3 * max(t_ops, t_bytes),
        'bound_by': 'operations' if t_ops >= t_bytes else 'bytes',
        'library_ms': None,
    }
    emit({'phase': 'kernel', 'kernel': row['name'], 'tiles': T,
          'pixels_per_tile': P, 'channels': ch, 'pairs': pairs,
          'evaluations': evals, 'ops': ops, 'bytes': nbytes,
          'max_abs_err_color': err_c, 'max_abs_err_alpha': err_a,
          'values_above_3e-5': above, 'tolerance': KERNEL_TOL,
          'finite': finite, 'ms': ms, 'plain_ms': plain_ms,
          'bound_ms': row['bound_ms'], 'bound_by': row['bound_by']})
    if not finite or max(err_c, err_a) > KERNEL_TOL:
        raise AssertionError(f'kernel disagrees with its plain version: '
                             f'colour {err_c}, alpha {err_a} > {KERNEL_TOL}')
    return row


def phase_slice(model, views, times, bg):
    """Serve the requests through evaluate with the counts at 0."""
    plain_rcfg = model.rcfg._replace(use_kernel=False)
    refs = [render_eval(model, v, t, bg, rcfg=plain_rcfg)['image']
            for v, t in zip(views, times)]
    render_eval(model, views[0], times[0], bg)          # warm-up
    torch.cuda.synchronize()

    for k in KERNELS:
        k.launches = 0
    torch.cuda.reset_peak_memory_stats()
    res = evaluate(model, views, refs, times, bg)
    launches = {k.name: k.launches for k in KERNELS}
    peak = torch.cuda.max_memory_allocated()

    n = res['count']
    emit({'phase': 'slice', 'requests': res['requests'], 'count': n,
          'fps': res['fps'], 'launches': launches,
          'max_memory_allocated': peak,
          'PSNR_mean_vs_plain': res['PSNR'] / n,
          'SSIM_mean_vs_plain': res['SSIM'] / n})
    for req in res['requests']:
        if req['overflow'] or not 2 ** 19 <= req['num_pairs'] <= 2 ** 20:
            raise AssertionError(f'pairs out of range: {req}')
    # serving runs the forward kernel once a render, the backward never
    expected = {k.name: n if k is tile_blend_fwd else 0 for k in KERNELS}
    if launches != expected:
        raise AssertionError(f'launches {launches} in {n} renders, '
                             f'expected {expected}')
    if not res['PSNR'] / n > 60.0 or not res['SSIM'] / n > 0.9999:
        raise AssertionError('kernel path disagrees with the plain path')
    return launches, sum(r['ms'] for r in res['requests']) / n


def phase_reference(seed, bg):
    """A small model rendered on the card (kernel) and on the CPU (plain)."""
    cfg, rcfg, _ = synthetic_fullscale()
    cfg = cfg._replace(gauss=cfg.gauss._replace(capacity=4096),
                       num_superpoints=64,
                       sk_net=cfg.sk_net._replace(width=64, depth=4,
                                                  skips=(2,)))
    rcfg = rcfg._replace(image_width=96, image_height=80,
                         pair_capacity=2 ** 16)
    flat = random_model_flat(cfg, seed + 1, n_alive=3000, log_scale_mean=-3.0)
    views, times = requests(2, rcfg.image_width, rcfg.image_height, 'cpu')
    errs = []
    for v, t in zip(views, times):
        outs = []
        for dev in ('cuda', 'cpu'):
            model = convert.model_from_flat(flat, cfg, rcfg, device=dev)
            img = render_eval(model, v.to(dev), t, bg.to(dev))['image']
            outs.append(img.cpu())
        if outs[0].shape != (rcfg.image_height, rcfg.image_width, 3):
            raise AssertionError(f'image shape {tuple(outs[0].shape)}')
        if not bool(torch.isfinite(outs[0]).all()):
            raise AssertionError('non-finite pixels')
        errs.append(float((outs[0] - outs[1]).abs().max()))
    emit({'phase': 'reference', 'image': [rcfg.image_height, rcfg.image_width],
          'max_abs_err_cuda_vs_cpu': max(errs), 'tolerance': KERNEL_TOL})
    if max(errs) > KERNEL_TOL:
        raise AssertionError(f'card and CPU renders differ by {max(errs)}')


def fullscale_trainer(cfg, rcfg, train) -> SKGSTrainer:
    """The preset's synthetic scene, made on the card, and the random
    full-width model made trainable, behind the port's trainer."""
    ds = train.dataset
    scene, meta, _ = make_synthetic_scene(
        seed=train.seed, num_links=ds.num_links,
        gauss_per_link=ds.gauss_per_link, num_frames=ds.num_frames,
        h=ds.image_size, w=ds.image_size, background=ds.background,
        pair_capacity=ds.gt_pair_capacity, chunk=rcfg.chunk, device='cuda')
    model = convert.model_from_flat(random_model_flat(cfg, SEED, 80_000),
                                    cfg, rcfg, device='cuda', trainable=True)
    return SKGSTrainer(cfg, rcfg, scene, meta, model, LossWeights(train.loss),
                       seed=train.seed, clip_norm=train.clip_norm,
                       optimizer=train.optimizer, device='cuda')


def first_view(trainer: SKGSTrainer, step: int) -> int:
    """The view ``train_step(step)`` samples first (a fresh sampler of the
    same seed, so the trainer's own draw counter is left alone)."""
    return UniformSampler(trainer.scene.num_views,
                          trainer.sampler.seed).sample(step)


def step_blend_inputs(trainer: SKGSTrainer, step: int):
    """The blend inputs of training step ``step`` and that step's
    cotangents of the tile colour and alpha (the trainer's forward,
    written out to stop at the blend)."""
    cfg, rcfg, model, scene = (trainer.cfg, trainer.rcfg, trainer.model,
                               trainer.scene)
    idx = first_view(trainer, step)
    trainer.loss_w.set_step(step)
    m2d_off = trainer.zero_grads()
    d = forward_deltas(cfg, model, scene.times[idx], cfg.stage_at(step),
                       time_id=scene.time_ids[idx], training=True)
    g = gaussian_inputs(model.gauss_view(), cfg.gauss, d.d_xyz, d.d_rotation,
                        d.d_scaling)
    inp = prepare_blend(g, scene.view(idx), rcfg, model.active_sh_degree,
                        m2d_off)
    color, alpha = blend_tiles(inp.binned, inp.geo, inp.col, rcfg)
    out = assemble_image(color, alpha, rcfg)
    img = composite_background(out['images'], out['opacity'], trainer.bg)
    image = scene.images[idx]
    lw = trainer.loss_w
    if lw.cfg('image').get('method', 'l1') != 'l1':
        raise AssertionError('the preset trains with the l1 image loss')
    loss = lw.w('image') * l1_loss(img, image) \
        + lw.w('ssim') * ssim_loss(img, image)
    g_color, g_alpha = torch.autograd.grad(loss, (color, alpha))
    return (inp, color.detach(), alpha.detach(), g_color.contiguous(),
            g_alpha.contiguous())


def phase_kernel_bwd(trainer: SKGSTrainer, step: int):
    """The backward kernel vs its plain version on a training step's
    inputs and real cotangents."""
    rcfg = trainer.rcfg
    inp, color, alpha, g_color, g_alpha = step_blend_inputs(trainer, step)
    b = inp.binned
    geo, col = inp.geo.detach(), inp.col.detach()
    args = (geo, col, b.sort_gauss, b.tile_start, b.tile_count, color, alpha,
            g_color, g_alpha, rcfg)
    with torch.no_grad():
        g_entry = tile_blend_bwd.launch(*args)
        torch.cuda.synchronize()
        p_entry = blend_backward_plain(*args)
        torch.cuda.synchronize()
        errs = {}
        for name, sl in GROUPS.items():
            scale = float(p_entry[:, sl].abs().max())
            errs[name] = float((g_entry[:, sl] - p_entry[:, sl]).abs().max()) \
                / max(scale, 1e-30)
        finite = bool(torch.isfinite(g_entry).all())
        max_abs = float((g_entry - p_entry).abs().max())
        stats = {}
        blend_forward_plain(geo, col, b.sort_gauss, b.tile_start,
                            b.tile_count, rcfg, stats=stats)
        ms = cuda_ms(lambda: tile_blend_bwd.launch(*args), iters=20, warmup=3)
        plain_ms = cuda_ms(lambda: blend_backward_plain(*args), iters=3,
                           warmup=1)
        reduce_ms = cuda_ms(lambda: rows_from_entries(
            g_entry, b.sort_gauss, geo.shape[0]), iters=20, warmup=3)

    pairs = int(b.num_pairs)
    T, P, ch = rcfg.num_tiles, rcfg.pix_per_tile, col.shape[1]
    evals, adds = stats['evaluations'], stats['adds']
    ops = evals * BLEND_OPS_PER_EVAL + adds * BWD_OPS_PER_ADD
    nbytes = 4 * (geo.numel() + col.numel() + pairs + 2 * T
                  + 2 * T * P * (ch + 1) + g_entry.numel())
    t_ops, t_bytes = ops / PEAK_FP32_FLOPS, nbytes / PEAK_HBM_BYTES
    row = {
        'name': tile_blend_bwd.name, 'route': tile_blend_bwd.route,
        'source': tile_blend_bwd.source, 'replaces': tile_blend_bwd.replaces,
        'max_abs_err': max_abs, 'ms': ms, 'plain_ms': plain_ms,
        'bound_ms': 1e3 * max(t_ops, t_bytes),
        'bound_by': 'operations' if t_ops >= t_bytes else 'bytes',
        'library_ms': None,
    }
    emit({'phase': 'kernel_bwd', 'kernel': row['name'], 'step': step,
          'tiles': T, 'pixels_per_tile': P, 'channels': ch, 'pairs': pairs,
          'entries': int(g_entry.shape[0]), 'evaluations': evals,
          'adds': adds, 'ops': ops, 'bytes': nbytes,
          'err_over_max_by_group': errs, 'max_abs_err': max_abs,
          'tolerance': BWD_TOL, 'finite': finite, 'ms': ms,
          'plain_ms': plain_ms, 'index_add_ms': reduce_ms,
          'bound_ms': row['bound_ms'], 'bound_by': row['bound_by']})
    if not finite or max(errs.values()) > BWD_TOL:
        raise AssertionError(f'backward kernel disagrees with its plain '
                             f'version: {errs} > {BWD_TOL}')
    return row


def view_loss(trainer: SKGSTrainer, step: int, idx: int) -> float:
    trainer.loss_w.set_step(step)
    with torch.no_grad():
        losses = trainer._losses(trainer.cfg.stage_at(step), idx,
                                 trainer.zero_grads())[0]
    return float(sum(losses.values()))


def phase_train(trainer: SKGSTrainer, s0: int):
    """A warm-up step, then N_STEPS steps with the launch counts at 0."""
    idx0 = first_view(trainer, s0)
    loss_before = view_loss(trainer, s0, idx0)
    trainer.train_step(s0)
    torch.cuda.synchronize()
    leaves = trainer.model.leaves()
    watch = ('xyz', 'sp_W', 'sk_deform/layers/0/w', 'global_tr')
    before = {k: leaves[k].detach().clone() for k in watch}

    for k in KERNELS:
        k.launches = 0
    torch.cuda.reset_peak_memory_stats()
    steps = []
    for step in range(s0 + 1, s0 + 1 + N_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = trainer.train_step(step)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        rec = {'step': step, 'ms': dt * 1e3}
        rec.update({k: float(v) for k, v in m.items()})
        rec['overflow'] = bool(m['overflow'])
        steps.append(rec)
        emit({'phase': 'train_step', **rec})
    launches = {k.name: k.launches for k in KERNELS}
    peak = torch.cuda.max_memory_allocated()
    loss_after = view_loss(trainer, s0 + N_STEPS, idx0)
    changed = {k: not torch.equal(before[k], leaves[k].detach())
               for k in watch}
    ms = [r['ms'] for r in steps]
    emit({'phase': 'train', 'steps': N_STEPS, 'first_step': s0 + 1,
          'stage': trainer.cfg.stage_at(s0 + 1), 'launches': launches,
          'ms_mean': sum(ms) / len(ms), 'ms_min': min(ms), 'ms_max': max(ms),
          'max_memory_allocated': peak, 'first_view': idx0,
          'loss_first_view_before': loss_before,
          'loss_first_view_after': loss_after, 'changed': changed})
    for r in steps:
        if not math.isfinite(r['loss']) or r['overflow']:
            raise AssertionError(f'bad training step: {r}')
    for name, count in launches.items():
        if count != N_STEPS:
            raise AssertionError(f'{name} launched {count} times in '
                                 f'{N_STEPS} steps')
    if not all(changed[k] for k in watch[:3]) or changed['global_tr']:
        raise AssertionError(f'leaves moved wrongly: {changed}')
    return launches, sum(ms) / len(ms)


def leaf_grads(trainer: SKGSTrainer, step: int, idx: int):
    """Every leaf's gradient of the step's loss at view ``idx`` (no
    update)."""
    trainer.loss_w.set_step(step)
    m2d_off = trainer.zero_grads()
    losses = trainer._losses(trainer.cfg.stage_at(step), idx, m2d_off)[0]
    sum(losses.values()).backward()
    return {k: p.grad.detach().clone()
            for k, p in trainer.model.leaves().items() if p.grad is not None}


def close_leaves(got, ref, tol):
    """Worst error over the leaf's max magnitude, per leaf; raises when the
    non-finite entries differ or a leaf is off by more than ``tol``."""
    worst = {}
    for name, r in ref.items():
        g = got[name].to(r.device)
        fin = torch.isfinite(r)
        if not torch.equal(fin, torch.isfinite(g)):
            raise AssertionError(f'{name}: non-finite entries differ')
        scale = float(r[fin].abs().max()) if bool(fin.any()) else 0.0
        err = float((g[fin] - r[fin]).abs().max()) if bool(fin.any()) else 0.0
        worst[name] = err / scale if scale > 0 else err
    bad = {k: v for k, v in worst.items() if v > tol}
    if bad:
        raise AssertionError(f'gradients differ beyond {tol}: {bad}')
    return worst


def phase_grad_path(trainer: SKGSTrainer, step: int):
    """One step's leaf gradients through the kernels and through the plain
    forward and backward on the card, same model and sample."""
    plain = SKGSTrainer(trainer.cfg, trainer.rcfg._replace(use_kernel=False),
                        trainer.scene, trainer.meta, trainer.model,
                        trainer.loss_w, opt_state=trainer.opt_state,
                        device='cuda')
    idx = first_view(trainer, step)
    got = leaf_grads(trainer, step, idx)
    ref = leaf_grads(plain, step, idx)
    trainer.zero_grads()
    worst = close_leaves(got, ref, GRAD_PATH_TOL)
    emit({'phase': 'grad_path', 'step': step, 'view': idx,
          'leaves': len(ref), 'tolerance': GRAD_PATH_TOL,
          'worst_err_over_max': max(worst.values()),
          'err_over_max_by_leaf': worst})


def phase_train_reference(seed: int):
    """A small model trained 2 steps on the card (kernels) and on the CPU
    (plain versions): losses 2e-4, gradients 3e-4 of each leaf's max, and
    parameters as in tests/test_torch_train.py (where the gradient exceeds
    1e-3 of the leaf's max: 1e-5 of the leaf plus 1% of its Adam steps;
    elsewhere 2 lr a step, since Adam moves a near-zero gradient entry by
    +-lr whatever its size)."""
    cfg, rcfg, train = synthetic_fullscale()
    cfg = cfg._replace(gauss=cfg.gauss._replace(capacity=4096),
                       num_superpoints=64, num_frames=6,
                       sk_net=cfg.sk_net._replace(width=64, depth=4,
                                                  skips=(2,)))
    rcfg = rcfg._replace(image_width=96, image_height=80,
                         pair_capacity=2 ** 16)
    flat = random_model_flat(cfg, seed + 1, n_alive=3000, log_scale_mean=-3.0)
    s0 = cfg.stages['sk'][0] + 1
    runs = {}
    for dev in ('cuda', 'cpu'):
        scene, meta, _ = make_synthetic_scene(
            seed=seed, num_links=3, gauss_per_link=60, num_frames=6, h=80,
            w=96, pair_capacity=2 ** 15, device=dev)
        model = convert.model_from_flat(flat, cfg, rcfg, device=dev,
                                        trainable=True)
        tr = SKGSTrainer(cfg, rcfg, scene, meta, model,
                         LossWeights(train.loss), device=dev)
        losses, grads = [], []
        for step in (s0, s0 + 1):
            losses.append(float(tr.train_step(step)['loss']))
            grads.append({k: p.grad.detach().cpu().clone()
                          for k, p in model.leaves().items()
                          if p.grad is not None})
        runs[dev] = (losses, grads, convert.model_to_flat(model),
                     tr.lr_trees(s0 + 1))
    (l_c, g_c, f_c, lrs), (l_p, g_p, f_p, _) = runs['cuda'], runs['cpu']
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(l_c, l_p))
    grad_worst = [max(close_leaves(a, b, 3e-4).values())
                  for a, b in zip(g_c, g_p)]
    param_worst = 0.0
    for name, lr in lrs.items():
        got, ref = f_c['params/' + name], f_p['params/' + name]
        g = g_p[-1][name].abs().numpy()
        big = g > 1e-3 * g.max()
        err = np.abs(got - ref)
        scale = float(np.abs(ref).max())
        tol_big = 1e-5 * scale + 0.01 * lr * 2
        tol_all = 2 * lr * 2 + 1e-5 * scale
        param_worst = max(param_worst, float(err[big].max(initial=0.0)) /
                          tol_big, float(err.max()) / tol_all)
    emit({'phase': 'train_reference', 'image': [80, 96], 'steps': 2,
          'loss_cuda': l_c, 'loss_cpu': l_p, 'loss_rel_err': loss_err,
          'grad_worst_err_over_max': grad_worst,
          'param_worst_over_tol': param_worst})
    if loss_err > 2e-4 or param_worst > 1.0:
        raise AssertionError('card and CPU training differ')


def phase_profile_train(trainer: SKGSTrainer, s0: int, step_ms: float):
    """Where a training step's time goes: forward (deltas to loss),
    backward, and Adam + statistics by CUDA events over 3 steps, then a
    torch.profiler window over 3 whole steps; the busy share is their
    device time over the unprofiled step time ``step_ms``."""
    splits = {'forward': [], 'backward': [], 'adam_stats': []}
    for step in range(s0, s0 + 3):
        stage = trainer.cfg.stage_at(step)
        trainer.loss_w.set_step(step)
        idx = first_view(trainer, step)
        lrs = trainer.lr_trees(step)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        torch.cuda.synchronize()
        ev[0].record()
        m2d_off = trainer.zero_grads()
        fwd = trainer._losses(stage, idx, m2d_off)
        total = sum(fwd[0].values())
        ev[1].record()
        total.backward()
        ev[2].record()
        trainer._update(idx, lrs, total, fwd, m2d_off)
        ev[3].record()
        torch.cuda.synchronize()
        for key, a, b in (('forward', 0, 1), ('backward', 1, 2),
                          ('adam_stats', 2, 3)):
            splits[key].append(ev[a].elapsed_time(ev[b]))
    split_ms = {k: sum(v) / len(v) for k, v in splits.items()}

    n_win = 3
    on_dev, wall = profile_window(
        lambda: [trainer.train_step(s0 + 3 + k) for k in range(n_win)])
    busy_ms = sum(dev_us(e) for e in on_dev) * 1e-3
    per_step = busy_ms / n_win
    emit({'phase': 'profile_train', 'split_ms': split_ms,
          'window_steps': n_win, 'window_wall_ms_profiled': wall * 1e3,
          'device_ms_per_step': per_step, 'step_ms': step_ms,
          'device_busy_share': per_step / step_ms,
          'top_device_kernels': top_kernels(on_dev, n_win, 'step')})


def dev_us(e) -> float:
    return getattr(e, 'self_device_time_total', 0.0)


def profile_window(fn):
    """Device-side events (kernels, copies, sets) of ``fn`` under
    torch.profiler, by device time, and the window's wall time. The
    CPU-side op rows carry the same device time again and are left out."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    on_dev = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    on_dev.sort(key=dev_us, reverse=True)
    return on_dev, wall


def top_kernels(on_dev, n, unit: str, k: int = 12):
    return [{'kernel': e.key[:120], f'device_ms_per_{unit}':
             dev_us(e) * 1e-3 / n, f'launches_per_{unit}': e.count / n}
            for e in on_dev[:k]]


def phase_profile(model, views, times, bg, served_ms):
    """Where a request's time goes: stages by CUDA events, then device
    kernels by torch.profiler over a window of whole requests; the busy
    share is their device time over the unprofiled request time
    ``served_ms``."""
    cfg, rcfg, view = model.cfg, model.rcfg, views[0]
    t = torch.tensor(times[0], device=model.device)
    with torch.no_grad():
        d = forward_deltas(cfg, model, t, 'sk')
        g = gaussian_inputs(model.gauss_view(), cfg.gauss, d.d_xyz,
                            d.d_rotation, d.d_scaling)
        pre = preprocess(g, view, rcfg, model.active_sh_degree)
        inp = prepare_blend(g, view, rcfg, model.active_sh_degree)
        tile_color, tile_alpha = blend_tiles(inp.binned, inp.geo, inp.col,
                                             rcfg)

        def assemble_composite():
            img = assemble_image(tile_color, tile_alpha, rcfg)
            return composite_background(img['images'], img['opacity'], bg)

        stages = {
            'forward_deltas': lambda: forward_deltas(cfg, model, t, 'sk'),
            'gaussian_inputs': lambda: gaussian_inputs(
                model.gauss_view(), cfg.gauss, d.d_xyz, d.d_rotation,
                d.d_scaling),
            'preprocess': lambda: preprocess(g, view, rcfg,
                                             model.active_sh_degree),
            'build_tile_lists': lambda: build_tile_lists(pre, rcfg),
            'prepare_blend': lambda: prepare_blend(g, view, rcfg,
                                                   model.active_sh_degree),
            'blend_tiles': lambda: blend_tiles(inp.binned, inp.geo, inp.col,
                                               rcfg),
            'assemble_composite': assemble_composite,
            'render_eval': lambda: render_eval(model, view, times[0], bg),
        }
        stage_ms = {k: cuda_ms(fn, iters=5, warmup=1)
                    for k, fn in stages.items()}

    n_win = 3
    on_dev, wall = profile_window(
        lambda: [render_eval(model, v, tt, bg)
                 for v, tt in zip(views[:n_win], times[:n_win])])
    busy_ms = sum(dev_us(e) for e in on_dev) * 1e-3
    per_req = busy_ms / n_win
    emit({'phase': 'profile', 'stage_ms': stage_ms,
          'window_requests': n_win, 'window_wall_ms_profiled': wall * 1e3,
          'device_ms_per_request': per_req,
          'served_ms_per_request': served_ms,
          'device_busy_share': per_req / served_ms,
          'top_device_kernels': top_kernels(on_dev, n_win, 'request')})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--profile', action='store_true',
                    help='add the stage timing and profiler phase')
    args = ap.parse_args(argv)

    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device (torch.cuda.is_available() is '
              'False); this script runs on the card only', file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    name = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()
    emit({'phase': 'device', 'name': name,
          'count': torch.cuda.device_count(), 'nvidia_smi': smi,
          'torch': torch.__version__, 'cuda': torch.version.cuda})

    t0 = time.perf_counter()
    infos = build_all([k.library for k in KERNELS])
    emit({'phase': 'build', 'seconds': time.perf_counter() - t0,
          'libraries': infos})

    cfg, rcfg, train = synthetic_fullscale()
    flat = random_model_flat(cfg, SEED, n_alive=80_000)
    model = convert.model_from_flat(flat, cfg, rcfg, device='cuda')
    views, times = requests(N_REQUESTS, rcfg.image_width,
                            rcfg.image_height, 'cuda')
    bg = torch.ones(3, device='cuda')

    rows = [phase_kernel(model, views[0], times[0])]
    serve_launches, served_ms = phase_slice(model, views, times, bg)
    phase_reference(SEED, torch.ones(3))

    trainer = fullscale_trainer(cfg, rcfg, train)
    s0 = cfg.stages['sk'][0] + 1
    rows.append(phase_kernel_bwd(trainer, s0))
    train_launches, step_ms = phase_train(trainer, s0)
    s_next = s0 + 1 + N_STEPS
    phase_grad_path(trainer, s_next)
    phase_train_reference(SEED)
    if args.profile:
        phase_profile(model, views, times, bg, served_ms)
        phase_profile_train(trainer, s_next, step_ms)

    for row in rows:
        row['launches'] = train_launches[row['name']]
        row['launches_by_path'] = {
            'serve': serve_launches.get(row['name'], 0),
            'train': train_launches[row['name']]}
    emit({'kernels': rows})
    emit({'phase': 'done', 'seconds': time.perf_counter() - t_start})
    print(smi, flush=True)
    emit({'ok': True, 'device': {'platform': 'gpu', 'kind': name,
                                 'count': torch.cuda.device_count()}})
    return 0


if __name__ == '__main__':
    sys.exit(main())
