#!/usr/bin/env python3
"""Chip smoke run of the PyTorch/CUDA port (sk_gs_tpu_torch) on one GPU.

    python3 chip_smoke.py [--profile]

Drives the port's three paths at full width (the ``synthetic_fullscale``
preset: 100,352 Gaussian slots, 512 joints, 400 x 400, random weights from
seed 0) through the entry points a user calls, and checks them: serving
through ``framework.evaluate`` (80,000 alive); training the ``sk`` stage
through ``framework.trainer.SKGSTrainer.train_step`` on the preset's
synthetic scene, made on the card (the ``tile`` schedule, kernels #1/#2);
and training the ``init`` family with adaptive density control on the
``chunk`` schedule (kernels #3/#4). Phases, one JSON line each:

1. device: the card, the device count and its power limit;
2. build: every hand-written kernel compiled from ``sk_gs_tpu_torch/csrc``
   (one nvcc each, started together), with ptxas' register and shared
   memory lines;
3. kernel: the forward kernel (#1) against its plain PyTorch version on
   the inputs of the first request, error, the kernel's device time by
   torch.profiler, the wrapper's and the plain version's by CUDA events,
   and the blocks resident per SM;
4. kernel_chunk: the chunk schedule's forward kernel (#3) against its plain
   version on the same request binned in chunks, as 3 reports #1, with the
   chunk layout and #1's device time on the same splats;
5. slice: the launch counts set to 0, 10 renders served at
   distinct (orbit camera, t), the counts read back; per request the
   synchronised time, the pairs and the overflow flag; PSNR / SSIM against
   the same requests rendered by the plain path;
6. reference: a small model rendered on the card and by the plain path on
   the CPU;
7. kernel_bwd: the backward kernel (#2) against its plain version on the
   first training step's inputs and cotangents: the gradient rows of the
   depth-ordered rows, error per column group, the dummy row's zeros, the
   difference between two launches (the atomics' order), the kernel's
   device time by torch.profiler (the in-kernel reduction included), the
   wrapper's (its zeroing of the rows included) and the plain version's by
   CUDA events, the bytes and bound, the blocks resident per SM, and the
   longest and mean tile list;
8. train: one warm-up step, the launch counts set to 0, 10 steps, the
   counts read back; per step the synchronised time and the metrics; the
   loss on the first step's view before and after; the peak memory;
9. grad_path: one step's leaf gradients through the kernels against the
   plain forward and backward on the card, on the same sample;
10. train_reference: a small model trained 2 steps on the card and on the
   CPU (plain versions), losses, gradients and parameters compared;
11. kernel_chunk_bwd: the chunk schedule's backward kernel (#4) against its
   plain version on a real ``init`` step's cotangents (the populated start
   of 13, at its first step, before it trains), as 7 reports #2;
12. grad_path_init: that step's leaf gradients through kernels #3 and #4
   against the plain chunk route on the card;
13. init_train: the launch counts set to 0, then three starts of the init
   family on the chunk schedule, the counts read back: the flagship start
   (2,000 points, ``init_from_pcd``, ``init_model`` from seed 0; steps 1-3
   and 99-101, densify and prune after step 100), a populated start (a
   random model with 80,000 alive and the warp nets; steps 2995-3004,
   densify, prune and opacity reset after step 3000 with 20,352 dead
   slots) and a full start (99,000 alive, steps 2998-3001: the event after
   step 3000 has fewer dead slots than selected rows and drops some); per
   step the synchronised time and the metrics, per event its counts, per
   start the mean step time before, at and after its event; the peak
   memory;
14. train_reference_init: a small init-family model trained 2 steps across
   a densify event on the card and on the CPU, compared as in 10;
15. with ``--profile`` only: one request's, one ``sk`` step's and one
   ``init`` step's (the flagship start's) stages timed with CUDA events,
   and torch.profiler windows over a few requests and steps (device time
   by kernel, device busy share against the same trainer's unprofiled
   steps, the pairs of the window's steps, and any ``index_add_`` kernel in
   a step's window); and for each of those two trainers, its backward
   kernel's device time on one step's inputs, by torch.profiler, alone
   (warm, and after a write that evicts L2) and inside that very step, with
   the step's pairs and tile lists, and on the tile schedule its time with
   every tile's list cut to its first 64, 250 and 1,000 entries; and
   profile_fwd / profile_chunk_fwd: each forward kernel's device time by
   torch.profiler, whole and with the lists cut the same way, its blocks
   per SM, the lists, the share of their entries with o < 1/255, and the
   shares of the plain version's evaluations by outcome (skipped by power,
   alpha below 1/255, added, stopping), for #1
   on the first request and on the ``sk`` step that profile_bwd takes, for
   #3 on the first request binned in chunks and on the populated start's
   first step (before it trains).

Then a ``kernels`` line (every ported kernel with its launches on its own
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
from sk_gs_tpu_torch.framework.presets import (flagship_point_cloud,
                                               synthetic_fullscale)
from sk_gs_tpu_torch.framework.random_model import orbit_view, random_model_flat
from sk_gs_tpu_torch.framework.trainer import SKGSTrainer
from sk_gs_tpu_torch.models.gaussian_splatting import (gaussian_inputs,
                                                       init_from_pcd)
from sk_gs_tpu_torch.models.losses import LossWeights, l1_loss, ssim_loss
from sk_gs_tpu_torch.models.sk_gs import forward_deltas, init_model
from sk_gs_tpu_torch.render import prepare_blend
from sk_gs_tpu_torch.render.binning import build_tile_lists, num_chunks
from sk_gs_tpu_torch.render.blend import (ALPHA_MIN, OUTCOMES, assemble_image,
                                          chunk_waves)
from sk_gs_tpu_torch.render.preprocess import preprocess
from sk_gs_tpu_torch.render.render import blend_tiles, composite_background
from sk_gs_tpu_torch.render.tile_kernel import (KERNELS, chunk_blend_bwd,
                                                chunk_blend_fwd,
                                                tile_blend_bwd, tile_blend_fwd)

# published H100 SXM peaks (NVIDIA data sheet): float32 outside the tensor
# cores, and HBM3 bandwidth
PEAK_FP32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12
# float32 instructions a second (132 SMs x 128 lanes x 1.98 GHz): the rate
# of the separate multiplies and adds that --fmad=false builds, where the
# data sheet's 67 TFLOP/s counts one FMA as two operations
PEAK_FP32_INSTR = 33.5e12
# operations of the forward blend (#1, #3) on what its evaluations come to
# (the plain version's ``stats``): every evaluation dx, dy (2), the
# quadratic form (9) and the skip and pre-test tests (2); a kept one (added
# or stopping) min(power, 0), exp, o * g, min(0.99, .), the keep test,
# T (1 - alpha) and the stop test (8); an added one w and the colour sums
# (1 + 2 ch). exp counted once and only where the entry is kept: a least
# count, since the pre-test also lets through the evaluations within its
# margin below the keep threshold.
FWD_OPS_PER_EVAL = 13
FWD_OPS_PER_KEPT = 8
# operations of one (entry, pixel) evaluation that the backward's forward
# walk does (it has no pre-test): dx, dy (2), the quadratic form (9),
# min(power, 0), exp, o * g, min(0.99, .) and the two skip tests (6)
BLEND_OPS_PER_EVAL = 17
# operations the backward adds for an (entry, pixel) pair that adds to the
# pixel: 1 - alpha, T (1 - alpha), w, B (2 ch - 1), the running sum (2),
# 1 / (1 - alpha), g_alpha (7), g_power, the six conic / position /
# opacity terms (18), w g_color (ch), and the 6 + ch sums over the pixels
# (at ch = 3; counted per adding pair, a least count)
BWD_OPS_PER_ADD = 49
KERNEL_TOL = 1e-4
BWD_TOL = 3e-4          # of each column group's max magnitude
# two launches of a backward kernel on the same inputs differ only in the
# order in which the tiles' atomics land on a row: rounding, far below this
# (of each column group's max magnitude)
RERUN_TOL = 1e-5
GRAD_PATH_TOL = 1e-3    # of each leaf's max magnitude
SEED = 0
N_REQUESTS = 10
N_STEPS = 10
# the profile phases time a kernel with every tile's list cut to these
LIST_CUTS = (64, 250, 1000)
# the init family's starts: (name, live slots of a random start or None
# for the flagship's point cloud, steps). An event follows step 100
# (densify + prune) and step 3000 (densify + prune + opacity reset); the
# 'full' start leaves fewer dead slots than rows to clone or split, so the
# event drops some.
INIT_STARTS = (('flagship', None, (1, 2, 3, 99, 100, 101)),
               ('populated', 80_000, tuple(range(2995, 3005))),
               ('full', 99_000, (2998, 2999, 3000, 3001)))
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


def bound(ops: int, nbytes: int, peak: float = PEAK_FP32_FLOPS):
    """(bound_ms, bound_by): the larger of the operations at the fp32 rate
    ``peak`` and the bytes at the HBM rate."""
    t_ops, t_bytes = ops / peak, nbytes / PEAK_HBM_BYTES
    return 1e3 * max(t_ops, t_bytes), ('operations' if t_ops >= t_bytes
                                       else 'bytes')


def fwd_ops(stats: dict, ch: int) -> int:
    """Operations of a forward blend whose evaluations came to ``stats``."""
    return (FWD_OPS_PER_EVAL * stats['evaluations']
            + FWD_OPS_PER_KEPT * (stats['adds'] + stats['stops'])
            + (1 + 2 * ch) * stats['adds'])


def schedule_kernels(inp, rcfg):
    """(forward kernel, backward kernel, the blend arguments they share
    before the pixel tensors, metadata bytes) of ``rcfg``'s schedule."""
    b = inp.binned
    rows = (inp.geo.detach(), inp.col.detach(), b.sort_gauss)
    if rcfg.chunked:
        meta = (b.chunk_tile, b.chunk_start_flag, b.chunk_src, b.chunk_valid)
        return (chunk_blend_fwd, chunk_blend_bwd, rows + meta,
                4 * 4 * num_chunks(rcfg))
    return (tile_blend_fwd, tile_blend_bwd, rows + (b.tile_start, b.tile_count),
            4 * 2 * rcfg.num_tiles)


def kernel_row(kernel, max_abs_err, ms, plain_ms, ops, nbytes) -> dict:
    """A kernel's entry of the ``kernels`` line (launches are added last)."""
    bound_ms, bound_by = bound(ops, nbytes)
    return {'name': kernel.name, 'route': kernel.route,
            'source': kernel.source, 'replaces': kernel.replaces,
            'max_abs_err': max_abs_err, 'ms': ms, 'plain_ms': plain_ms,
            'bound_ms': bound_ms, 'bound_by': bound_by, 'library_ms': None}


def chunk_layout(b) -> dict:
    """What the chunk schedule's metadata holds: chunks, the ones with
    entries, and the longest chain of chunks of one tile."""
    return {'chunks': int(b.chunk_valid.shape[0]),
            'live_chunks': int((b.chunk_valid > 0).sum()),
            'max_chunks_per_tile': int(torch.ceil(
                b.tile_count.float() / b.chunk_valid.max().clamp(min=1)).max())}


def request_inputs(model, view, t, rcfg):
    """The blend inputs of the request (view, t) binned for ``rcfg``."""
    cfg = model.cfg
    with torch.no_grad():
        d = forward_deltas(cfg, model, torch.tensor(t, device=model.device),
                           'sk')
        g = gaussian_inputs(model.gauss_view(), cfg.gauss, d.d_xyz,
                            d.d_rotation, d.d_scaling)
        return prepare_blend(g, view, rcfg, model.active_sh_degree)


def phase_kernel(model, view, t, schedule: str = 'tile'):
    """The schedule's forward kernel (#1 or #3) against its plain version
    on the first request's binned inputs; on the chunk schedule also kernel
    #1 on the same splats."""
    rcfg = model.rcfg._replace(schedule=schedule)
    with torch.no_grad():
        inp = request_inputs(model, view, t, rcfg)
        b = inp.binned
        kernel, _, args, meta_bytes = schedule_kernels(inp, rcfg)
        args = (*args, rcfg)
        color, alpha = kernel.launch(*args)
        extra = chunk_layout(b) if rcfg.chunked else {}
        stats = {}
        p_color, p_alpha = kernel.plain(*args, stats=stats)
        torch.cuda.synchronize()
        err_c = float((color - p_color).abs().max())
        err_a = float((alpha - p_alpha).abs().max())
        above = int(((color - p_color).abs().amax(-1) > 3e-5).sum()
                    + ((alpha - p_alpha).abs() > 3e-5).sum())
        finite = bool(torch.isfinite(color).all() and torch.isfinite(alpha).all())
        ms = device_ms(kernel, lambda: kernel.launch(*args))
        wrapper_ms = cuda_ms(lambda: kernel.launch(*args), iters=20, warmup=3)
        plain_ms = cuda_ms(lambda: kernel.plain(*args), iters=3, warmup=1)
        if rcfg.chunked:
            tile_args = (*schedule_kernels(inp, model.rcfg)[2], model.rcfg)
            extra['tile_kernel_ms_same_splats'] = device_ms(
                tile_blend_fwd, lambda: tile_blend_fwd.launch(*tile_args))

    pairs = int(b.num_pairs)
    T, P, ch = rcfg.num_tiles, rcfg.pix_per_tile, inp.col.shape[1]
    evals = stats['evaluations']
    ops = fwd_ops(stats, ch)
    nbytes = (4 * pairs + meta_bytes + 4 * inp.geo.numel()
              + 4 * inp.col.numel() + 4 * T * P * (ch + 1))
    row = kernel_row(kernel, max(err_c, err_a), ms, plain_ms, ops, nbytes)
    emit({'phase': 'kernel' if schedule == 'tile' else 'kernel_chunk',
          'kernel': row['name'], 'chunk': rcfg.chunk, 'tiles': T,
          'pixels_per_tile': P, 'channels': ch, 'pairs': pairs,
          'evaluations': evals, 'adds': stats['adds'],
          'stops': stats['stops'], 'ops': ops, 'bytes': nbytes,
          'max_abs_err_color': err_c, 'max_abs_err_alpha': err_a,
          'values_above_3e-5': above, 'tolerance': KERNEL_TOL,
          'finite': finite, 'ms': ms, 'wrapper_ms': wrapper_ms,
          'plain_ms': plain_ms,
          'blocks_per_sm': kernel.blocks_per_sm(rcfg, ch), **extra,
          'bound_ms': row['bound_ms'], 'bound_by': row['bound_by'],
          'bound_ms_unfused': bound(ops, nbytes, PEAK_FP32_INSTR)[0]})
    if not finite or max(err_c, err_a) > KERNEL_TOL:
        raise AssertionError(f'{kernel.name} disagrees with its plain '
                             f'version: colour {err_c}, alpha {err_a} > '
                             f'{KERNEL_TOL}')
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


def fullscale_scene(rcfg, train):
    """The preset's synthetic scene, made on the card."""
    ds = train.dataset
    return make_synthetic_scene(
        seed=train.seed, num_links=ds.num_links,
        gauss_per_link=ds.gauss_per_link, num_frames=ds.num_frames,
        h=ds.image_size, w=ds.image_size, background=ds.background,
        pair_capacity=ds.gt_pair_capacity, chunk=rcfg.chunk, device='cuda')


def fullscale_trainer(cfg, rcfg, train, model=None) -> SKGSTrainer:
    """The preset's synthetic scene and ``model`` (by default the random
    full-width model with 80,000 alive, made trainable) behind the port's
    trainer."""
    scene, meta, _ = fullscale_scene(rcfg, train)
    if model is None:
        model = convert.model_from_flat(random_model_flat(cfg, SEED, 80_000),
                                        cfg, rcfg, device='cuda',
                                        trainable=True)
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
    stage = cfg.stage_at(step)
    d = forward_deltas(cfg, model, scene.times[idx], stage,
                       time_id=scene.time_ids[idx], training=True)
    g = trainer.render_inputs(trainer.family(stage), d)
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
    """The trainer's schedule's backward kernel (#2 or #4) against its plain
    version on a training step's inputs and real cotangents: the gradient
    rows [R, 6 + ch] of the depth-ordered rows. Its time is the kernel's
    device time (its own reduction included); the wrapper's, its zeroing
    of the rows included, is given beside it."""
    rcfg = trainer.rcfg
    inp, color, alpha, g_color, g_alpha = step_blend_inputs(trainer, step)
    b = inp.binned
    fwd, kernel, args, meta_bytes = schedule_kernels(inp, rcfg)
    geo, col = args[:2]
    with torch.no_grad():
        bwd_args = (*args, color, alpha, g_color, g_alpha, rcfg)
        g_rows = kernel.launch(*bwd_args)
        again = kernel.launch(*bwd_args)
        p_rows = kernel.plain(*bwd_args)
        torch.cuda.synchronize()
        errs, rerun = {}, {}
        for name, sl in GROUPS.items():
            scale = max(float(p_rows[:, sl].abs().max()), 1e-30)
            errs[name] = float((g_rows[:, sl] - p_rows[:, sl]).abs().max()) \
                / scale
            rerun[name] = float((again[:, sl] - g_rows[:, sl]).abs().max()) \
                / scale
        finite = bool(torch.isfinite(g_rows).all())
        dummy_zero = not bool(g_rows[-1].any() or again[-1].any())
        max_abs = float((g_rows - p_rows).abs().max())
        stats = {}
        fwd.plain(*args, rcfg, stats=stats)
        ms = device_ms(kernel, lambda: kernel.launch(*bwd_args))
        wrapper_ms = cuda_ms(lambda: kernel.launch(*bwd_args), iters=20,
                             warmup=3)
        plain_ms = cuda_ms(lambda: kernel.plain(*bwd_args), iters=3, warmup=1)
        extra = chunk_layout(b) if rcfg.chunked else {}

    pairs = int(b.num_pairs)
    T, P, ch = rcfg.num_tiles, rcfg.pix_per_tile, col.shape[1]
    evals, adds = stats['evaluations'], stats['adds']
    ops = evals * BLEND_OPS_PER_EVAL + adds * BWD_OPS_PER_ADD
    # each input read once (the rows, the live entries' ids, the metadata,
    # the tiles' colours, alphas and their cotangents), g_rows written once
    nbytes = (4 * (geo.numel() + col.numel() + pairs) + meta_bytes
              + 4 * (2 * T * P * (ch + 1) + g_rows.numel()))
    row = kernel_row(kernel, max_abs, ms, plain_ms, ops, nbytes)
    counts = b.tile_count[b.tile_count > 0].float()
    emit({'phase': 'kernel_bwd' if not rcfg.chunked else 'kernel_chunk_bwd',
          'kernel': row['name'], 'step': step,
          'stage': trainer.cfg.stage_at(step), 'tiles': T,
          'pixels_per_tile': P, 'channels': ch, 'pairs': pairs,
          'rows': int(g_rows.shape[0]), 'evaluations': evals,
          'adds': adds, 'ops': ops, 'bytes': nbytes,
          'err_over_max_by_group': errs, 'max_abs_err': max_abs,
          'tolerance': BWD_TOL, 'finite': finite,
          'dummy_row_zero': dummy_zero,
          'rerun_diff_over_max_by_group': rerun,
          'rerun_tolerance': RERUN_TOL, 'ms': ms, 'wrapper_ms': wrapper_ms,
          'plain_ms': plain_ms,
          'blocks_per_sm': kernel.blocks_per_sm(rcfg, ch),
          'sms': torch.cuda.get_device_properties(0).multi_processor_count,
          'nonempty_tiles': int(counts.numel()),
          'tile_list_longest': int(counts.max()),
          'tile_list_mean': float(counts.mean()), **extra,
          'bound_ms': row['bound_ms'], 'bound_by': row['bound_by'],
          'bound_ms_unfused': bound(ops, nbytes, PEAK_FP32_INSTR)[0]})
    if not finite or max(errs.values()) > BWD_TOL:
        raise AssertionError(f'{kernel.name} disagrees with its plain '
                             f'version: {errs} > {BWD_TOL}')
    if not dummy_zero or max(rerun.values()) > RERUN_TOL:
        raise AssertionError(f'{kernel.name}: dummy row zero {dummy_zero}, '
                             f'two launches differ by {rerun}')
    return row


def phase_profile_bwd(trainer: SKGSTrainer, step: int, phase: str):
    """The trainer's backward kernel (#2 or #4) on step ``step``'s inputs,
    its device time a launch by torch.profiler three ways: alone, launches
    back to back (warm caches); alone, each launch after a write that
    evicts L2; and inside that very step (the step reads the same inputs:
    the state is unchanged and the forward is deterministic; its pairs are
    checked). On the tile schedule also with every tile's list cut to its
    first LIST_CUTS entries: where in the lists the time goes."""
    rcfg = trainer.rcfg
    inp, color, alpha, g_color, g_alpha = step_blend_inputs(trainer, step)
    b = inp.binned
    _, kernel, args, _ = schedule_kernels(inp, rcfg)
    bwd_args = (*args, color, alpha, g_color, g_alpha, rcfg)

    # twice the H100's 50 MB L2
    flush = torch.empty(25 << 20, dtype=torch.float32, device='cuda')
    with torch.no_grad():
        warm = device_ms(kernel, lambda: kernel.launch(*bwd_args))
        cold = device_ms(kernel, lambda: (flush.fill_(1.0),
                                          kernel.launch(*bwd_args)))
        clipped = {}
        for n in (LIST_CUTS if not rcfg.chunked else ()):
            cut = clip_lists(bwd_args, rcfg, n)
            clipped[n] = device_ms(kernel, lambda: kernel.launch(*cut))
    del flush
    metrics = []
    in_step = device_ms(kernel, lambda: metrics.append(
        trainer.train_step(step)), launches=1)
    pairs, step_pairs = int(b.num_pairs), int(metrics[0]['num_pairs'])
    counts = b.tile_count[b.tile_count > 0].float()
    emit({'phase': phase, 'kernel': kernel.name, 'step': step,
          'pairs': pairs, 'step_pairs': step_pairs,
          'nonempty_tiles': int(counts.numel()),
          'tile_list_longest': int(counts.max()),
          'tile_list_mean': float(counts.mean()),
          'device_ms_warm': warm, 'device_ms_cold_l2': cold,
          'device_ms_in_step': in_step, 'ms_lists_clipped_to': clipped})
    if pairs != step_pairs:
        raise AssertionError(f'{phase}: the step read other inputs '
                             f'({step_pairs} pairs against {pairs})')


def clip_lists(args, rcfg, n: int) -> list:
    """Blend arguments (geo, col, sort_gauss, the schedule's metadata, ...)
    with every tile's list cut to its first ``n`` entries: tile_count
    clamped on the tile schedule; on the chunk schedule each chunk's valid
    count cut at n less the entries of its tile's earlier chunks."""
    cut = list(args)
    if rcfg.chunked:
        room = n - chunk_waves(cut[4]) * rcfg.chunk   # chunk_start_flag
        cut[6] = torch.clamp(torch.minimum(cut[6].long(), room),
                             min=0).to(torch.int32)  # chunk_valid
    else:
        cut[4] = torch.clamp(cut[4], max=n)             # tile_count
    return cut


def listed_rows(args, rcfg) -> torch.Tensor:
    """The rows that the entries of the tiles' lists read, from the blend
    arguments (geo, col, sort_gauss, the schedule's metadata)."""
    src, valid = (args[5], args[6]) if rcfg.chunked else (args[3], args[4])
    src, valid = src.long(), valid.long()
    offs = torch.arange(int(valid.max()), device=src.device)
    listed = offs[None, :] < valid[:, None]
    return args[2].long()[(src[:, None] + offs[None, :])[listed]]


def fwd_case(kernel, inp, rcfg) -> dict:
    """A forward kernel (#1 or #3) on one input: its device time a launch,
    whole and with every tile's list cut to its first LIST_CUTS entries;
    the lists; the share of their entries with o < 1/255 (never kept); and
    what becomes of the plain version's evaluations, as shares of them."""
    b = inp.binned
    args = schedule_kernels(inp, rcfg)[2]
    low_o = float((args[0][listed_rows(args, rcfg), 5] < ALPHA_MIN)
                  .float().mean())
    stats = {}
    with torch.no_grad():
        kernel.plain(*args, rcfg, stats=stats)
        ms = device_ms(kernel, lambda: kernel.launch(*args, rcfg))
        clipped = {}
        for n in LIST_CUTS:
            cut = clip_lists(args, rcfg, n)
            clipped[n] = device_ms(kernel, lambda: kernel.launch(*cut, rcfg))
    counts = b.tile_count[b.tile_count > 0].float()
    evals = stats['evaluations']
    return {'pairs': int(b.num_pairs), 'nonempty_tiles': int(counts.numel()),
            'tile_list_longest': int(counts.max()),
            'tile_list_mean': float(counts.mean()),
            'share_entries_o_below_alpha_min': low_o, 'evaluations': evals,
            'outcome_shares': {k: stats[k] / evals for k in OUTCOMES},
            'ms': ms, 'ms_lists_clipped_to': clipped}


def phase_profile_fwd(phase: str, kernel, rcfg, cases: dict):
    """A forward kernel on each of ``cases`` (name -> ``fwd_case``): where
    in the lists its time goes, and what its evaluations come to."""
    emit({'phase': phase, 'kernel': kernel.name,
          'blocks_per_sm': kernel.blocks_per_sm(rcfg, 3), 'cases': cases})


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
    # the tile schedule: kernels #1 and #2 once a step, #3 and #4 never
    expected = {k.name: N_STEPS if k in (tile_blend_fwd, tile_blend_bwd)
                else 0 for k in KERNELS}
    if launches != expected:
        raise AssertionError(f'launches {launches} in {N_STEPS} steps, '
                             f'expected {expected}')
    if not all(changed[k] for k in watch[:3]) or changed['global_tr']:
        raise AssertionError(f'leaves moved wrongly: {changed}')
    return launches


def leaf_grads(trainer: SKGSTrainer, step: int, idx: int):
    """Every leaf's gradient of the step's loss at view ``idx`` (no
    update)."""
    trainer.loss_w.set_step(step)
    m2d_off = trainer.zero_grads()
    losses = trainer._losses(trainer.cfg.stage_at(step), idx, m2d_off)[0]
    sum(losses.values()).backward()
    return {k: p.grad.detach().clone()
            for k, p in trainer.model.leaves().items() if p.grad is not None}


def close_leaves(got, ref, tol, scale_of=None):
    """Worst error over the leaf's max magnitude, per leaf; raises when the
    non-finite entries differ or a leaf is off by more than ``tol``.
    ``scale_of`` maps a leaf to another leaf whose max magnitude is its
    scale instead (a leaf whose gradient is zero but for rounding)."""
    scale_of = scale_of or {}
    worst = {}
    for name, r in ref.items():
        g = got[name].to(r.device)
        fin = torch.isfinite(r)
        if not torch.equal(fin, torch.isfinite(g)):
            raise AssertionError(f'{name}: non-finite entries differ')
        s_ref = ref[scale_of.get(name, name)]
        scale = float(s_ref[torch.isfinite(s_ref)].abs().max()) \
            if bool(fin.any()) else 0.0
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


def params_over_tol(f_c, f_p, grads, lrs, steps: int, scale_of=None):
    """The worst parameter error over its bound and its leaf
    (tests/test_torch_train.py's bounds): where the gradient exceeded 1e-3
    of the leaf's max at every step (``grads``, one dict a step), 1e-5 of
    the leaf plus 1% of its Adam steps; elsewhere 2 lr a step, since Adam
    moves an entry whose gradient is near zero at any one step by up to
    +-lr at that step. ``scale_of`` as for ``close_leaves``."""
    scale_of = scale_of or {}
    worst, worst_leaf = 0.0, None
    for name, lr in lrs.items():
        got, ref = f_c['params/' + name], f_p['params/' + name]
        big = np.ones(got.shape, bool)
        for step_grads in grads:
            g = step_grads[name].abs().numpy()
            top = float(step_grads[scale_of.get(name, name)].abs().max())
            big &= g > 1e-3 * top
        err = np.abs(got - ref)
        scale = float(np.abs(ref).max())
        tol_big = 1e-5 * scale + 0.01 * lr * steps + 1e-30
        tol_all = 2 * lr * steps + 1e-5 * scale + 1e-30
        leaf = max(float(err[big].max(initial=0.0)) / tol_big,
                   float(err.max()) / tol_all)
        if leaf > worst:
            worst, worst_leaf = leaf, name
    return worst, worst_leaf


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
    param_worst, worst_leaf = params_over_tol(f_c, f_p, g_p, lrs, 2)
    # the same bounds with the last step's gradient alone deciding which
    # entries are settled (reported beside the rule above, not checked)
    last_worst, last_leaf = params_over_tol(f_c, f_p, g_p[-1:], lrs, 2)
    emit({'phase': 'train_reference', 'image': [80, 96], 'steps': 2,
          'loss_cuda': l_c, 'loss_cpu': l_p, 'loss_rel_err': loss_err,
          'grad_worst_err_over_max': grad_worst,
          'param_worst_over_tol': param_worst, 'param_worst_leaf': worst_leaf,
          'param_worst_over_tol_last_step_rule': last_worst,
          'param_worst_leaf_last_step_rule': last_leaf})
    if loss_err > 2e-4 or param_worst > 1.0:
        raise AssertionError('card and CPU training differ')


def flagship_model(cfg, rcfg, train, train_times):
    """The flagship start: 2,000 points from the preset's seed,
    ``init_from_pcd`` and ``init_model``."""
    pts, cols = flagship_point_cloud(train)
    base = init_from_pcd(pts, cols, cfg.gauss, device='cuda')
    return init_model(cfg, rcfg, base, train_times, seed=train.seed,
                      device='cuda')


def populated_model(cfg, rcfg, n_alive: int):
    """A random model with ``n_alive`` live slots and the warp nets, in the
    init stage (SH degree 0, as an init run has it)."""
    model = convert.model_from_flat(
        random_model_flat(cfg, SEED, n_alive), cfg, rcfg, device='cuda',
        trainable=True)
    model.active_sh_degree.zero_()
    return model


def run_init_steps(trainer: SKGSTrainer, start: str, steps):
    """Steps ``steps`` of ``trainer``: a record per step and per event."""
    records, events = [], []
    for step in steps:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = trainer.train_step(step)
        torch.cuda.synchronize()
        rec = {'start': start, 'step': step,
               'stage': trainer.cfg.stage_at(step),
               'ms': (time.perf_counter() - t0) * 1e3,
               'n_alive': int(trainer.model.alive.sum())}
        rec.update({k: float(m[k]) for k in ('loss', 'rgb', 'ssim', 'c_net',
                                              'num_pairs', 'n_bad_grad',
                                              'n_vis', 'psnr')})
        rec['overflow'] = bool(m['overflow'])
        records.append(rec)
        emit({'phase': 'init_step', **rec})
        if trainer.last_event:
            ev = {'start': start, 'after_step': step,
                  **{k: int(v) for k, v in trainer.last_event.items()}}
            events.append(ev)
            emit({'phase': 'init_event', **ev})
    return records, events


def phase_init_train(cfg, rcfg, train, profile: bool = False):
    """The init family at full width on the chunk schedule. First kernel #4
    and the gradient path on the populated start's first step (before it
    trains), and with ``profile`` kernel #3's ``fwd_case`` there; then,
    with the counts at 0, the steps of every start."""
    scene, meta, _ = fullscale_scene(rcfg, train)
    trainers = {}
    for start, n_alive, _ in INIT_STARTS:
        model = (flagship_model(cfg, rcfg, train, meta.train_times)
                 if n_alive is None else populated_model(cfg, rcfg, n_alive))
        trainers[start] = SKGSTrainer(
            cfg, rcfg, scene, meta, model, LossWeights(train.loss),
            seed=train.seed, clip_norm=train.clip_norm,
            optimizer=train.optimizer, device='cuda')
    s0 = INIT_STARTS[1][2][0]
    row = phase_kernel_bwd(trainers['populated'], s0)
    phase_grad_path_init(trainers['populated'], s0)
    fwd_profile = (fwd_case(chunk_blend_fwd, step_blend_inputs(
        trainers['populated'], s0)[0], rcfg) if profile else None)

    for k in KERNELS:
        k.launches = 0
    torch.cuda.reset_peak_memory_stats()
    records, events = [], []
    for start, _, steps in INIT_STARTS:
        recs, evs = run_init_steps(trainers[start], start, steps)
        records += recs
        events += evs
    launches = {k.name: k.launches for k in KERNELS}
    peak = torch.cuda.max_memory_allocated()
    n = len(records)
    ms = [r['ms'] for r in records]
    emit({'phase': 'init_train', 'steps': n, 'launches': launches,
          'ms_mean': sum(ms) / n, 'ms_mean_without_first': sum(ms[1:]) / (n - 1),
          'ms_min': min(ms), 'ms_max': max(ms),
          'ms_by_start': ms_by_start(records, events),
          'max_memory_allocated': peak, 'events': events})
    for r in records:
        if not math.isfinite(r['loss']) or r['overflow']:
            raise AssertionError(f'bad init step: {r}')
    expected = {k.name: n if k in (chunk_blend_fwd, chunk_blend_bwd) else 0
                for k in KERNELS}
    if launches != expected:
        raise AssertionError(f'launches {launches} in {n} init steps, '
                             f'expected {expected}')
    after = {(e['start'], e['after_step']): e for e in events}
    due = {('flagship', 100), ('populated', 3000), ('full', 3000)}
    if set(after) != due \
            or not all(after[k].get('opacity_reset') for k in due
                       if k[1] == 3000) \
            or min(e['n_cloned'] + e['n_split'] for e in events) == 0 \
            or after[('full', 3000)]['n_dropped'] == 0:
        raise AssertionError(f'adaptive control did not run as due: {events}')
    return launches, trainers, row, fwd_profile


def ms_by_start(records, events) -> dict:
    """Each start's mean step time and pairs before its event, the event
    step's (the step and the densify / prune / reset after it), and after."""
    out = {}
    for start, _, steps in INIT_STARTS:
        ev = next((e['after_step'] for e in events if e['start'] == start),
                  steps[-1] + 1)
        recs = [r for r in records if r['start'] == start]
        parts = {'before': [r for r in recs if r['step'] < ev],
                 'event_step': [r for r in recs if r['step'] == ev],
                 'after': [r for r in recs if r['step'] > ev]}
        out[start] = {
            name: {'steps': len(rs),
                   'ms_mean': sum(r['ms'] for r in rs) / len(rs),
                   'pairs_mean': sum(r['num_pairs'] for r in rs) / len(rs)}
            for name, rs in parts.items() if rs}
    return out


def phase_grad_path_init(trainer: SKGSTrainer, step: int):
    """One ``init`` step's leaf gradients through kernels #3 and #4 and
    through the plain chunk route on the card, same model and sample."""
    plain = SKGSTrainer(trainer.cfg, trainer.rcfg._replace(use_kernel=False),
                        trainer.scene, trainer.meta, trainer.model,
                        trainer.loss_w, opt_state=trainer.opt_state,
                        device='cuda')
    idx = first_view(trainer, step)
    got = leaf_grads(trainer, step, idx)
    ref = leaf_grads(plain, step, idx)
    trainer.zero_grads()
    # the init family renders every Gaussian at one isotropic scale, so the
    # covariance does not depend on the rotation: its gradient is rounding
    # noise, held against the position gradient's scale instead
    worst = close_leaves(got, ref, GRAD_PATH_TOL, scale_of={'rotation': 'xyz'})
    nets = sorted({k.split('/')[0] for k in ref if '/' in k})
    emit({'phase': 'grad_path_init', 'step': step,
          'stage': trainer.cfg.stage_at(step), 'view': idx,
          'leaves': len(ref), 'nets': nets, 'tolerance': GRAD_PATH_TOL,
          'worst_err_over_max': max(worst.values()),
          'max_abs_grad': {k: float(ref[k].abs().max())
                           for k in ('rotation', 'xyz')},
          'err_over_max_by_leaf': worst})
    if not {'sp_deform', 'canonical'} <= set(nets):
        raise AssertionError(f'the warp nets got no gradient: {nets}')


def phase_train_reference_init(seed: int):
    """A small init-family model trained on the card (kernels #3/#4) and
    on the CPU (plain versions) for steps 100 and 101, across the densify /
    prune event after step 100; compared as train_reference compares, and
    ``alive`` exactly. Both draw the split noise from a CPU generator."""
    cfg, rcfg, train = synthetic_fullscale()
    cfg = cfg._replace(gauss=cfg.gauss._replace(capacity=4096),
                       num_superpoints=64, num_frames=6,
                       net=cfg.net._replace(depth=4, width=64),
                       sk_net=cfg.sk_net._replace(width=64, depth=4,
                                                  skips=(2,)))
    rcfg = rcfg._replace(image_width=96, image_height=80,
                         pair_capacity=2 ** 16, schedule='chunk')
    pts, cols = flagship_point_cloud(train)
    runs = {}
    for dev in ('cuda', 'cpu'):
        scene, meta, _ = make_synthetic_scene(
            seed=seed, num_links=3, gauss_per_link=60, num_frames=6, h=80,
            w=96, pair_capacity=2 ** 15, device=dev)
        base = init_from_pcd(pts, cols, cfg.gauss, device=dev)
        model = init_model(cfg, rcfg, base, meta.train_times, seed=seed,
                           device=dev)
        tr = SKGSTrainer(cfg, rcfg, scene, meta, model,
                         LossWeights(train.loss), seed=seed, device=dev)
        losses, grads, events = [], [], []
        for step in (100, 101):
            losses.append(float(tr.train_step(step)['loss']))
            grads.append({k: p.grad.detach().cpu().clone()
                          for k, p in model.leaves().items()})
            events.append({k: int(v) for k, v in tr.last_event.items()})
        runs[dev] = (losses, grads, convert.model_to_flat(model),
                     tr.lr_trees(101), events)
    (l_c, g_c, f_c, lrs, ev_c), (l_p, g_p, f_p, _, ev_p) = (runs['cuda'],
                                                            runs['cpu'])
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(l_c, l_p))
    # the rotation gradient is rounding noise here (see grad_path_init)
    iso = {'rotation': 'xyz'}
    grad_worst = [max(close_leaves(a, b, 3e-4, scale_of=iso).values())
                  for a, b in zip(g_c, g_p)]
    param_worst, worst_leaf = params_over_tol(f_c, f_p, g_p, lrs, 2,
                                              scale_of=iso)
    same_alive = bool(np.array_equal(f_c['alive'], f_p['alive']))
    emit({'phase': 'train_reference_init', 'image': [80, 96], 'steps': 2,
          'loss_cuda': l_c, 'loss_cpu': l_p, 'loss_rel_err': loss_err,
          'events_cuda': ev_c, 'events_cpu': ev_p, 'alive_equal': same_alive,
          'n_alive': int(f_c['alive'].sum()),
          'grad_worst_err_over_max': grad_worst,
          'param_worst_over_tol': param_worst, 'param_worst_leaf': worst_leaf})
    if loss_err > 2e-4 or param_worst > 1.0 or not same_alive \
            or ev_c != ev_p or not ev_c[0]:
        raise AssertionError('card and CPU init training differ')


def phase_profile_train(trainer: SKGSTrainer, s0: int,
                        phase: str = 'profile_train'):
    """Where a training step's time goes: forward (deltas to loss),
    backward, and Adam + statistics by CUDA events over 3 steps; then 3
    whole steps timed unprofiled (synchronised, host clock) and the next 3
    under torch.profiler. The busy share is the window's device time a step
    over that unprofiled step time of the same trainer."""
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
    timed = []
    for step in range(s0 + 3, s0 + 3 + n_win):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.train_step(step)
        torch.cuda.synchronize()
        timed.append((time.perf_counter() - t0) * 1e3)
    step_ms = sum(timed) / n_win
    w0 = s0 + 3 + n_win
    metrics = []
    on_dev, wall = profile_window(
        lambda: [metrics.append(trainer.train_step(w0 + k))
                 for k in range(n_win)])
    busy_ms = sum(dev_us(e) for e in on_dev) * 1e-3
    per_step = busy_ms / n_win
    emit({'phase': phase, 'split_ms': split_ms, 'split_steps': [s0, s0 + 2],
          'timed_steps': [s0 + 3, w0 - 1], 'timed_ms': timed,
          'window_steps': [w0, w0 + n_win - 1],
          'window_pairs': [int(m['num_pairs']) for m in metrics],
          'n_alive': int(trainer.model.alive.sum()),
          'window_wall_ms_profiled': wall * 1e3,
          'device_ms_per_step': per_step, 'step_ms': step_ms,
          'device_busy_share': per_step / step_ms,
          'top_device_kernels': top_kernels(on_dev, n_win, 'step'),
          'index_add_kernels': top_kernels(
              [e for e in on_dev if is_index_add(e.key)], n_win, 'step')})


def dev_us(e) -> float:
    return getattr(e, 'self_device_time_total', 0.0)


def device_ms(kernel, fn, launches: int = 20) -> float:
    """``kernel``'s mean device time a launch, by torch.profiler, over the
    launches it records of ``launches`` calls of ``fn`` (each launching it
    once; the profiler may miss a few), after 3 unprofiled calls. Host time
    between launches does not count, as it does in CUDA events around a
    wrapper that takes longer on the host than the kernel on the card."""
    for _ in range(3 if launches > 1 else 0):
        fn()
    on_dev, _ = profile_window(lambda: [fn() for _ in range(launches)])
    found = [e for e in on_dev if kernel.name + '_kernel<' in e.key]
    if len(found) != 1 or found[0].count < 1:
        raise AssertionError(f'the profiler saw {kernel.name} as '
                             f'{[(e.key, e.count) for e in found]}')
    return dev_us(found[0]) * 1e-3 / found[0].count


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


def is_index_add(key: str) -> bool:
    """PyTorch's CUDA index_add_ kernels (indexFuncSmallIndex /
    indexFuncLargeIndex), by name."""
    return 'indexfunc' in key.lower() or 'index_add' in key.lower()


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
    chunk_row = phase_kernel(model, views[0], times[0], schedule='chunk')
    serve_launches, served_ms = phase_slice(model, views, times, bg)
    phase_reference(SEED, torch.ones(3))

    trainer = fullscale_trainer(cfg, rcfg, train)
    s0 = cfg.stages['sk'][0] + 1
    rows.append(phase_kernel_bwd(trainer, s0))
    train_launches = phase_train(trainer, s0)
    s_next = s0 + 1 + N_STEPS
    phase_grad_path(trainer, s_next)
    phase_train_reference(SEED)

    # the init family on the chunk schedule
    init_rcfg = rcfg._replace(schedule='chunk')
    init_launches, init_trainers, chunk_bwd_row, init_fwd_case = \
        phase_init_train(cfg, init_rcfg, train, args.profile)
    rows += [chunk_row, chunk_bwd_row]
    phase_train_reference_init(SEED)
    if args.profile:
        phase_profile(model, views, times, bg, served_ms)
        phase_profile_train(trainer, s_next)
        # kernel #1 on the inputs of the step that profile_bwd then trains
        s_prof = s_next + 9
        sk_case = fwd_case(tile_blend_fwd,
                           step_blend_inputs(trainer, s_prof)[0], rcfg)
        phase_profile_bwd(trainer, s_prof, 'profile_bwd')
        phase_profile_fwd('profile_fwd', tile_blend_fwd, rcfg, {
            'request_0': fwd_case(tile_blend_fwd, request_inputs(
                model, views[0], times[0], rcfg), rcfg),
            f'sk_step_{s_prof}': sk_case})
        phase_profile_fwd('profile_chunk_fwd', chunk_blend_fwd, init_rcfg, {
            'request_0': fwd_case(chunk_blend_fwd, request_inputs(
                model, views[0], times[0], init_rcfg), init_rcfg),
            f'init_populated_step_{INIT_STARTS[1][2][0]}': init_fwd_case})
        # the flagship start past its first event
        s_init = INIT_STARTS[0][2][-1] + 1
        phase_profile_train(init_trainers['flagship'], s_init,
                            phase='profile_train_init')
        phase_profile_bwd(init_trainers['flagship'], s_init + 9,
                          'profile_chunk_bwd')

    paths = {'serve': serve_launches, 'train': train_launches,
             'train_init': init_launches}
    for row in rows:
        own = 'train_init' if row['name'].startswith('chunk') else 'train'
        row['launches'] = paths[own][row['name']]
        row['launches_by_path'] = {k: v.get(row['name'], 0)
                                   for k, v in paths.items()}
    emit({'kernels': rows})
    emit({'phase': 'done', 'seconds': time.perf_counter() - t_start})
    print(smi, flush=True)
    emit({'ok': True, 'device': {'platform': 'gpu', 'kind': name,
                                 'count': torch.cuda.device_count()}})
    return 0


if __name__ == '__main__':
    sys.exit(main())
