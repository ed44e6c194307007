#!/usr/bin/env python3
"""Chip smoke run of the PyTorch/CUDA port (sk_gs_tpu_torch) on one GPU.

    python3 chip_smoke.py [--profile]

Serves a full-width SK-GS model (the ``synthetic_fullscale`` preset: 100,352
Gaussian slots, 512 joints, 400 x 400, random weights from seed 0)
through ``framework.evaluate``, the entry point a user calls, and checks it.
Phases, one JSON line each:

1. device: the card, the device count and its power limit;
2. build: every hand-written kernel compiled from ``sk_gs_tpu_torch/csrc``
   (one nvcc each, started together), with ptxas' register and shared
   memory lines;
3. kernel: each kernel against its plain PyTorch version on the inputs of
   the first request, error and CUDA-event times;
4. slice: the launch counts set to 0, 10 renders served at
   distinct (orbit camera, t), the counts read back; per request the
   synchronised time, the pairs and the overflow flag; PSNR / SSIM against
   the same requests rendered by the plain path;
5. reference: a small model rendered on the card and by the plain path on
   the CPU;
6. with ``--profile`` only: one request's stages timed with CUDA events,
   and a torch.profiler window over a few requests (device time by kernel,
   device busy share).

Then a ``kernels`` line (every ported kernel with its launches on the
served path, error, times and bound), the card's name and power limit as
nvidia-smi prints them, and last ``{"ok": true, "device": {...}}``. Any
failure raises and exits non-zero; with no CUDA device it exits non-zero
before printing any result, and without the port beside it the import
fails.
"""
from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time

import torch

from sk_gs_tpu_torch import convert
from sk_gs_tpu_torch.cuda_build import build_all
from sk_gs_tpu_torch.framework.evaluate import evaluate, render_eval
from sk_gs_tpu_torch.framework.presets import synthetic_fullscale
from sk_gs_tpu_torch.framework.random_model import orbit_view, random_model_flat
from sk_gs_tpu_torch.models.gaussian_splatting import gaussian_inputs
from sk_gs_tpu_torch.models.sk_gs import forward_deltas
from sk_gs_tpu_torch.render import prepare_blend
from sk_gs_tpu_torch.render.binning import build_tile_lists
from sk_gs_tpu_torch.render.blend import assemble_image, blend_forward_plain
from sk_gs_tpu_torch.render.preprocess import preprocess
from sk_gs_tpu_torch.render.render import blend_tiles, composite_background
from sk_gs_tpu_torch.render.tile_kernel import KERNELS, tile_blend_fwd

# published H100 SXM peaks (NVIDIA data sheet): float32 outside the tensor
# cores, and HBM3 bandwidth
PEAK_FP32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12
# operations of one (entry, pixel) evaluation of the forward blend, counting
# only what every evaluation does: dx, dy (2), the quadratic form (9),
# min(power, 0), exp, o * g, min(0.99, .) and the two skip tests (6). A kept
# entry does ~10 more; leaving them out keeps the bound a least time.
BLEND_OPS_PER_EVAL = 17
KERNEL_TOL = 1e-4
SEED = 0
N_REQUESTS = 10


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
    for name, count in launches.items():
        if count != n:
            raise AssertionError(f'{name} launched {count} times in {n} '
                                 'renders')
    if not res['PSNR'] / n > 60.0 or not res['SSIM'] / n > 0.9999:
        raise AssertionError('kernel path disagrees with the plain path')
    return launches, sum(r['ms'] for r in res['requests']) / n


def phase_reference(seed, bg):
    """A small model rendered on the card (kernel) and on the CPU (plain)."""
    cfg, rcfg = synthetic_fullscale()
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

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    n_win = 3
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for v, tt in zip(views[:n_win], times[:n_win]):
            render_eval(model, v, tt, bg)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # device-side events only (kernels, copies, sets): the CPU-side op rows
    # carry the same device time again
    on_dev = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_us = lambda e: getattr(e, 'self_device_time_total', 0.0)
    on_dev.sort(key=dev_us, reverse=True)
    busy_ms = sum(dev_us(e) for e in on_dev) * 1e-3
    per_req = busy_ms / n_win
    emit({'phase': 'profile', 'stage_ms': stage_ms,
          'window_requests': n_win, 'window_wall_ms_profiled': wall * 1e3,
          'device_ms_per_request': per_req,
          'served_ms_per_request': served_ms,
          'device_busy_share': per_req / served_ms,
          'top_device_kernels': [
              {'kernel': e.key[:120], 'device_ms_per_request':
               dev_us(e) * 1e-3 / n_win, 'launches_per_request':
               e.count / n_win} for e in on_dev[:12]]})


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

    cfg, rcfg = synthetic_fullscale()
    flat = random_model_flat(cfg, SEED, n_alive=80_000)
    model = convert.model_from_flat(flat, cfg, rcfg, device='cuda')
    views, times = requests(N_REQUESTS, rcfg.image_width,
                            rcfg.image_height, 'cuda')
    bg = torch.ones(3, device='cuda')

    rows = [phase_kernel(model, views[0], times[0])]
    launches, served_ms = phase_slice(model, views, times, bg)
    for row in rows:
        row['launches'] = launches[row['name']]
    phase_reference(SEED, torch.ones(3))
    if args.profile:
        phase_profile(model, views, times, bg, served_ms)

    emit({'kernels': rows})
    emit({'phase': 'done', 'seconds': time.perf_counter() - t_start})
    print(smi, flush=True)
    emit({'ok': True, 'device': {'platform': 'gpu', 'kind': name,
                                 'count': torch.cuda.device_count()}})
    return 0


if __name__ == '__main__':
    sys.exit(main())
