"""Serving SP-GS: ``entries/serve.py``'s closed loop, flat warm-up and
checked sample, each request a render of the random SP-GS model
(``inputs_sp``) at a (camera, t) of the layout's test split through
``framework/evaluate.py:render_eval`` at stage 'sp' (``program_sp``),
ending when its image is complete on the device (a synchronise).

``serve_fps`` is the requests completed over the window's seconds. With
``--trace 1`` the window's untraced part gives the latencies and the rate,
and its last ``profile_units`` requests are profiled (``trace_sp``, which
also puts each device operation down to the host range that launched it).
Once the window has closed, a sample of its requests drawn from the seed is
rendered again by the plain reference (``reference/sp.py``) from the same
inputs, and the widest root mean square gap of a served image is compared
with its limit.
"""
from __future__ import annotations

import time
from types import SimpleNamespace
from typing import Dict

import torch

from .. import (harness, inputs, inputs_sp, program, program_sp, roofline,
                roofline_sp, trace_sp)
from ..reference import render as ref_render
from ..reference import sk as ref_sk
from ..reference import sp as ref_sp
from .serve import FLAT_BLOCK, FLAT_MAX_BLOCKS, FLAT_SHARE, _sync, image_checks


def run(run: harness.Run) -> Dict:
    cfg, tr, dev = run.cell.cfg, run.cell.traffic, run.device
    sc = cfg['scene']
    nf = sc['num_frames']
    flat = inputs_sp.model_flat(cfg, run.seed, dev, nf)
    model = program.build_model(flat, cfg, nf, dev)
    cams = inputs.split_cameras(sc, tr['split'])
    arrays = inputs.view_arrays(sc, cams['c2w'])
    views = program.views(arrays, dev)
    times = [torch.tensor(float(t), device=dev) for t in cams['times']]
    bg = torch.tensor(sc['background'], dtype=torch.float32, device=dev)
    order = inputs.seeded_order(len(views), run.seed)

    def request(i):
        k = int(order[i % len(order)])
        out = program_sp.render_request(model, views[k], times[k], bg)
        _sync(dev)
        return out

    kept: Dict[int, Dict] = {}
    latencies = []
    with program_sp.fault(run.fault):
        # set-up: every view of the cell once (the first captures the
        # deformation's graph), then blocks of requests until a block's
        # time is flat
        t_warm = time.perf_counter()
        for i in range(len(order)):
            request(i)
        blocks = [time.perf_counter() - t_warm]
        if run.flat_warmup:
            for _ in range(FLAT_MAX_BLOCKS):
                t0 = time.perf_counter()
                for i in range(FLAT_BLOCK):
                    request(i)
                blocks.append(time.perf_counter() - t0)
                if len(blocks) > 2 and abs(blocks[-1] - blocks[-2]) \
                        <= FLAT_SHARE * blocks[-2]:
                    break
        per_req = blocks[-1] / (len(order) if len(blocks) == 1
                                else FLAT_BLOCK)
        sample = set(inputs.sample_ids(range(tr['check_pool']),
                                       tr['check_requests'], run.seed))
        profile_n = tr['profile_units'] if run.trace else 0
        untraced_s = max(run.seconds - profile_n * per_req, 0.5 * run.seconds)
        setup_s = harness.process_age_s()

        run.detail['window_start_unix_s'] = time.time()
        t_start = time.perf_counter()
        i, t_end = 0, t_start
        while t_end - t_start < untraced_s:
            t0 = time.perf_counter()
            out = request(i)
            t_end = time.perf_counter()
            latencies.append(t_end - t0)
            if i in sample:
                kept[i] = out
            i += 1
        n_untraced, t_untraced = i, t_end - t_start
        tr_data, profiled = None, []
        if profile_n:
            def window():
                nonlocal i
                for _ in range(profile_n):
                    with torch.profiler.record_function('render_eval'):
                        out = request(i)
                    profiled.append(int(order[i % len(order)]))
                    if i in sample:
                        kept[i] = out
                    i += 1

            with program.annotated():
                tr_data = trace_sp.profiled(window, dev)
    attempted = i
    dev_info = harness.device_info(dev)
    rate = n_untraced / t_untraced

    # the sample, judged after the window, the program's state freed
    served = {j: {'image': o['image'], 'overflow': bool(o['overflow']),
                  'pairs': int(o['num_pairs'])} for j, o in kept.items()}
    del model, views, kept
    if dev.type == 'cuda':
        torch.cuda.empty_cache()
    P = ref_sk.params_from_flat(flat, dev)
    size = sc['image_size']
    gaps, work, spots = [], {}, []
    with torch.no_grad():
        for j in sorted(served):
            k = int(order[j % len(order)])
            g = ref_sp.gaussians(P, cfg, float(cams['times'][k]))
            ref = ref_render.render(g, ref_render.camera(arrays, k, dev),
                                    size, bg)
            gaps.append(ref_render.image_gap(served[j]['image'], ref))
            diff = (served[j]['image'] - ref).abs()
            spots.append([float(diff.max()),
                          float((diff > 1e-3).float().mean())])
        for k in sorted(set(profiled)):
            stats = {}
            g = ref_sp.gaussians(P, cfg, float(cams['times'][k]))
            ref_render.render(g, ref_render.camera(arrays, k, dev), size, bg,
                              stats=stats)
            work[k] = stats
    overflow = sum(s['overflow'] for s in served.values())
    checks = dict(image_checks(run.cell.limits, gaps),
                  overflowed_requests={'value': overflow, 'limit': 0})
    run.detail.update({'setup_s': setup_s, 'warmup_blocks_s': blocks,
                       'latencies_s': latencies, 'image_rmse': gaps,
                       'max_abs_and_share_over_1e-3': spots,
                       'pairs': [s['pairs'] for s in served.values()]})

    res = {'correct': bool(gaps) and all(g == g for g in gaps),
           'attempted': attempted, 'failed': 0, 'device': dev_info,
           'checks': checks}
    if not run.trace:
        res['metrics'] = harness.e2e_metrics(
            run, {'setup_s': setup_s, 'serve_fps': rate})
        return res

    widths = inputs.widths(cfg)
    blender = cfg['model'].get('is_blender', True)
    rows, tiles = widths['capacity'] + 1, ((size + 15) // 16) ** 2
    fwd = [roofline.fwd_blend(work[k], rows, tiles) for k in profiled]
    reading = SimpleNamespace(
        trace=tr_data, units=len(profiled),
        latencies_s=latencies, unit_s=1.0 / rate,
        flops_per_unit=sum(roofline_sp.request_flops(widths, f['ops'],
                                                     blender)
                           for f in fwd) / max(len(fwd), 1),
        fwd_bound_s=sum(roofline.bound_s(f['ops'], f['bytes']) for f in fwd),
        deform_bound_s=roofline_sp.deform_bound_s(widths, blender))
    res['metrics'] = harness.layer_metrics(run, reading)
    res['device'].update({'busy_s': tr_data.busy_s,
                          'window_s': tr_data.window_s})
    res['breakdown'] = {
        'device_ops': tr_data.device_ops(),
        'idle_gaps': tr_data.idle_gaps(('render_eval', 'forward_deltas'))}
    return res
