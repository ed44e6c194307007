"""The readings that set the sp cell's limit of ``correct``: the control (the
plain reference of ``reference/sp.py`` in the program's place, its
products in TF32, one precision below the configuration's float32 with
TF32 off) and the planted faults 'tile_blanked' and 'deform_skipped'
(``program_sp.fault``: the image with one tile left at the background;
every request served with zero deltas), on the cell's own sizes, over
several seeds.

    python3 bench_port/control_sp.py --workload spgs_dnerf_800.serve_sp --seeds 1,2,3 [--faults] [--seconds 3]

Each line printed is one reading: the numbers that the cell's check
compares, and the ``correct`` that the harness's comparison
(``harness.checks_ok`` over the cell's limits, as a run decides it) gives
them. The control's line also gives the share of the live Gaussians whose
K nearest superpoints in (xyz, hyper) space are not their K nearest in
xyz alone ('knn_changed_share'): what the hyper features of the random
model (``inputs_sp``) change. The benchmark's own runs never run this.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

CHECKOUT = Path(__file__).resolve().parent.parent
# the faults a served sp image can have (program_sp.fault)
FAULTS = ('tile_blanked', 'deform_skipped')


def knn_changed_share(P, k: int) -> float:
    """The share of the live Gaussians whose K nearest set in (xyz, hyper)
    space differs from the xyz-only one."""
    from bench_port.reference import sp as ref_sp
    a = ref_sp.knn(P, k, hyper=True).sort(dim=1).values
    b = ref_sp.knn(P, k, hyper=False).sort(dim=1).values
    changed = (a != b).any(dim=1)[P['alive']]
    return float(changed.float().mean())


def control_serve_sp(cell, seed: int, device) -> dict:
    import torch
    from bench_port import harness, inputs, inputs_sp
    from bench_port.entries import serve as serve_entry
    from bench_port.reference import render as ref_render
    from bench_port.reference import sk as ref_sk
    from bench_port.reference import sp as ref_sp
    cfg, sc = cell.cfg, cell.cfg['scene']
    flat = inputs_sp.model_flat(cfg, seed, device, sc['num_frames'])
    cams = inputs.split_cameras(sc, cell.traffic['split'])
    arrays = inputs.view_arrays(sc, cams['c2w'])
    order = inputs.seeded_order(len(cams['times']), seed)
    bg = torch.tensor(sc['background'], dtype=torch.float32, device=device)
    P = ref_sk.params_from_flat(flat, device)
    gaps = []
    with torch.no_grad():
        for k in order[:cell.traffic['check_requests']]:
            k = int(k)
            cam = ref_render.camera(arrays, k, device)
            t = float(cams['times'][k])
            ref = ref_render.render(ref_sp.gaussians(P, cfg, t), cam,
                                    sc['image_size'], bg)
            low = ref_render.render(
                ref_sp.gaussians(P, cfg, t, mm=ref_sk.tf32_matmul), cam,
                sc['image_size'], bg, mm=ref_sk.tf32_matmul)
            gaps.append(ref_render.image_gap(low, ref))
        share = knn_changed_share(P, cfg['model']['num_knn'])
    checks = serve_entry.image_checks(cell.limits, gaps)
    return {'correct': harness.checks_ok(checks),
            **{k: c['value'] for k, c in checks.items()},
            'knn_changed_share': share}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seeds', required=True)
    ap.add_argument('--faults', action='store_true')
    ap.add_argument('--seconds', type=float, default=3.0)
    ap.add_argument('--device', default='cuda')
    args = ap.parse_args(argv)
    sys.path.insert(0, str(CHECKOUT))
    import torch
    from bench_port import harness
    spec = harness.load_spec(CHECKOUT / 'BENCHMARK.json')
    cell = harness.find_cell(spec, args.workload)
    device = torch.device(args.device)
    for seed in (int(s) for s in args.seeds.split(',')):
        reading = control_serve_sp(cell, seed, device)
        print(json.dumps({'workload': cell.name, 'seed': seed,
                          'reading': 'control', **reading}), flush=True)
        if device.type == 'cuda':
            torch.cuda.empty_cache()
        for fault in FAULTS if args.faults else ():
            run = harness.Run(cell, seed, args.seconds, False, device,
                              fault=fault)
            res = harness.execute(run)
            print(json.dumps({'workload': cell.name, 'seed': seed,
                              'reading': 'fault:' + fault,
                              'correct': res['correct'],
                              **{k: c['value'] for k, c in
                                 res['checks'].items()}}), flush=True)
            if device.type == 'cuda':
                torch.cuda.empty_cache()
    return 0


if __name__ == '__main__':
    sys.exit(main())
