"""Run one cell of the benchmark once and print its result line.

    python3 bench_port/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the card(s) the cell asks
for. The last line of standard output is one JSON object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1`` a
``breakdown``, and last the ``checks``: each number compared beside its
limit, which also end standard error). Without CUDA, or with fewer cards
than the cell asks for, or with a module of JAX or of the JAX package
loaded at the end, it exits with another code than 0 and prints no result.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

CHECKOUT = Path(__file__).resolve().parent.parent
# every build and kernel cache at a fixed path inside the checkout
CACHE = CHECKOUT / 'build' / 'bench_port_cache'


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seed', type=int, required=True)
    ap.add_argument('--seconds', type=float, required=True)
    ap.add_argument('--trace', type=int, choices=(0, 1), default=0)
    ap.add_argument('--no-flat-warmup', action='store_true',
                    help='warm up with one pass over the views only, not '
                         'until the time of a block of requests is flat '
                         '(the steadiness probe compares the two)')
    ap.add_argument('--detail', default=None,
                    help='write the per-request timings here')
    args = ap.parse_args(argv)

    sys.path.insert(0, str(CHECKOUT))
    for var, sub in (('TORCH_EXTENSIONS_DIR', 'torch_extensions'),
                     ('TRITON_CACHE_DIR', 'triton')):
        os.environ[var] = str(CACHE / sub)
    os.environ['USE_FLAX'] = '0'
    os.environ['USE_JAX'] = '0'

    from bench_port import harness
    spec = harness.load_spec(CHECKOUT / 'BENCHMARK.json')
    cell = harness.find_cell(spec, args.workload)
    import torch
    if not torch.cuda.is_available():
        print('torch.cuda.is_available() is False: the benchmark runs on '
              'the card only', file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f'{cell.name} needs {cell.chips} cards, '
              f'{torch.cuda.device_count()} present', file=sys.stderr)
        return 2
    run = harness.Run(cell, args.seed, args.seconds, bool(args.trace),
                      torch.device('cuda', 0), not args.no_flat_warmup)
    result = harness.execute(run)
    found = harness.forbidden_modules()
    if found:
        print('modules of JAX or of the JAX package were loaded: '
              + ', '.join(found), file=sys.stderr)
        return 3
    if args.detail:
        detail = dict(run.detail, flat_warmup=run.flat_warmup,
                      cpus_allowed=len(os.sched_getaffinity(0)),
                      load_average=list(os.getloadavg()), result=result)
        Path(args.detail).parent.mkdir(parents=True, exist_ok=True)
        Path(args.detail).write_text(json.dumps(detail))
    for key, c in result['checks'].items():
        print(f"check {key}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
