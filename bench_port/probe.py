"""The steadiness probe: fresh processes of one cell, in turns under the
harness's two warm-ups ('flat': until the time of a block of requests is
flat; 'once': one pass over the views), with each run's window rate, the
means of its consecutive stretches of requests (drift), the CPUs it was
allowed, and the load average; then each setting's spread (the distance
between the quartiles over the median, Python's ``statistics.quantiles``).

    python3 bench_port/probe.py --workload <name> --runs 6 --settings flat,once --seconds 10 --seed 1000

Run ``i`` of every setting takes seed ``seed + i``.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

CHECKOUT = Path(__file__).resolve().parent.parent
STRETCH = 100


def spread(values):
    if len(values) < 2:
        return None
    q1, q2, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / q2


def one_run(workload, seed, seconds, setting, timeout):
    with tempfile.TemporaryDirectory() as tmp:
        detail = Path(tmp) / 'detail.json'
        cmd = [sys.executable, str(CHECKOUT / 'bench_port' / 'run.py'),
               '--workload', workload, '--seed', str(seed), '--seconds',
               str(seconds), '--trace', '0', '--detail', str(detail)]
        if setting == 'once':
            cmd.append('--no-flat-warmup')
        elif setting != 'flat':
            raise ValueError(f'unknown setting {setting!r}')
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=timeout)
        if proc.returncode != 0 or not detail.exists():
            return {'setting': setting, 'seed': seed,
                    'rc': proc.returncode, 'stderr': proc.stderr[-2000:]}
        d = json.loads(detail.read_text())
    times = d['latencies_s']
    stretches = [statistics.fmean(times[i:i + STRETCH]) * 1e3
                 for i in range(0, len(times) - STRETCH + 1, STRETCH)]
    return {'setting': setting, 'seed': seed, 'rc': 0,
            'metrics': {k: v['value']
                        for k, v in d['result']['metrics'].items()},
            'correct': d['result']['correct'],
            'checks': {k: c['value']
                       for k, c in d['result']['checks'].items()},
            'stretch_ms': stretches, 'warmup_blocks_s': d['warmup_blocks_s'],
            'cpus_allowed': d['cpus_allowed'],
            'load_average': d['load_average']}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--workload', required=True)
    ap.add_argument('--runs', type=int, default=6)
    ap.add_argument('--settings', default='flat,once')
    ap.add_argument('--seconds', type=float, default=10.0)
    ap.add_argument('--seed', type=int, default=1000)
    ap.add_argument('--timeout', type=float, default=600.0)
    args = ap.parse_args(argv)
    settings = args.settings.split(',')
    runs = {s: [] for s in settings}
    for i in range(args.runs):
        # turns: the settings' order alternates run by run
        for s in (settings if i % 2 == 0 else settings[::-1]):
            r = one_run(args.workload, args.seed + i, args.seconds, s,
                        args.timeout)
            runs[s].append(r)
            print(json.dumps(r), flush=True)
    for s, rs in runs.items():
        ok = [r for r in rs if r['rc'] == 0]
        names = sorted({k for r in ok for k in r['metrics']})
        print(json.dumps({'setting': s, 'runs': len(ok), 'spread': {
            k: spread([r['metrics'][k] for r in ok if k in r['metrics']])
            for k in names}}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
