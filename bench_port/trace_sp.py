"""A profiled window's trace that also ties each device operation to the
host call that launched it, by the correlation id that the profiler gives
both: the card time of the operations launched inside named host ranges,
a CUDA graph's kernels included (they carry the correlation id of the
``cudaGraphLaunch`` that ran them).

``profiled`` is ``trace.profiled`` with this reader in place of
``trace.Trace``; every reading of ``trace.Trace`` stays as it is.
"""
from __future__ import annotations

import bisect
import json
import os
import tempfile
from typing import Callable, Dict, List, Optional

import torch

from . import trace

RUNTIME_CATS = ('cuda_runtime', 'cuda_driver')


class Trace(trace.Trace):
    """``trace.Trace`` with each device operation's launching host call."""

    def __init__(self, events: List[Dict]):
        super().__init__(events)
        self.call_ts: Dict[int, float] = {}
        self.device_corr: List = []
        lo, hi = self.window
        for e in events:
            corr = (e.get('args') or {}).get('correlation')
            if e.get('ph') != 'X' or 'ts' not in e or corr is None:
                continue
            cat, ts = e.get('cat', ''), float(e['ts'])
            if cat in RUNTIME_CATS:
                self.call_ts[corr] = ts
            elif cat in trace.DEVICE_CATS:
                a, b = max(ts, lo), min(ts + float(e.get('dur', 0.0)), hi)
                if b > a:
                    self.device_corr.append((b - a, corr))

    def device_s_in(self, label: str) -> float:
        """Seconds of device operations inside the window whose launching
        host call lies inside a host range named ``label``."""
        spans = sorted(self.ranges.get(label, []))
        starts = [a for a, _ in spans]
        total = 0.0
        for dur, corr in self.device_corr:
            ts = self.call_ts.get(corr)
            if ts is None:
                continue
            i = bisect.bisect_right(starts, ts) - 1
            if i >= 0 and ts <= spans[i][1]:
                total += dur
        return total * 1e-6


def profiled(fn: Callable[[], None], device) -> Optional[Trace]:
    """Run ``fn`` under ``torch.profiler`` inside a 'bench_window' range
    (synchronised at its end) and read the trace."""
    from torch.profiler import ProfilerActivity, profile, record_function
    acts = [ProfilerActivity.CPU]
    if device.type == 'cuda':
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        with record_function(trace.WINDOW):
            fn()
            if device.type == 'cuda':
                torch.cuda.synchronize(device)
    fd, path = tempfile.mkstemp(suffix='.json')
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            data = json.load(f)
    finally:
        os.unlink(path)
    events = data['traceEvents'] if isinstance(data, dict) else data
    return Trace(events)
