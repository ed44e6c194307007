"""Reading a ``torch.profiler`` trace of a run's profiled sub-window: the
device's busy time, the kernels by name, the longest idle gaps by what the
host was doing, and the kernel launches inside named host ranges.

The host ranges are ``record_function`` annotations: the harness's own
around each request ('render_eval') and the whole sub-window
('bench_window'), and the one that ``program.annotated`` puts around the
port's deformation ('forward_deltas'). The trace is exported to a
temporary file, read and deleted.
"""
from __future__ import annotations

import bisect
import json
import os
import tempfile
from typing import Callable, Dict, List, Optional, Tuple

import torch

DEVICE_CATS = ('kernel', 'gpu_memcpy', 'gpu_memset')
LAUNCH_NAMES = ('cudaLaunchKernel', 'cudaLaunchKernelExC', 'cuLaunchKernel',
                'cuLaunchKernelEx', 'cudaLaunchCooperativeKernel')
WINDOW = 'bench_window'
TOP = 10
NAME_CHARS = 80


class Trace:
    """The events of one profiled window, times in microseconds."""

    def __init__(self, events: List[Dict]):
        self.ranges: Dict[str, List[Tuple[float, float]]] = {}
        self.device: List[Tuple[float, float, str]] = []
        self.launches: List[float] = []
        for e in events:
            if e.get('ph') != 'X' or 'ts' not in e:
                continue
            ts, dur = float(e['ts']), float(e.get('dur', 0.0))
            cat, name = e.get('cat', ''), e.get('name', '')
            if cat in DEVICE_CATS:
                self.device.append((ts, ts + dur, name))
            elif cat in ('cuda_runtime', 'cuda_driver') and \
                    name in LAUNCH_NAMES:
                self.launches.append(ts)
            elif cat == 'user_annotation':
                self.ranges.setdefault(name, []).append((ts, ts + dur))
        win = self.ranges.get(WINDOW, [])
        if win:
            self.window = (min(a for a, _ in win), max(b for _, b in win))
        else:
            self.window = (0.0, 0.0)
        self.device.sort()

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) * 1e-6

    def busy_intervals(self) -> List[Tuple[float, float]]:
        """The union of the device's operations inside the window."""
        lo, hi = self.window
        merged: List[List[float]] = []
        for a, b, _ in self.device:
            a, b = max(a, lo), min(b, hi)
            if b <= a:
                continue
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        return [(a, b) for a, b in merged]

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) * 1e-6

    def kernels(self, part: str) -> List[float]:
        """Durations (s) of the device operations whose name holds
        ``part``."""
        return [(b - a) * 1e-6 for a, b, n in self.device if part in n]

    def count(self, label: str) -> int:
        return len(self.ranges.get(label, []))

    def launches_in(self, label: str) -> int:
        """Kernel launches made inside the host ranges named ``label``."""
        spans = sorted(self.ranges.get(label, []))
        if not spans:
            return 0
        starts = [a for a, _ in spans]
        n = 0
        for ts in self.launches:
            i = bisect.bisect_right(starts, ts) - 1
            if i >= 0 and ts <= spans[i][1]:
                n += 1
        return n

    def device_ops(self) -> List[List]:
        """The device operations that took the most time: [name, s]."""
        total: Dict[str, float] = {}
        for a, b, n in self.device:
            total[n] = total.get(n, 0.0) + (b - a) * 1e-6
        top = sorted(total.items(), key=lambda kv: -kv[1])[:TOP]
        return [[n[:NAME_CHARS], s] for n, s in top]

    def idle_gaps(self, labels) -> List[List]:
        """The longest gaps between device operations inside the window,
        each named by the innermost of the host ranges ``labels`` that
        holds its middle ('harness' when none does)."""
        lo, hi = self.window
        edges, last = [], lo
        for a, b in self.busy_intervals():
            if a > last:
                edges.append((last, a))
            last = max(last, b)
        if hi > last:
            edges.append((last, hi))
        edges.sort(key=lambda g: g[0] - g[1])
        out = []
        for a, b in edges[:TOP]:
            mid = 0.5 * (a + b)
            best, width = 'harness', float('inf')
            for label in labels:
                for s, e in self.ranges.get(label, []):
                    if s <= mid <= e and e - s < width:
                        best, width = label, e - s
            out.append([best, (b - a) * 1e-6])
        return out


def profiled(fn: Callable[[], None], device) -> Optional[Trace]:
    """Run ``fn`` under ``torch.profiler`` inside a 'bench_window' range
    (synchronised at its end) and read the trace."""
    from torch.profiler import ProfilerActivity, profile, record_function
    acts = [ProfilerActivity.CPU]
    if device.type == 'cuda':
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        with record_function(WINDOW):
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
