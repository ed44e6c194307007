"""``serve.deform_graph_share`` on synthetic traces: every profiled request
a graph replay reads 1.0, one of two 0.5, none 0.0, and a trace without the
port's 'sk.request' spans (or no trace) reads None.

    python -m pytest bench_port/tests -q
"""
from __future__ import annotations

import sys
from pathlib import Path
from types import SimpleNamespace

import pytest

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE.parents[1]))

from bench_port import harness  # noqa: E402
from bench_port.trace import Trace  # noqa: E402

NAME = 'serve.deform_graph_share'
# two requests, times in us: render_eval around sk.request around sk.deform
REQUESTS = [(10, 50), (55, 95)]


def trace(replays: int, port_spans: bool = True) -> Trace:
    spans = {'bench_window': [(0, 100)], 'render_eval': REQUESTS}
    if port_spans:
        spans['sk.request'] = [(a + 1, b - 5) for a, b in REQUESTS]
        spans['sk.deform'] = [(a + 2, a + 8) for a, _ in REQUESTS]
        spans['sk.deform.replay'] = [(a + 3, a + 6)
                                     for a, _ in REQUESTS[:replays]]
    events = [{'ph': 'X', 'cat': 'user_annotation', 'name': n, 'ts': a,
               'dur': b - a} for n, rs in spans.items() for a, b in rs]
    events.append({'ph': 'X', 'cat': 'kernel', 'name': 'k', 'ts': 20,
                   'dur': 30})
    return Trace(events)


@pytest.mark.parametrize('replays,want', [(2, 1.0), (1, 0.5), (0, 0.0)])
def test_share_of_requests_replayed(replays, want):
    mod = harness.load_metric(NAME)
    assert mod.read(SimpleNamespace(trace=trace(replays))) == want


def test_none_without_the_port_spans():
    mod = harness.load_metric(NAME)
    assert mod.read(SimpleNamespace(trace=trace(0, port_spans=False))) is None
    assert mod.read(SimpleNamespace(trace=None)) is None
