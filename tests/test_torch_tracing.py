"""The port's layer spans (``sk_gs_tpu_torch/utils/tracing.py``) on the CPU
at a toy size, and the benchmark's readers of them
(``bench_port/metrics/serve.*.py``) on a hand-made trace.

Without a profiler no span makes a profiler call; under ``torch.profiler``
a served request makes each serve span once, nested as the layers nest, a
training step its ``sk.train.*`` spans; images and losses do not move with
the profiler on; the garbage collector's hook, ``host_read`` and
``cli.train --profile`` do what they say. The readers are held to values
worked out by hand, the three idle metrics to the whole idle time, and a
trace without the port's spans (the parent's) reads None.
"""
import ast
import contextlib
import gc
import json
import re
import sys
from pathlib import Path

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from sk_gs_tpu_torch import convert
from sk_gs_tpu_torch.cli import train as cli_train
from sk_gs_tpu_torch.data.synthetic import make_synthetic_scene
from sk_gs_tpu_torch.framework import presets
from sk_gs_tpu_torch.framework.evaluate import render_eval
from sk_gs_tpu_torch.framework.random_model import (orbit_view,
                                                    random_model_flat)
from sk_gs_tpu_torch.framework.trainer import SKGSTrainer
from sk_gs_tpu_torch.models.losses import LossWeights
from sk_gs_tpu_torch.utils import tracing
from test_torch_mesh import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
METRICS = ROOT / 'bench_port' / 'metrics'
sys.path.insert(0, str(ROOT))
from bench_port import harness  # noqa: E402
from bench_port.trace import Trace  # noqa: E402

FRAMES = 4
SERVE_NEST = {'sk.deform': 'sk.request', 'sk.deform.fk': 'sk.deform',
              'sk.deform.lbs': 'sk.deform', 'sk.preprocess': 'sk.request',
              'sk.binning': 'sk.request', 'sk.blend': 'sk.request'}
TRAIN_SPANS = ('sk.train.events', 'sk.train.forward', 'sk.train.losses',
               'sk.train.backward', 'sk.train.update')
HARNESS_RANGES = ('render_eval', 'bench_window', 'forward_deltas')
NEW_METRICS = ('serve.deform_host_ms', 'serve.preprocess_host_ms',
               'serve.binning_host_ms', 'serve.blend_host_ms',
               'serve.sync_wait_ms', 'serve.deform_idle_ms',
               'serve.render_idle_ms', 'serve.unspanned_idle_ms',
               'serve.gc_host_ms', 'serve.fk_launches',
               'serve.lbs_launches', 'serve.render_launches',
               'serve.host_syncs', 'serve.deform_graph_share')


def toy_cfg():
    """The flagship's model cut to 512 slots, 16 joints and 2 x 32 nets,
    rendered at 64 x 48."""
    cfg, rcfg, train = presets.synthetic_fullscale()
    cfg = cfg._replace(
        gauss=cfg.gauss._replace(capacity=512), num_superpoints=16,
        net=cfg.net._replace(depth=2, width=32),
        sk_net=cfg.sk_net._replace(depth=2, width=32, skips=()),
        num_frames=FRAMES)
    rcfg = rcfg._replace(image_width=64, image_height=48,
                         pair_capacity=2 ** 14)
    return cfg, rcfg, train


def toy_model(trainable=False):
    cfg, rcfg, _ = toy_cfg()
    flat = random_model_flat(cfg, 3, n_alive=400, log_scale_mean=-3.0)
    return convert.model_from_flat(flat, cfg, rcfg, device='cpu',
                                   trainable=trainable)


def serve(model, n=1):
    """``n`` requests of stage 'sk'; returns the last image."""
    rcfg = model.rcfg
    bg = torch.ones(3)
    for i in range(n):
        view = orbit_view(0.7 * i, rcfg.image_width, rcfg.image_height,
                          device='cpu')
        out = render_eval(model, view, torch.tensor(0.3 + 0.1 * i), bg, 'sk')
    return out['image']


def toy_trainer():
    """A trainer at its first ``sk`` step on a 48 x 64 synthetic scene."""
    cfg, rcfg, train = toy_cfg()
    scene, meta, _ = make_synthetic_scene(
        seed=0, num_links=2, gauss_per_link=40, num_frames=FRAMES, h=48,
        w=64, pair_capacity=2 ** 14, chunk=rcfg.chunk, device='cpu')
    return SKGSTrainer(cfg, rcfg, scene, meta, toy_model(trainable=True),
                       LossWeights(train.loss), skeleton_initialized=True,
                       device='cpu')


def sk_step(trainer):
    return trainer.cfg.stages['sk'][0] + 1


def ranges(prof):
    """{name: [(start, end)]} of the profile's spans, in start order."""
    out = {}
    for e in prof.events():
        if e.name in tracing.SPANS:
            out.setdefault(e.name, []).append((e.time_range.start,
                                               e.time_range.end))
    return {k: sorted(v) for k, v in out.items()}


def inside(inner, outer):
    return outer[0] <= inner[0] and inner[1] <= outer[1]


@pytest.fixture
def no_profiler_calls(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError('a profiler call with no profiler running')
    monkeypatch.setattr(torch.profiler, 'record_function', refuse)
    monkeypatch.setattr(torch.autograd.profiler, 'record_function', refuse)


# ------------------------------------------------------------- the spans


@pytest.mark.parametrize('path', ['serve', 'train_step', 'gc'])
def test_no_profiler_no_profiler_call(no_profiler_calls, path):
    assert not tracing.recording()
    if path == 'serve':
        serve(toy_model())
    elif path == 'train_step':
        tr = toy_trainer()
        tr.train_step(sk_step(tr))
    else:
        gc.collect()
        assert tracing._gc_open == []


def test_serve_spans_once_a_request_and_nested():
    model = toy_model()
    serve(model)                                 # warm
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        serve(model, n=2)
    got = ranges(prof)
    requests = got['sk.request']
    assert len(requests) == 2
    for name, parent in SERVE_NEST.items():
        assert len(got[name]) == 2, name
        for span, outer in zip(got[name], got[parent]):
            assert inside(span, outer), (name, parent)
    order = ('sk.deform', 'sk.preprocess', 'sk.binning', 'sk.blend')
    for i in range(2):
        ends = [got[n][i] for n in order]
        assert all(a[1] <= b[0] for a, b in zip(ends, ends[1:]))
    assert 'sk.sync' not in got


def test_train_step_spans():
    tr = toy_trainer()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        tr.train_step(sk_step(tr))
    got = ranges(prof)
    assert len(got['sk.train.events']) == 2
    for name in TRAIN_SPANS[1:]:
        assert len(got[name]) == 1, name
    fwd, = got['sk.train.forward']
    for name in ('sk.deform', 'sk.deform.fk', 'sk.deform.lbs',
                 'sk.preprocess', 'sk.binning', 'sk.blend'):
        assert len(got[name]) == 1 and inside(got[name][0], fwd), name
    seq = [got[n][0] for n in TRAIN_SPANS[1:]]
    assert all(a[1] <= b[0] for a, b in zip(seq, seq[1:]))
    assert 'sk.request' not in got


@pytest.mark.parametrize('path', ['serve', 'train_step'])
def test_outputs_equal_with_and_without_profiler(path):
    outs = []
    for on in (False, True):
        with profile(activities=[ProfilerActivity.CPU]) if on else \
                contextlib.nullcontext():
            if path == 'serve':
                outs.append([serve(toy_model(), n=2)])
            else:
                tr = toy_trainer()
                m = tr.train_step(sk_step(tr))
                outs.append([m['loss'], m['psnr'],
                             *(p.detach().clone() for p in
                               tr.model.leaves().values())])
    for a, b in zip(*outs):
        assert torch.equal(a, b)


def test_gc_hook_makes_a_range_while_recording():
    assert tracing._gc_hook in gc.callbacks
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        gc.collect()
    assert len(ranges(prof).get('py.gc', [])) >= 1
    assert tracing._gc_open == []


@pytest.mark.parametrize('dtype', [torch.float32, torch.int64, torch.bool])
def test_host_read_is_cpu(dtype):
    x = (torch.arange(6) % 3).to(dtype)
    assert torch.equal(tracing.host_read(x), x.cpu())
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        got = tracing.host_read(x.sum())
    assert got.device.type == 'cpu' and len(ranges(prof)['sk.sync']) == 1


def test_span_names():
    """Every span of the package is named in ``SPANS`` and every name is
    used; none collides with the benchmark's own ranges; each serve span,
    'sk.sync' and 'py.gc' has a benchmark metric that reads it, and each
    train span is named in ``cli.train``'s ``--profile`` help."""
    used = set()
    for f in (ROOT / 'sk_gs_tpu_torch').rglob('*.py'):
        used |= set(re.findall(r"\bspan\('([^']+)'\)", f.read_text()))
    used |= {'py.gc'}
    assert used == set(tracing.SPANS)
    assert not set(tracing.SPANS) & set(HARNESS_RANGES)
    readers = ''.join(p.read_text() for p in METRICS.glob('serve.*.py'))
    for name in set(SERVE_NEST) | {'sk.request', 'sk.sync', 'py.gc'}:
        assert f"'{name}'" in readers, name
    for name in TRAIN_SPANS:
        assert name in cli_train.__doc__, name


def test_graph_span_names():
    """The deformation's CUDA graph has its two spans, beside 'sk.deform'
    (``models/deform_graph.py``), and a benchmark metric reads the replay."""
    spans = tracing.SPANS
    for name in ('sk.deform.replay', 'sk.deform.capture'):
        assert name in spans and spans.index(name) > spans.index('sk.deform')
    reader = (METRICS / 'serve.deform_graph_share.py').read_text()
    assert "'sk.deform.replay'" in reader


def test_cli_train_profile_window(tmp_path):
    cli_train.main(['-c', 'configs/synthetic_smoke.yaml', '--device', 'cpu',
                    '--set', f'output_dir={tmp_path}',
                    f'dataset.root={tmp_path}', '--steps', '2',
                    '--profile', '1:2'])
    path = tmp_path / 'synthetic_smoke' / 'profile_1_2.json'
    data = json.loads(path.read_text())
    events = data['traceEvents'] if isinstance(data, dict) else data
    names = [e.get('name') for e in events
             if e.get('cat') == 'user_annotation']
    for name in TRAIN_SPANS[1:] + ('sk.deform', 'sk.binning', 'sk.blend'):
        assert names.count(name) == 2, name
    assert names.count('sk.train.events') == 4


@pytest.mark.parametrize('text', ['2:1', '0:3', '3', 'a:b'])
def test_cli_train_profile_window_refused(text):
    with pytest.raises(SystemExit):
        cli_train.parse_args(['-c', 'x.yaml', '--profile', text])


# ----------------------------------------------- the benchmark's readers

# A hand-made window, times in us: two requests, each a harness
# 'render_eval' range around an 'sk.request' span and its synchronise.
#   window   [0, 100]
#   request 1: render_eval [10, 50]; sk.request [11, 45]; sk.deform
#     [12, 25] (and the harness's forward_deltas around it; fk [13, 16], lbs [17, 24]); sk.preprocess [26, 30];
#     sk.binning [30, 36]; sk.blend [37, 44]; sk.sync [20, 21]
#   request 2: render_eval [55, 95]; sk.request [56, 92]; sk.deform
#     [57, 70] (fk [58, 61], lbs [62, 69]); sk.preprocess [71, 75];
#     sk.binning [75, 81]; sk.blend [82, 90]
#   py.gc [96, 99]
#   device busy [15, 22], [28, 40], [42, 52], [66, 94]
#   launches at 14, 15, 18, 19, 23, 27, 33, 38, 59, 63, 72, 76, 83, 93
SPANS = {
    'bench_window': [(0, 100)],
    'render_eval': [(10, 50), (55, 95)],
    'forward_deltas': [(12, 25), (57, 70)],
    'sk.request': [(11, 45), (56, 92)],
    'sk.deform': [(12, 25), (57, 70)],
    'sk.deform.fk': [(13, 16), (58, 61)],
    'sk.deform.lbs': [(17, 24), (62, 69)],
    'sk.preprocess': [(26, 30), (71, 75)],
    'sk.binning': [(30, 36), (75, 81)],
    'sk.blend': [(37, 44), (82, 90)],
    'sk.sync': [(20, 21)],
    'py.gc': [(96, 99)],
}
BUSY = [(15, 22), (28, 40), (42, 52), (66, 94)]
LAUNCHES = [14, 15, 18, 19, 23, 27, 33, 38, 59, 63, 72, 76, 83, 93]
# the device idles [0, 15], [22, 28], [40, 42], [52, 66], [94, 100]: 43 us;
# in the deformation [12, 15] + [22, 25] + [57, 66] = 15 us, in the render
# [26, 28] + [40, 42] = 4 us (the card is busy through request 2's render),
# in no layer [0, 12] + [25, 26] + [52, 57] + [94, 100] = 24 us
EXPECTED = {
    'serve.deform_host_ms': 26 / 2e3,
    'serve.preprocess_host_ms': 8 / 2e3,
    'serve.binning_host_ms': 12 / 2e3,
    'serve.blend_host_ms': 15 / 2e3,
    'serve.sync_wait_ms': (5 + 3) / 2e3,
    'serve.deform_idle_ms': 15 / 2e3,
    'serve.render_idle_ms': 4 / 2e3,
    'serve.unspanned_idle_ms': 24 / 2e3,
    'serve.gc_host_ms': 3 / 2e3,
    'serve.fk_launches': 3 / 2,
    'serve.lbs_launches': 4 / 2,
    'serve.render_launches': 6 / 2,
    'serve.host_syncs': 1 / 2,
    'serve.deform_graph_share': 0.0,
}


def hand_trace(spans=SPANS):
    events = [{'ph': 'X', 'cat': 'user_annotation', 'name': name, 'ts': a,
               'dur': b - a} for name, rs in spans.items() for a, b in rs]
    events += [{'ph': 'X', 'cat': 'kernel', 'name': 'k', 'ts': a,
                'dur': b - a} for a, b in BUSY]
    events += [{'ph': 'X', 'cat': 'cuda_runtime', 'name': 'cudaLaunchKernel',
                'ts': ts, 'dur': 0.5} for ts in LAUNCHES]
    return Trace(events)


def reading(t):
    return type('Reading', (), {'trace': t})()


@pytest.mark.parametrize('name', NEW_METRICS)
def test_reader_on_a_hand_made_trace(name):
    got = harness.load_metric(name, METRICS).read(reading(hand_trace()))
    assert got == pytest.approx(EXPECTED[name], rel=1e-12)


def test_readers_add_up():
    """The three idle metrics split the idle time of
    ``serve.device_idle_pct``; the launches of FK and LBS are some of
    ``serve.deform_launches``'."""
    t = hand_trace()
    read = lambda n: harness.load_metric(n, METRICS).read(reading(t))
    parts = sum(read(n) for n in ('serve.deform_idle_ms',
                                  'serve.render_idle_ms',
                                  'serve.unspanned_idle_ms'))
    whole = read('serve.device_idle_pct') / 100 * t.window_s * 1e3 / 2
    assert parts == pytest.approx(whole, rel=1e-12)
    assert read('serve.fk_launches') + read('serve.lbs_launches') \
        == read('serve.deform_launches') == 3.5


@pytest.mark.parametrize('name', NEW_METRICS)
def test_reader_reads_none_without_the_port_spans(name):
    """The parent's trace: the harness's ranges and no span of the port."""
    parent = {k: v for k, v in SPANS.items()
              if k in HARNESS_RANGES}
    mod = harness.load_metric(name, METRICS)
    assert mod.read(reading(hand_trace(parent))) is None
    assert mod.read(reading(None)) is None


@pytest.mark.parametrize('name', NEW_METRICS)
def test_reader_imports_nothing_of_the_port(name):
    tree = ast.parse((METRICS / f'{name}.py').read_text())
    for node in ast.walk(tree):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or '']
        for n in names:
            assert n.split('.')[0] not in ('sk_gs_tpu_torch', 'sk_gs_tpu',
                                           'jax', 'torch'), n
