"""The served sk-stage deformation as a CUDA graph (``models/deform_graph.py``
and ``models/sk_gs.py:forward_deltas``).

On the CPU: the sync-free frame lookups (``frame_weight``, the root
transform's and the ``sk_cache``'s interpolation) give bitwise the values of
the 0-d tensor subscripts they replace, at, between and beyond the train
times; the graph's conditions, each alone; a CPU model takes the eager path.

On a card (marked ``gpu``, skipped elsewhere; no JAX here):

    python -m pytest tests/test_torch_deform_graph.py -m gpu -q --noconftest

the graph against the eager stage of the same model over every test time of
both benchmark layouts and beyond the train times, one capture over many
times, in-place updates seen at the next replay, a replaced tensor captured
again, the bypasses, deltas that the next request leaves alone, the repose
delta's buffer, the viewer's inference mode, and a served request that
makes no implicit sync.
"""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from sk_gs_tpu_torch import convert
from sk_gs_tpu_torch.framework import presets
from sk_gs_tpu_torch.framework.evaluate import render_eval
from sk_gs_tpu_torch.framework.random_model import random_model_flat
from sk_gs_tpu_torch.models import sk_gs
from sk_gs_tpu_torch.models.sk_gs import SKGSModel, forward_deltas, sk_stage
from sk_gs_tpu_torch.ops import se3

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
from bench_port import harness, inputs, program  # noqa: E402

FRAMES = 6
# uneven train times, so that the gaps differ
TRAIN_TIMES = np.asarray([0.0, 0.1, 0.35, 0.5, 0.8, 1.0], np.float32)
TIMES = ([float(x) for x in TRAIN_TIMES]
         + [0.05, 0.2, 0.499, 0.9999]           # between
         + [-0.25, -1e-6, 1.0 + 1e-6, 1.7])    # beyond the first and last
SERVE_CELLS = ('dnerf_800.serve', 'zju_1024.serve')
SEED = 2 ** 31 + 18


def toy_model(trainable=False, device='cpu', interp=False):
    """The flagship's model cut to 1,024 slots, 32 joints and 2 x 32 nets,
    with uneven train times and a random ``sk_cache``."""
    cfg, rcfg, _ = presets.synthetic_fullscale()
    cfg = cfg._replace(
        gauss=cfg.gauss._replace(capacity=1024), num_superpoints=32,
        net=cfg.net._replace(depth=2, width=32),
        sk_net=cfg.sk_net._replace(depth=2, width=32, skips=()),
        num_frames=FRAMES, test_time_interpolate=interp)
    rcfg = rcfg._replace(image_width=64, image_height=48,
                         pair_capacity=2 ** 14)
    flat = random_model_flat(cfg, 5, n_alive=900, log_scale_mean=-3.0)
    flat['train_times'] = TRAIN_TIMES
    rng = np.random.default_rng(7)
    flat['sk_cache'] = rng.normal(
        size=(FRAMES, 32, sum(cfg.sk_net.out_dims))).astype(np.float32)
    return convert.model_from_flat(flat, cfg, rcfg, device=device,
                                   trainable=trainable)


def subscript_frame_weight(train_times, t):
    """``frame_weight`` as it was: the frames' times by a 0-d tensor
    subscript (a host read)."""
    t0 = t.reshape(())
    idx2 = torch.clamp(torch.searchsorted(train_times, t0.reshape(1)), 1,
                       train_times.shape[0] - 1)[0]
    idx1 = idx2 - 1
    w = (t0 - train_times[idx1]) / torch.clamp(
        train_times[idx2] - train_times[idx1], min=1e-8)
    return idx1, idx2, w


# ------------------------------------------------------------ on the CPU


@pytest.mark.parametrize('t', TIMES)
def test_frame_weight_bitwise(t):
    tt = torch.from_numpy(TRAIN_TIMES)
    got = sk_gs.frame_weight(tt, torch.tensor(t))
    ref = subscript_frame_weight(tt, torch.tensor(t))
    for a, b in zip(got, ref):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a, b)


@pytest.mark.parametrize('interp', [False, True], ids=['net', 'sk_cache'])
@pytest.mark.parametrize('t', TIMES)
def test_interpolation_bitwise(t, interp):
    """The root transform, and the ``sk_cache`` rows with
    ``test_time_interpolate``, as the subscripts gave them."""
    model = toy_model(interp=interp)
    tt = torch.tensor(t)
    with torch.no_grad():
        out = forward_deltas(model.cfg, model, tt, 'sk')
    idx1, idx2, w = subscript_frame_weight(model.train_times, tt)
    g_tr = model.params['global_tr']
    ref = se3.se3_interpolate(g_tr[idx1], g_tr[idx2], w)
    assert torch.equal(out.aux['g_tr'], ref)
    if interp:
        wc = torch.clamp(w, 0.0, 1.0)
        row = (1.0 - wc) * model.sk_cache[idx1] + wc * model.sk_cache[idx2]
        assert torch.equal(out.aux['cache_row'], row)


@pytest.mark.parametrize('stage', ['sk', 'sk_fix', 'sp'])
def test_cpu_model_takes_the_eager_path(stage):
    model = toy_model()
    with torch.no_grad():
        forward_deltas(model.cfg, model, torch.tensor(0.3), stage)
    g = model.deform_graph
    assert (g.captures, g.replays, g.graph) == (0, 0, None)


ENGAGE_CASES = {
    # name: (trainable, grad on, t requires grad, delta, time_id,
    #        training, engages)
    'served': (False, False, False, None, None, False, True),
    'grad_on_nothing_requires_grad':
        (False, True, False, None, None, False, True),
    'grad_off_trainable_model': (True, False, False, None, None, False, True),
    'repose_delta': (False, False, False, 'plain', None, False, True),
    'grad_on_trainable_model': (True, True, False, None, None, False, False),
    'grad_on_t_requires_grad': (False, True, True, None, None, False, False),
    'grad_on_delta_requires_grad':
        (False, True, False, 'grad', None, False, False),
    'time_id': (False, False, False, None, 2, False, False),
    'training': (False, False, False, None, None, True, False),
}


@pytest.mark.parametrize('case', list(ENGAGE_CASES))
def test_engages_on_what_the_input_shows(case, monkeypatch):
    """Each condition alone, with the model taken for a card's (its
    device patched)."""
    (trainable, grad, t_grad, delta, time_id, training,
     want) = ENGAGE_CASES[case]
    model = toy_model(trainable=trainable)
    monkeypatch.setattr(SKGSModel, 'device',
                        property(lambda self: torch.device('cuda')))
    t = torch.tensor(0.3, requires_grad=t_grad)
    d = None if delta is None else \
        torch.zeros((32, 3), requires_grad=delta == 'grad')
    with torch.set_grad_enabled(grad):
        got = model.deform_graph.engages(model, t, time_id, d, training)
    assert got is want


def test_engages_not_on_the_cpu():
    model = toy_model()
    with torch.no_grad():
        assert not model.deform_graph.engages(model, torch.tensor(0.3), None,
                                              None, False)


# -------------------------------------------------------------- on a card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card (CUDA graphs run only there)')
    return torch.device('cuda')


def bench_model(cell, dev):
    """The benchmark cell's model, built as the serve entry builds it, the
    test split's times and its views."""
    c = harness.find_cell(harness.load_spec(), cell)
    sc = c.cfg['scene']
    nf = sc['num_frames']
    flat = inputs.model_flat(c.cfg, SEED, dev, nf)
    model = program.build_model(flat, c.cfg, nf, dev)
    cams = inputs.split_cameras(sc, c.traffic['split'])
    views = program.views(inputs.view_arrays(sc, cams['c2w']), dev)
    return model, [float(t) for t in cams['times']], views


def eager(model, t, delta=None):
    return sk_stage(model.cfg, model, model.params['xyz'], t, None, delta)


def deltas(out):
    return (out.d_xyz, out.d_rotation, out.d_scaling)


def assert_close(got, ref, tol=1e-6):
    for a, b in zip(deltas(got), deltas(ref)):
        assert a.shape == b.shape
        assert float((a - b).abs().max()) <= tol


@pytest.mark.gpu
@pytest.mark.parametrize('cell', SERVE_CELLS)
def test_graph_matches_eager_over_the_test_times(cuda, cell):
    model, times, _ = bench_model(cell, cuda)
    tt = model.train_times
    edge = float(tt[-1] - tt[0])
    times = times + [float(tt[0]) - 0.05 * edge, float(tt[-1]) + 0.05 * edge]
    bitwise = 0
    with torch.no_grad():
        for t in times:
            t_ = torch.tensor(t, device=cuda)
            got = forward_deltas(model.cfg, model, t_, 'sk')
            ref = eager(model, t_)
            assert_close(got, ref)
            bitwise += all(torch.equal(a, b)
                           for a, b in zip(deltas(got), deltas(ref)))
    g = model.deform_graph
    assert g.captures == 1 and g.replays == len(times)
    print(f'{cell}: {bitwise} of {len(times)} times bitwise equal')


@pytest.mark.gpu
def test_in_place_update_seen_at_the_next_replay(cuda):
    model = toy_model(device=cuda)
    t = torch.tensor(0.42, device=cuda)
    with torch.no_grad():
        forward_deltas(model.cfg, model, t, 'sk')
        model.params['joints'].add_(0.05)
        model.sk_deform.heads[0].w.mul_(1.5)
        model.params['global_tr'][:, :3] += 0.1
        got = forward_deltas(model.cfg, model, t, 'sk')
        assert_close(got, eager(model, t))
    assert model.deform_graph.captures == 1


@pytest.mark.gpu
@pytest.mark.parametrize('what', ['param', 'joint_parents', 'net_weight'])
def test_a_replaced_tensor_captures_again(cuda, what):
    model = toy_model(device=cuda)
    t = torch.tensor(0.42, device=cuda)
    with torch.no_grad():
        forward_deltas(model.cfg, model, t, 'sk')
        if what == 'param':
            model.params['global_tr'] = torch.nn.Parameter(
                model.params['global_tr'] * 0.5, requires_grad=False)
        elif what == 'joint_parents':
            model.joint_parents = torch.zeros_like(model.joint_parents)
        else:
            lin = model.sk_deform.layers[0]
            lin.w = torch.nn.Parameter(lin.w * 0.9, requires_grad=False)
        got = forward_deltas(model.cfg, model, t, 'sk')
        assert_close(got, eager(model, t))
    assert model.deform_graph.captures == 2


@pytest.mark.gpu
@pytest.mark.parametrize('path', ['grad', 'time_id', 'sp_stage', 'init_stage',
                                  'training'])
def test_bypasses_take_the_eager_path(cuda, path):
    model = toy_model(trainable=path == 'grad', device=cuda)
    t = torch.tensor(0.42, device=cuda)
    kw = {}
    stage = 'sk'
    if path == 'time_id':
        kw['time_id'] = torch.tensor(2, device=cuda)
    elif path == 'sp_stage':
        # the sp stages take the graph too, but not with time noise
        stage = 'sp'
        kw['noise'] = torch.zeros((), device=cuda)
    elif path == 'init_stage':
        stage = 'init'
    elif path == 'training':
        kw['training'] = True
    with torch.set_grad_enabled(path == 'grad'):
        out = forward_deltas(model.cfg, model, t, stage, **kw)
    if path == 'grad':
        assert out.d_xyz.requires_grad
    g = model.deform_graph
    assert (g.captures, g.replays, g.graph) == (0, 0, None)


@pytest.mark.gpu
def test_deltas_survive_the_next_request(cuda):
    model = toy_model(device=cuda)
    with torch.no_grad():
        first = forward_deltas(model.cfg, model,
                               torch.tensor(0.2, device=cuda), 'sk')
        kept = [x.clone() for x in deltas(first)]
        second = forward_deltas(model.cfg, model,
                                torch.tensor(0.9, device=cuda), 'sk')
    for a, b in zip(deltas(first), kept):
        assert torch.equal(a, b)
    assert not torch.equal(first.d_xyz, second.d_xyz)


@pytest.mark.gpu
def test_repose_delta_is_a_static_input(cuda):
    model = toy_model(device=cuda)
    t = torch.tensor(0.6, device=cuda)
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for _ in range(3):
            d = (torch.randn((32, 3), generator=gen) * 0.3).to(cuda)
            got = forward_deltas(model.cfg, model, t, 'sk', sk_r_delta=d)
            assert_close(got, eager(model, t, d))
        assert model.deform_graph.captures == 1
        q = torch.nn.functional.normalize(
            torch.randn((32, 4), generator=gen), dim=-1).to(cuda)
        got = forward_deltas(model.cfg, model, t, 'sk', sk_r_delta=q)
        assert_close(got, eager(model, t, q))
        forward_deltas(model.cfg, model, t, 'sk')
    assert model.deform_graph.captures == 3


@pytest.mark.gpu
def test_inference_mode_then_no_grad(cuda):
    """The viewer serves under inference mode; a graph captured there
    replays under ``no_grad`` as well."""
    model = toy_model(device=cuda)
    t = torch.tensor(0.3, device=cuda)
    with torch.inference_mode():
        a = forward_deltas(model.cfg, model, t, 'sk')
    with torch.no_grad():
        b = forward_deltas(model.cfg, model, t, 'sk')
        assert_close(b, eager(model, t))
    assert torch.equal(a.d_xyz, b.d_xyz)
    assert model.deform_graph.captures == 1


@pytest.mark.gpu
def test_a_served_request_makes_no_sync(cuda):
    model, times, views = bench_model('dnerf_800.serve', cuda)
    bg = torch.ones(3, device=cuda)
    ts = [torch.tensor(t, device=cuda) for t in times[:3]]
    render_eval(model, views[0], ts[0], bg, 'sk')     # the capture
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode('error')
    try:
        for view, t in zip(views, ts):
            render_eval(model, view, t, bg, 'sk')
    finally:
        torch.cuda.set_sync_debug_mode('default')
    torch.cuda.synchronize()
    assert model.deform_graph.replays == 1 + len(ts)
