"""The served sp-stage deformation (SP-GS) as a CUDA graph
(``models/deform_graph.py`` and ``models/sk_gs.py:forward_deltas``), on a
card (marked ``gpu``, skipped elsewhere; no JAX here):

    python -m pytest tests/test_torch_sp_graph.py -m gpu -q --noconftest

Held: an sp (and sp_fix) replay's deltas equal the eager ``sp_stage``'s bit
for bit at every test time of the benchmark cell ``spgs_dnerf_800.serve_sp``
and beyond the train times, one capture over them all; an in-place update
seen at the next replay; a replaced ``sp_deform`` weight, ``hyper`` or
``sp_alive`` captured again; a switch between the sp and sk stages captured
again each time; time noise taking the eager path; no implicit sync, in the
eager stage or in a served request.
"""
import sys
from pathlib import Path

import pytest
import torch

from sk_gs_tpu_torch.framework.evaluate import render_eval
from sk_gs_tpu_torch.models.sk_gs import forward_deltas, sk_stage, sp_stage

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / 'tests'))
from bench_port import harness, inputs, inputs_sp, program  # noqa: E402
from test_torch_deform_graph import toy_model  # noqa: E402

CELL = 'spgs_dnerf_800.serve_sp'
SEED = 2 ** 31 + 19


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card (CUDA graphs run only there)')
    return torch.device('cuda')


def bench_model(dev):
    """The cell's model, built as its entry builds it, the test split's
    times and its views."""
    c = harness.find_cell(harness.load_spec(), CELL)
    sc = c.cfg['scene']
    nf = sc['num_frames']
    flat = inputs_sp.model_flat(c.cfg, SEED, dev, nf)
    model = program.build_model(flat, c.cfg, nf, dev)
    cams = inputs.split_cameras(sc, c.traffic['split'])
    views = program.views(inputs.view_arrays(sc, cams['c2w']), dev)
    return model, [float(t) for t in cams['times']], views


def eager(model, t):
    return sp_stage(model.cfg, model, model.params['xyz'], t)


def deltas(out):
    return (out.d_xyz, out.d_rotation, out.d_scaling)


def assert_equal(got, ref):
    for a, b in zip(deltas(got), deltas(ref)):
        assert a.shape == b.shape and torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize('stage', ['sp', 'sp_fix'])
def test_sp_replay_equals_eager_bitwise(cuda, stage):
    model, times, _ = bench_model(cuda)
    times = times + [-0.1, 1.1]
    with torch.no_grad():
        for t in times:
            t_ = torch.tensor(t, device=cuda)
            assert_equal(forward_deltas(model.cfg, model, t_, stage),
                         eager(model, t_))
    g = model.deform_graph
    assert len(times) >= 22
    assert g.captures == 1 and g.replays == len(times)


@pytest.mark.gpu
def test_sp_in_place_update_seen_at_the_next_replay(cuda):
    model = toy_model(device=cuda)
    t = torch.tensor(0.42, device=cuda)
    with torch.no_grad():
        forward_deltas(model.cfg, model, t, 'sp')
        model.params['hyper'].add_(0.05)
        model.sp_deform.warp.w.mul_(3.0)
        got = forward_deltas(model.cfg, model, t, 'sp')
        assert_equal(got, eager(model, t))
    assert model.deform_graph.captures == 1


@pytest.mark.gpu
@pytest.mark.parametrize('what', ['sp_deform', 'hyper', 'sp_alive'])
def test_sp_a_replaced_tensor_captures_again(cuda, what):
    model = toy_model(device=cuda)
    t = torch.tensor(0.42, device=cuda)
    with torch.no_grad():
        forward_deltas(model.cfg, model, t, 'sp')
        if what == 'sp_deform':
            lin = model.sp_deform.trunk[0]
            lin.w = torch.nn.Parameter(lin.w * 0.9, requires_grad=False)
        elif what == 'hyper':
            model.params['hyper'] = torch.nn.Parameter(
                model.params['hyper'] + 0.05, requires_grad=False)
        else:
            alive = model.sp_alive.clone()
            alive[1::3] = False
            model.sp_alive = alive
        got = forward_deltas(model.cfg, model, t, 'sp')
        assert_equal(got, eager(model, t))
    assert model.deform_graph.captures == 2


@pytest.mark.gpu
def test_switching_between_sp_and_sk_captures_again(cuda):
    model = toy_model(device=cuda)
    t = torch.tensor(0.3, device=cuda)
    with torch.no_grad():
        for n, stage in enumerate(['sp', 'sk', 'sp', 'sp', 'sk_fix']):
            got = forward_deltas(model.cfg, model, t, stage)
            if stage.startswith('sp'):
                assert_equal(got, eager(model, t))
            else:
                ref = sk_stage(model.cfg, model, model.params['xyz'], t)
                for a, b in zip(deltas(got), deltas(ref)):
                    assert float((a - b).abs().max()) <= 1e-6
    assert model.deform_graph.captures == 4
    assert model.deform_graph.replays == 5


@pytest.mark.gpu
def test_sp_time_noise_takes_the_eager_path(cuda):
    model = toy_model(device=cuda)
    t = torch.tensor(0.42, device=cuda)
    with torch.no_grad():
        forward_deltas(model.cfg, model, t, 'sp',
                       noise=torch.zeros((), device=cuda), noise_scale=0.5)
    g = model.deform_graph
    assert (g.captures, g.replays, g.graph) == (0, 0, None)


@pytest.mark.gpu
def test_sp_makes_no_sync(cuda):
    """The eager stage, and served requests that replay it, under
    ``set_sync_debug_mode('error')``."""
    model, times, views = bench_model(cuda)
    bg = torch.ones(3, device=cuda)
    ts = [torch.tensor(t, device=cuda) for t in times[:3]]
    with torch.no_grad():
        eager(model, ts[0])
    render_eval(model, views[0], ts[0], bg, 'sp')     # the capture
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode('error')
    try:
        with torch.no_grad():
            eager(model, ts[1])
        for view, t in zip(views, ts):
            render_eval(model, view, t, bg, 'sp')
    finally:
        torch.cuda.set_sync_debug_mode('default')
    torch.cuda.synchronize()
    assert model.deform_graph.replays == 1 + len(ts)
