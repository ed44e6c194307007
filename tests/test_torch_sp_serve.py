"""Serving SP-GS (stage 'sp') on the CPU at a toy size, against the
benchmark's plain reference (``bench_port/reference/sp.py``).

The model is the benchmark cell ``spgs_dnerf_800.serve_sp``'s, built as its
entry builds it (``bench_port/inputs_sp.py``: the warp net's heads and the
hyper features at the spreads the configuration states), cut to the
benchmark's toy size (``bench_port/tests/toy.py``: 2,048 slots, 32
superpoints, 64 px). Held: the port's ``forward_deltas`` at 'sp' with
``gaussian_inputs`` against the reference's per-Gaussian inputs;
``render_eval`` at 'sp' against the reference render; zero deltas failing
both by at least ten times; the hyper features changing the K nearest
superpoints of a tenth of the live Gaussians or more (at the cell's own
sizes); the sp stage's spans; and the deformation graph's rule for the sp
stages, each condition alone.
"""
import sys
from pathlib import Path

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from sk_gs_tpu_torch.models import deform_graph
from sk_gs_tpu_torch.models.gaussian_splatting import gaussian_inputs
from sk_gs_tpu_torch.models.sk_gs import SKGSModel, forward_deltas
from sk_gs_tpu_torch.utils import tracing
from test_torch_mesh import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
from bench_port import harness, inputs, inputs_sp, program  # noqa: E402
from bench_port import control_sp, program_sp  # noqa: E402
from bench_port.reference import render as ref_render  # noqa: E402
from bench_port.reference import sk as ref_sk  # noqa: E402
from bench_port.reference import sp as ref_sp  # noqa: E402
from bench_port.tests import toy  # noqa: E402

CELL = 'spgs_dnerf_800.serve_sp'
SEEDS = (2 ** 31 + 19, 7)
VIEWS = range(toy.TOY['test_views'])
# the per-Gaussian inputs: on the CPU the port and the reference run the
# same float32 operations in the same order (they agree to the bit at this
# size); 1e-6 leaves room for a BLAS that orders the sums of the
# [N, M] @ [M, 19] blend product otherwise, far under the 1e-2 and more
# that zero deltas move a Gaussian's mean
GAUSS_TOL = 1e-6
# the image: the limit that decides the cell's ``correct``
# (``bench_port/traffic/serve_sp.json``)
IMAGE_TOL = harness.find_cell(harness.load_spec(), CELL).limits['image_rmse']


def toy_cfg():
    c = harness.find_cell(harness.load_spec(), CELL)
    return toy.toy_config(c.cfg), c.traffic


@pytest.fixture(scope='module', params=SEEDS, ids=['seed_big', 'seed_7'])
def served(request):
    cfg, traffic = toy_cfg()
    sc = cfg['scene']
    flat = inputs_sp.model_flat(cfg, request.param, torch.device('cpu'),
                                sc['num_frames'])
    model = program.build_model(flat, cfg, sc['num_frames'], 'cpu')
    cams = inputs.split_cameras(sc, traffic['split'])
    arrays = inputs.view_arrays(sc, cams['c2w'])
    return {'cfg': cfg, 'model': model, 'cams': cams, 'arrays': arrays,
            'views': program.views(arrays, 'cpu'),
            'P': ref_sk.params_from_flat(flat, 'cpu')}


def port_inputs(model, t, zero=False):
    with torch.no_grad():
        out = forward_deltas(model.cfg, model, torch.tensor(t), 'sp')
        if zero:
            return gaussian_inputs(model.gauss_view(), model.cfg.gauss)
        return gaussian_inputs(model.gauss_view(), model.cfg.gauss,
                               d_xyz=out.d_xyz, d_rotation=out.d_rotation,
                               d_scaling=out.d_scaling)


def gauss_gap(g, ref):
    """The widest gap of the live Gaussians' means, scales and unit
    rotations."""
    live = ref['alive']
    pairs = ((g.means3d, ref['means']), (g.scales, ref['scales']),
             (g.rotations, ref['rotations']))
    return max(float((a - b)[live].abs().max()) for a, b in pairs)


@pytest.mark.parametrize('k', VIEWS)
def test_deltas_match_the_reference(served, k):
    t = float(served['cams']['times'][k])
    ref = ref_sp.gaussians(served['P'], served['cfg'], t)
    g = port_inputs(served['model'], t)
    assert torch.equal(g.mask, ref['alive'])
    assert torch.equal(g.opacities, ref['opacities'])
    assert torch.equal(g.sh, ref['sh'])
    assert gauss_gap(g, ref) <= GAUSS_TOL


@pytest.mark.parametrize('k', VIEWS)
def test_zero_deltas_fail_the_tolerance(served, k):
    t = float(served['cams']['times'][k])
    ref = ref_sp.gaussians(served['P'], served['cfg'], t)
    assert gauss_gap(port_inputs(served['model'], t, zero=True), ref) \
        > 10 * GAUSS_TOL


def served_and_reference(served, k, fault=''):
    t = float(served['cams']['times'][k])
    bg = torch.ones(3)
    with program_sp.fault(fault), torch.no_grad():
        img = program_sp.render_request(served['model'], served['views'][k],
                                        torch.tensor(t), bg)['image']
        ref = ref_render.render(
            ref_sp.gaussians(served['P'], served['cfg'], t),
            ref_render.camera(served['arrays'], k, 'cpu'),
            served['cfg']['scene']['image_size'], bg)
    return ref_render.image_gap(img, ref)


@pytest.mark.parametrize('k', VIEWS)
def test_render_eval_matches_the_reference(served, k):
    assert served_and_reference(served, k) <= IMAGE_TOL


@pytest.mark.parametrize('k', VIEWS)
def test_zero_deltas_fail_the_image_limit(served, k):
    """Served with zero deltas (``program_sp``'s 'deform_skipped'), the
    image misses the limit ten times over."""
    assert served_and_reference(served, k, 'deform_skipped') > 10 * IMAGE_TOL


@pytest.mark.parametrize('seed', SEEDS, ids=['seed_big', 'seed_7'])
def test_hyper_features_change_the_knn(seed):
    """At the cell's own sizes (512 superpoints; the share taken over the
    first 16,384 slots), as the configuration's hyper spread was sized."""
    c = harness.find_cell(harness.load_spec(), CELL)
    flat = inputs_sp.model_flat(c.cfg, seed, torch.device('cpu'),
                                c.cfg['scene']['num_frames'])
    P = ref_sk.params_from_flat(flat, 'cpu')
    for key in ('xyz', 'hyper', 'alive'):
        P[key] = P[key][:16384]
    share = control_sp.knn_changed_share(P, c.cfg['model']['num_knn'])
    assert share >= 0.1


def test_sp_spans_once_a_request_inside_the_deformation(served):
    model = served['model']
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        port_inputs(model, 0.3)
    got = {}
    for e in prof.events():
        if e.name in tracing.SPANS:
            got.setdefault(e.name, []).append((e.time_range.start,
                                               e.time_range.end))
    (outer,) = got['sk.deform']
    for name in ('sk.deform.net', 'sk.deform.lbs'):
        (inner,) = got[name]
        assert outer[0] <= inner[0] and inner[1] <= outer[1], name
    assert got['sk.deform.net'][0][1] <= got['sk.deform.lbs'][0][0]
    assert 'sk.deform.fk' not in got and 'sk.deform.replay' not in got


ENGAGE_CASES = {
    # name: (trainable, grad on, time_id, training, drop sp_deform, engages)
    'served': (False, False, None, False, False, True),
    'grad_off_trainable_model': (True, False, None, False, False, True),
    'grad_on_nothing_requires_grad': (False, True, None, False, False, True),
    'grad_on_trainable_model': (True, True, None, False, False, False),
    'time_id': (False, False, 2, False, False, False),
    'training': (False, False, None, True, False, False),
    'no_sp_deform_net': (False, False, None, False, True, False),
}


@pytest.mark.parametrize('stage', ['sp', 'sp_fix'])
@pytest.mark.parametrize('case', list(ENGAGE_CASES))
def test_sp_engages_on_what_the_input_shows(served, case, stage,
                                            monkeypatch):
    """Each condition alone, the model taken for a card's (its device
    patched); the sp stages read their own tensors (``stage_inputs``)."""
    trainable, grad, time_id, training, drop, want = ENGAGE_CASES[case]
    model = served['model']
    monkeypatch.setattr(SKGSModel, 'device',
                        property(lambda self: torch.device('cuda')))
    if drop:
        monkeypatch.setattr(model, 'sp_deform', None)
    if trainable:
        for p in deform_graph.stage_inputs(model, stage):
            if p.is_floating_point():
                monkeypatch.setattr(p, 'requires_grad', True)
    with torch.set_grad_enabled(grad):
        got = model.deform_graph.engages(model, torch.tensor(0.3), time_id,
                                         None, training, stage)
    assert got is want


def test_sp_stage_inputs_are_the_warp_net_and_the_superpoints(served):
    model = served['model']
    sp = deform_graph.stage_inputs(model, 'sp')
    ids = {id(x) for x in sp}
    for x in (*model.sp_deform.parameters(), model.params['hyper'],
              model.params['sp_hyper'], model.params['sp_W'],
              model.sp_alive):
        assert id(x) in ids
    for x in (*model.sk_deform.parameters(), model.sk_cache,
              model.joint_parents):
        assert id(x) not in ids
    assert deform_graph.family('sp_fix') == 'sp'
    assert deform_graph.family('sk_fix') == 'sk'
