"""The served preprocess as one hand-written kernel
(``csrc/preprocess_fwd.cu``, ``render/preprocess.py:preprocess_fwd``) and
the dispatch that picks it (``render/preprocess.py:kernel_engages``).

On the CPU: CPU tensors, autograd recording and ``use_kernel`` off each
take the plain version, whose outputs the dispatcher hands back unchanged
and without a launch; each condition of the dispatch alone, with the inputs
taken for a card's; a training step and a one-rank mesh step, whose
preprocess autograd records, take the plain version.

On a card (marked ``gpu``, skipped elsewhere; no JAX here):

    python -m pytest tests/test_torch_preprocess_kernel.py -m gpu -q --noconftest

the kernel against the plain version on both sk cells' models and views,
at every SH degree, below the active degree, with colours in place of SH,
without a mask, without tight culling, at tile height 8, and on planted
rows (behind ``near``, with det == 0, dead); a served request under
``set_sync_debug_mode('error')``; the plain version under grad; the span.

Bars on the card (``chip_smoke.py:preprocess_errors``): on the rows the
plain version draws, a float field within 1e-4 of the field's largest
magnitude there (the repository's kernel-against-plain bar), its non-finite
values in the same places; on the culled and dead rows, whose projection
may pass through 1/1e-7, the same non-finite values in the same places, and
colour and tau (which no cull touches) within 1e-4, relative with a floor
of 1. Integer fields and ``visible`` equal on every
row but the ties: the plain version leaves p_view, p_hom, w and full_proj
to cuBLAS, whose order of summing the kernel cannot know, so a row whose
float rect edge lies within 1e-3 of a tile boundary, whose radius lies
within 1e-3 of an integer before its ceiling, or whose depth lies within
1e-3 of ``near`` may round the other way; such rows must be at most 0.01%
of the live rows.
"""
import math
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from sk_gs_tpu_torch.framework.evaluate import render_eval
from sk_gs_tpu_torch.framework.random_model import orbit_view
from sk_gs_tpu_torch.models.gaussian_splatting import gaussian_inputs
from sk_gs_tpu_torch.models.sk_gs import forward_deltas
from sk_gs_tpu_torch.ops.transforms import perspective_opencv
from sk_gs_tpu_torch.parallel import make_mesh
from sk_gs_tpu_torch.parallel.trainer import MeshTrainer
from sk_gs_tpu_torch.render.settings import (TILE, GaussianInputs,
                                             RasterConfig, ViewParams)
from test_torch_mesh import one_torch_thread  # noqa: F401
from test_torch_tracing import sk_step, toy_cfg, toy_model, toy_trainer

pre_mod = sys.modules['sk_gs_tpu_torch.render.preprocess']
ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

FLOAT_FIELDS = ('means2d', 'depths', 'conic', 'colors', 'tau')
INT_FIELDS = ('radius', 'tiles_touched', 'rect_min', 'rect_max', 'visible')
TOL = 1e-4
TIE = 1e-3
TIE_SHARE = 1e-4
SERVE_CELLS = ('dnerf_800.serve', 'zju_1024.serve')


def toy_inputs(n=256, seed=0, requires_grad=False, device='cpu'):
    """Random Gaussians around the origin, a quarter of them dead."""
    rng = np.random.default_rng(seed)
    f = lambda *s, scale=1.0: torch.tensor(
        rng.normal(size=s) * scale, dtype=torch.float32, device=device,
        requires_grad=requires_grad)
    q = rng.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    return GaussianInputs(
        means3d=f(n, 3, scale=0.5),
        scales=torch.tensor(np.exp(rng.normal(-3.0, 0.5, size=(n, 3))),
                            dtype=torch.float32, device=device,
                            requires_grad=requires_grad),
        rotations=torch.tensor(q, dtype=torch.float32, device=device),
        opacities=torch.tensor(rng.uniform(0.01, 0.99, size=n),
                               dtype=torch.float32, device=device),
        sh=f(n, 16, 3, scale=0.3),
        mask=torch.tensor(rng.uniform(size=n) > 0.25, device=device))


def toy_view(device='cpu'):
    return orbit_view(0.4, 64, 48, device=device)


def toy_rcfg(**kw):
    return RasterConfig(image_width=64, image_height=48,
                        pair_capacity=2 ** 14)._replace(**kw)


def assert_equal_out(a, b):
    for name in a._fields:
        x, y = getattr(a, name), getattr(b, name)
        assert x.dtype == y.dtype and x.shape == y.shape, name
        assert torch.equal(torch.nan_to_num(x), torch.nan_to_num(y)), name


# ------------------------------------------------------------ on the CPU


CPU_CASES = {
    # name: (grad on, inputs require grad, use_kernel)
    'cpu_tensors': (False, False, True),
    'autograd_records': (True, True, True),
    'use_kernel_off': (False, False, False),
}


@pytest.mark.parametrize('case', list(CPU_CASES))
def test_plain_version_taken_and_unchanged(case):
    """The dispatcher hands back the plain version's outputs, bit for bit,
    and launches nothing; under autograd the outputs carry a graph."""
    grad, req, use_kernel = CPU_CASES[case]
    g = toy_inputs(requires_grad=req)
    view, rcfg = toy_view(), toy_rcfg(use_kernel=use_kernel)
    active = torch.tensor(2, dtype=torch.int32)
    before = pre_mod.preprocess_fwd.launches
    with torch.set_grad_enabled(grad):
        got = pre_mod.preprocess(g, view, rcfg, active)
        ref = pre_mod.preprocess_plain(g, view, rcfg, active)
    assert_equal_out(got, ref)
    assert pre_mod.preprocess_fwd.launches == before
    assert got.means2d.requires_grad is req
    if req:
        got.means2d.sum().backward()
        assert g.means3d.grad is not None


class OnCard(torch.Tensor):
    """A CPU tensor that says it lies on a card (the dispatch reads only
    the device and ``requires_grad``)."""

    @property
    def device(self):
        return torch.device('cuda')


def on_card(g: GaussianInputs) -> GaussianInputs:
    return g._replace(means3d=g.means3d.as_subclass(OnCard))


ENGAGE_CASES = {
    # name: (grad on, which input requires grad, use_kernel, engages)
    'served': (False, None, True, True),
    'grad_on_nothing_requires_grad': (True, None, True, True),
    'grad_off_inputs_require_grad': (False, 'means3d', True, True),
    'grad_on_means_require_grad': (True, 'means3d', True, False),
    'grad_on_sh_requires_grad': (True, 'sh', True, False),
    'grad_on_view_requires_grad': (True, 'Tw2v', True, False),
    'use_kernel_off': (False, None, False, False),
}


@pytest.mark.parametrize('case', list(ENGAGE_CASES))
def test_engages_on_what_the_input_shows(case):
    grad, req, use_kernel, want = ENGAGE_CASES[case]
    g, view = toy_inputs(), toy_view()
    if req in GaussianInputs._fields:
        g = g._replace(**{req: getattr(g, req).requires_grad_(True)})
    elif req is not None:
        view = view._replace(**{req: getattr(view, req).requires_grad_(True)})
    with torch.set_grad_enabled(grad):
        got = pre_mod.kernel_engages(on_card(g), view,
                                     toy_rcfg(use_kernel=use_kernel))
    assert got is want


def test_engages_not_on_the_cpu():
    with torch.no_grad():
        assert not pre_mod.kernel_engages(toy_inputs(), toy_view(),
                                          toy_rcfg())


def record_engages(monkeypatch):
    """Patch the dispatch to record, for each preprocess, whether it would
    launch the kernel were the inputs on a card; the CPU run itself goes
    on through the plain version."""
    seen = []
    real = pre_mod.kernel_engages

    def recorded(g, view, cfg):
        seen.append(real(on_card(g), view, cfg))
        return False

    monkeypatch.setattr(pre_mod, 'kernel_engages', recorded)
    return seen


@pytest.mark.parametrize('trainer', ['one_card', 'mesh_one_rank'])
def test_training_step_takes_the_plain_version(trainer, monkeypatch):
    """Every preprocess of a training step is recorded by autograd, so on a
    card too it would run the plain version: the one-card step and a
    one-rank mesh step (``parallel/trainer.py``, the mesh's seams)."""
    t = toy_trainer()
    if trainer == 'mesh_one_rank':
        t = MeshTrainer(t.cfg, t.rcfg, t.scene, t.meta, toy_model(True),
                        t.loss_w, skeleton_initialized=True, device='cpu',
                        mesh=make_mesh(1, 1))
    seen = record_engages(monkeypatch)
    before = pre_mod.preprocess_fwd.launches
    t.train_step(sk_step(t))
    assert seen and not any(seen)
    assert pre_mod.preprocess_fwd.launches == before


def test_served_request_would_take_the_kernel(monkeypatch):
    """A served request (``render_eval``, no grad) is the path the kernel
    takes on a card."""
    model = toy_model()
    seen = record_engages(monkeypatch)
    render_eval(model, toy_view(), torch.tensor(0.3), torch.ones(3), 'sk')
    assert seen == [True]


# -------------------------------------------------------------- on a card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card (the kernel builds and runs only '
                    'there)')
    return torch.device('cuda')


def cell_inputs(cell, dev, n_views=2):
    """The benchmark cell's model (``tests/test_torch_deform_graph.py:
    bench_model``), and the Gaussian inputs of its first test requests."""
    from test_torch_deform_graph import bench_model
    model, times, views = bench_model(cell, dev)
    out = []
    with torch.no_grad():
        for k in range(n_views):
            d = forward_deltas(model.cfg, model,
                               torch.tensor(times[k], device=dev), 'sk')
            out.append((gaussian_inputs(model.gauss_view(), model.cfg.gauss,
                                        d.d_xyz, d.d_rotation, d.d_scaling),
                        views[k]))
    return model, out


def plain_edges(g, view, cfg, active):
    """The plain version's float quantities that integer fields and
    ``visible`` round from: the four rect edges in tiles, the radius and
    the two tight radii before their ceilings, and view z."""
    p_view, p_ndc = pre_mod.project_points(g.means3d, view)
    cov3d = pre_mod.compute_cov3d(g.scales, g.rotations, cfg.scale_modifier)
    cov2d = pre_mod.compute_cov2d(p_view, cov3d, view, cfg)
    det = cov2d[:, 0] * cov2d[:, 2] - cov2d[:, 1] * cov2d[:, 1]
    mid = 0.5 * (cov2d[:, 0] + cov2d[:, 2])
    lam = mid + torch.sqrt(torch.clamp(mid * mid - det, min=0.1))
    r_arg = 3.0 * torch.sqrt(torch.clamp(lam, min=0.0))
    radius_f = torch.ceil(r_arg)
    tau = 2.0 * torch.clamp(torch.log(255.0 * g.opacities.reshape(-1)),
                            min=0.0)
    args = [r_arg]
    rx = ry = radius_f
    if cfg.tight_culling:
        ax, ay = torch.sqrt(tau * cov2d[:, 0]), torch.sqrt(tau * cov2d[:, 2])
        args += [ax, ay]
        rx = torch.minimum(torch.ceil(ax), radius_f)
        ry = torch.minimum(torch.ceil(ay), radius_f)
    px = pre_mod.ndc_to_pix(p_ndc[:, 0], cfg.image_width)
    py = pre_mod.ndc_to_pix(p_ndc[:, 1], cfg.image_height)
    th = cfg.tile_h
    edges = [(px - rx) / TILE, (py - ry) / th, (px + rx + TILE - 1) / TILE,
             (py + ry + th - 1) / th]
    return edges, args, p_view[:, 2]


def tie_rows(g, view, cfg, active):
    edges, args, z = plain_edges(g, view, cfg, active)
    near_int = lambda x: (x - torch.round(x)).abs() < TIE
    tie = torch.zeros_like(z, dtype=torch.bool)
    for x in edges + args:
        tie |= near_int(x)
    return tie | ((z - cfg.near).abs() < TIE)


def compare(g, view, cfg, active):
    """The kernel against the plain version on one input: the largest
    float error of each field over its largest magnitude on the drawn
    rows, and the rows whose integer fields or ``visible`` differ (all of
    them ties)."""
    from chip_smoke import preprocess_errors
    fwd = pre_mod.preprocess_fwd
    before = fwd.launches
    got = fwd.launch(g, view, cfg, active)
    ref = pre_mod.preprocess_plain(g, view, cfg, active)
    torch.cuda.synchronize()
    assert fwd.launches == before + 1
    differ = torch.zeros(g.means3d.shape[0], dtype=torch.bool,
                         device=g.means3d.device)
    for name in INT_FIELDS:
        a, b = getattr(got, name), getattr(ref, name)
        assert a.dtype == b.dtype and a.shape == b.shape, name
        ne = a != b
        differ |= ne.reshape(ne.shape[0], -1).any(-1)
    for name in FLOAT_FIELDS:
        a, b = getattr(got, name), getattr(ref, name)
        assert a.dtype == b.dtype and a.shape == b.shape, name
    errs, culled_bad = preprocess_errors(got, ref, differ)
    for name, err in errs.items():
        assert err <= TOL, (name, err)
    assert culled_bad == 0, culled_bad
    ties = tie_rows(g, view, cfg, active)
    assert not (differ & ~ties).any(), int((differ & ~ties).sum())
    live = int(g.mask.sum()) if g.mask is not None else g.means3d.shape[0]
    assert int(differ.sum()) <= TIE_SHARE * live, int(differ.sum())
    return errs, int(differ.sum())


@pytest.mark.gpu
@pytest.mark.parametrize('cell', SERVE_CELLS)
def test_kernel_matches_plain_on_the_cells(cuda, cell):
    model, cases = cell_inputs(cell, cuda)
    with torch.no_grad():
        for g, view in cases:
            errs, ties = compare(g, view, model.rcfg, model.active_sh_degree)
            print(cell, errs, 'tie rows', ties)


VARIANTS = ('degree_0', 'degree_1', 'degree_2', 'active_below_max',
            'colors', 'no_mask', 'not_tight', 'tile_h_8')


def variant(name, g, cfg, active, dev):
    """The dnerf cell's inputs changed as ``name`` says."""
    if name.startswith('degree_'):
        d = int(name[-1])
        g = g._replace(sh=g.sh[:, :(d + 1) ** 2].contiguous())
        cfg = cfg._replace(sh_degree=d)
        active = torch.tensor(d, dtype=torch.int32, device=dev)
    elif name == 'active_below_max':
        active = torch.tensor(1, dtype=torch.int32, device=dev)
    elif name == 'colors':
        gen = torch.Generator(device=dev).manual_seed(3)
        g = g._replace(sh=None, colors=torch.rand(
            (g.means3d.shape[0], 3), generator=gen, device=dev))
    elif name == 'no_mask':
        g = g._replace(mask=None)
    elif name == 'not_tight':
        cfg = cfg._replace(tight_culling=False)
    elif name == 'tile_h_8':
        cfg = cfg._replace(tile_h=8)
    return g, cfg, active


@pytest.mark.gpu
@pytest.mark.parametrize('name', VARIANTS)
def test_kernel_matches_plain_variants(cuda, name):
    model, cases = cell_inputs('dnerf_800.serve', cuda, n_views=1)
    g, view = cases[0]
    g, cfg, active = variant(name, g, model.rcfg, model.active_sh_degree,
                             cuda)
    with torch.no_grad():
        errs, ties = compare(g, view, cfg, active)
        if name == 'colors':
            got = pre_mod.preprocess(g, view, cfg, active)
            assert got.colors is g.colors
    print(name, errs, 'tie rows', ties)


@pytest.mark.gpu
@pytest.mark.parametrize('active', ['cpu_tensor', 'int64'])
def test_launch_refuses_an_active_degree_off_the_card(cuda, active):
    """The active SH degree goes in as the model's int32 tensor on the
    card, which the kernel reads there: a host tensor, which the launch
    would have to read, or another dtype is refused."""
    g, view = toy_inputs(device=cuda), toy_view(cuda)
    value = {'cpu_tensor': torch.tensor(2, dtype=torch.int32),
             'int64': torch.tensor(2, device=cuda)}[active]
    before = pre_mod.preprocess_fwd.launches
    with pytest.raises(ValueError):
        pre_mod.preprocess_fwd.launch(g, view, toy_rcfg(), value)
    assert pre_mod.preprocess_fwd.launches == before


def planted_inputs(dev, n=2048, size=256):
    """A camera at the origin looking down +z (Tw2v the identity, square
    image, equal fields of view) and random Gaussians in front of it, with
    planted rows: behind ``near`` (z 0.1, 0 and -1), det == 0 (at x == y,
    unrotated, scales (0, 0, 1e4): the Jacobian's two z terms are equal, so
    cxx == cxy == cyy once the low-pass 0.3 is lost to rounding, every
    product exact or the same on both sides) and dead ones (mask off)."""
    g = toy_inputs(n=n, seed=11)
    means = g.means3d.clone()
    means[:, 2] = means[:, 2].abs() + 1.5
    means[0] = torch.tensor([0.2, 0.1, 0.1])
    means[1] = torch.tensor([0.0, 0.0, 0.0])
    means[2] = torch.tensor([0.1, -0.3, -1.0])
    means[3] = torch.tensor([0.1, 0.1, 2.0])
    scales, rot = g.scales.clone(), g.rotations.clone()
    scales[3] = torch.tensor([0.0, 0.0, 1e4])
    rot[3] = torch.tensor([0.0, 0.0, 0.0, 1.0])
    mask = g.mask.clone()
    mask[:4] = True
    mask[4:8] = False
    g = g._replace(means3d=means, scales=scales, rotations=rot, mask=mask)
    tan = math.tan(0.35)
    Tv2c = perspective_opencv(0.7, 1.0, 0.01, 100.0)
    view = ViewParams(Tw2v=torch.eye(4), Tv2c=Tv2c,
                      campos=torch.zeros(3), tan_fovx=torch.tensor(tan),
                      tan_fovy=torch.tensor(tan))
    g = GaussianInputs(*(None if t is None else t.to(dev) for t in g))
    view = view.to(dev)
    cfg = RasterConfig(image_width=size, image_height=size,
                       pair_capacity=2 ** 18)
    return g, view, cfg


@pytest.mark.gpu
def test_kernel_matches_plain_on_planted_rows(cuda):
    g, view, cfg = planted_inputs(cuda)
    with torch.no_grad():
        ref = pre_mod.preprocess_plain(g, view, cfg)
        p_view, _ = pre_mod.project_points(g.means3d, view)
        cov2d = pre_mod.compute_cov2d(
            p_view, pre_mod.compute_cov3d(g.scales, g.rotations), view, cfg)
        det = cov2d[:, 0] * cov2d[:, 2] - cov2d[:, 1] * cov2d[:, 1]
        assert float(det[3]) == 0.0 and float(p_view[3, 2]) > cfg.near
        assert not ref.visible[:8].any()
        assert ref.visible[8:].any()
        compare(g, view, cfg, None)


@pytest.mark.gpu
def test_a_served_request_makes_no_sync_and_one_launch(cuda):
    from test_torch_deform_graph import bench_model
    model, times, views = bench_model('dnerf_800.serve', cuda)
    bg = torch.ones(3, device=cuda)
    ts = [torch.tensor(t, device=cuda) for t in times[:3]]
    render_eval(model, views[0], ts[0], bg, 'sk')     # builds and captures
    torch.cuda.synchronize()
    before = pre_mod.preprocess_fwd.launches
    torch.cuda.set_sync_debug_mode('error')
    try:
        for view, t in zip(views, ts):
            render_eval(model, view, t, bg, 'sk')
    finally:
        torch.cuda.set_sync_debug_mode('default')
    torch.cuda.synchronize()
    assert pre_mod.preprocess_fwd.launches == before + len(ts)


@pytest.mark.gpu
def test_grad_takes_the_plain_version(cuda):
    g = toy_inputs(requires_grad=True, device=cuda)
    before = pre_mod.preprocess_fwd.launches
    out = pre_mod.preprocess(g, toy_view(cuda), toy_rcfg())
    out.means2d.sum().backward()
    assert pre_mod.preprocess_fwd.launches == before
    assert g.means3d.grad is not None


@pytest.mark.gpu
def test_kernel_span_inside_preprocess(cuda):
    model = toy_model_on(cuda)
    view = toy_view(cuda)
    bg = torch.ones(3, device=cuda)
    t = torch.tensor(0.3, device=cuda)
    render_eval(model, view, t, bg, 'sk')
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(2):
            render_eval(model, view, t, bg, 'sk')
    ranges = {}
    for e in prof.events():
        ranges.setdefault(e.name, []).append(
            (e.time_range.start, e.time_range.end))
    inner, outer = ranges['sk.preprocess.kernel'], ranges['sk.preprocess']
    assert len(inner) == len(outer) == 2
    for (a, b), (c, d) in zip(sorted(inner), sorted(outer)):
        assert c <= a and b <= d


def toy_model_on(dev):
    from sk_gs_tpu_torch import convert
    from sk_gs_tpu_torch.framework.random_model import random_model_flat
    cfg, rcfg, _ = toy_cfg()
    flat = random_model_flat(cfg, 3, n_alive=400, log_scale_mean=-3.0)
    return convert.model_from_flat(flat, cfg, rcfg, device=dev,
                                   trainable=False)


# ------------------------------------ the benchmark's reader of the span

SHARE = 'serve.preprocess_kernel_share'


def share_reading(spans):
    from bench_port import harness
    from bench_port.trace import Trace
    events = [{'ph': 'X', 'cat': 'user_annotation', 'name': name, 'ts': a,
               'dur': b - a} for name, rs in spans.items() for a, b in rs]
    mod = harness.load_metric(SHARE, ROOT / 'bench_port' / 'metrics')
    return mod.read(type('Reading', (), {'trace': Trace(events)})())


SHARE_CASES = {
    # name: (kernel spans, share); three requests
    'every_request': ([(12, 13), (32, 33), (52, 53)], 1.0),
    'one_of_three': ([(12, 13)], 1 / 3),
    'none': ([], 0.0),           # plain preprocess, as without the kernel
}


@pytest.mark.parametrize('case', list(SHARE_CASES))
def test_kernel_share_reader(case):
    kernel, want = SHARE_CASES[case]
    spans = {'bench_window': [(0, 70)],
             'render_eval': [(10, 20), (30, 40), (50, 60)],
             'sk.request': [(10, 19), (30, 39), (50, 59)],
             'sk.preprocess': [(11, 14), (31, 34), (51, 54)],
             'sk.preprocess.kernel': kernel}
    got = share_reading(spans)
    assert got == pytest.approx(want, rel=1e-12)
    del spans['sk.request']
    assert share_reading(spans) is None


def test_kernel_share_reader_imports_nothing_of_the_port():
    import ast
    tree = ast.parse((ROOT / 'bench_port' / 'metrics'
                      / f'{SHARE}.py').read_text())
    for node in ast.walk(tree):
        assert not isinstance(node, (ast.Import, ast.ImportFrom))
