"""The port's viewer (``sk_gs_tpu_torch/cli/viewer.py``) against the JAX
package's root ``viewer.py``: its helpers equal; ``render_topk`` against
the JAX one (ids equal, weights 1e-5) on ``tests/test_viewer_pick.py``'s
scene, on a random scene at two chunk sizes and on a dense opaque one
where a pixel's transmittance falls below 1e-4 inside a chunk and resumes
at the next (the JAX picking's rule, which the port's ``render`` does not
share: the top-k is held to the JAX function, not to the render); and the
port's HTTP server on localhost against the JAX ``ViewerState`` on the
same small model (converted through a checkpoint): ``/info`` equal, each
render mode's PNG within 1 of 255 a channel, ``/pick``'s superpoint equal
and its weight within 1e-4, ``/skeleton``'s ``alive``, ``bones`` and
``root`` equal and ``xy`` within 0.1 px, a bad mode 400, an unknown path
404."""
import io
import json
import threading
import types
import urllib.error
import urllib.request
from http.server import ThreadingHTTPServer

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import viewer as jviewer
from sk_gs_tpu.render import render_topk as jax_render_topk
from sk_gs_tpu.render.settings import GaussianInputs as JGaussianInputs
from sk_gs_tpu_torch.cli import viewer as tviewer
from sk_gs_tpu_torch.render.render import render_topk
from tests.test_render import CFG, build_inputs, make_view
from tests.test_torch_cli import one_torch_thread  # noqa: F401
from tests.test_torch_render import port_cfg, port_inputs, port_view
from tests.test_torch_slice import CAP, M, port_model, tiny_jax_model

W_TOL = 1e-5
# requests: (theta, phi, radius, t, pose 'x,y,z;...', sel)
REQUESTS = ((0.0, 0.3, 4.0, 0.0, '', -1),
            (0.7, -0.2, 3.5, 0.45, '0.3,0,0.2;0,0.5,0', 2),
            (-1.1, 0.6, 4.5, 1.0, '0,0,0;0.1,0.1,0.1;-0.4,0.2,0', 0))
PICKS = ((32, 24), (10, 40), (50, 5), (63, 47))
SMOKE = 'configs/synthetic_smoke.yaml'


@pytest.mark.parametrize('n', [5, 40])
def test_palette_and_pose_helpers_match(n):
    np.testing.assert_array_equal(tviewer.superpoint_palette(n),
                                  jviewer.superpoint_palette(n))
    for s in ('', '0.1,0.2,0.3', '1,2;3,4,5,6;x,1;', '0.5;;-1,-2,-3'):
        np.testing.assert_array_equal(tviewer.parse_pose(s, 3),
                                      jviewer.parse_pose(s, 3))
    rng = np.random.default_rng(n)
    for _ in range(20):
        idx = rng.integers(-1, 12, size=8).astype(np.int32)
        w = rng.uniform(size=8).astype(np.float32)
        p2sp = rng.integers(0, 4, size=10)
        assert tviewer.dominant_superpoint(idx, w, p2sp, 4) == \
            jviewer.dominant_superpoint(idx, w, p2sp, 4)
    assert tviewer.PAGE == jviewer.PAGE


def assert_topk_equal(g, view, cfg, k):
    ji, jw = jax_render_topk(g, view, cfg, k=k)
    ti, tw = render_topk(port_inputs(g), port_view(view), port_cfg(cfg), k=k)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=0,
                               atol=W_TOL)
    return ti.numpy(), tw.numpy()


def test_render_topk_pick_case():
    """``tests/test_viewer_pick.py``'s scene: the opaque front Gaussian
    wins the centre pixel."""
    n = 6
    means = np.zeros((n, 3), np.float32)
    means[:, 2] = np.linspace(2.0, 4.0, n)
    means[1:, 0] = np.linspace(-0.5, 0.5, n - 1)
    g = JGaussianInputs(
        means3d=jnp.asarray(means), scales=jnp.full((n, 3), 0.2),
        rotations=jnp.tile(jnp.asarray([[0.0, 0, 0, 1]]), (n, 1)),
        opacities=jnp.asarray([0.95] + [0.1] * (n - 1)),
        colors=jnp.ones((n, 3)))
    idx, w = assert_topk_equal(g, make_view(), CFG, 3)
    assert idx[24, 32, 0] == 0 and w[24, 32, 0] > 0.5


@pytest.mark.parametrize('chunk', [16, 64])
def test_render_topk_random_scene(chunk):
    g = build_inputs(np.random.default_rng(3), n=300)
    idx, _ = assert_topk_equal(g, make_view(), CFG._replace(chunk=chunk), 8)
    assert (idx >= 0).sum() > 1000


def dense_opaque_scene(rng, n=400):
    """Many near-opaque Gaussians stacked in front of the camera: most
    pixels' transmittance falls below 1e-4 within a few entries."""
    means = np.stack([rng.uniform(-0.4, 0.4, n), rng.uniform(-0.3, 0.3, n),
                      rng.uniform(-0.5, 0.5, n)], -1).astype(np.float32)
    q = rng.normal(size=(n, 4)).astype(np.float32)
    return JGaussianInputs(
        means3d=jnp.asarray(means),
        scales=jnp.asarray(rng.uniform(0.08, 0.2, (n, 3)), jnp.float32),
        rotations=jnp.asarray(q / np.linalg.norm(q, axis=-1, keepdims=True)),
        opacities=jnp.asarray(rng.uniform(0.9, 0.99, n), jnp.float32),
        colors=jnp.ones((n, 3)))


def test_render_topk_resumes_at_the_next_chunk():
    """The JAX rule held: a pixel whose transmittance fell below 1e-4 in a
    chunk contributes again from the next chunk, so the top-k depends on
    where the chunks cut the lists (unlike the render, which stops a pixel
    for good); the port equals the JAX function at both cuts."""
    g = dense_opaque_scene(np.random.default_rng(11))
    out = {c: assert_topk_equal(g, make_view(), CFG._replace(chunk=c), 8)
           for c in (16, 64)}
    (i16, w16), (i64, w64) = out[16], out[64]
    # the resumed entries weigh ~T_EPS: they fill the slots the opaque
    # front leaves, and differ with the cut
    assert (i16 != i64).any() and np.abs(w16 - w64).max() > 0


# ------------------------------------------------------------ the server


def viewer_model():
    """The tiny sk model of ``test_torch_slice`` with a random Gaussian ->
    superpoint map, for both packages."""
    cfg, rcfg, model = tiny_jax_model()
    p2sp = np.random.default_rng(5).integers(0, M, CAP).astype(np.int32)
    return cfg, rcfg._replace(use_pallas=False), model._replace(
        p2sp=jnp.asarray(p2sp))


@pytest.fixture(scope='module')
def states(tmp_path_factory):
    cfg, rcfg, model = viewer_model()
    tmodel = port_model(cfg, rcfg, model, tmp_path_factory.mktemp('ckpt'))
    jview, tview = make_view(), port_view(make_view())
    meta = types.SimpleNamespace(num_frames=6)
    jscene = types.SimpleNamespace(image_size=(64, 48),
                                   campos=np.asarray(jview.campos)[None],
                                   view=lambda i: jview)
    tscene = types.SimpleNamespace(image_size=(64, 48),
                                   campos=tview.campos[None],
                                   view=lambda i: tview)
    jstate = jviewer.ViewerState(None, jscene, meta, cfg, rcfg, model, 'sk')
    tstate = tviewer.ViewerState(None, tscene, meta, tmodel.cfg,
                                 port_cfg(rcfg), tmodel, 'sk')
    server = ThreadingHTTPServer(('127.0.0.1', 0),
                                 tviewer.make_handler(tstate))
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    yield jstate, f'http://127.0.0.1:{server.server_address[1]}'
    server.shutdown()
    server.server_close()
    thread.join()


def get(url):
    with urllib.request.urlopen(url, timeout=120) as r:
        return r.status, r.headers['Content-Type'], r.read()


def query(theta, phi, radius, t, pose, sel=None):
    q = f'theta={theta}&phi={phi}&radius={radius}&t={t}&pose={pose}'
    return q if sel is None else q + f'&sel={sel}'


def test_info_and_page(states):
    jstate, base = states
    status, ctype, body = get(base + '/info')
    assert (status, ctype) == (200, 'application/json')
    assert json.loads(body) == json.loads(jstate.info_json())
    status, ctype, body = get(base + '/')
    assert (status, ctype, body) == (200, 'text/html', jviewer.PAGE.encode())


@pytest.mark.parametrize('mode', ['rgb', 'opacity', 'superpoints'])
def test_render_modes_match_jax(states, mode):
    jstate, base = states
    for theta, phi, radius, t, pose, sel in REQUESTS:
        status, ctype, body = get(f'{base}/render?mode={mode}&'
                                  + query(theta, phi, radius, t, pose, sel))
        assert (status, ctype) == (200, 'image/png')
        got = np.asarray(Image.open(io.BytesIO(body))).astype(int)
        ref = np.asarray(Image.open(io.BytesIO(jstate.render_png(
            theta, phi, radius, t, mode, jviewer.parse_pose(pose, M),
            sel)))).astype(int)
        assert got.shape == ref.shape == (48, 64, 3)
        assert np.abs(got - ref).max() <= 1
        assert got.std() > 1  # not a blank frame


def test_pick_matches_jax(states):
    jstate, base = states
    picked = []
    for theta, phi, radius, t, pose, _ in REQUESTS:
        for x, y in PICKS:
            _, ctype, body = get(f'{base}/pick?x={x}&y={y}&'
                                 + query(theta, phi, radius, t, pose))
            got = json.loads(body)
            ref = json.loads(jstate.pick_json(
                theta, phi, radius, t, jviewer.parse_pose(pose, M), x, y))
            assert ctype == 'application/json'
            assert got['superpoint'] == ref['superpoint']
            assert (got['x'], got['y']) == (ref['x'], ref['y'])
            assert abs(got['weight'] - ref['weight']) <= 1e-4
            picked.append(got['superpoint'])
    assert max(picked) >= 0


def test_skeleton_matches_jax(states):
    jstate, base = states
    for theta, phi, radius, t, pose, _ in REQUESTS:
        _, _, body = get(f'{base}/skeleton?'
                         + query(theta, phi, radius, t, pose))
        got = json.loads(body)
        ref = json.loads(jstate.skeleton_json(
            theta, phi, radius, t, jviewer.parse_pose(pose, M)))
        for key in ('alive', 'bones', 'root'):
            assert got[key] == ref[key], key
        np.testing.assert_allclose(got['xy'], ref['xy'], rtol=0, atol=0.1)
        assert sum(got['alive']) > 0


def test_bad_requests(states):
    _, base = states
    for path, code in (('/render?mode=depth', 400),
                       ('/render?theta=abc', 400), ('/nothing', 404)):
        with pytest.raises(urllib.error.HTTPError) as e:
            get(base + path)
        assert e.value.code == code


# ------------------------------------------------------------ the entry point


def smoke_checkpoint(tmp_path):
    """A random ``sk`` model at configs/synthetic_smoke.yaml's widths,
    saved through the port's checkpoint."""
    from sk_gs_tpu_torch import convert
    from sk_gs_tpu_torch.framework import build
    from sk_gs_tpu_torch.framework.checkpoint import CheckpointManager
    from sk_gs_tpu_torch.framework.config import make_config
    from sk_gs_tpu_torch.framework.random_model import random_model_flat
    cfg = make_config(SMOKE, [f'dataset.root={tmp_path}'])
    meta = types.SimpleNamespace(num_frames=cfg['dataset']['num_frames'])
    size = cfg['dataset']['image_size']
    skcfg, rcfg = build.build_model_cfg(cfg, meta, (size, size))
    flat = random_model_flat(skcfg, 0, n_alive=400)
    model = convert.model_from_flat(flat, skcfg, rcfg, device='cpu')
    state = {'model/' + k: v for k, v in convert.model_to_flat(model).items()}
    return CheckpointManager(tmp_path / 'ckpt').save(state, 100, force=True,
                                                     name='sk.npz')


def test_build_state_serves_a_checkpoint_on_the_cpu(tmp_path):
    """``cli.viewer``'s ``build_state`` from a config and a port checkpoint
    with ``--device cpu``: every route's function answers."""
    ckpt = smoke_checkpoint(tmp_path)
    state = tviewer.build_state(tviewer.parse_args([
        '-c', SMOKE, '--load', str(ckpt), '--device', 'cpu', '--set',
        f'dataset.root={tmp_path}']))
    assert state.device.type == 'cpu' and state.stage == 'sk'
    info = json.loads(state.info_json())
    assert (info['width'], info['height'], info['num_joints']) == (
        48, 48, 16)
    pose = np.zeros((16, 3), np.float32)
    for mode in tviewer.MODES:
        img = np.asarray(Image.open(io.BytesIO(state.render_png(
            0.3, 0.2, state.radius0, 0.5, mode, pose))))
        assert img.shape == (48, 48, 3)
    pick = json.loads(state.pick_json(0.3, 0.2, state.radius0, 0.5, pose,
                                      24, 24))
    assert set(pick) == {'superpoint', 'weight', 'x', 'y'}
    skel = json.loads(state.skeleton_json(0.3, 0.2, state.radius0, 0.5,
                                          pose))
    assert len(skel['xy']) == 16 and set(skel) == {'xy', 'alive', 'bones',
                                                   'root'}


def test_viewer_refuses_cpu_fallback(tmp_path, monkeypatch):
    """Without ``--device cpu`` the viewer needs the card: no fallback."""
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='cuda'):
        tviewer.build_state(tviewer.parse_args([
            '-c', SMOKE, '--load', str(tmp_path / 'none.npz')]))
