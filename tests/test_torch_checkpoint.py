"""Port parity, checkpoints: a port checkpoint loads into the JAX trainer's
``ckpt_state()`` template (``load_into_pytree``) with every leaf taken from
the file, a JAX checkpoint restores into the port's trainer with every leaf
equal, both managers rotate the same files, and ``restore`` sets the JAX
flags; the PLY writer gives the JAX package's bytes and the PNG writer
files that Pillow decodes. Both trainers run ``configs/synthetic_smoke.yaml``
on the CPU."""
import jax
import numpy as np
import pytest
import torch
from PIL import Image

from sk_gs_tpu.framework import checkpoint as jckpt
from sk_gs_tpu.framework.config import make_config as jmake_config
from sk_gs_tpu.framework.trainer import SKGSTrainer as JTrainer
from sk_gs_tpu.models import gaussian_splatting as jgs
from sk_gs_tpu.models import sk_gs as jsk_gs
from sk_gs_tpu.utils import ply as jply
from sk_gs_tpu_torch import convert
from sk_gs_tpu_torch.framework import build, checkpoint
from sk_gs_tpu_torch.framework.config import make_config
from sk_gs_tpu_torch.framework.trainer import SKGSTrainer
from sk_gs_tpu_torch.models import sk_gs
from sk_gs_tpu_torch.models.gaussian_splatting import init_from_pcd
from sk_gs_tpu_torch.models.losses import LossWeights
from sk_gs_tpu_torch.utils import ply, png
from tests.test_torch_cli import one_torch_thread  # noqa: F401

CONFIG = 'configs/synthetic_smoke.yaml'
# steps of each stage of the smoke schedule: init_fix 1-10, init 11-40,
# sp_fix 41-50, sp 51-110, sk_init 111-120, sk 121-180
STAGE_STEPS = (5, 30, 45, 100, 115, 150)


def smoke_cfg(tmp):
    return make_config(CONFIG, [f'dataset.root={tmp}'])


def port_trainer(cfg, steps=0):
    scene, meta, eval_scene, pcd = build.build_scene(cfg, 'cpu')
    skcfg, rcfg = build.build_model_cfg(cfg, meta, scene.image_size)
    pts, cols = build.initial_point_cloud(cfg, pcd)
    model = sk_gs.init_model(skcfg, rcfg,
                             init_from_pcd(pts, cols, skcfg.gauss, 'cpu'),
                             meta.train_times, device='cpu')
    tr = SKGSTrainer(skcfg, rcfg, scene, meta, model,
                     loss_weights=LossWeights(cfg['loss']), pcd=(pts, cols),
                     sampler=build.build_sampler(cfg, scene, skcfg),
                     device='cpu', **build.trainer_options(cfg))
    for s in range(1, steps + 1):
        tr.train_step(s)
    return tr


@pytest.fixture(scope='module')
def smoke(tmp_path_factory):
    """(config, the port's trainer after 3 steps, the JAX trainer)."""
    from train import build_model_cfg, build_scene
    tmp = tmp_path_factory.mktemp('data')
    cfg = smoke_cfg(tmp)
    tr = port_trainer(cfg, steps=3)
    jcfg = jmake_config(CONFIG, [f'dataset.root={tmp}'])
    scene, meta, eval_scene, _ = build_scene(jcfg)
    skcfg, rcfg = build_model_cfg(jcfg, meta, scene.image_size)
    pts, cols = build.initial_point_cloud(cfg)
    model = jsk_gs.init_model(jax.random.PRNGKey(0), skcfg,
                              jgs.init_from_pcd(pts, cols, skcfg.gauss),
                              np.asarray(meta.train_times))
    jt = JTrainer(skcfg, rcfg, scene, meta, model, eval_scene=eval_scene,
                  pcd=(pts, cols))
    return cfg, tr, jt


def jax_template(jt):
    return {'state': jt.ckpt_state(), 'meta': {'step': 0}}


def flat_of(tree):
    return jckpt._flatten(tree)


def test_port_checkpoint_loads_into_jax(smoke, tmp_path):
    """Every leaf of the JAX template comes from the port's file, in the
    template's shape and dtype; the port's extra keys are its own."""
    cfg, tr, jt = smoke
    tr.model.joint_depth.copy_(torch.arange(tr.model.joint_depth.shape[0]))
    tr.best_psnr, tr.skeleton_initialized = 21.5, True
    path = checkpoint.CheckpointManager(tmp_path).save(
        tr.ckpt_state, 3, force=True, name='port.npz')
    written = checkpoint.load(path)
    template = flat_of(jax_template(jt))
    extra = set(written) - set(template)
    assert extra == {'state/' + convert.NOISE_GEN_KEY,
                     'state/' + convert.BG_GEN_KEY,
                     'state/' + convert.TIME_GEN_KEY,
                     'state/' + convert.REG_GEN_KEY,
                     'state/' + convert.KNN_OWN_KEY}
    assert set(template) <= set(written)
    loaded = flat_of(jckpt.load_into_pytree(jax_template(jt), path))
    assert set(loaded) == set(template)
    for k, ref in template.items():
        got = loaded[k]
        assert got.shape == ref.shape, k
        assert got.dtype == ref.dtype, (k, got.dtype, ref.dtype)
        np.testing.assert_array_equal(got, written[k], err_msg=k)
    assert float(loaded['state/flags/best_psnr']) == 21.5
    assert loaded['state/model/joint_depth'][5] == 5
    assert int(loaded['state/opt/count']) == 3


def test_jax_checkpoint_restores_into_port(smoke, tmp_path):
    """A JAX trainer checkpoint restores into the port's trainer, and the
    port's checkpoint of it holds every JAX leaf equal."""
    cfg, tr, jt = smoke
    path = tmp_path / 'jax.npz'
    jckpt.CheckpointManager(tmp_path).save(jt.ckpt_state(), 7, force=True,
                                           name='jax.npz')
    ref = checkpoint.load(path)
    fresh = port_trainer(cfg)
    fresh.restore(ref, checkpoint.step_of(ref))
    assert fresh.step == 7
    got = {'state/' + k: v for k, v in fresh.ckpt_state().items()}
    for k, v in ref.items():
        if k in ('meta/step', 'state/flags/key'):
            continue
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    assert got['state/flags/gs_knn_index'].dtype == np.int32


def test_manager_rotation_matches_jax(smoke, tmp_path):
    cfg, tr, jt = smoke
    state = {'model/x': np.zeros(2, np.float32)}
    jm = jckpt.CheckpointManager(tmp_path / 'jax', interval=3, max_keep=2)
    pm = checkpoint.CheckpointManager(tmp_path / 'port', interval=3,
                                      max_keep=2)
    for step in range(1, 14):
        jm.save({'model': {'x': state['model/x']}}, step)
        pm.save(state, step)
        if step in (4, 11):
            jm.save({'model': {'x': state['model/x']}}, step, force=True,
                    name=f'pin{step}.npz', manage=False)
            pm.save(state, step, force=True, name=f'pin{step}.npz',
                    manage=False)
    names = lambda d: sorted(p.name for p in d.iterdir())
    assert names(tmp_path / 'port') == names(tmp_path / 'jax') == [
        'checkpoint_00000009.npz', 'checkpoint_00000012.npz', 'pin11.npz',
        'pin4.npz']
    assert pm.latest_step() == jm.latest_step() == 12
    assert checkpoint.step_of(pm.load()) == 12


@pytest.mark.parametrize('step', STAGE_STEPS)
def test_restore_flags_match_jax(smoke, tmp_path, step):
    """A checkpoint with the flags unset, restored at a step of each stage:
    the flags OR-ed with the schedule, as the JAX ``restore`` sets them,
    and ``best_psnr`` read back. Inside sp_fix / sp the JAX trainer rebuilds
    an all-zero KNN; the port does so for a JAX checkpoint and keeps the
    zeros of its own (a resumed run then goes on as an uninterrupted one)."""
    cfg, tr, jt = smoke
    tr.sp_initialized = tr.reinit_done = tr.skeleton_initialized = False
    tr.best_psnr = 17.25
    tr.gs_knn_index.zero_()
    path = checkpoint.CheckpointManager(tmp_path).save(
        tr.ckpt_state, step, force=True, name='c.npz')
    loaded = jckpt.load_into_pytree(jax_template(jt), path)
    jt.restore(loaded['state'], step)
    fresh = port_trainer(cfg)
    flat = checkpoint.load(path)
    fresh.restore(flat, step)
    for name in convert.TRAINER_FLAGS:
        assert getattr(fresh, name) == bool(getattr(jt.state, name)), name
    assert fresh.best_psnr == jt.state.best_psnr == 17.25
    rebuilt = jt.cfg.stage_at(step) in ('sp_fix', 'sp')
    assert np.asarray(jt.state.gs_knn_index).any() == rebuilt
    assert not fresh.gs_knn_index.any()
    # a JAX-written checkpoint (no port mark) is rebuilt as JAX rebuilds it
    flat.pop('state/' + convert.KNN_OWN_KEY)
    fresh.restore(flat, step)
    alive = flat['state/model/alive']
    np.testing.assert_array_equal(
        np.sort(fresh.gs_knn_index.numpy()[alive], axis=1),
        np.sort(np.asarray(jt.state.gs_knn_index)[alive], axis=1))


def test_noise_generator_round_trip(smoke, tmp_path):
    cfg, tr, jt = smoke
    path = checkpoint.CheckpointManager(tmp_path).save(
        tr.ckpt_state, 3, force=True, name='g.npz')
    want = torch.rand(5, generator=tr.noise_gen)
    fresh = port_trainer(cfg)
    fresh.restore(checkpoint.load(path), 3)
    torch.testing.assert_close(torch.rand(5, generator=fresh.noise_gen), want,
                               rtol=0, atol=0)


def test_pad_capacity(smoke):
    cfg, tr, jt = smoke
    flat = {'state/' + k: v for k, v in tr.ckpt_state().items()}
    cap = flat['state/model/params/xyz'].shape[0]
    big = checkpoint.pad_capacity(flat, cap + 64)
    for k in checkpoint.per_gaussian_keys(flat):
        assert big[k].shape[0] == cap + 64, k
    assert not big['state/model/alive'][cap:].any()
    assert (big['state/model/params/scaling'][cap:] == -10).all()
    assert big['state/model/joint_cost'].shape == \
        flat['state/model/joint_cost'].shape
    with pytest.raises(ValueError):
        checkpoint.pad_capacity(big, cap)


def gaussian_params(rng, n=50, rest=3):
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    return {'xyz': f(n, 3), 'f_dc': f(n, 1, 3), 'f_rest': f(n, rest, 3),
            'opacity': f(n, 1), 'scaling': f(n, 3), 'rotation': f(n, 4)}


def test_ply_bytes_match_jax(rng, tmp_path):
    params = gaussian_params(rng)
    alive = rng.uniform(size=50) > 0.3
    ply.save_gaussian_ply(tmp_path / 'port.ply', params, alive)
    jply.save_gaussian_ply(tmp_path / 'jax.ply', params, alive)
    assert (tmp_path / 'port.ply').read_bytes() == \
        (tmp_path / 'jax.ply').read_bytes()
    back = ply.load_gaussian_ply(tmp_path / 'port.ply')
    ref = jply.load_gaussian_ply(tmp_path / 'jax.ply')
    for k, v in params.items():
        np.testing.assert_array_equal(back[k], v[alive], err_msg=k)
        np.testing.assert_array_equal(back[k], ref[k], err_msg=k)


@pytest.mark.parametrize('fmt', ['ascii', 'binary'])
def test_point_ply_matches_jax(rng, tmp_path, fmt):
    pts = rng.normal(size=(20, 3)).astype(np.float32)
    rgb = rng.integers(0, 256, size=(20, 3)).astype(np.uint8)
    head = ['ply', f'format {"ascii" if fmt == "ascii" else "binary_little_endian"} 1.0',
            'element vertex 20', 'property float x', 'property float y',
            'property float z', 'property uchar red', 'property uchar green',
            'property uchar blue', 'end_header']
    path = tmp_path / 'p.ply'
    with path.open('wb') as f:
        f.write(('\n'.join(head) + '\n').encode())
        if fmt == 'ascii':
            for p, c in zip(pts, rgb):
                f.write((' '.join(f'{x!r}' for x in p.tolist())
                         + ' ' + ' '.join(str(x) for x in c) + '\n').encode())
        else:
            dt = np.dtype([('x', '<f4'), ('y', '<f4'), ('z', '<f4'),
                           ('r', 'u1'), ('g', 'u1'), ('b', 'u1')])
            rec = np.zeros(20, dt)
            rec['x'], rec['y'], rec['z'] = pts.T
            rec['r'], rec['g'], rec['b'] = rgb.T
            f.write(rec.tobytes())
    got, ref = ply.load_point_ply(path), jply.load_point_ply(path)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(got[1], rgb / 255.0, rtol=1e-6)


def test_png_writer_decodes_in_pil(rng, tmp_path):
    img = rng.uniform(-0.1, 1.1, size=(17, 23, 3)).astype(np.float32)
    png.write_png(tmp_path / 'a.png', img)
    want = (np.clip(img, 0, 1) * 255).astype(np.uint8)
    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / 'a.png')),
                                  want)
    np.testing.assert_array_equal(png.read_png(tmp_path / 'a.png'), want)
    # Pillow's own files, every row filter: a smooth ramp plus noise
    yy, xx = np.mgrid[0:31, 0:29]
    for mode, c in (('RGB', 3), ('RGBA', 4), ('L', 1)):
        arr = ((xx[..., None] * 3 + yy[..., None] * 5 + np.arange(c) * 40
                + rng.integers(0, 4, size=(31, 29, c))) % 256).astype(np.uint8)
        arr = arr[..., 0] if c == 1 else arr
        Image.fromarray(arr, mode).save(tmp_path / 'b.png', optimize=True)
        np.testing.assert_array_equal(
            png.read_png(tmp_path / 'b.png').reshape(arr.shape), arr,
            err_msg=mode)
