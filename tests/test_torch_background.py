"""Port parity, the backgrounds composited per step ('random', 'random2',
'reference', 'checker'; reference ``datasets/base.py:125-170``).

``sample_background``'s semantics; one ``static`` training step (the
family whose step the JAX package compiles fastest: the compositing is the
same in every family) of the tiny model of test_torch_slice.py on an RGBA
scene per background type against
the JAX trainer's own ``train_step`` (its blend through XLA), both packages
handed the same background, drawn once with numpy, by monkeypatching each
package's ``sample_background`` (the packages draw from different random
streams); the evaluation of RGBA ground truth; and a ``cli.train`` run
with 'random' resumed from a checkpoint reaching the uninterrupted run's
``last.npz`` bit for bit (the background generator's state is in the
checkpoint).

Tolerances are test_torch_train.py's: losses rtol 2e-4, gradients 3e-4 of
each leaf's max magnitude, parameters after Adam as there.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sk_gs_tpu.data.base as jbase
from sk_gs_tpu.data import synthetic as jsynth
from sk_gs_tpu.framework.checkpoint import _flatten
from sk_gs_tpu.framework.trainer import SKGSTrainer as JaxTrainer
from sk_gs_tpu.models import losses as jlosses
from sk_gs_tpu_torch import convert
from sk_gs_tpu_torch.cli import train as cli_train
from sk_gs_tpu_torch.data import base
from sk_gs_tpu_torch.framework import trainer as ttrainer
from sk_gs_tpu_torch.framework.checkpoint import load
from sk_gs_tpu_torch.models import losses as tlosses
from tests.test_torch_cli import one_torch_thread  # noqa: F401
from tests.test_torch_render import to_np
from tests.test_torch_train import (LOSS, SCENE, close_rel, port_model,
                                    port_scene)
from tests.test_torch_slice import tiny_jax_model

H, W = SCENE['h'], SCENE['w']
# the fallback backgrounds of the evaluation: black, and the board
EVALUATED = ('random', 'checker')


@pytest.fixture(scope='module')
def rgba_scene():
    """The chain rendered as unpremultiplied RGBA (any dynamic type gives
    the same frames), its blend through XLA."""
    scene, meta, _ = jsynth.make_synthetic_scene(
        chunk=256, use_pallas=False, **{**SCENE, 'background': 'random'})
    assert scene.images.shape[-1] == 4
    return scene


def test_sample_background_semantics():
    gen = torch.Generator().manual_seed(3)
    r = base.sample_background('random', gen, 16, 20)
    assert r.shape == (16, 20, 3) and r.dtype == torch.float32
    assert 0.0 <= float(r.min()) and float(r.max()) < 1.0
    assert float(r.std()) > 0.1
    again = base.sample_background('random', torch.Generator().manual_seed(3),
                                   16, 20)
    torch.testing.assert_close(r, again, rtol=0, atol=0)
    assert not torch.equal(r, base.sample_background('random', gen, 16, 20))
    r2 = base.sample_background('random2', gen, 16, 20)
    assert r2.shape == (16, 20, 3)
    assert float(r2.std(dim=(0, 1)).max()) == 0.0
    assert float(r2[0, 0].std()) > 1e-3
    ref = torch.full((8, 8, 3), 0.3)
    assert base.sample_background('reference', gen, 8, 8,
                                  reference_rgb=ref) is ref
    board = torch.from_numpy(base.image_checkerboard(8, 8))
    assert base.sample_background('checker', gen, 8, 8, checker=board) \
        is board
    with pytest.raises(NotImplementedError):
        base.sample_background('white', gen, 8, 8)


def draw(kind: str) -> np.ndarray:
    rng = np.random.default_rng(11)
    if kind == 'random2':
        return np.broadcast_to(rng.uniform(size=(1, 1, 3)), (H, W, 3)) \
            .astype(np.float32)
    return rng.uniform(size=(H, W, 3)).astype(np.float32)


@pytest.fixture(scope='module')
def one_step(rgba_scene, tmp_path_factory):
    """Per background type: both trainers' metrics, gradients and models
    after one ``static`` step on the RGBA scene."""
    cfg, rcfg, model = tiny_jax_model()
    cfg = cfg._replace(train_schedule=(('static', 10),))
    rcfg = rcfg._replace(use_pallas=False)
    mp = pytest.MonkeyPatch()
    jorig, torig = jbase.sample_background, base.sample_background

    def handed(orig, to_array):
        def fn(kind, key, h, w, checker=None, reference_rgb=None):
            if kind in ('random', 'random2'):
                return to_array(draw(kind))
            return orig(kind, key, h, w, checker=checker,
                        reference_rgb=reference_rgb)
        return fn

    mp.setattr(jbase, 'sample_background', handed(jorig, jnp.asarray))
    mp.setattr(ttrainer, 'sample_background',
               handed(torig, torch.from_numpy))
    out = {}
    try:
        for kind in base.DYNAMIC_BG:
            board = base.image_checkerboard(H, W) if kind == 'checker' \
                else None
            jmeta = jbase.SceneMeta(background_type=kind, background=board)
            jt = JaxTrainer(cfg, rcfg, rgba_scene, jmeta, model,
                            loss_weights=jlosses.LossWeights(LOSS))
            captured = {}
            update = jt.opt_update

            def spy(grads, *a, _update=update, _into=captured, **kw):
                jax.debug.callback(
                    lambda g: _into.update(_flatten(jax.tree.map(
                        np.asarray, g))), grads)
                return _update(grads, *a, **kw)

            jt.opt_update = spy
            tmodel = port_model((cfg, rcfg, model),
                                tmp_path_factory.mktemp(kind))
            tt = ttrainer.SKGSTrainer(
                tmodel.cfg, tmodel.rcfg, port_scene(rgba_scene),
                base.SceneMeta(background_type=kind, background=board),
                tmodel, tlosses.LossWeights(LOSS), device='cpu')
            step = 1
            jm = {n: np.asarray(v) for n, v in jt.train_step(step).items()}
            tm = {n: to_np(v) for n, v in tt.train_step(step).items()}
            out[kind] = dict(
                jax=jm, port=tm, jgrads=dict(captured),
                tgrads={n: to_np(p.grad)
                        for n, p in tt.model.leaves().items()},
                lrs=tt.lr_trees(step), jflat=_flatten(jt.state.model),
                tflat=convert.model_to_flat(tt.model))
            if kind in EVALUATED:
                out[kind].update(
                    jeval=jt.evaluate(rgba_scene, stage='static'),
                    teval=tt.evaluate(tt.scene, stage='static'))
    finally:
        mp.undo()
    return out


@pytest.mark.parametrize('kind', base.DYNAMIC_BG)
def test_train_step_matches_jax(one_step, kind):
    s = one_step[kind]
    jm, tm = s['jax'], s['port']
    assert set(jm) == set(tm)
    for name in ('n_bad_grad', 'n_vis', 'num_pairs', 'overflow'):
        assert int(tm[name]) == int(jm[name]), name
    for name in ('loss', 'rgb', 'ssim'):
        np.testing.assert_allclose(tm[name], jm[name], rtol=2e-4,
                                   err_msg=name)
    np.testing.assert_allclose(tm['psnr'], jm['psnr'], rtol=1e-5)
    assert set(s['jgrads']) == set(s['tgrads'])
    for name, ref in s['jgrads'].items():
        if np.abs(ref).max() > 0:
            close_rel(s['tgrads'][name], ref, 3e-4, name)
        else:
            assert np.abs(s['tgrads'][name]).max() == 0, name
    for name, lr in s['lrs'].items():
        got, ref = s['tflat']['params/' + name], s['jflat']['params/' + name]
        g = np.abs(s['tgrads'][name])
        big = g > 1e-3 * g.max()
        err = np.abs(got - ref)
        assert err[big].max(initial=0.0) <= \
            1e-5 * np.abs(ref).max() + 0.01 * lr, name
        assert err.max() <= 2 * lr + 1e-5 * np.abs(ref).max(), name


def test_backgrounds_change_the_step(one_step):
    """Each type trains against another target: the losses differ."""
    losses = {k: float(v['port']['rgb']) for k, v in one_step.items()}
    assert len(set(losses.values())) == len(losses), losses


@pytest.mark.parametrize('kind', EVALUATED)
def test_evaluate_rgba_ground_truth_matches_jax(one_step, kind):
    """The evaluation composites RGBA ground truth over the fallback
    background: black for 'random', the board for 'checker'."""
    s = one_step[kind]
    for name in ('PSNR', 'SSIM'):
        np.testing.assert_allclose(s['teval'][name], s['jeval'][name],
                                   rtol=1e-5, err_msg=name)


def test_resume_with_random_background(tmp_path):
    """``cli.train`` with 'random' over 30 steps, and again from its
    step-15 checkpoint: the same ``last.npz``, the background generator's
    state included."""
    def args(root, *extra):
        return ['-c', 'configs/synthetic_smoke.yaml', '--device', 'cpu',
                '--steps', '30', '--set', f'output_dir={root}',
                f'dataset.root={tmp_path}', 'dataset.background=random',
                'train.checkpoint_interval=15', *extra]

    first = cli_train.main(args(tmp_path / 'a'))
    ck = tmp_path / 'a' / 'synthetic_smoke' / 'checkpoints'
    resumed = cli_train.main(args(tmp_path / 'b', '--resume',
                                  str(ck / 'checkpoint_00000015.npz')))
    a = load(ck / 'last.npz')
    b = load(tmp_path / 'b' / 'synthetic_smoke' / 'checkpoints' / 'last.npz')
    assert 'state/' + convert.BG_GEN_KEY in a
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert resumed['PSNR'] == first['PSNR']
