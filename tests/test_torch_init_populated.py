"""Port parity, the ``init`` family from a populated random start across
the step-3000 event, where the run diverges.

chip_smoke.py's populated start (``random_model_flat`` with 80% of the
slots alive and random warp nets, put in the ``init`` stage at SH degree 0,
the preset's loss weights, fresh Adam moments) runs steps 2995-3004. After
step 3000 it densifies, prunes and resets the opacity, and then it falls
apart: the pairs drop to almost none and ``c_net`` climbs. This file holds
that run to the JAX trainer: the preset's configuration
(``configs/synthetic_fullscale.yaml``, held equal to the port's preset by
test_torch_slice.py) cut to 2,048 slots (1,638 alive) and a 96 x 96 view of
the preset's scene, through the JAX trainer's own jitted ``train_step``
(``chunk`` schedule, Pallas in interpret mode, a chunk that holds each
tile's list) and through the port, over the same ten steps. The JAX
trainer's split noise is fed to the port. With 410 dead slots the event
also drops rows, as chip_smoke.py's full start does.

What is held, and why the bounds:
- steps 2995 and 2996 as test_torch_init.py holds a step: loss, rgb, ssim
  and c_net rtol 2e-4, ``num_pairs`` and ``n_vis`` exactly;
- every step: loss, rgb and ssim rtol 2e-2, c_net rtol 5e-2, ``num_pairs``
  and ``n_vis`` within 10% or 4 counts. Adam moves an entry whose gradient
  is near zero by about +-lr whichever way rounding tips it, and in a run
  that diverges each such flip grows with the steps after it: here the two
  sides drift apart to 6e-3 (loss), 1.6e-2 (c_net) and 8% of the pairs
  (236 against 218, at step 3003);
- the event: its counts exactly, ``alive`` equal after it;
- the divergence, on both sides alike: the last step keeps under 1% of the
  first step's pairs, and its ``c_net`` is over ten times step 2999's.
"""
import types

import jax
import numpy as np
import pytest
import torch

import sk_gs_tpu.render.tile_kernel as jtk
from sk_gs_tpu.data import synthetic as jsynth
from sk_gs_tpu.framework import trainer as jtrainer
from sk_gs_tpu.framework.checkpoint import load_into_pytree
from sk_gs_tpu.framework.config import make_config
from sk_gs_tpu.models import gaussian_splatting as jgs
from sk_gs_tpu.models import losses as jlosses
from sk_gs_tpu.models import sk_gs as jsk_gs
from sk_gs_tpu_torch import convert
from sk_gs_tpu_torch.data.base import SceneMeta
from sk_gs_tpu_torch.framework import trainer as ttrainer
from sk_gs_tpu_torch.framework.presets import synthetic_fullscale
from sk_gs_tpu_torch.framework.random_model import random_model_flat
from sk_gs_tpu_torch.models import losses as tlosses
from sk_gs_tpu_torch.models import sk_gs as tsk_gs
from sk_gs_tpu_torch.models.gaussian_splatting import densify_and_prune_noise
from tests.test_torch_render import port_cfg, to_np
from tests.test_torch_slice import to_port_cfg_fields
from tests.test_torch_train import port_scene
from train import build_model_cfg

CAP, N_ALIVE, PX = 2048, 1638, 96
STEPS = tuple(range(2995, 3005))
EVENT = 3000
FIRST_TIGHT = 2               # steps 2995 and 2996
METRICS = ('loss', 'rgb', 'ssim', 'c_net')


def jax_cfgs():
    """The preset's configuration, cut to CAP slots and a PX x PX view."""
    _, _, train = synthetic_fullscale()
    meta = types.SimpleNamespace(num_frames=train.dataset.num_frames)
    cfg, rcfg = build_model_cfg(
        make_config('configs/synthetic_fullscale.yaml', []), meta, (PX, PX))
    cfg = cfg._replace(gauss=cfg.gauss._replace(capacity=CAP))
    # chunk 1024 holds each tile's list of this view (module docstring)
    return cfg, rcfg._replace(pair_capacity=2 ** 15, chunk=1024), train


@pytest.fixture(scope='module')
def populated_runs(tmp_path_factory):
    old = jtk.INTERPRET, jtk.IMPL['schedule']
    jtk.INTERPRET, jtk.IMPL['schedule'] = True, 'chunk'
    try:
        yield _run_both(tmp_path_factory.mktemp('populated'))
    finally:
        jtk.INTERPRET, jtk.IMPL['schedule'] = old


def _run_both(tmp):
    cfg, rcfg, train = jax_cfgs()
    ds = train.dataset
    scene, meta, _ = jsynth.make_synthetic_scene(
        seed=train.seed, num_links=ds.num_links,
        gauss_per_link=ds.gauss_per_link, num_frames=ds.num_frames, h=PX,
        w=PX, background=ds.background, pair_capacity=2 ** 15,
        chunk=rcfg.chunk, use_pallas=True)
    tcfg = tsk_gs.SKGSConfig(**to_port_cfg_fields(cfg))
    trcfg = port_cfg(rcfg)._replace(schedule='chunk')
    flat = random_model_flat(tcfg, 0, N_ALIVE)
    flat['active_sh_degree'] = np.asarray(0, np.int32)

    # the JAX model: a template of the same configuration, filled from flat
    pts = np.random.default_rng(0).uniform(-1, 1, (64, 3)).astype(np.float32)
    template = jsk_gs.init_model(jax.random.PRNGKey(0), cfg,
                                 jgs.init_from_pcd(pts, pts, cfg.gauss),
                                 np.asarray(meta.train_times))
    np.savez(tmp / 'populated.npz', **flat)
    jt = jtrainer.SKGSTrainer(
        cfg, rcfg, scene, meta, load_into_pytree(template, tmp / 'populated.npz'),
        loss_weights=jlosses.LossWeights(train.loss), seed=train.seed)
    tt = ttrainer.SKGSTrainer(
        tcfg, trcfg, port_scene(scene),
        SceneMeta(background=meta.background,
                  cameras_extent=meta.cameras_extent),
        convert.model_from_flat(flat, tcfg, trcfg, device='cpu',
                                trainable=True),
        tlosses.LossWeights(train.loss), seed=train.seed, device='cpu')

    # the JAX trainer's densify key, and its split noise fed to the port
    keys = []

    def jax_densify(gm, opt, gcfg, extent, key, *args):
        keys.append(key)
        return jgs.densify_and_prune(gm, opt, gcfg, extent, key, *args)

    def port_densify(m, opt, gcfg, extent, generator, *args):
        _, k1, k2 = jax.random.split(keys[-1], 3)
        noise = [torch.from_numpy(np.array(jax.random.normal(
            k, (m.capacity, 3)))) for k in (k1, k2)]
        return densify_and_prune_noise(m, opt, gcfg, extent, *noise, *args)

    mp = pytest.MonkeyPatch()
    mp.setattr(jtrainer, 'densify_and_prune', jax_densify)
    mp.setattr(ttrainer, 'densify_and_prune', port_densify)
    runs = {'jax': [], 'port': []}
    try:
        for step in STEPS:
            jm = jt.train_step(step)
            tm = tt.train_step(step)
            runs['jax'].append({k: float(np.asarray(jm[k]))
                                for k in METRICS + ('num_pairs', 'n_vis')})
            runs['port'].append({k: float(to_np(tm[k]))
                                 for k in METRICS + ('num_pairs', 'n_vis')})
            if step == EVENT:
                runs['event'] = {k: int(v) for k, v in tt.last_event.items()}
                runs['jax_event'] = len(keys)
                runs['alive'] = (np.asarray(jt.state.model.alive),
                                 to_np(tt.model.alive).copy())
    finally:
        mp.undo()
    return runs


@pytest.mark.parametrize('k', range(len(STEPS)))
def test_populated_step_matches_jax(populated_runs, k):
    jm, tm = populated_runs['jax'][k], populated_runs['port'][k]
    tight = k < FIRST_TIGHT
    for name in METRICS:
        rtol = 2e-4 if tight else (5e-2 if name == 'c_net' else 2e-2)
        np.testing.assert_allclose(tm[name], jm[name], rtol=rtol,
                                   err_msg=f'{name} at {STEPS[k]}')
    for name in ('num_pairs', 'n_vis'):
        if tight:
            assert tm[name] == jm[name], name
        else:
            assert abs(tm[name] - jm[name]) <= max(0.1 * jm[name], 4), name


def test_populated_event_matches_jax(populated_runs):
    ev = populated_runs['event']
    assert populated_runs['jax_event'] == 1
    assert ev['opacity_reset'] == 1
    assert ev['n_cloned'] > 0 and ev['n_split'] > 0 and ev['n_dropped'] > 0
    j_alive, t_alive = populated_runs['alive']
    np.testing.assert_array_equal(t_alive, j_alive)
    assert int(t_alive.sum()) == (N_ALIVE + ev['n_cloned'] + ev['n_split']
                                  - ev['n_pruned'])


@pytest.mark.parametrize('side', ['jax', 'port'])
def test_populated_start_diverges_after_the_event(populated_runs, side):
    run = populated_runs[side]
    first, last = run[0], run[-1]
    before = run[STEPS.index(EVENT - 1)]
    assert last['num_pairs'] < 0.01 * first['num_pairs']
    assert last['c_net'] > 10 * before['c_net']


if __name__ == '__main__':
    # python -m tests.test_torch_init_populated: both runs, a line a step
    import json
    import tempfile
    from pathlib import Path
    jtk.INTERPRET, jtk.IMPL['schedule'] = True, 'chunk'
    with tempfile.TemporaryDirectory() as d:
        out = _run_both(Path(d))
    for step, j, t in zip(STEPS, out['jax'], out['port']):
        print(json.dumps({'step': step, 'jax': j, 'port': t}))
    print(json.dumps({'event': out['event'], 'alive_equal': bool(
        np.array_equal(*out['alive'])), 'n_alive': int(out['alive'][1].sum())}))
