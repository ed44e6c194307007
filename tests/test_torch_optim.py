"""Port parity, the optimizer registry: sk_gs_tpu_torch.models.optim's
Adam, AdamW, SGD and Adan against sk_gs_tpu.models.optim over 5 steps on
the same gradients (numpy, from a seed), a leaf at learning rate 0, and
the row and leaf surgery on every state type; and the optimizer state
through a checkpoint in the JAX package's key names, both ways.

Tolerances: parameters and every state field within 1e-6 (absolute; the
leaves are O(1)); the frozen leaf bit for bit; the surgery and the
checkpoint arrays exactly.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sk_gs_tpu.framework.checkpoint import _flatten
from sk_gs_tpu.models import optim as joptim
from sk_gs_tpu_torch import convert
from sk_gs_tpu_torch.framework.checkpoint import pad_capacity
from sk_gs_tpu_torch.models import optim as toptim
from tests.test_torch_cli import one_torch_thread  # noqa: F401
from tests.test_torch_render import to_np

SHAPES = {'a': (6, 3), 'b': (4,), 'frozen': (2, 2)}
LRS = {'a': 0.01, 'b': 0.003, 'frozen': 0.0}
# (name, keyword arguments of its update), the JAX defaults first
CASES = [('adam', {}), ('adam', {'clip_norm': 0.5}), ('adamw', {}),
         ('adamw', {'weight_decay': 0.1}), ('sgd', {}),
         ('sgd', {'nesterov': True, 'weight_decay': 0.01}),
         ('sgd', {'momentum': 0.0, 'clip_norm': 0.5}), ('adan', {}),
         ('adan', {'weight_decay': 0.02, 'clip_norm': 1.0})]


def test_registry_matches_jax():
    assert list(toptim.OPTIMIZERS) == list(joptim.OPTIMIZERS)
    for name in toptim.OPTIMIZERS:
        init, _ = toptim.make_optimizer(name)
        ref = joptim.make_optimizer(name)[0]({'x': jnp.zeros(2)})
        got = init({'x': torch.zeros(2)})
        assert type(got).__name__ == type(ref).__name__
        assert got._fields == ref._fields
        assert toptim.moment_fields(got) == tuple(
            f for f in ref._fields if f != 'count')
    with pytest.raises(KeyError, match='rmsprop'):
        toptim.make_optimizer('rmsprop')


@pytest.mark.parametrize('name,kw', CASES)
def test_update_matches_jax(rng, name, kw):
    p0 = {k: rng.normal(size=s).astype(np.float32) for k, s in SHAPES.items()}
    jinit, jupdate = joptim.make_optimizer(name)
    tinit, tupdate = toptim.make_optimizer(name)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    jstate = jinit(jp)
    tp = {k: torch.tensor(v) for k, v in p0.items()}
    tstate = tinit(tp)
    for _ in range(5):
        g = {k: rng.normal(size=s).astype(np.float32)
             for k, s in SHAPES.items()}
        jp, jstate = jupdate({k: jnp.asarray(v) for k, v in g.items()},
                             jstate, jp,
                             {k: jnp.asarray(v, jnp.float32)
                              for k, v in LRS.items()}, **kw)
        tstate = tupdate({k: torch.tensor(v) for k, v in g.items()}, tstate,
                         tp, LRS, **kw)
    assert tstate.count == int(jstate.count) == 5
    for k in SHAPES:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                   atol=1e-6, err_msg=k)
        for field in toptim.moment_fields(tstate):
            np.testing.assert_allclose(
                getattr(tstate, field)[k].numpy(),
                np.asarray(getattr(jstate, field)[k]), atol=1e-6,
                err_msg=f'{field}/{k}')
    np.testing.assert_array_equal(tp['frozen'].numpy(), p0['frozen'])
    assert float(tstate.mu['frozen'].abs().max()) > 0
    assert not np.allclose(tp['a'].numpy(), p0['a'])


def stepped_states(rng, name):
    """Both packages' states of ``name`` after 2 steps on [8, 3] / [5]
    leaves: every field non-zero."""
    shapes = {'rows': (8, 3), 'leaf': (5,)}
    jinit, jupdate = joptim.make_optimizer(name)
    tinit, tupdate = toptim.make_optimizer(name)
    p0 = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    tp = {k: torch.tensor(v) for k, v in p0.items()}
    jstate, tstate = jinit(jp), tinit(tp)
    lrs = {k: 0.01 for k in shapes}
    for _ in range(2):
        g = {k: rng.normal(size=s).astype(np.float32)
             for k, s in shapes.items()}
        jp, jstate = jupdate({k: jnp.asarray(v) for k, v in g.items()},
                             jstate, jp, {k: jnp.asarray(v)
                                          for k, v in lrs.items()})
        tstate = tupdate({k: torch.tensor(v) for k, v in g.items()}, tstate,
                         tp, lrs)
    return jstate, tstate


def fields_of(state, lib_np):
    return {f'{f}/{k}': lib_np(v)
            for f in state._fields if f != 'count'
            for k, v in getattr(state, f).items()}


@pytest.mark.parametrize('name', list(toptim.OPTIMIZERS))
def test_surgery_matches_jax(rng, name):
    """``reset_rows`` then ``reset_leaf`` zero the same entries of every
    moment field as the JAX surgery; the rest is untouched."""
    jstate, tstate = stepped_states(rng, name)
    rows = np.asarray([True, False, False, True, False, True, False, False])
    ref = joptim.reset_leaf(joptim.reset_rows(jstate, 'rows',
                                              jnp.asarray(rows)), 'leaf')
    before = fields_of(tstate, lambda v: to_np(v).copy())
    toptim.reset_rows(tstate, 'rows', torch.from_numpy(rows))
    toptim.reset_leaf(tstate, 'leaf')
    got = fields_of(tstate, to_np)
    want = fields_of(ref, np.asarray)
    assert set(got) == set(want)
    for key, v in want.items():
        np.testing.assert_allclose(got[key], v, atol=1e-6, err_msg=key)
        if key.endswith('/rows'):
            assert not got[key][rows].any() and before[key][rows].any()
            np.testing.assert_array_equal(got[key][~rows],
                                          before[key][~rows])
        else:
            assert not got[key].any() and before[key].any()


class _Leaves:
    """The two parameter leaves a state of ``stepped_states`` covers, as a
    model's ``leaves()``."""

    def __init__(self):
        self.p = {'rows': torch.zeros(8, 3), 'leaf': torch.zeros(5)}

    def leaves(self):
        return self.p


@pytest.mark.parametrize('name', list(toptim.OPTIMIZERS))
def test_state_checkpoint_round_trip(rng, name, monkeypatch):
    """``optimizer_to_flat`` writes the JAX state's ``_flatten`` keys
    (``opt/mu/rows``, ``opt/prev_grad/leaf``, ``opt/count``, ...) with its
    values, ``optimizer_from_flat`` reads them back; ``pad_capacity`` pads
    every field's per-Gaussian leaves."""
    jstate, tstate = stepped_states(rng, name)
    flat = convert.optimizer_to_flat(tstate)
    ref = _flatten(jstate, 'opt/')
    assert set(flat) == set(ref)
    for key, v in ref.items():
        np.testing.assert_allclose(flat[key], np.asarray(v), atol=1e-6,
                                   err_msg=key)
    assert flat['opt/count'].dtype == np.int32
    monkeypatch.setattr(convert, 'model_prefix', lambda f: 'state/model/')
    back = convert.optimizer_from_flat(
        {'state/' + k: v for k, v in flat.items()}, _Leaves(), name)
    assert type(back) is type(tstate) and back.count == 2
    for key, v in fields_of(back, to_np).items():
        np.testing.assert_array_equal(v, flat['opt/' + key])
    with pytest.raises(KeyError, match='missing optimizer array'):
        other = 'adan' if name != 'adan' else 'sgd'
        convert.optimizer_from_flat(
            {'state/' + k: v for k, v in flat.items()
             if not k.startswith('opt/mu/')}, _Leaves(), other)
    ckpt = {'state/model/params/xyz': np.zeros((8, 3), np.float32),
            **{f'state/opt/{f}/xyz': np.ones((8, 3), np.float32)
               for f in toptim.moment_fields(tstate)}}
    padded = pad_capacity(ckpt, 12)
    for f in toptim.moment_fields(tstate):
        arr = padded[f'state/opt/{f}/xyz']
        assert arr.shape == (12, 3) and not arr[8:].any(), f
