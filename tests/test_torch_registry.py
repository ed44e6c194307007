"""Port parity, ``framework/registry.py`` and ``framework/lr_schedules.py``
against the JAX package's: the registry's lookups and errors, and every
learning-rate schedule at the same steps and settings (float32, rtol
1e-6)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sk_gs_tpu.framework import lr_schedules as jlr
from sk_gs_tpu.framework import registry as jreg
from sk_gs_tpu_torch.framework import lr_schedules as tlr
from sk_gs_tpu_torch.framework import registry as treg

STEPS = [0, 1, 7, 999, 1000, 1001, 2500, 29_999, 30_000, 45_000]
SETTINGS = {'fix': {}, 'step': {'step_size': 700, 'gamma': 0.3},
            'exp': {'gamma': 0.9995}, 'exp2': {'final_mult': 0.02},
            'poly': {'power': 0.7, 'max_steps': 20_000},
            'cos': {'max_steps': 25_000, 'final_mult': 0.1},
            'triangle': {'period': 1500, 'low': 0.2}}


def test_same_schedules():
    assert sorted(tlr.LR_SCHEDULES) == sorted(jlr.LR_SCHEDULES) \
        == sorted(SETTINGS)


@pytest.mark.parametrize('name', sorted(SETTINGS))
@pytest.mark.parametrize('default', [True, False])
def test_schedule_matches_jax(name, default):
    kw = {} if default else SETTINGS[name]
    got = tlr.lr_multiplier(name, torch.tensor(STEPS), **kw)
    ref = jlr.lr_multiplier(name, jnp.asarray(STEPS), **kw)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6,
                               atol=1e-7)
    one = tlr.lr_multiplier(name, 1001, **kw)
    np.testing.assert_allclose(float(one),
                               float(jlr.lr_multiplier(name, 1001, **kw)),
                               rtol=1e-6)


def test_unknown_schedule_raises():
    for mod in (tlr, jlr):
        with pytest.raises(KeyError, match='unknown lr schedule'):
            mod.lr_multiplier('linear', 3)


@pytest.mark.parametrize('ignore_case', [False, True])
def test_registry_matches_jax(ignore_case):
    regs = [treg.Registry(ignore_case), jreg.Registry(ignore_case)]
    for reg in regs:
        @reg.register()
        def Lego():
            return 1

        reg.register('Hook')(len)
    t, j = regs
    assert list(t) == list(j)
    for name in ('Lego', 'Hook', 'lego', 'HOOK'):
        if name in ('Lego', 'Hook') or ignore_case:
            assert t[name] is not None and (t[name] is len) == (j[name] is len)
        else:
            with pytest.raises(KeyError, match='not registered'):
                t[name]
            with pytest.raises(KeyError, match='not registered'):
                j[name]
    assert isinstance(treg.NETWORKS, treg.Registry)
    assert isinstance(treg.DATASETS, treg.Registry)
