"""The sp cell's calls into the system under test: a request served at
stage 'sp' (SP-GS, the superpoint stage) through the port's own
``framework/evaluate.py:render_eval``, and the faults that the sp cell's
check has to catch. Like ``program.py``, each import of ``sk_gs_tpu_torch``
sits inside the function that needs it.
"""
from __future__ import annotations

from contextlib import contextmanager

import torch

from . import program

STAGE = 'sp'


def render_request(model, view, t: torch.Tensor, bg: torch.Tensor):
    """One served request: ``render_eval`` at stage 'sp'; returns its output
    dict ('image', 'num_pairs', 'overflow')."""
    from sk_gs_tpu_torch.framework.evaluate import render_eval
    return render_eval(model, view, t, bg, STAGE)


@contextmanager
def fault(name: str):
    """A fault planted in the timed path (never set in a benchmark run):
    'deform_skipped' serves every request with the deformation computed
    and its three deltas replaced by zeros; any other name is
    ``program.fault``'s ('tile_blanked')."""
    if name != 'deform_skipped':
        with program.fault(name):
            yield
        return
    from sk_gs_tpu_torch.framework import evaluate
    orig = evaluate.forward_deltas

    def skipped(*a, **kw):
        out = orig(*a, **kw)
        return out._replace(d_xyz=torch.zeros_like(out.d_xyz),
                            d_rotation=torch.zeros_like(out.d_rotation),
                            d_scaling=torch.zeros_like(out.d_scaling))

    evaluate.forward_deltas = skipped
    try:
        yield
    finally:
        evaluate.forward_deltas = orig
