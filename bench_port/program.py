"""The system under test, and nothing else of it: the port's entry points
that a cell drives, built from the configuration as the port's own entry
point builds them (``framework/build.py:build_model_cfg`` from the
configuration's YAML sections). The only module of the benchmark that
imports ``sk_gs_tpu_torch``; each import sits inside the function that
needs it.
"""
from __future__ import annotations

from contextlib import contextmanager
from types import SimpleNamespace
from typing import Dict, List

import numpy as np
import torch


def model_cfg(cfg: Dict, num_frames: int):
    """(SKGSConfig, RasterConfig) of the configuration at its image size."""
    from sk_gs_tpu_torch.framework import build
    size = cfg['scene']['image_size']
    meta = SimpleNamespace(num_frames=num_frames)
    return build.build_model_cfg(cfg, meta, (size, size))


def build_model(flat: Dict[str, np.ndarray], cfg: Dict, num_frames: int,
                device):
    """The model from the benchmark's flat arrays, through
    ``convert.model_from_flat`` as a checkpoint goes."""
    from sk_gs_tpu_torch import convert
    skcfg, rcfg = model_cfg(cfg, num_frames)
    return convert.model_from_flat(flat, skcfg, rcfg, device=device,
                                   trainable=False)


def views(arrays: Dict, device) -> List:
    """``ViewParams`` of every camera of ``inputs.view_arrays``."""
    from sk_gs_tpu_torch.render.settings import ViewParams
    f = lambda x: torch.as_tensor(np.asarray(x), dtype=torch.float32,
                                  device=device)
    return [ViewParams(Tw2v=f(arrays['Tw2v'][i]), Tv2c=f(arrays['Tv2c']),
                       campos=f(arrays['campos'][i]),
                       tan_fovx=f(arrays['tan_fovx']),
                       tan_fovy=f(arrays['tan_fovy']))
            for i in range(len(arrays['Tw2v']))]


def render_request(model, view, t: torch.Tensor, bg: torch.Tensor):
    """One served request: ``framework/evaluate.py:render_eval`` at stage
    'sk'; returns its output dict ('image', 'num_pairs', 'overflow')."""
    from sk_gs_tpu_torch.framework.evaluate import render_eval
    return render_eval(model, view, t, bg, 'sk')


@contextmanager
def annotated():
    """Name the deformation in a profiler trace: ``forward_deltas`` as
    ``render_eval`` calls it, wrapped in a ``record_function`` range for
    the duration."""
    from sk_gs_tpu_torch.framework import evaluate
    orig = evaluate.forward_deltas

    def wrapped(*a, **kw):
        with torch.profiler.record_function('forward_deltas'):
            return orig(*a, **kw)

    evaluate.forward_deltas = wrapped
    try:
        yield
    finally:
        evaluate.forward_deltas = orig


@contextmanager
def fault(name: str):
    """A fault planted in the timed path, for the checks that ``correct``
    catches it (never set in a benchmark run): 'tile_blanked' serves every
    image with one 16 x 16 tile left at the background."""
    from sk_gs_tpu_torch.framework import evaluate
    if not name:
        yield
        return
    if name != 'tile_blanked':
        raise ValueError(f'unknown fault {name!r}')
    orig = evaluate.composite_background

    def blanked(images, opacity, bg):
        images = images.clone()
        opacity = opacity.clone()
        h, w = images.shape[0] // 2, images.shape[1] // 2
        images[h:h + 16, w:w + 16] = 0.0
        opacity[h:h + 16, w:w + 16] = 0.0
        return orig(images, opacity, bg)

    evaluate.composite_background = blanked
    try:
        yield
    finally:
        evaluate.composite_background = orig
