"""Named spans of the port's layers, on the profiler's clock.

``span(name)`` is a ``torch.profiler.record_function`` range while a
``torch.profiler`` session records, and one shared no-op context otherwise
(one check of the profiler's state, no profiler call, no allocation). The
ranges land in the profiler's trace beside the kernels and runtime calls
they enclose, so a reader of the trace can put each kernel launch, and each
stretch in which the card idles, down to the layer the host was in.

``host_read(x)`` brings ``x`` to the host inside an 'sk.sync' span: the
port's deliberate reads of a card value on the host go through it, so that a
trace counts them by layer. Implicit synchronisations (``nonzero``, a
boolean mask's indexing) make no such span.

While the profiler records, a collection of Python's garbage collector is a
'py.gc' range (a ``gc.callbacks`` hook, installed on import).

Every span name is one of ``SPANS``:

- a served request (``framework/evaluate.py:render_eval``): 'sk.request'
  around it all, 'sk.deform' (``models/sk_gs.py:forward_deltas``, every
  stage) holding 'sk.deform.fk' (forward kinematics) of the sk stages,
  'sk.deform.net' (the warp net on the superpoints) of the sp stages, and
  'sk.deform.lbs' (the LBS weights and the blend of the joint or superpoint
  transforms) of both, then 'sk.preprocess', 'sk.binning' and 'sk.blend'
  (``render/render.py``); where the preprocess is one launch of its kernel
  (on a card, ``use_kernel`` on, autograd off: ``render/preprocess.py``),
  'sk.preprocess' holds 'sk.preprocess.kernel' around it. Where the sk or sp
  stage runs as a CUDA graph (on a card, no train frame, no time noise,
  autograd off: ``models/deform_graph.py``), 'sk.deform' holds
  'sk.deform.replay' instead of 'sk.deform.fk', 'sk.deform.net' and
  'sk.deform.lbs', and once before it, on the first call, after a switch of
  stage and after a model tensor it reads was replaced, 'sk.deform.capture'
  (the eager warm-up calls and the capture; the fk, net and lbs spans inside
  when the profiler records);
- a training step (``framework/trainer.py``): 'sk.train.events',
  'sk.train.forward' (a view's deformation and render, the serve spans
  inside), 'sk.train.losses', 'sk.train.backward', 'sk.train.update';
- 'sk.sync' (``host_read``) and 'py.gc', wherever they happen.
"""
from __future__ import annotations

import gc
from contextlib import nullcontext

import torch

SPANS = ('sk.request', 'sk.deform', 'sk.deform.fk', 'sk.deform.net',
         'sk.deform.lbs', 'sk.deform.replay', 'sk.deform.capture',
         'sk.preprocess', 'sk.preprocess.kernel', 'sk.binning', 'sk.blend',
         'sk.train.events', 'sk.train.forward', 'sk.train.losses',
         'sk.train.backward', 'sk.train.update',
         'sk.sync', 'py.gc')

_OFF = nullcontext()
recording = torch._C._autograd._profiler_enabled


def span(name: str):
    """A ``record_function(name)`` range while the profiler records, else a
    shared no-op context."""
    if recording():
        return torch.profiler.record_function(name)
    return _OFF


def host_read(x: torch.Tensor) -> torch.Tensor:
    """``x.cpu()``, inside an 'sk.sync' span."""
    with span('sk.sync'):
        return x.cpu()


_gc_open = []


def _gc_hook(phase: str, info: dict):
    """Opens a 'py.gc' range at a collection's start while the profiler
    records, and closes it at the collection's stop."""
    if phase == 'start':
        if recording():
            rf = torch.profiler.record_function('py.gc')
            rf.__enter__()
            _gc_open.append(rf)
    elif _gc_open:
        _gc_open.pop().__exit__(None, None, None)


gc.callbacks.append(_gc_hook)
