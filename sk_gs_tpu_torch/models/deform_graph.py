"""The served sk- and sp-stage deformation as one CUDA graph replay.

Serving runs the same chain of small kernels on every request, on shapes
fixed by the model, with the time ``t`` (and, for the sk stages, a repose
delta) its only input that changes: the sk stages' skeleton net, forward
kinematics' ``se3_mul`` levels, the masked KNN, the dense LBS rows and the
blend (some 660 kernels); the sp stages' warp net on the superpoints, the
masked KNN in (xyz, hyper) space, the dense LBS rows and the blend.
Launched one by one from Python, the chain keeps the card waiting on the
host. ``DeformGraph`` captures it once as a ``torch.cuda.CUDAGraph`` and
replays it: one launch a request, the same kernels in the same order.

The graph reads the model's tensors at the addresses they had at capture,
so a value updated in place is seen at the next replay; the key of a
capture is the stage family ('sk' or 'sp') and the stage, the config fields
that choose a branch, the shape and dtype of ``t`` and of the repose delta,
and ``(data_ptr, shape, dtype)`` of every model tensor the family reads
(``stage_inputs``). A call whose key differs captures again and releases
the old graph and its memory pool: one graph a model, so a switch between
stages captures again.
"""
from __future__ import annotations

from typing import Callable, List, Optional

import torch

from ..utils.tracing import span

# eager calls on a side stream before a capture: the lazy set-up of the
# libraries (cuBLAS handles and workspaces) happens outside the graph
WARMUP_CALLS = 3


def family(stage: str) -> str:
    """'sp' for the sp stages ('sp_fix', 'sp'), else 'sk'."""
    return 'sp' if stage in ('sp_fix', 'sp') else 'sk'


def stage_inputs(model, stage: str = 'sk') -> List[torch.Tensor]:
    """Every tensor of ``model`` that the stage's family reads. sk: the
    parameters, the skeleton net's weights, the train times, the per-frame
    skeleton cache and the joint tree; sp: the parameters, the warp net
    ``sp_deform``'s weights and the live superpoints."""
    if family(stage) == 'sp':
        return [*model.params.values(), *model.sp_deform.parameters(),
                model.sp_alive]
    return [*model.params.values(), *model.sk_deform.parameters(),
            model.train_times, model.sk_cache, model.joint_parents,
            model.joint_root, model.sp_alive]


def _sig(x: Optional[torch.Tensor]):
    return None if x is None else (tuple(x.shape), x.dtype)


class DeformGraph:
    """One model's captured sk- or sp-stage deformation. ``captures`` and
    ``replays`` count what it did."""

    def __init__(self):
        self.key = self.graph = None
        self.static_t = self.static_delta = self.out = None
        self.captures = self.replays = 0

    def engages(self, model, t, time_id, sk_r_delta, training: bool,
                stage: str = 'sk') -> bool:
        """Whether a call of an sk or sp stage replays the graph: the model
        on a CUDA device (with an ``sp_deform`` net for the sp stages), no
        train frame (``time_id``), not ``training``, and autograd recording
        nothing (grad off, or no input requiring grad)."""
        if training or time_id is not None or model.device.type != 'cuda':
            return False
        if family(stage) == 'sp' and model.sp_deform is None:
            return False
        if torch.is_grad_enabled():
            grads = [t, *stage_inputs(model, stage)]
            if sk_r_delta is not None:
                grads.append(sk_r_delta)
            return not any(x.requires_grad for x in grads)
        return True

    def __call__(self, cfg, model, stage: str, t: torch.Tensor,
                 sk_r_delta: Optional[torch.Tensor],
                 run: Callable[[torch.Tensor, Optional[torch.Tensor]],
                               object]):
        """``run(t, sk_r_delta)`` (the eager stage) through the graph:
        captured first if the key changed, then replayed on the current
        stream with ``t`` and ``sk_r_delta`` copied into its static inputs.
        The three deltas are handed out as fresh copies; the aux entries
        are the graph's own buffers, valid until the next call."""
        key = (family(stage), stage, cfg.test_time_interpolate,
               cfg.LBS_method, cfg.num_knn, cfg.sk_net, cfg.net,
               cfg.hyper_dim, cfg.warp_method, cfg.sep_rot, _sig(t),
               _sig(sk_r_delta),
               tuple((x.data_ptr(), tuple(x.shape), x.dtype)
                     for x in stage_inputs(model, stage)))
        if key != self.key:
            self._capture(key, model.device, t, sk_r_delta, run)
        with span('sk.deform.replay'):
            self.static_t.copy_(t)
            if sk_r_delta is not None:
                self.static_delta.copy_(sk_r_delta)
            self.graph.replay()
            self.replays += 1
            out = self.out
            return out._replace(d_xyz=out.d_xyz.clone(),
                                d_rotation=out.d_rotation.clone(),
                                d_scaling=out.d_scaling.clone())

    def _release(self):
        """Drop the graph, its static buffers and its memory pool."""
        if self.graph is not None:
            self.graph.reset()
        self.key = self.graph = None
        self.static_t = self.static_delta = self.out = None

    def _capture(self, key, device, t, sk_r_delta, run):
        """A few eager calls on a side stream, then the capture. The static
        buffers are ordinary tensors (made outside inference mode), so that
        the copies into them are allowed under any grad mode."""
        self._release()
        with span('sk.deform.capture'), torch.inference_mode(False), \
                torch.no_grad():
            static_t = t.detach().to(device).clone()
            static_delta = None if sk_r_delta is None else \
                sk_r_delta.detach().to(device).clone()
            side = torch.cuda.Stream(device)
            side.wait_stream(torch.cuda.current_stream(device))
            with torch.cuda.stream(side):
                for _ in range(WARMUP_CALLS):
                    run(static_t, static_delta)
            torch.cuda.current_stream(device).wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                out = run(static_t, static_delta)
        self.key, self.graph, self.out = key, graph, out
        self.static_t, self.static_delta = static_t, static_delta
        self.captures += 1
