"""Kernels a served request launches in the warp net of the sp stages:
inside the 'sk.deform.net' spans (``models/sk_gs.py:sp_stage``:
``sp_net_outputs``), from the profiled requests. 0 where every request
replays the deformation's CUDA graph (the span is entered only at the
capture); more shows an eager fallback. None where the trace has neither
the span nor a replay (a program without them)."""
UNIT = 'count'
LAYER = 'deformation (models/sk_gs.py:forward_deltas)'
MOVES = 'serve_fps'
SPAN = 'sk.deform.net'


def read(r):
    t = r.trace
    if t is None or not t.count('sk.request') or not t.count('render_eval'):
        return None
    if not t.count(SPAN) and not t.count('sk.deform.replay'):
        return None
    return t.launches_in(SPAN) / t.count('render_eval')
