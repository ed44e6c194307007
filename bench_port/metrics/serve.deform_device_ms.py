"""The card's time a served request spends on the deformation: the
device operations launched inside the 'sk.deform' spans
(``models/sk_gs.py:forward_deltas``), a CUDA graph replay's kernels
included (tied to their launch by the profiler's correlation id,
``trace_sp.Trace.device_s_in``), over the profiled requests."""
UNIT = 'ms'
LAYER = 'deformation (models/sk_gs.py:forward_deltas)'
MOVES = 'serve_fps'
SPAN = 'sk.deform'


def read(r):
    t = r.trace
    if t is None or not t.count('sk.request') or not t.count('render_eval'):
        return None
    device_s_in = getattr(t, 'device_s_in', None)
    s = device_s_in(SPAN) if device_s_in else 0.0
    return s * 1e3 / t.count('render_eval') if s > 0 else None
