"""The sp deformation's share of its roofline: the least time of a served
request's sp warp (``roofline_sp.deform_bound_s``: its operations at the
float32 peak or its bytes at the HBM peak, the larger) over the card time
of the operations launched inside 'sk.deform' (``serve.deform_device_ms``),
over the profiled requests."""
UNIT = '%'
LAYER = 'deformation (models/sk_gs.py:forward_deltas)'
MOVES = 'serve_fps'
SPAN = 'sk.deform'


def read(r):
    t = r.trace
    bound = getattr(r, 'deform_bound_s', None)
    if t is None or not bound or not t.count('sk.request') \
            or not t.count('render_eval'):
        return None
    device_s_in = getattr(t, 'device_s_in', None)
    s = device_s_in(SPAN) if device_s_in else 0.0
    return 100.0 * bound * t.count('render_eval') / s if s > 0 else None
