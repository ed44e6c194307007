"""The host's time a served request spends in the deformation: the
summed 'sk.deform' spans (``models/sk_gs.py:forward_deltas``) of the
profiled requests, over the requests."""
UNIT = 'ms'
LAYER = 'deformation (models/sk_gs.py:forward_deltas)'
MOVES = 'serve_fps'
SPAN = 'sk.deform'


def read(r):
    t = r.trace
    if t is None or not t.count('sk.request') or not t.count('render_eval'):
        return None
    host_us = sum(b - a for a, b in t.ranges.get(SPAN, []))
    return host_us * 1e-3 / t.count('render_eval')
