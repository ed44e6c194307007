"""The host's time a served request spends in the binning: the
summed 'sk.binning' spans (``render/render.py:prepare_blend``: the tile
lists and the depth-order gathers) of the profiled requests, over the
requests."""
UNIT = 'ms'
LAYER = 'binning (render/binning.py)'
MOVES = 'serve_fps'
SPAN = 'sk.binning'


def read(r):
    t = r.trace
    if t is None or not t.count('sk.request') or not t.count('render_eval'):
        return None
    host_us = sum(b - a for a, b in t.ranges.get(SPAN, []))
    return host_us * 1e-3 / t.count('render_eval')
