"""The host's time a served request spends in the blend and the
image's assembly: the summed 'sk.blend' spans (``render/render.py:render``)
of the profiled requests, over the requests."""
UNIT = 'ms'
LAYER = 'blend (render/tile_kernel.py)'
MOVES = 'serve_fps'
SPAN = 'sk.blend'


def read(r):
    t = r.trace
    if t is None or not t.count('sk.request') or not t.count('render_eval'):
        return None
    host_us = sum(b - a for a, b in t.ranges.get(SPAN, []))
    return host_us * 1e-3 / t.count('render_eval')
