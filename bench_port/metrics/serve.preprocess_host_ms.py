"""The host's time a served request spends in the preprocess: the
summed 'sk.preprocess' spans (``render/render.py:prepare_blend``) of the
profiled requests, over the requests."""
UNIT = 'ms'
LAYER = 'preprocess (render/preprocess.py)'
MOVES = 'serve_fps'
SPAN = 'sk.preprocess'


def read(r):
    t = r.trace
    if t is None or not t.count('sk.request') or not t.count('render_eval'):
        return None
    host_us = sum(b - a for a, b in t.ranges.get(SPAN, []))
    return host_us * 1e-3 / t.count('render_eval')
