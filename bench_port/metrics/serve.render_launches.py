"""Kernels a served request launches in the render: inside the
'sk.preprocess', 'sk.binning' and 'sk.blend' spans
(``render/render.py``), from the profiled requests."""
UNIT = 'count'
LAYER = 'render (render/render.py)'
MOVES = 'serve_fps'
SPANS = ('sk.preprocess', 'sk.binning', 'sk.blend')


def read(r):
    t = r.trace
    if t is None or not t.count('sk.request') or not t.count('render_eval'):
        return None
    return sum(t.launches_in(s) for s in SPANS) / t.count('render_eval')
