"""The host's time a served request spends in Python's garbage
collector: the summed 'py.gc' ranges (``utils/tracing.py``'s hook) of the
profiled sub-window, over the requests."""
UNIT = 'ms'
LAYER = 'Python runtime (gc)'
MOVES = 'serve_fps'
SPAN = 'py.gc'


def read(r):
    t = r.trace
    if t is None or not t.count('sk.request') or not t.count('render_eval'):
        return None
    host_us = sum(b - a for a, b in t.ranges.get(SPAN, []))
    return host_us * 1e-3 / t.count('render_eval')
