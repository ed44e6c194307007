"""The card's idle time a served request while the host is in none of the
layers' spans: the profiled sub-window's device idle time (the window less
the union of the device's operations) outside the 'sk.deform',
'sk.preprocess', 'sk.binning' and 'sk.blend' spans (the request's glue in
``framework/evaluate.py:render_eval``, the harness's loop and its
synchronise), over the requests. With ``serve.deform_idle_ms`` and
``serve.render_idle_ms`` it splits the idle time without overlap."""
import bisect

UNIT = 'ms'
LAYER = 'request loop (framework/evaluate.py:render_eval)'
MOVES = 'serve_fps'
SPANS = ('sk.deform', 'sk.preprocess', 'sk.binning', 'sk.blend')


def idle_us_in(t, labels):
    """Device idle time (us) of the window inside the union of the host
    ranges named ``labels``."""
    lo, hi = t.window
    busy = t.busy_intervals()
    starts = [a for a, _ in busy]
    spans = []
    ranges = [r for label in labels for r in t.ranges.get(label, [])]
    for a, b in sorted(ranges):
        a, b = max(a, lo), min(b, hi)
        if b <= a:
            continue
        if spans and a <= spans[-1][1]:
            spans[-1][1] = max(spans[-1][1], b)
        else:
            spans.append([a, b])
    idle = 0.0
    for a, b in spans:
        idle += b - a
        i = max(bisect.bisect_right(starts, a) - 1, 0)
        while i < len(busy) and busy[i][0] < b:
            idle -= max(0.0, min(b, busy[i][1]) - max(a, busy[i][0]))
            i += 1
    return idle


def read(r):
    t = r.trace
    if t is None or not t.count('sk.request') or not t.count('render_eval'):
        return None
    lo, hi = t.window
    idle_us = (hi - lo) - sum(b - a for a, b in t.busy_intervals())
    return (idle_us - idle_us_in(t, SPANS)) * 1e-3 / t.count('render_eval')
