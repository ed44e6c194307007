"""The card's idle time a served request while the host is in the
deformation: the profiled sub-window's device idle time (the window less
the union of the device's operations) inside the 'sk.deform' spans
(``models/sk_gs.py:forward_deltas``), over the requests. With
``serve.render_idle_ms`` and ``serve.unspanned_idle_ms`` it splits the
idle time without overlap."""
import bisect

UNIT = 'ms'
LAYER = 'deformation (models/sk_gs.py:forward_deltas)'
MOVES = 'serve_fps'
SPANS = ('sk.deform',)


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
    return idle_us_in(t, SPANS) * 1e-3 / t.count('render_eval')
