"""The share of the profiled sub-window in which no operation ran on the
card, while requests were served."""
UNIT = '%'
LAYER = 'device'
MOVES = 'serve_fps'


def read(r):
    t = r.trace
    if t is None or t.window_s <= 0 or t.busy_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
