"""The host's wait on the card at the end of a served request: the end of
each harness 'render_eval' range (after its synchronise) less the end of
the 'sk.request' span (``framework/evaluate.py:render_eval``) inside it,
over the profiled requests."""
UNIT = 'ms'
LAYER = 'request loop (framework/evaluate.py:render_eval)'
MOVES = 'serve_fps'


def read(r):
    t = r.trace
    if t is None or not t.count('sk.request') or not t.count('render_eval'):
        return None
    spans = t.ranges['sk.request']
    wait_us = 0.0
    for a, b in t.ranges['render_eval']:
        ends = [e for s, e in spans if a <= s and e <= b]
        if ends:
            wait_us += b - max(ends)
    return wait_us * 1e-3 / t.count('render_eval')
