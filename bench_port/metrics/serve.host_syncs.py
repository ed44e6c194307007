"""Deliberate reads of a card value on the host a served request makes:
the 'sk.sync' spans (``utils/tracing.py:host_read``) of the profiled
sub-window, over the requests. Implicit synchronisations (``nonzero``, a
boolean mask's indexing) make no span and are not counted."""
UNIT = 'count'
LAYER = 'host reads (utils/tracing.py:host_read)'
MOVES = 'serve_fps'


def read(r):
    t = r.trace
    if t is None or not t.count('sk.request') or not t.count('render_eval'):
        return None
    return t.count('sk.sync') / t.count('render_eval')
