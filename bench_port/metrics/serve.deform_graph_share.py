"""The share of the profiled requests whose deformation was one CUDA graph
replay: the 'sk.deform.replay' spans (``models/deform_graph.py``, inside
``models/sk_gs.py:forward_deltas``) over the requests. 1.0 where every
served request replays the graph captured in the warm-up; 0.0 where the
deformation ran eagerly."""
UNIT = 'ratio'
LAYER = 'deformation (models/sk_gs.py:forward_deltas)'
MOVES = 'serve_fps'
SPAN = 'sk.deform.replay'


def read(r):
    t = r.trace
    if t is None or not t.count('sk.request') or not t.count('render_eval'):
        return None
    return t.count(SPAN) / t.count('render_eval')
