"""Kernels a served request launches in forward kinematics: inside
the 'sk.deform.fk' spans (``models/sk_gs.py:sk_stage``:
``skeleton.kinematic_transforms``), from the profiled requests."""
UNIT = 'count'
LAYER = 'deformation (models/sk_gs.py:forward_deltas)'
MOVES = 'serve_fps'
SPANS = ('sk.deform.fk',)


def read(r):
    t = r.trace
    if t is None or not t.count('sk.request') or not t.count('render_eval'):
        return None
    return sum(t.launches_in(s) for s in SPANS) / t.count('render_eval')
