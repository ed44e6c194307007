"""Kernels a served request launches inside ``models/sk_gs.py:
forward_deltas`` (the skeleton net, forward kinematics, the LBS weights
and blend), from the profiled requests."""
UNIT = 'count'
LAYER = 'deformation (models/sk_gs.py:forward_deltas)'
MOVES = 'serve_fps'


def read(r):
    t = r.trace
    if t is None or not t.count('render_eval'):
        return None
    n = t.launches_in('forward_deltas')
    return n / t.count('render_eval') if n else None
