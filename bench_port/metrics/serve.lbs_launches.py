"""Kernels a served request launches for the LBS weights and the
blend of the joint transforms: inside the 'sk.deform.lbs' spans
(``models/sk_gs.py:sk_stage``: ``calc_lbs_weight``, ``dense_lbs_rows``,
``warp_blend_dense``), from the profiled requests."""
UNIT = 'count'
LAYER = 'deformation (models/sk_gs.py:forward_deltas)'
MOVES = 'serve_fps'
SPANS = ('sk.deform.lbs',)


def read(r):
    t = r.trace
    if t is None or not t.count('sk.request') or not t.count('render_eval'):
        return None
    return sum(t.launches_in(s) for s in SPANS) / t.count('render_eval')
