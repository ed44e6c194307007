"""The share of the profiled requests whose preprocess was one launch of
the hand-written kernel: the 'sk.preprocess.kernel' spans
(``render/preprocess.py:preprocess``, inside 'sk.preprocess') over the
requests. 1.0 where every served request launches the kernel; 0.0 where the
preprocess ran as plain operations, as in a program without the kernel."""
UNIT = 'ratio'
LAYER = 'preprocess (render/preprocess.py)'
MOVES = 'serve_fps'
SPAN = 'sk.preprocess.kernel'


def read(r):
    t = r.trace
    if t is None or not t.count('sk.request') or not t.count('render_eval'):
        return None
    return t.count(SPAN) / t.count('render_eval')
