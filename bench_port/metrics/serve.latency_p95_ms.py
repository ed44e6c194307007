"""The 95th percentile of a served request's latency: host clock around a
synchronised ``render_eval``, over the traced run's requests outside the
profiled sub-window (needs 20 or more)."""
import statistics

UNIT = 'ms'
LAYER = 'request loop (framework/evaluate.py:render_eval)'
MOVES = 'serve_fps'


def read(r):
    lat = r.latencies_s or []
    if len(lat) < 20:
        return None
    return statistics.quantiles(lat, n=20)[18] * 1e3
