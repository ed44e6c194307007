"""A served request's share of the card's float32 peak: the benchmark's
least count of its floating-point operations (``roofline.request_flops``:
the warp and the forward blend), over the mean request time of the traced
run's untraced part, against 67 TFLOP/s."""
from bench_port import roofline

UNIT = '%'
LAYER = 'whole request'
MOVES = 'serve_fps'


def read(r):
    if not r.flops_per_unit or not r.unit_s:
        return None
    return 100.0 * r.flops_per_unit / r.unit_s / roofline.PEAK_FP32_FLOPS
