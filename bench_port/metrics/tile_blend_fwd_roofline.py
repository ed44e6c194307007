"""Kernel #1's (``csrc/tile_blend_fwd.cu``) share of its roofline: the
least time of the profiled launches' work (the frozen operation and byte
counts of ``roofline.fwd_blend`` on the reference's lists of the same
inputs) over the kernel's device time in the trace."""
UNIT = '%'
LAYER = 'blend (render/tile_kernel.py)'
MOVES = 'serve_fps'
KERNEL = 'tile_blend_fwd_kernel'


def read(r):
    t = r.trace
    if t is None or not r.fwd_bound_s:
        return None
    times = t.kernels(KERNEL)
    if not times or len(times) != r.units:
        return None
    return 100.0 * r.fwd_bound_s / sum(times)
