"""The frozen arithmetic of the per-layer metrics: the card's peaks, the
operations and bytes of the forward blend kernel (copied from
``chip_smoke.py``: ``bound`` and ``fwd_ops``), and a least count of the
floating-point operations of a served request.

The blend counts come from the cell's inputs (the reference's lists and
front-to-back walk, ``reference/render.py``'s ``stats``), never from a
kernel's own statistics, so a roofline reads the same work whatever
implements the blend.
"""
from __future__ import annotations

from typing import Dict

# published H100 SXM peaks (NVIDIA data sheet): float32 outside the tensor
# cores (TF32 is off in the port), and HBM3 bandwidth
PEAK_FP32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12
# operations of the forward blend (#1): every evaluation dx, dy (2), the
# quadratic form (9) and the skip and pre-test tests (2); a kept one (added
# or stopping) min(power, 0), exp, o * g, min(0.99, .), the keep test,
# T (1 - alpha) and the stop test (8); an added one w and the colour sums
# (1 + 2 ch)
FWD_OPS_PER_EVAL = 13
FWD_OPS_PER_KEPT = 8
TILE_PIXELS = 256
CHANNELS = 3


def bound_s(ops: float, nbytes: float) -> float:
    """The least time the card could take: the larger of the operations at
    the float32 peak and the bytes at the HBM peak."""
    return max(ops / PEAK_FP32_FLOPS, nbytes / PEAK_HBM_BYTES)


def fwd_blend(stats: Dict, rows: int, tiles: int) -> Dict[str, float]:
    """Operations and bytes of kernel #1 on work ``stats`` over ``rows``
    depth-ordered rows (capacity + 1) and ``tiles`` tiles: the entry ids,
    the tile metadata, the rows' geometry and colour, the tiles' colour
    and alpha written, each once."""
    ch = CHANNELS
    ops = (FWD_OPS_PER_EVAL * stats['evaluations']
           + FWD_OPS_PER_KEPT * (stats['adds'] + stats['stops'])
           + (1 + 2 * ch) * stats['adds'])
    nbytes = (4 * stats['pairs'] + 8 * tiles + 4 * rows * (6 + ch)
              + 4 * tiles * TILE_PIXELS * (ch + 1))
    return {'ops': ops, 'bytes': nbytes}


def mlp_flops(rows: int, dims) -> float:
    """2 rows in out of each linear layer [(in, out), ...]."""
    return sum(2.0 * rows * i * o for i, o in dims)


def deform_flops(widths: Dict, n: int) -> float:
    """A least count of the skeleton warp of ``n`` Gaussians: the skeleton
    net on the M joints, the K-nearest search's squared distances over
    [N, M] (3 subtractions, 3 squares, 2 adds), the dense blend product
    [N, M] @ [M, 19], and the warp of each point (a 3 x 3 product and
    adds)."""
    sk = widths['sk_net']
    m = widths['num_superpoints']
    in0 = 3 + 3 * 2 * sk['pos_degree'] + 1 + 2 * sk['t_degree']
    dims, cin = [], in0
    for i in range(sk['depth']):
        dims.append((cin, sk['width']))
        cin = sk['width'] + (in0 if i in sk['skips'] else 0)
    dims += [(cin, o) for o in sk['out_dims']]
    return (mlp_flops(m, dims) + 8.0 * n * m + 2.0 * n * m * 19
            + 21.0 * n)


def request_flops(widths: Dict, blend_ops: float) -> float:
    """A served request: the warp and the forward blend (the preprocess,
    SH and binning's arithmetic are left out: a least count)."""
    return deform_flops(widths, widths['capacity']) + blend_ops
