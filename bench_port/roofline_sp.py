"""The frozen arithmetic of the sp cell: least counts of the floating-point
operations and bytes of SP-GS's served deformation
(``models/sk_gs.py:sp_stage``), and of a served sp request.

The operations follow ``roofline.deform_flops``'s conventions, so that a
request's count and ``serve.mfu`` read alike in the sk and sp cells: the
net's linear layers, the K-nearest search's squared distances over
[N, M] in the (xyz, hyper) space, the dense blend product [N, M] @ [M, 19]
and the warp of each point. The bytes are what the deformation must read
and write at least, each once: every Gaussian's position and hyper
feature, its K entries of ``sp_W``, the net's weights, the superpoints,
and the three deltas written.
"""
from __future__ import annotations

from typing import Dict

from . import roofline

BLEND_COLUMNS = 19
F32_BYTES = 4


def net_dims(net: Dict, blender: bool = True):
    """[(in, out)] of the warp net's linear layers (``models/deform.py:
    DeformNet``): the timenet, the trunk with its skip after depth // 2,
    the heads (warp 3, rotation 4, scaling 3)."""
    p_dim = 3 + 3 * 2 * net['pos_degree']
    t_in = 1 + 2 * net['t_degree']
    dims = []
    if blender:
        dims += [(t_in, 256), (256, 30)]
        in_dim = p_dim + 30
    else:
        in_dim = p_dim + t_in
    cin = in_dim
    for i in range(net['depth']):
        dims.append((cin, net['width']))
        cin = net['width'] + (in_dim if i == net['depth'] // 2 else 0)
    return dims + [(cin, 3), (cin, 4), (cin, 3)]


def deform_flops(widths: Dict, blender: bool = True) -> float:
    """A least count of the sp warp of every slot: the warp net on the M
    superpoints, the squared distances over [N, M] in 3 + hyper
    dimensions (a subtraction and a square a dimension, the adds between),
    the dense blend product and the warp of each point (a 3 x 3 product and
    adds)."""
    n, m = widths['capacity'], widths['num_superpoints']
    d = 3 + widths['hyper_dim']
    return (roofline.mlp_flops(m, net_dims(widths['net'], blender))
            + (3.0 * d - 1.0) * n * m + 2.0 * n * m * BLEND_COLUMNS
            + 21.0 * n)


def deform_bytes(widths: Dict, blender: bool = True) -> float:
    """The least bytes of the sp warp of every slot: each Gaussian's
    position and hyper feature and its K ``sp_W`` entries read, its three
    deltas (3 + 4 + 3) written; the net's weights and biases and the
    superpoints' positions, hyper features and live flags read."""
    n, m = widths['capacity'], widths['num_superpoints']
    k, h = widths['num_knn'], widths['hyper_dim']
    params = sum(i * o + o for i, o in net_dims(widths['net'], blender))
    return F32_BYTES * (n * (3 + h + k + 10) + params + m * (3 + h)) + m


def deform_bound_s(widths: Dict, blender: bool = True) -> float:
    """The least time of the sp warp on the card."""
    return roofline.bound_s(deform_flops(widths, blender),
                            deform_bytes(widths, blender))


def request_flops(widths: Dict, blend_ops: float,
                  blender: bool = True) -> float:
    """A served sp request: the warp and the forward blend (the preprocess,
    SH and binning's arithmetic are left out: a least count)."""
    return deform_flops(widths, blender) + blend_ops
