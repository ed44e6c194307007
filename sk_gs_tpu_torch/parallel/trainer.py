"""SK-GS training on a device mesh (the JAX package's
``framework/trainer.py:SKGSTrainer`` with a ``mesh``): ``MeshTrainer``, the
one-device ``framework.trainer.SKGSTrainer`` with its seams overridden.

On a device mesh (``parallel.make_mesh``; one process a rank, every rank
holding the whole model) the step is the JAX step's ``par`` branch
(``trainer.py:595-1055``). Over the ``view`` axis it is data parallel:
every rank samples all K views and takes its contiguous K / n_view of
them, and draws every view's background and time noise in the
single-device order, keeping its own, so that the streams are the
single-device step's. Over the ``gs`` axis each rank computes the
per-Gaussian work on its contiguous 1/n_gs of the capacity
(``slice_model_gs``: views of the full leaves, so that the backward leaves
zeros off the slice): the deltas, the preprocess, the splats exchanged
into tile-row bands (``parallel.sharded_render.exchange_render_band``),
its band blended and the bands all-gathered into the whole image; the
per-point losses are masked means over the whole capacity's live count
(``live_mean``), the losses that need every row gather them
(``smooth``, ``sp_extra_losses``, ``arap_p``), the replicated ones run on
every rank, and every loss is scaled by 1/n_gs. After the backward, two
all-reduces over the whole mesh merge what the single-device step sums
over its views: the max of the statistics' radii (gathered over ``gs``),
the overflow, pairs (summed over the bands), visible count and largest
warp (with which leaves have a gradient), then the sum of the leaves'
gradients and the means2d gradient (divided by the global K), the view
counts, the losses, the PSNR, the cache rows at their views' places and
the last view's ``p2sp`` (what every rank of a ``gs`` row holds alike
enters from its first rank only). Every rank then takes the same update,
and runs the same events on the whole model; after a stage event, a KNN
rebuild or an adaptive control event, rank 0's model, optimizer state and
KNN are written into every rank's (``sync_replicas``, which records how
far they had drifted).
"""
from __future__ import annotations

from typing import Dict

import torch

from . import collectives as coll
from .mesh import AXES, Mesh, shard_rows
from .sharded_render import exchange_render_band
from ..framework.trainer import SKGSTrainer
from ..models.sk_gs import SKGSModel
from ..render.preprocess import preprocess
from ..render.settings import GaussianInputs
from ..utils.tracing import host_read

# the leaves and fields with a leading capacity axis, which a rank of a
# mesh's gs axis computes on its slice of (trainer.py:144-147); the
# superpoints, skeleton, nets and caches are shared
PER_POINT_PARAMS = ('xyz', 'f_dc', 'f_rest', 'opacity', 'scaling',
                    'rotation', 'hyper', 'sp_W')
PER_POINT_FIELDS = ('alive', 'max_radii2d', 'xyz_grad_accum', 'denom',
                    'sp_weights', 'sp_knn', 'p2sp')
# the sums of a step that every rank of a gs row holds alike
GS_ROW_ALIKE = ('n_seen', 'psnr', 'cache_rows', 'time_ids', 'joint_cost',
                'p2sp')


class ModelSlice:
    """Capacity slice ``i`` of ``n_gs`` of an ``SKGSModel``, what
    ``slice_model_gs`` returns: ``params`` and the fields of
    ``PER_POINT_PARAMS`` / ``PER_POINT_FIELDS`` are the rows [i N / n_gs,
    (i + 1) N / n_gs) of the model's, as views (``narrow``), so that a
    gradient reaches the full leaf with zeros off the slice (the transpose
    of JAX's ``dynamic_slice``); every other attribute is the model's."""

    def __init__(self, model: SKGSModel, i: int, n_gs: int):
        self.model = model
        n = model.alive.shape[0] // n_gs
        rows = lambda x: x.narrow(0, i * n, n)
        self.params = {k: rows(v) if k in PER_POINT_PARAMS else v
                       for k, v in model.params.items()}
        for name in PER_POINT_FIELDS:
            setattr(self, name, rows(getattr(model, name)))

    def __getattr__(self, name):
        return getattr(self.model, name)

    gauss_view = SKGSModel.gauss_view


def slice_model_gs(model: SKGSModel, i: int, n_gs: int) -> ModelSlice:
    """Contiguous capacity slice ``i`` of ``n_gs`` of the per-point leaves
    and fields (``trainer.py:150-165``); the rest stays the model's."""
    return ModelSlice(model, i, n_gs)


class MeshTrainer(SKGSTrainer):
    """``SKGSTrainer`` as one rank of ``mesh`` (``parallel.make_mesh``),
    every other argument the same. The mesh's ``view`` axis must divide
    ``batch_views``, its ``gs`` axis the capacity and the tile rows.
    ``replica_drift`` holds the largest difference each sync found between
    a rank's state and rank 0's, by the events it followed."""

    def __init__(self, *args, mesh: Mesh, **kw):
        super().__init__(*args, **kw)
        n_view, n_gs = mesh.axis_size('view'), mesh.axis_size('gs')
        if self.batch_views % n_view:
            raise ValueError(
                f"batch_views {self.batch_views} not divisible by mesh view "
                f"axis {n_view}")
        if self.model.alive.shape[0] % n_gs:
            raise ValueError(
                f"capacity {self.model.alive.shape[0]} not divisible by mesh "
                f"gs axis {n_gs}")
        if self.rcfg.grid_h % n_gs:
            raise ValueError(
                f"grid_h {self.rcfg.grid_h} not divisible by mesh gs axis "
                f"{n_gs} (pad image height)")
        self.mesh, self.n_gs = mesh, n_gs
        self.replica_drift: Dict[str, float] = {}
        self._view_slice = None

    # ------------------------------------------------------------ events

    def sync_replicas(self, events):
        """On a mesh of more than one rank, after ``events`` (names; nothing
        when empty): rank 0's model (parameters and buffers), optimizer
        state and smooth-loss KNN written into every rank's, and the
        largest difference found recorded in ``replica_drift`` under the
        events' names. The events' kernels and scatters add in another
        order on each rank (atomics), so the replicas may part there."""
        if self.mesh.size == 1 or not events:
            return
        self.replica_drift['+'.join(events)] = coll.broadcast_from(
            self.replica_state(), self.mesh.group(AXES), 0)

    after_events = sync_replicas

    def replica_state(self) -> list:
        """Every tensor a replica must hold alike: the model's parameters
        and buffers, the optimizer's state and the smooth loss's KNN."""
        opt = [t for field in self.opt_state if isinstance(field, dict)
               for t in field.values()]
        return list(self.model.state_dict().values()) + opt \
            + [self.gs_knn_index]

    # ------------------------------------------------------------ forward

    def pass_model(self):
        """The model, or on a ``gs`` axis this rank's ``slice_model_gs``:
        the view's own while ``_losses`` runs."""
        if self.n_gs == 1:
            return self.model
        if self._view_slice is not None:
            return self._view_slice
        return slice_model_gs(self.model, self.mesh.axis_index('gs'),
                              self.n_gs)

    def own_rows(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's contiguous 1/n_gs of ``x``'s rows, a view (``x``
        itself off a ``gs`` axis)."""
        return x if self.n_gs == 1 else shard_rows(x, self.mesh, 'gs')

    def all_rows(self, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """The ``gs`` row's slices of ``x`` concatenated along ``dim``
        (``x`` itself off a ``gs`` axis), differentiable."""
        return coll.all_gather(x, self.mesh.group('gs'), dim)

    def live_mean(self, x: torch.Tensor, mask: torch.Tensor
                  ) -> torch.Tensor:
        """``masked_mean`` over the whole capacity's rows (``trainer.py:
        614-626``): on a ``gs`` axis ``x`` and ``mask`` are this rank's
        slice, and the slice's masked sum, times n_gs (which the 1/n_gs
        scale of every loss takes back), is divided by the live count
        summed over the axis."""
        if self.n_gs == 1:
            return super().live_mean(x, mask)
        mask_b = torch.broadcast_to(mask, x.shape).to(x.dtype)
        num = torch.sum(x * mask_b) * self.n_gs
        den = coll.psum(torch.sum(mask_b), self.mesh.group('gs'))
        return num / torch.clamp(den, min=1.0)

    def render_pass(self, g: GaussianInputs, view, m2d_off: torch.Tensor
                    ) -> Dict[str, torch.Tensor]:
        """The one-device render off a ``gs`` axis, ``exchange_render`` of
        this rank's rows of ``m2d_off`` on one."""
        if self.n_gs == 1:
            return super().render_pass(g, view, m2d_off)
        return self.exchange_render(g, view, self.own_rows(m2d_off))

    def exchange_render(self, g: GaussianInputs, view,
                        m2d_off: torch.Tensor) -> Dict[str, torch.Tensor]:
        """The render of a rank of a mesh's ``gs`` axis (``trainer.py:
        679-699``): its slice's ``g`` preprocessed, the slice's means2d
        offset ``m2d_off`` added, the splats exchanged into tile-row bands
        (``exchange_render_band``; a band's pair capacity is pair_capacity
        / n_gs, a block's max(pair_capacity // n_gs, 1024) rows), and the
        bands all-gathered into the whole image (the gather's backward
        sums the cotangents back to each band). 'radii' are the slice's;
        'overflow' the sends' or the band's; 'num_pairs' the band's."""
        rcfg, n = self.rcfg, self.n_gs
        pre = preprocess(g, view, rcfg, self.model.active_sh_degree)
        pre = pre._replace(means2d=pre.means2d + m2d_off)
        band, opacity, overflow, binned, sent = exchange_render_band(
            pre, g.opacities.reshape(-1), rcfg, self.mesh, 'gs',
            max(rcfg.pair_capacity // n, 1024))
        whole = self.all_rows(torch.cat([band, opacity[..., None]], -1))
        return {'images': whole[..., :-1], 'opacity': whole[..., -1],
                'radii': pre.radius, 'overflow': overflow,
                'num_pairs': binned.num_pairs, 'sent': sent}

    def _losses(self, *args, **kw):
        """The one-device losses of this rank's part of the view, each
        scaled by 1/n_gs on a ``gs`` axis, so that the sum over the axis is
        the one-process value (``trainer.py:836-840``). Every reader of the
        view's main pass takes one slice (``pass_model``): one view of each
        leaf, whose gradient sums its readers' in one order."""
        self._view_slice = self.pass_model()
        try:
            losses, *rest = super()._losses(*args, **kw)
        finally:
            self._view_slice = None
        if self.n_gs > 1:
            losses = {k: v * (1.0 / self.n_gs) for k, v in losses.items()}
        return (losses, *rest)

    # ------------------------------------------------------------ update

    def local_views(self, k: int) -> range:
        """This rank's contiguous k / n_view of a step's ``k`` views."""
        n, i = self.mesh.axis_size('view'), self.mesh.axis_index('view')
        return range(i * (k // n), (i + 1) * (k // n))

    def view_rows(self, k: int, rows: Dict[str, torch.Tensor]
                  ) -> Dict[str, torch.Tensor]:
        """On a ``gs`` axis the slice radii [K, N / n_gs] and band pairs
        [K] of this rank's views gathered in one all-gather: the whole
        model's radii [K, N] and each view's pairs summed over the bands,
        which partition the image's tiles. The cache rows and time ids at
        their views' places of a [k, ...] block, zeros elsewhere (so that a
        sum over the ranks gathers every view's row in view order). The
        last view's ``p2sp`` gathered over the axis, zeros on a rank that
        does not compute the last view."""
        rows = dict(rows)
        if self.n_gs > 1:
            radii, pairs = rows['radii'], rows['num_pairs']
            k_mine, n = radii.shape
            both = torch.cat([radii, pairs.to(radii.dtype)[:, None]], 1)
            both = self.all_rows(both, 1).view(k_mine, self.n_gs, n + 1)
            rows['radii'] = both[..., :n].reshape(k_mine, self.n_gs * n)
            rows['num_pairs'] = both[..., n].sum(1)
        mine = self.local_views(k)
        for key in ('cache_row', 'time_id'):
            if key in rows and len(mine) < k:
                block = rows[key].new_zeros((k,) + rows[key].shape[1:])
                block[mine.start:mine.stop] = rows[key]
                rows[key] = block
        if 'p2sp' in rows:
            last = self.all_rows(rows['p2sp'])
            rows['p2sp'] = last if mine[-1] == k - 1 else \
                torch.zeros_like(last)
        return rows

    def merge(self, maxes, sums, grads):
        """``merge_views``, where the sums that every rank of a ``gs`` row
        holds alike (``GS_ROW_ALIKE``) enter from its first rank only, as
        zeros from the others, so that a sum over the whole mesh counts
        them once."""
        if self.mesh.axis_index('gs'):
            sums = {k: torch.zeros_like(v) if k in GS_ROW_ALIKE else v
                    for k, v in sums.items()}
        return self.merge_views(maxes, sums, grads)

    def merge_views(self, maxes, sums, grads):
        """``maxes``, ``sums`` and ``grads`` (None where a leaf has no
        gradient) of this rank's views, merged over the whole mesh (a
        ``psum`` over ('view', 'gs')): one max all-reduce of ``maxes`` and
        of which leaves have a gradient on some rank, then one sum
        all-reduce of those leaves' gradients (zeros where this rank has
        none) and of ``sums``."""
        group = self.mesh.group(AXES)
        names = list(grads)
        has = torch.tensor([grads[n] is not None for n in names],
                           dtype=torch.float64, device=self.device)
        out = coll.pmax_all([has] + list(maxes.values()), group)
        has = out[0] > 0
        maxes = dict(zip(maxes, out[1:]))
        shapes = {'means2d': (self.model.alive.shape[0], 2)}
        live = [n for n, h in zip(names, host_read(has).tolist()) if h]
        mine = [grads[n] if grads[n] is not None else torch.zeros(
            shapes.get(n) or self.model.leaves()[n].shape,
            device=self.device) for n in live]
        out = coll.psum_all(mine + list(sums.values()), group)
        grads = dict.fromkeys(names)
        grads.update(zip(live, out[:len(live)]))
        return maxes, dict(zip(sums, out[len(live):])), grads
