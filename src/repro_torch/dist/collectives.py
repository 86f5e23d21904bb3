"""The collectives of the sharded steps on a ``DeviceMesh``.

The state lives sharded at rest, each leaf a DTensor on its
:class:`~repro_torch.dist.sharding.NamedSharding`.

*The data-parallel train step.*  Every rank computes the step on its own
batch rows with every parameter gathered whole, so the ``model`` axis
shards storage only: the model ranks of one data group compute the same
step on the same rows (tensor-parallel training is ROADMAP §1 item 5c).
:class:`DataParallel` holds what that needs:

* :meth:`~DataParallel.reduce_grad`: a rank's gradient as
  ``Partial("avg")`` over the batch axes, redistributed onto the leaf's
  placements (a reduce-scatter where the leaf is sharded over a batch
  axis, an all-reduce where it is not; a local slice over the others);
* :meth:`~DataParallel.global_norm`: the clipping norm over sharded
  leaves, each element counted once however often its leaf is
  replicated;
* :meth:`~DataParallel.row_absmax_`: the int8 moments' row absmax
  all-reduced (max) over the mesh dims that shard a leaf's last dim;
* :meth:`~DataParallel.batch_counts` and :meth:`~DataParallel.mean`: the
  mask counts of every rank's micro-batches, and the metrics averaged
  over the batch axes.

On a mesh whose every dim has size 1 each of these is the identity, bit
for bit.

*The tensor-parallel serve steps* (``train/steps.py``
``make_prefill_step``, ``make_serve_step`` on a mesh) hand the model each
parameter and cache leaf as a :class:`LocalBlock`: the rank's block
(one ``to_local()`` a leaf a step) with the spec that placed it.  The
model computes on its blocks, Megatron style, with the helpers below:
``_c10d_functional`` ops on the groups of the mesh's axes, which
``core/hlo.py`` traces with their mesh axis, as the reference's
``shard_map`` names its ``psum``s: :func:`all_reduce` (sum, max),
:func:`all_gather` along a dim, and :meth:`LocalBlock.block`, the rank's
block of a dim (``NamedSharding.index``).  A weight sharded over an axis
the computation does not split is gathered over it where it is used
(:meth:`LocalBlock.gathered`), layer by layer, the way GSPMD gathers it.
On a mesh whose axes all have size 1 the collectives are still
dispatched; a one-rank group returns the same bits.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.distributed as dist

from ..models.common import tree_leaves
from .sharding import NamedSharding, _group


class DataParallel:
    """The batch axes of ``mesh`` (listed in mesh order) and the
    placements of the parameter leaves (``param_shardings``, in tree
    order)."""

    def __init__(self, mesh, batch_axes: tuple[str, ...], param_shardings):
        from torch.distributed.tensor import Partial, Replicate, Shard

        names = list(mesh.mesh_dim_names)
        missing = [a for a in batch_axes if a not in names]
        if missing:
            raise ValueError(f"batch axes {missing} are not axes of the mesh "
                             f"{tuple(names)}")
        self.batch_dims = [names.index(a) for a in batch_axes]
        if self.batch_dims != sorted(self.batch_dims):
            raise ValueError(f"batch axes {tuple(batch_axes)} out of the "
                             f"mesh's order {tuple(names)}")
        self.mesh = mesh
        self.shape = tuple(mesh.shape)
        self.coordinate = mesh.get_coordinate()
        self.ranks = 1
        self.rank = 0               # this rank's index in its data group
        for d in self.batch_dims:
            self.ranks *= self.shape[d]
            self.rank = self.rank * self.shape[d] + self.coordinate[d]
        self._partial = [Partial("avg") if d in self.batch_dims else Replicate()
                         for d in range(len(names))]
        self._gathered = [Shard(0) if d in self.batch_dims else Replicate()
                          for d in range(len(names))]
        self.placements = [s.placements() for s in tree_leaves(param_shardings)]

    def _dtensor(self, local, placements):
        from torch.distributed.tensor import DTensor

        return DTensor.from_local(local, self.mesh, placements, run_check=False)

    def reduce_grad(self, grad: torch.Tensor, index: int) -> torch.Tensor:
        """The rank's gradient of parameter leaf ``index`` averaged over
        the data ranks, as that leaf's local shard."""
        return self._dtensor(grad, self._partial).redistribute(
            self.mesh, self.placements[index]).to_local()

    def mean(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` averaged over the batch axes, on every rank."""
        return self._dtensor(x, self._partial).full_tensor()

    def batch_counts(self, counts: torch.Tensor) -> torch.Tensor:
        """Each rank's ``counts`` (one per micro-batch), gathered over the
        data group in batch-row order: ``(ranks * len(counts),)``."""
        return self._dtensor(counts[None], self._gathered).full_tensor().reshape(-1)

    def _sharded_dims(self, index: int, tensor_dim: int | None = None) -> list[int]:
        from torch.distributed.tensor import Shard

        return [d for d, p in enumerate(self.placements[index])
                if isinstance(p, Shard) and self.shape[d] > 1
                and (tensor_dim is None or p.dim == tensor_dim)]

    def global_norm(self, leaves: list) -> torch.Tensor:
        """sqrt of the sum of squares of the whole (unsharded) leaves,
        from their local shards: the per-leaf sums of squares (one dot
        product each, in f32) summed over the mesh dims that shard the
        leaf, a replicated leaf taken from coordinate 0 of the others
        alone, then added in tree order (``optim.global_norm``'s order)."""
        sq = torch.stack([torch.dot(f, f) for f in
                          (x.float().reshape(-1) for x in leaves)])
        for d, n in enumerate(self.shape):
            if n == 1:
                continue
            if self.coordinate[d]:
                sharded = torch.tensor([d in self._sharded_dims(i)
                                        for i in range(len(leaves))],
                                       device=sq.device)
                sq = torch.where(sharded, sq, torch.zeros_like(sq))
            dist.all_reduce(sq, group=self.mesh.get_group(d))
        total = 0
        for x in sq.unbind():
            total = total + x
        return torch.sqrt(total)

    def row_absmax_(self, index: int, absmax: torch.Tensor) -> None:
        """The row absmax of parameter leaf ``index``'s local shard made
        the whole row's, in place: an all-reduce (max) over the mesh dims
        that shard the leaf's last dim."""
        for d in self._sharded_dims(index, absmax.dim() - 1):
            dist.all_reduce(absmax, op=dist.ReduceOp.MAX,
                            group=self.mesh.get_group(d))


# ---------------------------------------------------------------------------
# Tensor-parallel serving: the axis collectives and a rank's blocks
# ---------------------------------------------------------------------------


def axis_group(mesh, axis: str):
    """The process group of ``mesh``'s dim named ``axis``."""
    return mesh.get_group(axis)


def all_reduce(x: torch.Tensor, mesh, axis: str, op: str = "sum") -> torch.Tensor:
    """``x`` reduced (``"sum"`` or ``"max"``) over ``mesh``'s ``axis``.  A
    sum of a floating dtype narrower than f32 over more than one rank is
    taken in f32 and rounded once, as XLA's all-reduce of bf16 partials
    on the host is: a ring's adds in the narrow dtype would round after
    each, in an order that depends on the rank.  (On one rank the sum is
    ``x`` in either dtype.)"""
    group = axis_group(mesh, axis)
    fc = torch.ops._c10d_functional
    wide = (op == "sum" and x.is_floating_point() and group.size() > 1
            and torch.finfo(x.dtype).bits < 32)
    out = fc.wait_tensor(fc.all_reduce(x.float() if wide else x, op,
                                       group.group_name))
    return out.to(x.dtype) if wide else out


def all_gather(x: torch.Tensor, mesh, axis: str, dim: int) -> torch.Tensor:
    """The blocks of ``x`` over ``mesh``'s ``axis`` concatenated along
    ``dim``, in the axis's order."""
    group = axis_group(mesh, axis)
    n = group.size()
    fc = torch.ops._c10d_functional
    out = fc.wait_tensor(fc.all_gather_into_tensor(x.contiguous(), n,
                                                   group.group_name))
    if dim % x.ndim:
        out = torch.cat(out.chunk(n, dim=0), dim=dim)
    return out


def gather_entry(x: torch.Tensor, mesh, entry, dim: int) -> torch.Tensor:
    """``x``'s dim ``dim`` gathered over every mesh axis of a spec entry
    (a name, a tuple of names or ``None``): the minor axis first, so a
    tuple's blocks come back in JAX's order."""
    for a in reversed(_group(entry)):
        x = all_gather(x, mesh, a, dim)
    return x


def spec_of(dtensor) -> tuple:
    """The spec (one entry per tensor dim, as :class:`NamedSharding`'s)
    that a DTensor's placements encode."""
    from torch.distributed.tensor import Shard

    names = dtensor.device_mesh.mesh_dim_names
    axes: list[list[str]] = [[] for _ in range(dtensor.ndim)]
    for d, p in enumerate(dtensor.placements):
        if isinstance(p, Shard):
            axes[p.dim].append(names[d])
    return tuple(None if not a else a[0] if len(a) == 1 else tuple(a)
                 for a in axes)


@dataclass(frozen=True)
class LocalBlock:
    """A rank's block ``tensor`` of a tensor placed by ``sharding``: what
    a tensor-parallel step hands the model for each parameter and cache
    leaf.  ``full_shape`` is the whole tensor's shape and ``index`` the
    rank's block of it (``NamedSharding.index``).  Indexing and
    ``unbind`` along a replicated leading dim (the stacked layers) give
    the layers' blocks."""

    tensor: torch.Tensor
    sharding: NamedSharding
    full_shape: tuple[int, ...]
    index: tuple[slice, ...]

    @classmethod
    def at(cls, tensor: torch.Tensor, sharding: NamedSharding,
           full_shape) -> "LocalBlock":
        """The rank's block ``tensor`` of a ``full_shape`` tensor."""
        full_shape = tuple(full_shape)
        return cls(tensor, sharding, full_shape, sharding.index(
            sharding.mesh.get_coordinate(), full_shape))

    @classmethod
    def of(cls, dtensor) -> "LocalBlock":
        return cls.at(dtensor.to_local(),
                      NamedSharding(dtensor.device_mesh, spec_of(dtensor)),
                      dtensor.shape)

    @property
    def mesh(self):
        return self.sharding.mesh

    def _layer(self, t: torch.Tensor) -> "LocalBlock":
        if self.sharding.spec[0] is not None:
            raise ValueError(f"dim 0 of {self.sharding.spec} is sharded: a "
                             f"leading stack is replicated")
        return LocalBlock(t, NamedSharding(self.mesh, self.sharding.spec[1:]),
                          self.full_shape[1:], self.index[1:])

    def __getitem__(self, i: int) -> "LocalBlock":
        return self._layer(self.tensor[i])

    def unbind(self, dim: int = 0) -> list:
        if dim != 0:
            raise ValueError("a block unbinds along its leading dim only")
        return [self._layer(t) for t in self.tensor.unbind(0)]

    def block(self, dim: int, axis: str = "model") -> tuple[int, int, bool]:
        """``(start, stop, split)``: the block of dim ``dim`` this rank
        holds when the dim is split over ``axis`` alone (``split`` true,
        even on an axis of size 1), else the whole dim (the block that
        :meth:`gathered` with ``keep=dim`` returns)."""
        if self.sharding.spec[dim] != axis:
            return 0, self.full_shape[dim], False
        return self.index[dim].start, self.index[dim].stop, True

    def gathered(self, dtype=None, *, keep: int | None = None,
                 axis: str = "model") -> torch.Tensor:
        """The block cast to ``dtype`` (before any gather, so the wire
        carries the compute dtype), then gathered over every mesh axis
        that shards it but ``axis`` on dim ``keep``."""
        t = self.tensor if dtype is None else self.tensor.to(dtype)
        for i, entry in enumerate(self.sharding.spec):
            if i == keep and entry == axis:
                continue
            t = gather_entry(t, self.mesh, entry, i)
        return t

