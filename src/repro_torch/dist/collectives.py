"""The collectives of the sharded steps on a ``DeviceMesh``.

The state lives sharded at rest, each leaf a DTensor on its
:class:`~repro_torch.dist.sharding.NamedSharding`.

*The train step* (``train/steps.py`` ``make_sharded_train_step``) and
*the serve steps* (``make_prefill_step``, ``make_serve_step`` on a mesh)
hand the model each parameter and cache leaf as a :class:`LocalBlock`:
the rank's block (one ``to_local()`` a leaf a step) with the spec that
placed it.  The model computes on its blocks, Megatron style, with the
helpers below: ``_c10d_functional`` ops on the groups of the mesh's
axes, which ``core/hlo.py`` traces with their mesh axis, as the
reference's ``shard_map`` names its ``psum``s: :func:`all_reduce` (sum,
max), :func:`all_gather` along a dim, and :meth:`LocalBlock.block`, the
rank's block of a dim (``NamedSharding.index``).  A weight sharded over
an axis the computation does not split is gathered over it where it is
used (:meth:`LocalBlock.gathered`), layer by layer, the way GSPMD
gathers it.  On a mesh whose axes all have size 1 the collectives are
still dispatched; a one-rank group returns the same bits.

*Gradients.*  The sum and the gather are differentiable, each backward
its forward's exact adjoint: the sum's is the sum of the cotangents,
the gather's the reduce-scatter (sum) of the cotangent along the
gathered dim.  Read the train step's loss as ``1 / n`` times the sum,
over the mesh's ``n`` ranks, of each rank's copy of its loss: each rank
seeds its backward with ``1 / n`` (:attr:`DataParallel.share`), the
adjoints carry every cross-rank term, and the gradient of a leaf's block
is finished by summing over the axes that replicate the leaf
(:meth:`DataParallel.reduce_grad`).  No layer needs to know whether an
activation is replicated or a rank's partial term.  A ``max`` has no
such adjoint here and refuses a tensor that requires grad.

:class:`DataParallel` holds the rest of the sharded step:

* :meth:`~DataParallel.reduce_grad`: a rank's gradient of its block
  summed over the mesh dims that replicate the leaf, the leaf's local
  shard (over a dim that shards it the gather's adjoint has summed
  already);
* :meth:`~DataParallel.global_norm`: the clipping norm over sharded
  leaves, each element counted once however often its leaf is
  replicated;
* :meth:`~DataParallel.row_absmax_`: the int8 moments' row absmax
  all-reduced (max) over the mesh dims that shard a leaf's last dim;
* :meth:`~DataParallel.batch_counts` and :meth:`~DataParallel.mean`: the
  mask counts of every rank's micro-batches, and the metrics averaged
  over the batch axes.

These exchanges of counts, norms, absmaxes and metrics carry no
gradient.  On a mesh whose every dim has size 1 each of these is the
identity, bit for bit.
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
        #: each rank's share of the step's mean loss: the seed of its
        #: backward (1.0 on a one-rank mesh)
        self.share = 1.0 / mesh.size()

    def _dtensor(self, local, placements):
        from torch.distributed.tensor import DTensor

        return DTensor.from_local(local, self.mesh, placements, run_check=False)

    def reduce_grad(self, grad: torch.Tensor, index: int) -> torch.Tensor:
        """The gradient of parameter leaf ``index`` as that leaf's local
        shard, from the rank's gradient of its block (a backward seeded
        with :attr:`share`): summed over the mesh dims of more than one
        rank that replicate the leaf, which averages it over the batch
        axes too (the seed's ``1 / n``).  A dim that shards the leaf
        needs no sum: each rank's block has its whole gradient, summed by
        the gather's adjoint where the block was gathered for its use."""
        from torch.distributed.tensor import Replicate

        for d, p in enumerate(self.placements[index]):
            if isinstance(p, Replicate) and self.shape[d] > 1:
                grad = _sum(grad, self.mesh.get_group(d))
        return grad

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
# Tensor parallel: the axis collectives, their adjoints, a rank's blocks
# ---------------------------------------------------------------------------


def axis_group(mesh, axis: str):
    """The process group of ``mesh``'s dim named ``axis``."""
    return mesh.get_group(axis)


def _wide(x: torch.Tensor, group) -> bool:
    """Whether a sum of ``x`` over ``group`` is taken in f32: a floating
    dtype narrower than f32 over more than one rank."""
    return (x.is_floating_point() and group.size() > 1
            and torch.finfo(x.dtype).bits < 32)


def _sum(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` summed over ``group``; a narrow float's sum in f32, rounded
    once (:func:`all_reduce`)."""
    fc = torch.ops._c10d_functional
    wide = _wide(x, group)
    out = fc.wait_tensor(fc.all_reduce(
        x.float() if wide else x.contiguous(), "sum", group.group_name))
    return out.to(x.dtype) if wide else out


def _gather(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The blocks of ``x`` over ``group`` concatenated along ``dim``."""
    n = group.size()
    fc = torch.ops._c10d_functional
    out = fc.wait_tensor(fc.all_gather_into_tensor(x.contiguous(), n,
                                                   group.group_name))
    if n > 1 and dim % x.ndim:
        out = torch.cat(out.chunk(n, dim=0), dim=dim)
    return out


def _scatter_sum(g: torch.Tensor, group, dim: int) -> torch.Tensor:
    """:func:`_gather`'s adjoint: ``g`` summed over ``group`` and this
    rank's block of ``dim`` kept (a reduce-scatter; a narrow float's sum
    in f32, rounded once)."""
    n = group.size()
    if n > 1 and dim % g.ndim:
        g = torch.cat(g.chunk(n, dim=dim), dim=0)
    fc = torch.ops._c10d_functional
    wide = _wide(g, group)
    out = fc.wait_tensor(fc.reduce_scatter_tensor(
        (g.float() if wide else g).contiguous(), "sum", n, group.group_name))
    return out.to(g.dtype) if wide else out


class _AllReduceSum(torch.autograd.Function):
    """The sum over a group; its adjoint is the sum of the cotangents."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _sum(x, group)

    @staticmethod
    def backward(ctx, g):
        return _sum(g, ctx.group), None


class _AllGather(torch.autograd.Function):
    """The gather along a dim; its adjoint is the reduce-scatter (sum)
    along that dim."""

    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _scatter_sum(g, ctx.group, ctx.dim), None, None


def all_reduce(x: torch.Tensor, mesh, axis: str, op: str = "sum") -> torch.Tensor:
    """``x`` reduced (``"sum"`` or ``"max"``) over ``mesh``'s ``axis``.  A
    sum of a floating dtype narrower than f32 over more than one rank is
    taken in f32 and rounded once, as XLA's all-reduce of bf16 partials
    on the host is: a ring's adds in the narrow dtype would round after
    each, in an order that depends on the rank.  (On one rank the sum is
    ``x`` in either dtype.)  The sum is differentiable (its backward the
    same sum of the cotangents, by the same rule); a ``max`` of a tensor
    that requires grad raises ``ValueError``."""
    group = axis_group(mesh, axis)
    if op == "sum":
        return _AllReduceSum.apply(x, group)
    if torch.is_grad_enabled() and x.requires_grad:
        raise ValueError(f"all_reduce {op!r} over {axis!r} has no gradient: "
                         f"reduce a tensor that requires none")
    fc = torch.ops._c10d_functional
    return fc.wait_tensor(fc.all_reduce(x, op, group.group_name))


def all_gather(x: torch.Tensor, mesh, axis: str, dim: int) -> torch.Tensor:
    """The blocks of ``x`` over ``mesh``'s ``axis`` concatenated along
    ``dim``, in the axis's order.  Differentiable: the backward
    reduce-scatters (sums) the cotangent along ``dim``."""
    return _AllGather.apply(x, axis_group(mesh, axis), dim)


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

