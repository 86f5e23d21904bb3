"""The collectives of the data-parallel train step on a ``DeviceMesh``.

The state lives sharded at rest, each leaf a DTensor on its
:class:`~repro_torch.dist.sharding.NamedSharding`.  Every rank computes
the step on its own batch rows with every parameter gathered whole, so
the ``model`` axis shards storage only: the model ranks of one data
group compute the same step on the same rows (tensor-parallel compute is
ROADMAP §1 item 5c).  :class:`DataParallel` holds what that needs:

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
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from ..models.common import tree_leaves


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
