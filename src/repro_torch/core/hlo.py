"""Resource terms of one traced step: the port's performance counter (the
reference's ``repro/core/hlo.py``).

The reference compiles each (architecture x input shape x mesh) cell with
XLA and reads ``cost_analysis()``, ``memory_analysis()`` and the HLO
text.  The port has no compiler between the model and the card, so it
runs the step once, eagerly, under counters: on fake tensors
(``torch._subclasses.fake_tensor.FakeTensorMode``, no storage and no
launch) for the dry-run, or on real ones.  :func:`analyze` records

* FLOPs from ``torch.utils.flop_counter.FlopCounterMode``: the ops it has
  a formula for (the products, convolutions, attention; the port's flash
  op registers its own: :func:`flop_counter`), not the elementwise ops;
* bytes as the sum over every dispatched aten op of the bytes of its
  input and output tensors: the traffic of an eager program that runs one
  kernel per op, each reading its operands from device memory and writing
  its results back, with every L2 hit left out (an upper bound on the
  card's traffic, where XLA's ``bytes accessed`` counts a fused program).
  An input counts the memory it spans, so a broadcast (a stride of 0) is
  read once; views and aliases, which launch nothing, and the
  collectives, which count below, are left out;
* transcendentals as the output elements of ``exp``, ``log``, ``tanh``,
  ``sigmoid``, ``rsqrt``, ``erf``, ``sin`` and ``cos``;
* the collectives (``_c10d_functional`` and ``c10d`` ops) with their
  kind, output bytes and group size, as the reference parses them from
  the HLO text, and priced on the wire by the same ring multipliers
  (:class:`CollectiveOp`); each also names the mesh axis its group spans
  (a ``DeviceMesh`` runs one group a dim), which the HLO text does not,
  and a reduction its op;
* the memory: the bytes of the arguments, the peak of the arguments and
  every storage the step made while it was alive (a weak reference to
  each storage tells when it is freed), the outputs (what the step made
  that is still alive after it), and the temporaries, the rest of the
  peak (the reference's ``memory_analysis()`` fields).

The counts are the program of one rank: under a ``DeviceMesh`` each rank
runs its own rows, so FLOPs and bytes are per card, as the reference's
partitioned module's are.  The reference's HLO-text parser
(``parse_collectives``) has nothing to read here and is not ported.
"""
from __future__ import annotations

import weakref
from collections import defaultdict
from dataclasses import dataclass, field

import torch
from torch.utils._python_dispatch import TorchDispatchMode

__all__ = ["CollectiveOp", "HLOResources", "Trace", "analyze",
           "flop_counter", "memory_analysis_dict", "mesh_axes"]


def flop_counter():
    """A ``FlopCounterMode`` that counts the port's flash op too.  A counter
    copies the formula registry when it is made, and the op registers its
    formula when its module is imported, which a model does lazily, inside
    its first call: so the module is imported here first."""
    from torch.utils.flop_counter import FlopCounterMode

    from ..kernels.attention import ops  # noqa: F401

    return FlopCounterMode(display=False)


@dataclass
class CollectiveOp:
    kind: str
    out_bytes: float
    group_size: int
    line: str = ""
    #: the mesh axis the group spans, where the trace knows it ("" if not)
    axis: str = ""
    #: the reduction of an all-reduce or reduce-scatter (``"sum"``,
    #: ``"max"``, ...; "" where the op names none)
    op: str = ""

    @property
    def wire_bytes_per_chip(self) -> float:
        """Per-chip on-wire bytes for a ring algorithm.

        With output/buffer size B and group size N (per chip contribution):
          all-gather:        each chip sends its shard around: (N-1)/N * B
          reduce-scatter:    same traffic pattern: (N-1)/N * B
          all-reduce:        RS + AG: 2 (N-1)/N * B
          all-to-all:        each chip keeps 1/N: (N-1)/N * B
          collective-permute: B (point-to-point)
        """
        n = max(self.group_size, 1)
        frac = (n - 1) / n
        if self.kind == "all-reduce":
            return 2.0 * frac * self.out_bytes
        if self.kind == "collective-permute":
            return self.out_bytes
        return frac * self.out_bytes


@dataclass
class HLOResources:
    """Aggregated per-program resources of one rank."""

    flops: float = 0.0
    bytes_accessed: float = 0.0
    transcendentals: float = 0.0
    collectives: list[CollectiveOp] = field(default_factory=list)

    @property
    def collective_bytes(self) -> float:
        """Sum of collective operand (output) bytes."""
        return sum(c.out_bytes for c in self.collectives)

    @property
    def wire_bytes_per_chip(self) -> float:
        return sum(c.wire_bytes_per_chip for c in self.collectives)

    def by_kind(self) -> dict[str, float]:
        out: dict[str, float] = defaultdict(float)
        for c in self.collectives:
            out[c.kind] += c.out_bytes
        return dict(out)


#: aten ops whose output elements count as transcendentals (with their
#: in-place forms)
TRANSCENDENTALS = frozenset({"exp", "log", "tanh", "sigmoid", "rsqrt", "erf",
                             "sin", "cos"})
#: collective op name (``_c10d_functional`` / ``c10d``) -> the reference's
#: kind
COLLECTIVE_KINDS = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "allgather_": "all-gather",
    "_allgather_base_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "allreduce_": "all-reduce",
    "allreduce_coalesced_": "all-reduce",
    "all_to_all_single": "all-to-all",
    "alltoall_base_": "all-to-all",
    "alltoall_": "all-to-all",
    "send": "collective-permute",
}
_COLLECTIVE_NAMESPACES = ("_c10d_functional", "c10d_functional", "c10d")
#: aten ops that launch no kernel and move no byte
_NO_TRAFFIC = frozenset({"empty", "empty_strided", "empty_like", "new_empty",
                         "new_empty_strided", "detach", "lift_fresh", "alias",
                         "_unsafe_view", "_reshape_alias",
                         "_local_scalar_dense", "set_", "resize_"})


def _local(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's local shard (the bytes this rank holds), else ``t``."""
    return getattr(t, "_local_tensor", t)


def _tensors(tree) -> list[torch.Tensor]:
    """The tensors of an op's arguments or outputs (tensors, and lists,
    tuples and dicts of them), a DTensor as its local shard."""
    if isinstance(tree, torch.Tensor):
        return [_local(tree)]
    if isinstance(tree, (list, tuple)):
        return [t for x in tree for t in _tensors(x)]
    if isinstance(tree, dict):
        return [t for x in tree.values() for t in _tensors(x)]
    return []


def _nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _read_bytes(tensors) -> int:
    """The bytes the tensors span in memory: a dim of stride 0 (a
    broadcast) is read once."""
    total = 0
    for t in tensors:
        if t.numel():
            span = 1 + sum((n - 1) * abs(st)
                           for n, st in zip(t.shape, t.stride()))
            total += min(t.numel(), span) * t.element_size()
    return total


def _named(func, args, kwargs) -> dict:
    return dict(zip((a.name for a in func._schema.arguments), args)) | kwargs


def _group(func, args, kwargs) -> tuple[int, str]:
    """The group of a collective: its size (the ``group_size`` argument of
    an all-gather or reduce-scatter, else the size of the process group
    its ``group_name`` or ``process_group`` argument names) and that
    group's name ("" where the op names none)."""
    import torch.distributed as dist
    from torch.distributed import distributed_c10d as c10d

    named = _named(func, args, kwargs)
    group = named.get("group_name", named.get("process_group"))
    if isinstance(group, str):
        group = c10d._resolve_process_group(group)
    elif isinstance(group, torch.ScriptObject):
        group = dist.ProcessGroup.unbox(group)
    name = getattr(group, "group_name", "") or ""
    if "group_size" in named:
        return int(named["group_size"]), name
    return (group.size() if hasattr(group, "size") else 1), name


class _Recorder(TorchDispatchMode):
    """Counts the bytes, transcendentals and collectives of every dispatched
    op, and tracks the live storages for the peak."""

    def __init__(self, arguments: list[torch.Tensor], mesh_axes: dict):
        super().__init__()
        self.mesh_axes = mesh_axes
        self.bytes = 0
        self.transcendentals = 0
        self.collectives: list[CollectiveOp] = []
        self._seen: dict[int, weakref.ref] = {}
        self.argument_bytes = 0
        for t in arguments:
            self.argument_bytes += self._track(t, argument=True)
        self.live = 0
        self.peak = 0

    def _free(self, key: int, nbytes: int, _ref) -> None:
        if self._seen.get(key) is _ref:
            del self._seen[key]
            self.live -= nbytes

    def _track(self, t: torch.Tensor, *, argument: bool = False) -> int:
        """Register ``t``'s storage; its bytes if it is new."""
        st = t.untyped_storage()
        key = id(st)
        if key in self._seen:
            return 0
        n = st.nbytes()
        if argument:
            self._seen[key] = weakref.ref(st)
        else:
            ref = weakref.ref(st, lambda r, key=key, n=n: self._free(key, n, r))
            self._seen[key] = ref
        return n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func.namespace in ("prim", "profiler"):
            return out
        name = func.overloadpacket.__name__
        outs = _tensors(out)
        if func.namespace in _COLLECTIVE_NAMESPACES:
            kind = COLLECTIVE_KINDS.get(name)
            if kind is not None:
                size, group = _group(func, args, kwargs)
                self.collectives.append(CollectiveOp(
                    kind, float(_nbytes(outs or _tensors(args[0]))), size,
                    line=str(func), axis=self.mesh_axes.get(group, ""),
                    op=str(_named(func, args, kwargs).get("reduce_op", ""))))
        elif not func.is_view and name not in _NO_TRAFFIC:
            self.bytes += (_read_bytes(_tensors((args, kwargs)))
                           + _nbytes(outs))
            if name.rstrip("_") in TRANSCENDENTALS:
                self.transcendentals += sum(t.numel() for t in outs)
        for t in outs:
            self.live += self._track(t)
        self.peak = max(self.peak, self.live)
        return out


@dataclass
class Trace:
    """What :func:`analyze` read off one run of a step."""

    resources: HLOResources
    memory: dict[str, float]


def mesh_axes(mesh) -> dict[str, str]:
    """Process-group name -> mesh axis name of each dim of a
    ``DeviceMesh`` (``analyze``'s ``mesh_axes``)."""
    return {mesh.get_group(i).group_name: name
            for i, name in enumerate(mesh.mesh_dim_names)}


def analyze(fn, *args, mesh_axes: dict | None = None, **kwargs) -> Trace:
    """Run ``fn(*args, **kwargs)`` once under the counters of the module's
    docstring and return its :class:`Trace`.  The caller makes the inputs:
    fake tensors under its ``FakeTensorMode`` for a dry-run (the step then
    runs nothing on a device), or real ones.  The arguments' storages count
    as arguments (a DTensor's by its local shard).  ``mesh_axes`` (from
    :func:`mesh_axes`) tags each collective with the mesh axis its group
    spans."""
    rec = _Recorder(_tensors((args, kwargs)), mesh_axes or {})
    with flop_counter() as fc, rec:
        out = fn(*args, **kwargs)
    res = HLOResources(flops=float(fc.get_total_flops()),
                       bytes_accessed=float(rec.bytes),
                       transcendentals=float(rec.transcendentals),
                       collectives=rec.collectives)
    outputs = rec.live      # what the step made that ``out`` keeps alive
    memory = {"argument_size_in_bytes": float(rec.argument_bytes),
              "output_size_in_bytes": float(outputs),
              "temp_size_in_bytes": float(rec.peak - outputs),
              "peak_size_in_bytes": float(rec.argument_bytes + rec.peak)}
    del out
    return Trace(res, memory)


def memory_analysis_dict(trace: Trace) -> dict[str, float]:
    """The reference's ``memory_analysis_dict`` fields of a :class:`Trace`
    (``argument_size_in_bytes``, ``output_size_in_bytes``,
    ``temp_size_in_bytes``) and its ``peak_size_in_bytes``."""
    return dict(trace.memory)
