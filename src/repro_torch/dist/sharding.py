"""Logical-axis sharding: rules, profiles and the active mesh context (the
reference's ``repro/dist/sharding.py``) on a torch ``DeviceMesh``.

Models declare parameters with *logical* axis names
(``repro_torch.models.common.ParamSpec``); a :class:`ShardingProfile`
maps logical names to mesh axes; and :func:`param_shardings` resolves a
whole spec tree into one :class:`NamedSharding` per leaf for one
concrete mesh.  A spec stays the reference's ``PartitionSpec`` kept as
data: a tuple with one entry per tensor dim, each a mesh-axis name,
``None`` (replicated) or a tuple of names (one tensor dim over several
mesh dims), so it compares with the reference's entry for entry.

Resolution is divisibility-aware, as the reference's: a logical axis
whose dimension does not divide the mesh axes it maps to is left
unsharded; a tuple keeps its longest dividing prefix; a mesh axis
appears at most once per spec, the first (leftmost) logical axis that
claims it wins.  Resolution reads only the mesh's axis names and sizes
(``mesh_dim_names``, ``shape``), so a spec can be computed for a mesh
larger than the world at hand.

:class:`NamedSharding` turns a spec into DTensor placements:
``Shard(dim)`` on each mesh dim the spec names, ``Replicate()`` on the
rest.  A tuple group shards one tensor dim over several mesh dims.  JAX
orders the blocks major-to-minor in the tuple's order (device
``(c_1, .., c_k)`` along the tuple's axes holds block
``((c_1 n_2 + c_2) n_3 + ..) + c_k``); DTensor orders them by mesh-dim
order.  The two agree exactly when the tuple lists its axes in mesh
order, so each rank holds the block JAX's ``NamedSharding`` gives that
device; a tuple out of mesh order raises (:meth:`NamedSharding.index`
gives JAX's block for any spec).

:func:`use_mesh_context` installs the active mesh and profile: code reads
it back with :func:`current_context` (the data axes, the MoE's FSDP
axis, the decode cache's sequence axis).  The reference's activation
annotations (``shard_annotate``) have nothing to act on in eager
PyTorch and are not ported: the serve steps compute on each rank's
blocks explicitly (``dist/collectives.py``).

The reference's serving rules (its ``launch/dryrun.py``), which the
serve launcher and the dry-run share: :func:`input_profile` places the
batch and the decode caches (KV heads over ``model`` where they divide
it, else the sequence), :func:`serving_profile` the decode profile
with ``heads: None`` where they do not (the q heads whole beside a cache
split by sequence), and the prefill's ``seq: model``, which is recorded
and not applied: a sequence-parallel residual stream is GSPMD's rewrite,
with no reference code to port (ROADMAP §3 item 2).
"""
from __future__ import annotations

import math
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Any

from ..models.common import ParamSpec, tree_map

# ---------------------------------------------------------------------------
# Profiles
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ShardingProfile:
    """Named bundle of logical-axis -> mesh-axis rules.

    ``rules`` governs parameters (and optimizer state, which shares the
    parameter specs); ``activation_rules`` the activations (here only
    ``batch``, which gives the data axes).  A rule value is a mesh axis
    name, a tuple of mesh axis names, or ``None`` (replicate).
    """

    name: str
    rules: dict[str, Any]
    activation_rules: dict[str, Any] = field(default_factory=dict)


def _batch_axes(multi_pod: bool) -> tuple[str, ...]:
    return ("pod", "data") if multi_pod else ("data",)


def tp_dp(multi_pod: bool = False) -> ShardingProfile:
    """Tensor parallel over ``model``, data parallel over batch."""
    return ShardingProfile(
        name="tp_dp",
        rules={
            "mlp": "model", "heads": "model", "kv_heads": "model",
            "heads_qk": "model", "experts": "model", "experts_r": None,
            "mamba_inner": "model", "vocab": "model",
            "embed": None, "layers": None, "head_dim": None,
        },
        activation_rules={
            "batch": _batch_axes(multi_pod),
            "mlp": "model", "heads": "model", "kv_heads": "model",
            "mamba_inner": "model", "vocab": "model",
            "embed": None, "seq": None,
        },
    )


def tp_fsdp(multi_pod: bool = False) -> ShardingProfile:
    """TP over ``model`` + FSDP: the embed axis of every weight is sharded
    over ``data``."""
    base = tp_dp(multi_pod)
    return ShardingProfile(
        name="tp_fsdp",
        rules={**base.rules, "embed": "data"},
        activation_rules=base.activation_rules,
    )


def moe_ep(multi_pod: bool = False) -> ShardingProfile:
    """Expert parallelism: experts over ``model``, tokens data-sharded,
    expert weights FSDP'd over ``data``."""
    base = tp_dp(multi_pod)
    return ShardingProfile(
        name="moe_ep",
        rules={**base.rules, "experts": "model", "mlp": None,
               "embed": "data"},
        activation_rules=base.activation_rules,
    )


def dp_vocab(multi_pod: bool = False) -> ShardingProfile:
    """Pure data parallel with only the (large) vocab dims model-sharded."""
    base = tp_dp(multi_pod)
    return ShardingProfile(
        name="dp_vocab",
        rules={**base.rules, "mlp": None, "heads": None, "heads_qk": None,
               "mamba_inner": None, "vocab": "model"},
        activation_rules={**base.activation_rules, "mlp": None,
                          "heads": None, "mamba_inner": None},
    )


# ---------------------------------------------------------------------------
# Profile registry
# ---------------------------------------------------------------------------

#: name -> constructor ``(multi_pod: bool = False) -> ShardingProfile``
PROFILES: dict[str, Any] = {}
_PROFILE_ALIASES: dict[str, str] = {}


def register_profile(profile_or_ctor, *aliases, name: str | None = None):
    """Register a sharding profile by name: a constructor
    ``ctor(multi_pod: bool = False) -> ShardingProfile`` or a concrete
    :class:`ShardingProfile` (wrapped in a constructor that ignores
    ``multi_pod``).  Returns the argument, so it can decorate."""
    if isinstance(profile_or_ctor, ShardingProfile):
        prof = profile_or_ctor
        key = name or prof.name

        def ctor(multi_pod: bool = False, _p=prof) -> ShardingProfile:
            return _p
    else:
        ctor = profile_or_ctor
        key = name or ctor(False).name
    PROFILES[key] = ctor
    for a in aliases:
        _PROFILE_ALIASES[a] = key
    return profile_or_ctor


def get_profile(name_or_profile, *,
                multi_pod: bool = False) -> ShardingProfile:
    """Resolve a profile by registered name (a :class:`ShardingProfile`
    passes through unchanged)."""
    if isinstance(name_or_profile, ShardingProfile):
        return name_or_profile
    key = _PROFILE_ALIASES.get(name_or_profile, name_or_profile)
    try:
        ctor = PROFILES[key]
    except KeyError:
        raise KeyError(
            f"unknown sharding profile {name_or_profile!r}; registered: "
            f"{', '.join(profile_names())}") from None
    return ctor(multi_pod)


def profile_names() -> tuple[str, ...]:
    """Sorted names of all registered sharding profiles."""
    return tuple(sorted(PROFILES))


for _ctor in (tp_dp, tp_fsdp, moe_ep, dp_vocab):
    register_profile(_ctor)
del _ctor


# ---------------------------------------------------------------------------
# Rule resolution
# ---------------------------------------------------------------------------


def _axis_sizes(mesh) -> dict[str, int]:
    """Axis name -> size of a ``DeviceMesh`` (or anything with its
    ``mesh_dim_names`` and ``shape``)."""
    if mesh is None:
        return {}
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))


def _group_size(group: tuple[str, ...], sizes: dict[str, int]) -> int:
    n = 1
    for g in group:
        n *= sizes.get(g, 1)
    return n


def _resolve_one(assignment, dim: int | None, sizes: dict[str, int],
                 taken: set[str]):
    """Resolve one logical-axis assignment against divisibility + dedup:
    the mesh axis (or tuple, or None) used.  Tuples keep the largest
    prefix whose mesh-size product divides ``dim``."""
    if assignment is None:
        return None
    group = assignment if isinstance(assignment, tuple) else (assignment,)
    if any(g in taken for g in group):
        return None
    if dim is None or not sizes:
        return assignment
    for k in range(len(group), 0, -1):
        n = _group_size(group[:k], sizes)
        if n and dim % n == 0:
            return group[:k] if k > 1 else group[0]
    return None


def logical_to_pspec(axes, rules: dict[str, Any],
                     dims: tuple[int, ...] | None = None,
                     mesh=None) -> tuple:
    """Map logical axis names to a spec (a tuple, one entry per dim) via
    ``rules``.  ``dims``/``mesh`` enable the divisibility fallback (an
    indivisible logical axis is replicated).  Duplicate mesh axes are
    deduped, first occurrence wins."""
    sizes = _axis_sizes(mesh)
    taken: set[str] = set()
    out = []
    for i, a in enumerate(axes):
        assignment = rules.get(a) if a else None
        dim = dims[i] if dims is not None else None
        chosen = _resolve_one(assignment, dim, sizes, taken)
        if chosen is not None:
            taken.update(chosen if isinstance(chosen, tuple) else (chosen,))
        out.append(chosen)
    return tuple(out)


def _ensure_model(spec: ParamSpec, pspec: tuple, sizes: dict[str, int],
                  min_elems: int) -> tuple:
    """Force ``model`` onto the largest divisible dim of a big param that
    would otherwise be replicated over ``model``.  ``layers`` axes (the
    stacked layers) are never chosen."""
    n_model = sizes.get("model", 1)
    if n_model <= 1:
        return pspec
    flat: set[str] = set()
    for e in pspec:
        if e is not None:
            flat.update(e if isinstance(e, tuple) else (e,))
    if "model" in flat or math.prod(spec.shape) < min_elems:
        return pspec
    for i in sorted(range(len(spec.shape)), key=lambda i: -spec.shape[i]):
        if spec.axes[i] == "layers" or pspec[i] is not None:
            continue
        if spec.shape[i] % n_model == 0:
            out = list(pspec)
            out[i] = "model"
            return tuple(out)
    return pspec


def _group(entry) -> tuple[str, ...]:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


@dataclass(frozen=True)
class NamedSharding:
    """One leaf's sharding: the mesh and the spec (the reference's
    ``NamedSharding(mesh, PartitionSpec)``)."""

    mesh: Any
    spec: tuple

    def placements(self) -> tuple:
        """DTensor placements, one per mesh dim: ``Shard(i)`` where the
        spec puts tensor dim ``i`` over that mesh dim, else
        ``Replicate()``.  Raises ``ValueError`` for a tuple group out of
        mesh-dim order (DTensor would order its blocks otherwise than
        JAX)."""
        from torch.distributed.tensor import Replicate, Shard

        names = list(self.mesh.mesh_dim_names)
        out: list = [Replicate() for _ in names]
        for i, entry in enumerate(self.spec):
            dims = [names.index(a) for a in _group(entry)]
            if dims != sorted(dims):
                raise ValueError(
                    f"spec entry {entry!r} lists its mesh axes out of the "
                    f"mesh's order {tuple(names)}: DTensor orders the blocks "
                    f"of one tensor dim by mesh dim, JAX by the tuple")
            for d in dims:
                out[d] = Shard(i)
        return tuple(out)

    def index(self, coordinate, shape) -> tuple[slice, ...]:
        """The block of a ``shape`` tensor that the device at mesh
        ``coordinate`` holds under JAX's rule (blocks major-to-minor in
        each tuple's order), as a tuple of slices."""
        sizes = _axis_sizes(self.mesh)
        coord = dict(zip(self.mesh.mesh_dim_names, coordinate))
        out = []
        for i, n in enumerate(shape):
            entry = self.spec[i] if i < len(self.spec) else None
            block, parts = 0, 1
            for a in _group(entry):
                block = block * sizes[a] + coord[a]
                parts *= sizes[a]
            if n % parts:
                raise ValueError(f"dim {i} of {tuple(shape)} does not split "
                                 f"into {parts} blocks ({entry!r})")
            size = n // parts
            out.append(slice(block * size, (block + 1) * size))
        return tuple(out)

    def distribute(self, full):
        """``full`` (the whole tensor, the same on every rank) as a
        DTensor on this sharding, each rank keeping its own block (no
        communication; a leaf replicated on every mesh dim on the mesh's
        device keeps ``full``'s storage)."""
        from torch.distributed.tensor import distribute_tensor

        return distribute_tensor(full.to(mesh_device(self.mesh)), self.mesh,
                                 self.placements(), src_data_rank=None)


def mesh_device(mesh):
    """This rank's device on ``mesh`` (the current card for ``cuda``)."""
    import torch

    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def param_shardings(spec_tree, mesh, profile: ShardingProfile, *,
                    ensure_model_axis: bool = False,
                    min_elems: int = 1 << 16):
    """Spec tree -> :class:`NamedSharding` tree for one concrete mesh."""
    sizes = _axis_sizes(mesh)

    def one(spec: ParamSpec):
        pspec = logical_to_pspec(spec.axes, profile.rules, spec.shape, mesh)
        if ensure_model_axis:
            pspec = _ensure_model(spec, pspec, sizes, min_elems)
        return NamedSharding(mesh, pspec)

    return tree_map(one, spec_tree)


# ---------------------------------------------------------------------------
# Serving rules
# ---------------------------------------------------------------------------


def input_profile(*, multi_pod: bool, kv_divisible: bool,
                  batch_axes=None) -> ShardingProfile:
    """The placement of a serving cell's inputs: the batch over the data
    axes, the decode caches' KV heads over ``model`` when they divide it,
    else their sequence, so a 32k-500k cache fits a card."""
    batch_axes = batch_axes or _batch_axes(multi_pod)
    rules = {
        "batch": batch_axes,
        "embed": None,
        "layers": None,
        "head_dim": None,
        "kv_heads": "model" if kv_divisible else None,
        "seq": None if kv_divisible else "model",
        "heads": "model",
        "mamba_inner": "model",
    }
    return ShardingProfile(name="inputs", rules=rules)


def kv_divisible(cfg, mesh) -> bool:
    """Whether the config's KV heads (its heads, where it has no
    ``n_kv_heads``) divide the mesh's ``model`` axis."""
    kvh = getattr(cfg, "n_kv_heads", None)
    if kvh is None:
        kvh = getattr(cfg, "n_heads", 1)
    return kvh % _axis_sizes(mesh).get("model", 1) == 0


def serving_profile(profile: ShardingProfile, kind: str, *,
                    kv_divisible: bool) -> ShardingProfile:
    """A serving cell's profile: a prefill's records ``seq: model`` (not
    applied), a decode whose cache is split by sequence sets ``heads:
    None``; other cells keep ``profile``."""
    import dataclasses

    if kind == "prefill":
        extra = {"seq": "model"}
    elif kind == "decode" and not kv_divisible:
        extra = {"heads": None}
    else:
        return profile
    return dataclasses.replace(
        profile, activation_rules={**profile.activation_rules, **extra})


# ---------------------------------------------------------------------------
# Active mesh context
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class MeshContext:
    """What model code may ask about the ambient distribution."""

    mesh: Any = None
    profile: ShardingProfile | None = None
    data_axes: tuple[str, ...] = ("data",)
    cache_seq_axis: str | None = None


_NULL_CONTEXT = MeshContext()
_CONTEXT: list[MeshContext] = []


def current_context() -> MeshContext:
    return _CONTEXT[-1] if _CONTEXT else _NULL_CONTEXT


def current_mesh():
    return current_context().mesh


@contextmanager
def use_mesh_context(mesh, profile: ShardingProfile | None, *,
                     multi_pod: bool = False,
                     cache_seq_axis: str | None = None):
    """Install ``mesh``/``profile`` as the ambient distribution context:
    inside the block :func:`current_context` reports the mesh, the
    profile (with its activation rules) and the data axes (the profile's
    ``batch`` rule, else those of ``multi_pod``)."""
    batch = profile.activation_rules.get("batch") if profile else None
    data_axes = (batch if isinstance(batch, tuple)
                 else (batch,) if batch else _batch_axes(multi_pod))
    ctx = MeshContext(mesh=mesh, profile=profile, data_axes=data_axes,
                      cache_seq_axis=cache_seq_axis)
    _CONTEXT.append(ctx)
    try:
        yield ctx
    finally:
        _CONTEXT.pop()
