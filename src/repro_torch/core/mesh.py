"""Multi-card parallelism model: Eq. 2 over NVLink and the network (the
reference's ``repro/core/mesh.py``).

The paper's Eq. 2 treats multicore scaling as saturation against a
shared bottleneck: compute divides over the executing units, the
bottleneck transfer time does not, and the saturation point is
``n_S = ceil(T_single / T_bottleneck)``.  This module applies it at card
granularity over the strategy space of ``dist/sharding.py``: data,
tensor, pipeline and expert parallelism.

* a :class:`MeshPlan` names one point in the strategy space: the
  ``(data, model, pipe, pods)`` factorization, the sharding profile by
  registered name (``dist.sharding.get_profile``) and the microbatch
  count;
* :func:`plan_collectives` derives each plan's collectives analytically
  from the ``core/compose.py`` op walk (``model_ops``, the reference's
  walk line for line): a row-parallel projection back into the residual
  stream costs a TP all-reduce, expert-parallel MoE layers a
  dispatch/combine all-to-all pair, a vocab-sharded unembedding a
  per-token softmax all-reduce, FSDP the per-microbatch weight
  all-gathers, training the gradient all-reduce (or reduce-scatter +
  all-gather under FSDP), and pipeline stages a boundary
  collective-permute.  Wire bytes per card come from
  ``core/hlo.py`` :class:`~.hlo.CollectiveOp` (the ring multipliers);
* :func:`predict_plan` composes the link and network terms with the
  per-card ``StepPrediction`` of ``core/compose.py`` through
  ``core/gpu_ecm.py`` :class:`~.gpu_ecm.GPUStepECM`: the data-invariant
  collectives (gradient sync, FSDP gathers) are the Eq. 2 floor, and
  pipeline parallelism adds the bubble ``(p - 1) / (m + p - 1)``;
* :func:`rank_meshes` ranks every candidate ``(mesh, profile)`` for a
  config and a card count, with the attention block that ``core/
  autotune.py`` ``rank`` picks among the tile route's compiled tilings;
* :func:`plan_scaling` / :func:`dp_scaling` are the traced-resources
  path: a traced step's collectives used as they are; the pure
  data-parallel case is ``core/scaling.py`` ``gpu_dp_scaling``.

Everything is priced on a :class:`~.machine.GPUMachineModel`: compute at
``peak_bf16_tensor_flops``, the ``data`` and ``model`` axes at
``nvlink_bytes_per_s``, the ``pod`` axis at ``net_bytes_per_s``, the
exposed share of the collectives at ``exposed_link_fraction`` and the
capacity at ``memory_bytes``.  As in the reference a pod is one fabric
domain (its ICI domain; here one NVLink domain), whatever its size: a
DGX H100's NVLink spans only its eight cards.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, replace

from .gpu_ecm import GPUStepECM, fabric_rates
from .hlo import CollectiveOp
from .machine import H100_SXM, GPUMachineModel

__all__ = [
    "MeshPlan",
    "PlanCollectives",
    "TRAIN_STEP_MULT",
    "dp_scaling",
    "plan_candidates",
    "plan_collectives",
    "plan_memory_bytes",
    "plan_scaling",
    "predict_plan",
    "rank_meshes",
]

#: fwd + bwd + update as a multiple of the forward pass (the dry-run's
#: composed-vs-traced steps)
TRAIN_STEP_MULT = 3.0

#: bytes of optimizer state per parameter (f32 master + Adam moments)
OPT_BYTES_PER_PARAM = 12


# ---------------------------------------------------------------------------
# The strategy space
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class MeshPlan:
    """One point in the parallelism-strategy space.

    ``data`` x ``model`` x ``pipe`` x ``pods`` cards; ``profile`` is a
    registered sharding-profile name (``dist/sharding.py``);
    ``microbatches`` feeds the pipeline bubble and the FSDP re-gather
    count.  A plain ``MeshPlan(data=n)`` is the pure data-parallel point
    of ``gpu_dp_scaling``.
    """

    data: int = 1
    model: int = 1
    pipe: int = 1
    pods: int = 1
    profile: str = "tp_dp"
    microbatches: int = 1

    @property
    def n_chips(self) -> int:
        return self.data * self.model * self.pipe * self.pods

    @property
    def multi_pod(self) -> bool:
        return self.pods > 1

    @property
    def data_total(self) -> int:
        """Extent of the batch split (the ``("pod", "data")`` axes)."""
        return self.data * self.pods

    @property
    def bubble_fraction(self) -> float:
        """Classic GPipe bubble: ``(p - 1) / (m + p - 1)``."""
        if self.pipe <= 1:
            return 0.0
        m = max(self.microbatches, 1)
        return (self.pipe - 1) / (m + self.pipe - 1)

    @property
    def pipeline_scale(self) -> float:
        """Per-card time multiplier from the bubble: ``(m+p-1)/m``."""
        if self.pipe <= 1:
            return 1.0
        m = max(self.microbatches, 1)
        return (m + self.pipe - 1) / m

    @property
    def label(self) -> str:
        parts = [f"dp{self.data}"]
        if self.model > 1:
            parts.append(f"tp{self.model}")
        if self.pipe > 1:
            parts.append(f"pp{self.pipe}")
        if self.pods > 1:
            parts.insert(0, f"{self.pods}pod")
        return "x".join(parts)


def plan_candidates(n_chips: int, *, profiles=None, pipe_sizes=(1, 2, 4),
                    microbatches: int = 8, max_model: int | None = None,
                    pods: int = 1) -> list[MeshPlan]:
    """Enumerate the power-of-two ``(data, model, pipe)`` factorizations
    of ``n_chips`` crossed with the registered sharding profiles."""
    from ..dist.sharding import get_profile, profile_names

    profs = tuple(profiles) if profiles is not None else profile_names()
    if n_chips % max(pods, 1):
        raise ValueError(f"pods={pods} does not divide n_chips={n_chips}")

    # At model == 1 the model-axis rules are moot: profiles collapse into
    # FSDP vs non-FSDP classes, one canonical name each (tp_dp / tp_fsdp
    # preferred), so rankings carry no duplicate rows.
    by_class: dict[bool, str] = {}
    for prof in profs:
        fsdp = get_profile(prof).rules.get("embed") == "data"
        if fsdp not in by_class:
            by_class[fsdp] = prof
        if prof in ("tp_dp", "tp_fsdp"):
            by_class[fsdp] = prof
    dp_profs = tuple(by_class[k] for k in sorted(by_class))

    per_pod = n_chips // max(pods, 1)
    out: list[MeshPlan] = []
    for pp in pipe_sizes:
        if pp < 1 or per_pod % pp:
            continue
        rem = per_pod // pp
        mdl = 1
        while mdl <= rem:
            if rem % mdl == 0 and (max_model is None or mdl <= max_model):
                micro = max(microbatches, pp) if pp > 1 else 1
                for prof in (profs if mdl > 1 else dp_profs):
                    out.append(MeshPlan(data=rem // mdl, model=mdl, pipe=pp,
                                        pods=pods, profile=prof,
                                        microbatches=micro))
            mdl *= 2
    return out


# ---------------------------------------------------------------------------
# Analytic per-strategy collective volumes (the compose op walk)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class PlanCollectives:
    """Per-step collectives of one plan, split by fabric (``link``: NVLink,
    the reference's ICI; ``net``: the network, its DCN) and by Eq. 2
    role: ``floor`` is the subset of ``link`` whose per-card volume does
    not shrink as the data axis grows (gradient sync, FSDP weight
    gathers), the shared-bottleneck term of Eq. 2."""

    link: tuple[CollectiveOp, ...] = ()
    net: tuple[CollectiveOp, ...] = ()
    floor: tuple[CollectiveOp, ...] = ()

    @property
    def link_wire_bytes_per_chip(self) -> float:
        return sum(c.wire_bytes_per_chip for c in self.link)

    @property
    def net_wire_bytes_per_chip(self) -> float:
        return sum(c.wire_bytes_per_chip for c in self.net)

    @property
    def floor_bytes(self) -> float:
        """Ring fraction ``(n-1)/n -> 1``: the asymptotic per-card wire
        bytes of the data-invariant collectives."""
        return sum((2.0 if c.kind == "all-reduce" else 1.0) * c.out_bytes
                   for c in self.floor)


#: matmul-op leaf name -> the profile rule that governs its collective:
#: row-parallel projections back into the residual stream (partial sums,
#: an all-reduce where the rule maps to ``model``), but ``expert_*`` (the
#: EP all-to-all) and ``unembed`` (the vocab-sharded softmax reduction)
_TP_GATES = {
    "out": "heads",                 # attn.out / shared.out / enc.out / dec.out
    "out_proj": "mamba_inner",      # mamba.out_proj
    "down_proj": "mamba_inner",     # mlstm.down_proj
    "down": "mlp",                  # mlp.down
    "mlp_down": "mlp",              # shared./enc./dec. mlp_down
    "ff_down": "mlp",               # slstm.ff_down
    "expert_up": "experts",         # MoE dispatch all-to-all
    "expert_down": "experts",       # MoE combine all-to-all
    "unembed": "vocab",             # softmax max+sum reduction
}


def _maps_to_model(rule) -> bool:
    if rule == "model":
        return True
    return isinstance(rule, tuple) and "model" in rule


#: op leaf name -> the profile rule that decides whether the op's compute
#: divides over the model axis (the Amdahl term of TP: work the profile
#: leaves unsharded is replicated across the model axis)
_COMPUTE_GATES = {
    # attention family
    "qkv": "heads", "self_qkv": "heads", "cross_q": "heads",
    "cross_kv": "heads", "core": "heads", "attn": "heads",
    "self_attn": "heads", "cross_attn": "heads", "out": "heads",
    # dense MLP family
    "up": "mlp", "down": "mlp", "mlp_up": "mlp", "mlp_down": "mlp",
    "ff_up": "mlp", "ff_down": "mlp",
    # MoE experts
    "expert_up": "experts", "expert_down": "experts",
    # recurrent inner dims (Mamba / xLSTM)
    "in_proj": "mamba_inner", "out_proj": "mamba_inner",
    "scan": "mamba_inner", "up_proj": "mamba_inner",
    "down_proj": "mamba_inner", "recurrence": "mamba_inner",
    "gates": "mamba_inner", "conv": "mamba_inner", "gate": "mamba_inner",
    # head
    "unembed": "vocab",
}


def _model_coverage(pred, base: str, rules: dict) -> float:
    """Fraction of the composed per-card cycles whose op the profile
    shards over ``model``: the divisible part of the Amdahl split across
    the tensor-parallel axis."""
    ops = pred.phase_ops(base)
    total = sum(o.cycles for o in ops)
    if total <= 0:
        return 0.0
    covered = sum(
        o.cycles for o in ops
        if _maps_to_model(rules.get(_COMPUTE_GATES.get(
            o.name.split(".")[-1], ""))))
    return covered / total


def _matmul_params(mops) -> float:
    """Total parameter count of the matmul ops (expert weights scaled up
    to all ``n_experts`` via the router's output dim)."""
    n_experts = 1.0
    for o in mops:
        if o.kind == "matmul" and o.name.split(".")[-1] == "router":
            n_experts = max(float(o.workload.n), 1.0)
    total = 0.0
    for o in mops:
        if o.kind != "matmul":
            continue
        w = o.workload
        scale = n_experts if o.name.split(".")[-1].startswith("expert") else 1.0
        total += float(w.n) * float(w.k) * o.count * scale
    return total


def _d_model(cfg, mops) -> float:
    d = getattr(cfg, "d_model", None)
    if d:
        return float(d)
    for o in mops:
        if o.kind == "matmul" and o.name.split(".")[-1] in ("out", "down"):
            return float(o.workload.n)
    return 0.0


def _walk(config, phase: str, batch: int, seq_len: int, context,
          elem_bytes: int):
    from .compose import _resolve_config, model_ops

    _, cfg = _resolve_config(config)
    base = "decode" if phase == "decode" else "prefill"
    ctx = context if context is not None else seq_len
    return cfg, base, model_ops(cfg, base, batch=batch, seq_len=seq_len,
                                context=ctx, elem_bytes=elem_bytes)


def plan_collectives(config, plan: MeshPlan, *, batch: int = 8,
                     seq_len: int = 2048, context: int | None = None,
                     phase: str = "train", dtype_bytes: int = 2,
                     elem_bytes: int = 4) -> PlanCollectives:
    """Analytic per-layer collective volumes of ``config`` under ``plan``,
    from the ``core/compose.py`` op walk at ``elem_bytes``-byte operands
    (the reference's 4 by default).

    ``phase``: ``"train"`` (forward and backward activation collectives,
    gradient sync), ``"prefill"`` or ``"decode"`` (forward only).
    Activation volumes are per data shard: the global token count splits
    over the ``("pod", "data")`` axes.
    """
    from ..dist.sharding import get_profile

    cfg, base, mops = _walk(config, phase, batch, seq_len, context,
                            elem_bytes)
    rules = get_profile(plan.profile, multi_pod=plan.multi_pod).rules
    train = phase == "train"
    act_mult = 2.0 if train else 1.0        # fwd + grad-of-activation
    dt = max(plan.data_total, 1)
    tp = plan.model

    link: list[CollectiveOp] = []
    net: list[CollectiveOp] = []
    floor: list[CollectiveOp] = []

    # -- tensor / expert / vocab parallelism (activation collectives) --
    if tp > 1:
        for o in mops:
            if o.kind != "matmul":
                continue
            gate = _TP_GATES.get(o.name.split(".")[-1])
            if gate is None or not _maps_to_model(rules.get(gate)):
                continue
            w = o.workload
            if gate == "experts":
                # dispatch moves the routed inputs, combine the outputs
                leaf = o.name.split(".")[-1]
                elems = (float(w.m) * float(w.k) if leaf == "expert_up"
                         else o.out_elems)
                nbytes = elems * o.elem_bytes * o.count / dt
                link.append(CollectiveOp("all-to-all", nbytes * act_mult, tp))
            elif gate == "vocab":
                # shard-wise softmax: per-token max + sum (f32 scalars)
                nbytes = 2.0 * float(w.m) * 4.0 * o.count / dt
                link.append(CollectiveOp("all-reduce", nbytes * act_mult, tp))
            else:
                nbytes = o.out_elems * o.elem_bytes * o.count / dt
                link.append(CollectiveOp("all-reduce", nbytes * act_mult, tp))

    # -- gradient sync and FSDP (weight collectives) -------------------
    fsdp = rules.get("embed") == "data"
    params = _matmul_params(mops)
    shard = 4.0 * params / (tp * plan.pipe)     # f32 grads, per model shard
    if train:
        if plan.data > 1:
            if fsdp:
                grads = (CollectiveOp("reduce-scatter", shard, plan.data),
                         CollectiveOp("all-gather", shard, plan.data))
            else:
                grads = (CollectiveOp("all-reduce", shard, plan.data),)
            link.extend(grads)
            floor.extend(grads)
        if plan.pods > 1:
            net.append(CollectiveOp(
                "all-reduce", shard / (plan.data if fsdp else 1), plan.pods))
    if fsdp and plan.data > 1:
        # every microbatch re-gathers the data-sharded weights
        w_bytes = (dtype_bytes * params / (tp * plan.pipe)
                   * max(plan.microbatches, 1))
        gather = CollectiveOp("all-gather", w_bytes, plan.data)
        link.append(gather)
        floor.append(gather)

    # -- pipeline boundary permutes ------------------------------------
    if plan.pipe > 1:
        tokens = float(batch) if base == "decode" else float(batch * seq_len)
        act_bytes = tokens * _d_model(cfg, mops) * 4.0 / dt
        link.append(CollectiveOp("collective-permute",
                                 act_bytes * act_mult, plan.pipe))

    return PlanCollectives(link=tuple(link), net=tuple(net),
                           floor=tuple(floor))


def plan_memory_bytes(config, plan: MeshPlan, *, phase: str = "train",
                      batch: int = 8, seq_len: int = 2048,
                      context: int | None = None, dtype_bytes: int = 2,
                      elem_bytes: int = 4) -> float:
    """Coarse per-card device-memory footprint of the model state under
    ``plan``: weights plus (training) optimizer state, divided over the
    axes the profile shards them on.  Activations and KV are not
    modelled."""
    from ..dist.sharding import get_profile

    _, _, mops = _walk(config, phase, batch, seq_len, context, elem_bytes)
    prof = get_profile(plan.profile, multi_pod=plan.multi_pod)
    params = _matmul_params(mops)
    per_param = dtype_bytes + (OPT_BYTES_PER_PARAM if phase == "train" else 0)
    denom = plan.model * plan.pipe
    if prof.rules.get("embed") == "data":        # FSDP: sharded over data too
        denom *= max(plan.data_total, 1)
    return params * per_param / denom


# ---------------------------------------------------------------------------
# Eq. 2 composition: per-card StepPrediction + link floor + bubble
# ---------------------------------------------------------------------------


def predict_plan(config, plan: MeshPlan,
                 machine: GPUMachineModel = H100_SXM, *,
                 batch: int = 8, seq_len: int = 2048,
                 context: int | None = None, phase: str = "train",
                 dtype_bytes: int = 2, elem_bytes: int = 4,
                 step_prediction=None, collectives=None) -> dict:
    """One plan's predicted step: the per-card composed
    ``StepPrediction`` (ideal ``1/n`` split, scaled by the pipeline
    bubble) plus the plan's link and network terms, composed under the
    machine's ``exposed_link_fraction`` by :class:`GPUStepECM`.

    ``step_prediction`` / ``collectives`` take precomputed values so a
    sweep over many plans composes the model once per config.
    """
    from ..dist.sharding import get_profile
    from .compose import predict_step

    base = "decode" if phase == "decode" else "prefill"
    mult = TRAIN_STEP_MULT if phase == "train" else 1.0
    pred = step_prediction
    if pred is None:
        pred = predict_step(config, machine, batch=batch, seq_len=seq_len,
                            context=context, phases=(base,),
                            elem_bytes=elem_bytes)

    t_single = pred.seconds(base) * mult
    n = plan.n_chips
    rules = get_profile(plan.profile, multi_pod=plan.multi_pod).rules
    # Amdahl over the model axis: only profile-sharded compute divides
    # by ``model``; the rest is replicated across it.
    cov = _model_coverage(pred, base, rules) if plan.model > 1 else 1.0
    eff = cov / plan.model + (1.0 - cov)
    t_chip = (t_single * eff / (plan.data_total * plan.pipe)
              * plan.pipeline_scale)

    colls = collectives
    if colls is None:
        colls = plan_collectives(config, plan, batch=batch, seq_len=seq_len,
                                 context=context, phase=phase,
                                 dtype_bytes=dtype_bytes,
                                 elem_bytes=elem_bytes)
    link_bw, net_bw = fabric_rates(machine)
    t_link = colls.link_wire_bytes_per_chip / link_bw
    t_net = colls.net_wire_bytes_per_chip / net_bw
    exposed = machine.exposed_link_fraction
    step = GPUStepECM(name=f"{plan.label}/{plan.profile}", t_comp=t_chip,
                      t_hbm=0.0, t_link=t_link, t_net=t_net,
                      exposed_link_fraction=exposed,
                      exposed_hbm_fraction=machine.exposed_hbm_fraction)

    # Eq. 2 over the links: only the data-invariant collectives floor out
    t_floor = colls.floor_bytes / link_bw
    n_sat = (None if t_floor <= 0 or exposed <= 0
             else max(1, math.ceil(t_single / (exposed * t_floor))))

    mem = plan_memory_bytes(config, plan, phase=phase, batch=batch,
                            seq_len=seq_len, context=context,
                            dtype_bytes=dtype_bytes, elem_bytes=elem_bytes)
    t_step = step.t_ecm
    return {
        "mesh": plan.label,
        "profile": plan.profile,
        "data": plan.data, "model": plan.model, "pipe": plan.pipe,
        "pods": plan.pods, "microbatches": plan.microbatches,
        "n_chips": n,
        "t_step_us": t_step * 1e6,
        "t_chip_us": t_chip * 1e6,
        "t_link_us": t_link * 1e6,
        "t_net_us": t_net * 1e6,
        "bubble_fraction": plan.bubble_fraction,
        "model_coverage": cov,
        "t_link_floor_us": t_floor * 1e6,
        "n_saturation": n_sat,
        "parallel_efficiency": (t_single / (t_step * n)) if t_step > 0 else 0.0,
        "hbm_bytes_per_chip": mem,
        "fits_hbm": bool(mem <= machine.memory_bytes),
    }


def _attention_block(config, machine, base: str, seq_len: int, context):
    """The tile the port's attention runs at for the phase's shape: the
    first pick of ``core/autotune.py`` ``rank`` among the route's
    compiled tilings, ``None`` where none takes the shape."""
    from .autotune import rank
    from .compose import _resolve_config

    _, cfg = _resolve_config(config)
    dh = getattr(cfg, "head_dim_", None) or getattr(cfg, "head_dim", None)
    if not dh:
        return None
    sq = 1 if base == "decode" else seq_len
    skv = (context or seq_len) if base == "decode" else seq_len
    try:
        ranked = rank((sq, skv, int(dh)), machine, objective="attention",
                      causal=base != "decode")
    except ValueError:
        return None
    return ranked[0]["block"]


def rank_meshes(config, n_chips: int, machine: GPUMachineModel = H100_SXM, *,
                batch: int = 8, seq_len: int = 2048,
                context: int | None = None, phase: str = "train",
                profiles=None, pipe_sizes=(1, 2, 4), microbatches: int = 8,
                max_model: int | None = None, pods: int = 1,
                include_blocks: bool = True, top: int | None = None,
                dtype_bytes: int = 2, elem_bytes: int = 4) -> list[dict]:
    """Rank every ``(mesh shape, sharding profile)`` candidate for one
    config and card count, each row carrying the attention ``block``.

    The composed step is built once per config and reused across plans.
    Plans that overflow the card's memory rank after fitting ones; ties
    break on the mesh label, then the profile.
    """
    from .compose import predict_step

    base = "decode" if phase == "decode" else "prefill"
    pred = predict_step(config, machine, batch=batch, seq_len=seq_len,
                        context=context, phases=(base,),
                        elem_bytes=elem_bytes)
    block = (_attention_block(config, machine, base, seq_len, context)
             if include_blocks else None)

    rows = []
    for plan in plan_candidates(n_chips, profiles=profiles,
                                pipe_sizes=pipe_sizes,
                                microbatches=microbatches,
                                max_model=max_model, pods=pods):
        colls = plan_collectives(config, plan, batch=batch, seq_len=seq_len,
                                 context=context, phase=phase,
                                 dtype_bytes=dtype_bytes,
                                 elem_bytes=elem_bytes)
        row = predict_plan(config, plan, machine, batch=batch,
                           seq_len=seq_len, context=context, phase=phase,
                           dtype_bytes=dtype_bytes, elem_bytes=elem_bytes,
                           step_prediction=pred, collectives=colls)
        row["block"] = block
        rows.append(row)
    rows.sort(key=lambda r: (not r["fits_hbm"], r["t_step_us"],
                             r["mesh"], r["profile"]))
    return rows[:top] if top else rows


# ---------------------------------------------------------------------------
# Traced-resources path (recorded collectives) + the data-parallel case
# ---------------------------------------------------------------------------


def plan_scaling(resources, plans, *, machine: GPUMachineModel = H100_SXM,
                 dtype_peak: float | None = None,
                 exposed_link_fraction: float | None = None) -> dict:
    """Eq. 2 over explicit :class:`MeshPlan`\\ s, driven by a traced
    program's resources (``core/hlo.py``).

    Compute and HBM divide over ``plan.n_chips`` (scaled by the pipeline
    bubble); the program's collectives are grouped over each plan's data
    axis (their ring wire bytes approach the Eq. 2 floor); saturation is
    ``n_S = ceil(T_single / T_link_floor)``.
    """
    peak = dtype_peak or machine.peak_bf16_tensor_flops
    exposed = (machine.exposed_link_fraction if exposed_link_fraction is None
               else exposed_link_fraction)
    colls = list(getattr(resources, "collectives", ()))
    link_bw, _ = fabric_rates(machine)

    def t_link(n: int) -> float:
        return sum(replace(c, group_size=n).wire_bytes_per_chip
                   for c in colls) / link_bw

    # the floor: ring fraction (n-1)/n -> 1
    floor_bytes = sum((2.0 if c.kind == "all-reduce" else 1.0) * c.out_bytes
                      for c in colls)
    t_floor = floor_bytes / link_bw

    plans = list(plans)
    mesh, chips, t_comp, t_hbm, t_coll, t_step, bubble = \
        [], [], [], [], [], [], []
    for p in plans:
        n = p.n_chips
        scale = p.pipeline_scale
        step = GPUStepECM(
            t_comp=resources.flops / (n * peak) * scale,
            t_hbm=(resources.bytes_accessed / (n * machine.hbm_bytes_per_s)
                   * scale),
            t_link=t_link(p.data), t_net=0.0,
            exposed_link_fraction=exposed, name=p.label)
        mesh.append(p.label)
        chips.append(int(n))
        bubble.append(p.bubble_fraction)
        t_comp.append(step.t_comp)
        t_hbm.append(step.t_hbm)
        t_coll.append(step.t_link)
        t_step.append(step.t_ecm)
    t1 = t_step[0] * chips[0]          # single-card step time equivalent
    # no collectives, or a fully hidden link term: nothing saturates
    n_sat = (None if t_floor <= 0 or exposed <= 0
             else max(1, math.ceil(t1 / (exposed * t_floor))))
    return {
        "mesh": mesh,
        "chips": chips,
        "t_comp_us": [t * 1e6 for t in t_comp],
        "t_hbm_us": [t * 1e6 for t in t_hbm],
        "t_link_us": [t * 1e6 for t in t_coll],
        "t_step_us": [t * 1e6 for t in t_step],
        "speedup": [t_step[0] / t for t in t_step],
        "parallel_efficiency": [t_step[0] / (t * n) * chips[0]
                                for n, t in zip(chips, t_step)],
        "bubble_fraction": bubble,
        "t_link_floor_us": t_floor * 1e6,
        "n_saturation": n_sat,
    }


_DP_KEYS = ("chips", "t_comp_us", "t_hbm_us", "t_link_us", "t_step_us",
            "speedup", "parallel_efficiency", "t_link_floor_us",
            "n_saturation")


def dp_scaling(resources, chip_counts=(1, 2, 4, 8, 16, 32, 64, 128, 256), *,
               machine: GPUMachineModel = H100_SXM,
               dtype_peak: float | None = None,
               exposed_link_fraction: float | None = None) -> dict:
    """The pure data-parallel case of :func:`plan_scaling`, with the
    reference's ``tpu_dp_scaling`` return shape (its ``t_ici`` keys as
    ``t_link``)."""
    full = plan_scaling(resources,
                        [MeshPlan(data=int(n)) for n in chip_counts],
                        machine=machine, dtype_peak=dtype_peak,
                        exposed_link_fraction=exposed_link_fraction)
    return {k: full[k] for k in _DP_KEYS}
