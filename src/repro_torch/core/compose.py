"""Whole-model ECM composition on the card: step-time prediction for a
model config (the reference's ``repro/core/compose.py``).

The paper's Eq. 1 predicts one kernel; a model step is a *sequence* of
kernels.  This module walks a model's ops (a ``LayerSpec`` adapter over
the ``repro_torch.configs`` architecture definitions, the reference's walk
line for line), binds every op to a workload —

* projections / MLP / MoE experts  -> :class:`~.workload.MatmulWorkload`
* prefill / decode attention       -> :class:`~.workload.AttentionWorkload`
* norms / residuals / lookups      -> :class:`~.workload.StreamWorkload`
  (the Table I specs ``update``, ``striad`` and ``copy`` at f32 width)

— prices each on a :class:`~.machine.GPUMachineModel` and composes the
per-op results into a :class:`StepPrediction`.

**Pricing** (:func:`compose_ops`), one instance of each op (one product;
one batch element x head of attention; one 128-lane f32 row of a stream
op), in seconds:

* matmul: ``core/gpu_ecm.py`` ``gpu_matmul_ecm`` at the first pick of
  ``core/autotune.py`` ``rank(objective="matmul")`` for its dims and
  operand size: the tile the port's own kernel launches when given no
  block, which stands in for the tile cuBLAS runs the served models'
  products at (the port's kernel is no model's).  A product that no
  compiled tiling divides (a decode GEMV of a few rows) is priced at the
  best of the route's tilings clamped to its dims, ranked the same way;
* attention: ``gpu_attention_ecm`` with ``batch_heads=1`` at the first
  pick of ``rank(objective="attention")``; heads multiply the work and
  the traffic of one head, so the op's count (batch x heads x layers)
  scales it.  A head dim with no compiled tiling is priced at the
  reference's blocks, ``min(512, s)``;
* stream ops: ``gpu_stream_ecm`` per 128-lane f32 row, on the machine's
  sustained rate for the op (the calibrated one where measured).

The walk's workloads carry the reference's blocks (matmul 256 x 256,
attention ``min(512, s)``), so the walk and its FLOP counts
(:attr:`OpSpec.flops`) are the reference's; the prediction's records
(:class:`OpPrediction`) carry the card's pick and count their FLOPs
there.  An op that names its blocks (the serving engine's buckets) is
priced at them.

**Units and cycles.**  An op's unit is one output row of its instance
(a row of ``C``; a query row of one head) or one 128-lane row of a stream
op; ``units`` counts them (``out_tokens`` overrides the attention rows
where the workload is evaluated at a bucketed ``sq``).  Cycles are the
reference's unit at the card's ``clock_hz``, the product taken in the
serving engine's order (``serve/engine.py`` ``BucketModel``)::

    cycles = t / rows * (clock_hz * count) * units

**The overlap rule.**  :func:`overlap_alpha` is 1.0 on the card: the
port's kernels run back to back on one stream, so per-op times add (the
reference's write-allocate branch, not its TPU ``exposed_hbm_fraction``).
Per op, ``t_ol_cy`` is ``T_comp`` and ``t_rest_cy`` is ``T_hbm``
(``T_nOL = 0``), and ``cycles`` their Eq. 1 at the machine's
``exposed_hbm_fraction`` (``StepECM.t_ecm``; at its 0.0, ``max(T_comp,
T_hbm)``).  So the pipelined form ``max(sum T_comp, sum T_hbm)`` is the
roofline of the summed terms, the form :func:`model_lowered` and
``core/scaling.py`` ``scale_model`` read.

**Operand width.**  The reference prices every product at f32.
:func:`model_ops` and :func:`predict_step` take the operand element size
(``elem_bytes``, the reference's 4 by default); at 2 (bf16) the matmuls
run on the tensor cores and attention stays on FFMA, as
``gpu_matmul_ecm`` and the tile route do.  Stream ops stay at f32 width,
as in the reference.

Everything here is first-order by design (the GQA KV stream is counted
per query head; chunked SSM scans are modeled as their per-token state
contractions), as in the reference.  ``core/scaling.py`` ``scale_model``
and the serving engine's composition-backed ``BucketModel`` consume these
records.  The reference's ``core/engine.py`` lowering table has no
counterpart: the port prices ops through closed forms, and rankings are
memoized per dims and machine (:func:`pick_block`).
"""
from __future__ import annotations

from dataclasses import dataclass, replace

import numpy as np

from .autotune import rank
from .ecm import ECMBatch
from .gpu_ecm import (LANES, gpu_attention_ecm, gpu_matmul_ecm,
                      gpu_stream_ecm, one_sm_ecm, stream_count)
from .kernel_spec import BENCHMARKS
from .machine import H100_SXM, GPUMachineModel
from .workload import AttentionWorkload, MatmulWorkload, StreamWorkload

PHASES = ("prefill", "decode")

#: Table I stream specs reused at activation (f32) width (the reference's)
_NORM_SPEC = replace(BENCHMARKS["update"], elem_bytes=4)      # x = f(x)
_RESID_SPEC = replace(BENCHMARKS["striad"], elem_bytes=4)     # y = x + a*r
_GATHER_SPEC = replace(BENCHMARKS["copy"], elem_bytes=4)      # table lookup

#: composed-vs-three-term-model agreement band on the dry-run path (ratio
#: composed/simulated step time), the reference's; the card's composed
#: step is held against measured device time with it
DRYRUN_TOLERANCE = (0.2, 5.0)

#: the reference's default blocks, which the walk's workloads carry
_REF_MATMUL_BLOCK = 256
_REF_ATTENTION_BLOCK = 512


def overlap_alpha(machine: GPUMachineModel) -> float:
    """Cross-op serialization coefficient of the card's overlap rule: 1.0,
    the port's kernels run back to back on one stream (per-op times add)."""
    return 1.0


def compose_cycles(t_ol, t_rest, serial, alpha: float) -> float:
    """The Eq. 1 overlap rule across ops.

    ``serial`` sums per-op ``max(T_nOL + T_data, T_OL)``; ``pipelined``
    applies Eq. 1 once to the summed terms.  ``alpha`` blends the two
    (see :func:`overlap_alpha`).
    """
    t_ol = np.asarray(t_ol, float)
    t_rest = np.asarray(t_rest, float)
    serial = np.asarray(serial, float)
    pipelined = max(float(t_ol.sum()), float(t_rest.sum()))
    return alpha * float(serial.sum()) + (1.0 - alpha) * pipelined


# ---------------------------------------------------------------------------
# Op records
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class OpSpec:
    """One model op bound to a workload.

    ``out_elems`` / ``elem_bytes`` describe the op's output per instance;
    ``count`` is the number of identical instances per step (layers x
    heads x batch folded in).  ``block`` is the tiling to price at; ``None``
    prices at the card's pick (:func:`pick_block`).
    """

    name: str                      # e.g. "attn.qkv"
    layer: str                     # breakdown group ("block", "head", ...)
    phase: str                     # prefill | decode
    kind: str                      # matmul | attention | stream
    workload: object
    out_elems: float               # output elements per instance
    elem_bytes: int
    count: float = 1.0
    block: tuple | None = None

    @property
    def row_elems(self) -> int:
        """Elements of one unit of output: a row of ``C`` (``n``), a query
        row of one head (``d``), a 128-lane row of a stream op."""
        if self.kind == "stream":
            return LANES
        return self.workload.n if self.kind == "matmul" else self.workload.d

    def units(self) -> float:
        """Units of work (output rows) per instance."""
        return self.out_elems / self.row_elems

    @property
    def flops(self) -> float:
        """Useful FLOPs across all instances (the reference's accounting)."""
        per_elem = self.workload.work_per_elem()[0]
        return float(per_elem) * self.out_elems * self.count


@dataclass(frozen=True)
class OpPrediction:
    """One composed op: its priced terms scaled to step totals."""

    name: str
    layer: str
    phase: str
    kind: str
    count: float
    units: float                   # output rows per instance
    cy_per_unit: float             # serial cycles a unit (the whole card)
    t_ol_cy: float                 # step-total T_comp cycles
    t_rest_cy: float               # step-total T_hbm cycles
    cycles: float                  # step-total serial Eq. 1 cycles
    flops: float                   # at the priced blocks
    hbm_bytes: float               # step-total device-memory traffic
    block: tuple | None = None     # the tiling priced (None: a stream op)

    def as_dict(self) -> dict:
        return {
            "op": self.name, "layer": self.layer, "phase": self.phase,
            "kind": self.kind, "count": self.count,
            "cy_per_unit": self.cy_per_unit, "cycles": self.cycles,
            "flops": self.flops, "hbm_bytes": self.hbm_bytes,
            "block": list(self.block) if self.block else None,
        }


@dataclass(frozen=True)
class StepPrediction:
    """A whole-model step prediction, decomposable per op / layer / phase.

    ``ops`` carry both phases; the per-phase totals re-apply the
    machine's overlap rule (``alpha``), so *the breakdown always sums to
    the total under that rule* — the invariant the tests pin.
    """

    name: str
    machine: str
    clock_hz: float
    alpha: float
    ops: tuple

    # -- composition --------------------------------------------------
    def phase_ops(self, phase: str | None = None) -> tuple:
        if phase is None:
            return self.ops
        return tuple(o for o in self.ops if o.phase == phase)

    def cycles(self, phase: str | None = None) -> float:
        ops = self.phase_ops(phase)
        if not ops:
            return 0.0
        return compose_cycles([o.t_ol_cy for o in ops],
                              [o.t_rest_cy for o in ops],
                              [o.cycles for o in ops], self.alpha)

    def seconds(self, phase: str | None = None) -> float:
        return self.cycles(phase) / self.clock_hz

    @property
    def prefill_s(self) -> float:
        return self.seconds("prefill")

    @property
    def decode_s(self) -> float:
        return self.seconds("decode")

    # -- breakdowns ---------------------------------------------------
    def per_op(self, phase: str | None = None) -> list[dict]:
        return [o.as_dict() for o in sorted(self.phase_ops(phase),
                                            key=lambda o: -o.cycles)]

    def per_layer(self, phase: str | None = None) -> dict[str, float]:
        out: dict[str, float] = {}
        for o in self.phase_ops(phase):
            out[o.layer] = out.get(o.layer, 0.0) + o.cycles
        return out

    def per_kind(self, phase: str | None = None) -> dict[str, float]:
        """Serial cycles by op kind (matmul, attention, stream)."""
        out: dict[str, float] = {}
        for o in self.phase_ops(phase):
            out[o.kind] = out.get(o.kind, 0.0) + o.cycles
        return out

    def flops(self, phase: str | None = None) -> float:
        return sum(o.flops for o in self.phase_ops(phase))

    def hbm_bytes(self, phase: str | None = None) -> float:
        return sum(o.hbm_bytes for o in self.phase_ops(phase))

    def dominant_op(self, phase: str | None = None) -> str:
        ops = self.phase_ops(phase)
        return max(ops, key=lambda o: o.cycles).name if ops else ""

    def summary(self) -> dict:
        out = {"name": self.name, "machine": self.machine,
               "alpha": self.alpha, "n_ops": len(self.ops)}
        for ph in PHASES:
            if not self.phase_ops(ph):
                continue
            out[ph] = {
                "cycles": self.cycles(ph),
                "seconds": self.seconds(ph),
                "flops": self.flops(ph),
                "hbm_bytes": self.hbm_bytes(ph),
                "dominant_op": self.dominant_op(ph),
            }
        return out


# ---------------------------------------------------------------------------
# Op constructors
# ---------------------------------------------------------------------------


def matmul_op(name: str, layer: str, phase: str, *, m: int, n: int, k: int,
              count: float = 1.0, elem_bytes: int = 4,
              block: tuple | None = None) -> OpSpec:
    w = MatmulWorkload(m=max(int(m), 1), n=max(int(n), 1), k=max(int(k), 1),
                       bm=_REF_MATMUL_BLOCK, bn=_REF_MATMUL_BLOCK,
                       elem_bytes=elem_bytes)
    return OpSpec(name=name, layer=layer, phase=phase, kind="matmul",
                  workload=w, out_elems=float(m) * float(n),
                  elem_bytes=elem_bytes, count=float(count), block=block)


def attention_op(name: str, layer: str, phase: str, *, sq: int, skv: int,
                 d: int, count: float, causal: bool,
                 bq: int | None = None, bkv: int | None = None,
                 out_tokens: int | None = None,
                 elem_bytes: int = 4) -> OpSpec:
    """One attention instance per (batch element x head); ``out_tokens``
    overrides the output row count when the workload is evaluated at a
    bucketed ``sq`` (the serving path).  ``bq`` and ``bkv`` given price
    the op at them; left out, at the card's pick."""
    block = None if bq is None and bkv is None else (
        int(bq or _REF_ATTENTION_BLOCK), int(bkv or _REF_ATTENTION_BLOCK))
    w = AttentionWorkload(sq=int(sq), skv=int(skv), d=int(d),
                          bq=min(_REF_ATTENTION_BLOCK, int(sq)),
                          bkv=min(_REF_ATTENTION_BLOCK, int(skv)),
                          causal=causal, elem_bytes=elem_bytes)
    rows = sq if out_tokens is None else out_tokens
    return OpSpec(name=name, layer=layer, phase=phase, kind="attention",
                  workload=w, out_elems=float(rows) * float(d),
                  elem_bytes=elem_bytes, count=float(count), block=block)


def stream_op(name: str, layer: str, phase: str, *, elems: float,
              count: float = 1.0, spec=_NORM_SPEC) -> OpSpec:
    return OpSpec(name=name, layer=layer, phase=phase, kind="stream",
                  workload=StreamWorkload(spec), out_elems=float(elems),
                  elem_bytes=spec.elem_bytes, count=float(count))


# ---------------------------------------------------------------------------
# LayerSpec adapters: config dataclass -> op walk (the reference's)
# ---------------------------------------------------------------------------


def _attn_dims(phase: str, seq_len: int, context: int) -> tuple[int, int, bool]:
    """(sq, skv, causal) for decoder self-attention in this phase."""
    if phase == "decode":
        return 1, context, False
    return seq_len, seq_len, True


def _lm_ops(cfg, phase: str, *, batch: int, seq_len: int, context: int,
            eb: int) -> list[OpSpec]:
    """Dense / GQA / MoE / VLM decoder stack (``LMConfig``-shaped)."""
    d, nh, dh = cfg.d_model, cfg.n_heads, cfg.head_dim_
    kvh = cfg.n_kv_heads
    n_layers = cfg.n_layers
    tokens = batch if phase == "decode" else batch * seq_len
    sq, skv, causal = _attn_dims(phase, seq_len, context)
    ops = [
        stream_op("embed.lookup", "embed", phase, elems=tokens * d,
                  spec=_GATHER_SPEC),
        stream_op("block.norm", "block", phase, elems=tokens * d,
                  count=2 * n_layers),
        stream_op("block.residual", "block", phase, elems=tokens * d,
                  count=2 * n_layers, spec=_RESID_SPEC),
        matmul_op("attn.qkv", "block", phase, m=tokens,
                  n=(nh + 2 * kvh) * dh, k=d, count=n_layers, elem_bytes=eb),
        attention_op("attn.core", "block", phase, sq=sq, skv=skv, d=dh,
                     count=batch * nh * n_layers, causal=causal,
                     elem_bytes=eb),
        matmul_op("attn.out", "block", phase, m=tokens, n=d, k=nh * dh,
                  count=n_layers, elem_bytes=eb),
    ]
    moe = getattr(cfg, "moe", None)
    if moe is not None:
        ops += [
            matmul_op("moe.router", "block", phase, m=tokens,
                      n=moe.n_experts, k=d, count=n_layers, elem_bytes=eb),
            matmul_op("moe.expert_up", "block", phase,
                      m=tokens * moe.top_k, n=2 * moe.d_ff, k=d,
                      count=n_layers, elem_bytes=eb),
            matmul_op("moe.expert_down", "block", phase,
                      m=tokens * moe.top_k, n=d, k=moe.d_ff,
                      count=n_layers, elem_bytes=eb),
        ]
    else:
        ops += [
            matmul_op("mlp.up", "block", phase, m=tokens, n=2 * cfg.d_ff,
                      k=d, count=n_layers, elem_bytes=eb),
            matmul_op("mlp.down", "block", phase, m=tokens, n=d,
                      k=cfg.d_ff, count=n_layers, elem_bytes=eb),
        ]
    ops += [
        stream_op("head.norm", "head", phase, elems=tokens * d),
        matmul_op("head.unembed", "head", phase, m=tokens,
                  n=cfg.vocab_padded, k=d, elem_bytes=eb),
    ]
    return ops


def _zamba2_ops(cfg, phase: str, *, batch: int, seq_len: int, context: int,
                eb: int) -> list[OpSpec]:
    """Mamba2 backbone + shared attention blocks (Zamba2)."""
    d = cfg.d_model
    mc = cfg.mamba_cfg
    di, ds = mc.d_inner, mc.d_state
    n_layers, n_shared = cfg.n_layers, cfg.n_shared
    nh, kvh, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    tokens = batch if phase == "decode" else batch * seq_len
    sq, skv, causal = _attn_dims(phase, seq_len, context)
    proj_out = 2 * di + 2 * mc.n_groups * ds + mc.n_heads
    return [
        stream_op("embed.lookup", "embed", phase, elems=tokens * d,
                  spec=_GATHER_SPEC),
        stream_op("mamba.norm", "mamba", phase, elems=tokens * d,
                  count=n_layers),
        stream_op("mamba.residual", "mamba", phase, elems=tokens * d,
                  count=n_layers, spec=_RESID_SPEC),
        matmul_op("mamba.in_proj", "mamba", phase, m=tokens, n=proj_out,
                  k=d, count=n_layers, elem_bytes=eb),
        stream_op("mamba.conv", "mamba", phase, elems=tokens * mc.conv_dim,
                  count=n_layers),
        # chunked SSM scan as its per-token state contractions (B·x in,
        # C·h out): two d_state-deep GEMVs per channel per token
        matmul_op("mamba.scan", "mamba", phase, m=tokens, n=di, k=ds,
                  count=2 * n_layers, elem_bytes=eb),
        stream_op("mamba.gate", "mamba", phase, elems=tokens * di,
                  count=n_layers),
        matmul_op("mamba.out_proj", "mamba", phase, m=tokens, n=d, k=di,
                  count=n_layers, elem_bytes=eb),
        # shared transformer block (input: concat of stream + skip -> 2d)
        stream_op("shared.norm", "shared", phase, elems=tokens * 2 * d,
                  count=2 * n_shared),
        stream_op("shared.residual", "shared", phase, elems=tokens * d,
                  count=2 * n_shared, spec=_RESID_SPEC),
        matmul_op("shared.qkv", "shared", phase, m=tokens,
                  n=(nh + 2 * kvh) * dh, k=2 * d, count=n_shared,
                  elem_bytes=eb),
        attention_op("shared.attn", "shared", phase, sq=sq, skv=skv, d=dh,
                     count=batch * nh * n_shared, causal=causal,
                     elem_bytes=eb),
        matmul_op("shared.out", "shared", phase, m=tokens, n=d, k=nh * dh,
                  count=n_shared, elem_bytes=eb),
        matmul_op("shared.mlp_up", "shared", phase, m=tokens, n=2 * cfg.d_ff,
                  k=d, count=n_shared, elem_bytes=eb),
        matmul_op("shared.mlp_down", "shared", phase, m=tokens, n=d,
                  k=cfg.d_ff, count=n_shared, elem_bytes=eb),
        stream_op("head.norm", "head", phase, elems=tokens * d),
        matmul_op("head.unembed", "head", phase, m=tokens,
                  n=cfg.vocab_padded, k=d, elem_bytes=eb),
    ]


def _xlstm_ops(cfg, phase: str, *, batch: int, seq_len: int, context: int,
               eb: int) -> list[OpSpec]:
    """mLSTM / sLSTM block stack (xLSTM)."""
    d = cfg.d_model
    bc = cfg.block_cfg
    di, dh = bc.d_inner, bc.head_dim
    n_s = sum(1 for i in cfg.slstm_at if i < cfg.n_layers)
    n_m = cfg.n_layers - n_s
    tokens = batch if phase == "decode" else batch * seq_len
    ops = [
        stream_op("embed.lookup", "embed", phase, elems=tokens * d,
                  spec=_GATHER_SPEC),
        stream_op("block.norm", "block", phase, elems=tokens * d,
                  count=2 * cfg.n_layers),
        stream_op("block.residual", "block", phase, elems=tokens * d,
                  count=2 * cfg.n_layers, spec=_RESID_SPEC),
    ]
    if n_m:
        ops += [
            matmul_op("mlstm.up_proj", "mlstm", phase, m=tokens, n=2 * di,
                      k=d, count=n_m, elem_bytes=eb),
            matmul_op("mlstm.qkv", "mlstm", phase, m=tokens, n=3 * di, k=d,
                      count=n_m, elem_bytes=eb),
            # matrix-memory update/readout: head_dim-deep contraction per
            # channel per token (C += v k^T; h = C q)
            matmul_op("mlstm.recurrence", "mlstm", phase, m=tokens, n=di,
                      k=dh, count=2 * n_m, elem_bytes=eb),
            matmul_op("mlstm.down_proj", "mlstm", phase, m=tokens, n=d,
                      k=di, count=n_m, elem_bytes=eb),
        ]
    if n_s:
        ops += [
            matmul_op("slstm.gates", "slstm", phase, m=tokens, n=4 * d, k=d,
                      count=n_s, elem_bytes=eb),
            stream_op("slstm.recurrence", "slstm", phase, elems=tokens * d,
                      count=n_s),
            matmul_op("slstm.ff_up", "slstm", phase, m=tokens,
                      n=2 * bc.d_ff_s, k=d, count=n_s, elem_bytes=eb),
            matmul_op("slstm.ff_down", "slstm", phase, m=tokens, n=d,
                      k=bc.d_ff_s, count=n_s, elem_bytes=eb),
        ]
    ops += [
        stream_op("head.norm", "head", phase, elems=tokens * d),
        matmul_op("head.unembed", "head", phase, m=tokens,
                  n=cfg.vocab_padded, k=d, elem_bytes=eb),
    ]
    return ops


def _whisper_ops(cfg, phase: str, *, batch: int, seq_len: int, context: int,
                 eb: int) -> list[OpSpec]:
    """Whisper encoder-decoder: the encoder runs in prefill only; decode
    replays cached cross-attention KV over the encoded frames."""
    d, nh, dh = cfg.d_model, cfg.n_heads, cfg.head_dim_
    n_layers = cfg.n_layers
    tokens = batch if phase == "decode" else batch * seq_len
    enc_tokens = batch * seq_len
    sq, skv, causal = _attn_dims(phase, seq_len, context)
    ops: list[OpSpec] = []
    if phase == "prefill":
        ops += [
            matmul_op("enc.qkv", "encoder", phase, m=enc_tokens, n=3 * d,
                      k=d, count=n_layers, elem_bytes=eb),
            attention_op("enc.attn", "encoder", phase, sq=seq_len,
                         skv=seq_len, d=dh, count=batch * nh * n_layers,
                         causal=False, elem_bytes=eb),
            matmul_op("enc.out", "encoder", phase, m=enc_tokens, n=d,
                      k=d, count=n_layers, elem_bytes=eb),
            matmul_op("enc.mlp_up", "encoder", phase, m=enc_tokens,
                      n=cfg.d_ff, k=d, count=n_layers, elem_bytes=eb),
            matmul_op("enc.mlp_down", "encoder", phase, m=enc_tokens, n=d,
                      k=cfg.d_ff, count=n_layers, elem_bytes=eb),
            stream_op("enc.norm", "encoder", phase, elems=enc_tokens * d,
                      count=2 * n_layers),
            # cross-attention KV of the encoded frames, computed once
            matmul_op("dec.cross_kv", "decoder", phase, m=enc_tokens,
                      n=2 * d, k=d, count=n_layers, elem_bytes=eb),
        ]
    ops += [
        stream_op("dec.norm", "decoder", phase, elems=tokens * d,
                  count=3 * n_layers),
        stream_op("dec.residual", "decoder", phase, elems=tokens * d,
                  count=3 * n_layers, spec=_RESID_SPEC),
        matmul_op("dec.self_qkv", "decoder", phase, m=tokens, n=3 * d,
                  k=d, count=n_layers, elem_bytes=eb),
        attention_op("dec.self_attn", "decoder", phase, sq=sq, skv=skv,
                     d=dh, count=batch * nh * n_layers, causal=causal,
                     elem_bytes=eb),
        matmul_op("dec.cross_q", "decoder", phase, m=tokens, n=d, k=d,
                  count=n_layers, elem_bytes=eb),
        attention_op("dec.cross_attn", "decoder", phase,
                     sq=1 if phase == "decode" else seq_len,
                     skv=context, d=dh, count=batch * nh * n_layers,
                     causal=False, elem_bytes=eb),
        matmul_op("dec.out", "decoder", phase, m=tokens, n=d, k=d,
                  count=2 * n_layers, elem_bytes=eb),
        matmul_op("dec.mlp_up", "decoder", phase, m=tokens, n=cfg.d_ff,
                  k=d, count=n_layers, elem_bytes=eb),
        matmul_op("dec.mlp_down", "decoder", phase, m=tokens, n=d,
                  k=cfg.d_ff, count=n_layers, elem_bytes=eb),
        stream_op("head.norm", "head", phase, elems=tokens * d),
        matmul_op("head.unembed", "head", phase, m=tokens,
                  n=cfg.vocab_padded, k=d, elem_bytes=eb),
    ]
    return ops


def model_ops(cfg, phase: str, *, batch: int = 1, seq_len: int = 4096,
              context: int | None = None, elem_bytes: int = 4
              ) -> list[OpSpec]:
    """The ``LayerSpec`` adapter: walk one phase of a model config into
    bound op records, products and attention at ``elem_bytes``-byte
    operands.  Dispatch is structural (field signatures), so any config
    dataclass with the right fields composes — not just the shipped zoo."""
    if phase not in PHASES:
        raise ValueError(f"unknown phase {phase!r}; expected one of {PHASES}")
    context = context or seq_len
    kw = dict(batch=batch, seq_len=seq_len, context=context, eb=elem_bytes)
    if hasattr(cfg, "shared_every"):            # Zamba2 hybrid
        ops = _zamba2_ops(cfg, phase, **kw)
    elif hasattr(cfg, "slstm_at"):              # xLSTM
        ops = _xlstm_ops(cfg, phase, **kw)
    elif hasattr(cfg, "max_frames"):            # Whisper enc-dec
        ops = _whisper_ops(cfg, phase, **kw)
    elif hasattr(cfg, "n_kv_heads"):            # dense / GQA / MoE / VLM LM
        ops = _lm_ops(cfg, phase, **kw)
    else:
        raise TypeError(
            f"no LayerSpec adapter for config type {type(cfg).__name__}: "
            f"expected LM / Zamba2 / xLSTM / Whisper field signature")
    return [o for o in ops if o.count > 0 and o.out_elems > 0]


# ---------------------------------------------------------------------------
# Pricing on the card
# ---------------------------------------------------------------------------

#: the card's pick per (kind, dims, causal, operand size, the machine's
#: fields the ranking reads)
_PICKS: dict[tuple, tuple] = {}


def _rank_fields(machine: GPUMachineModel) -> tuple:
    """The fields of ``machine`` that ``rank`` and the compute models read
    (a machine's fingerprint hashes every field, and its ``measured_bw``
    dict makes it unhashable)."""
    return (machine.l2_bytes, machine.smem_per_block_optin,
            machine.hbm_bytes_per_s, machine.peak_f32_flops,
            machine.peak_bf16_tensor_flops, machine.exposed_hbm_fraction)


def _clamped_matmul_block(m: int, n: int, k: int, machine,
                          elem_bytes: int) -> tuple:
    """The best tiling of the operands' route clamped to ``(m, n)``, for a
    product no compiled tiling divides; ranked as ``rank`` ranks."""
    import torch

    from ..kernels.matmul import kernel as K

    dtype = {4: torch.float32, 2: torch.bfloat16}[elem_bytes]
    cands = [t for t in K.TILINGS[K.route_of(dtype)]
             if K.smem_bytes(*t, dtype) <= machine.smem_per_block_optin]
    if not cands:
        raise ValueError(f"no compiled matmul tiling fits {machine.name}")

    def key(t):
        bm, bn = min(t[0], m), min(t[1], n)
        w = MatmulWorkload(m, n, k, bm, bn, elem_bytes)
        return gpu_matmul_ecm(w, machine).t_ecm, -bm * bn
    return min(cands, key=key)


def pick_block(kind: str, dims: tuple, machine: GPUMachineModel, *,
               causal: bool = True, elem_bytes: int = 4) -> tuple:
    """The tiling an op is priced at: the first pick of ``rank`` for its
    ``dims`` (matmul ``(m, n, k)``, attention ``(sq, skv, d)``) and operand
    size on ``machine``, memoized; the fallbacks of the module's docstring
    where no compiled tiling takes the dims."""
    dims = tuple(int(x) for x in dims)
    key = (kind, dims, bool(causal), int(elem_bytes), _rank_fields(machine))
    block = _PICKS.get(key)
    if block is None:
        try:
            block = tuple(rank(dims, machine, objective=kind, causal=causal,
                               elem_bytes=elem_bytes)[0]["block"])
        except ValueError:
            if kind == "matmul":
                block = _clamped_matmul_block(*dims, machine, elem_bytes)
            else:
                block = (min(_REF_ATTENTION_BLOCK, dims[0]),
                         min(_REF_ATTENTION_BLOCK, dims[1]))
        _PICKS[key] = block
    return block


@dataclass(frozen=True)
class _Priced:
    """One instance of an op priced on the card, seconds."""

    workload: object
    block: tuple | None
    rows: float                    # units the instance's times cover
    t_comp: float
    t_hbm: float
    t: float                       # Eq. 1 of the two
    hbm_bytes: float


def _price(op: OpSpec, machine: GPUMachineModel) -> _Priced:
    w = op.workload
    if op.kind == "stream":
        ecm = gpu_stream_ecm(w.name, machine)
        c = machine.clock_hz
        return _Priced(w, None, 1.0, ecm.t_ol / c, ecm.transfers[0] / c,
                       ecm.prediction(-1) / c,
                       float(stream_count(w.name) * LANES * 4))
    if op.kind == "matmul":
        block = op.block or pick_block("matmul", (w.m, w.n, w.k), machine,
                                       elem_bytes=w.elem_bytes)
        w = replace(w, bm=min(block[0], w.m), bn=min(block[1], w.n))
        step = gpu_matmul_ecm(w, machine)
        rows = w.m
    elif op.kind == "attention":
        block = op.block or pick_block("attention", (w.sq, w.skv, w.d),
                                       machine, causal=w.causal,
                                       elem_bytes=w.elem_bytes)
        w = AttentionWorkload(w.sq, w.skv, w.d, min(block[0], w.sq),
                              min(block[1], w.skv), w.causal, w.elem_bytes)
        step = gpu_attention_ecm(w, machine, batch_heads=1)
        rows = w.sq
    else:
        raise ValueError(f"unknown op kind {op.kind!r}")
    return _Priced(w, tuple(block), float(rows), step.t_comp, step.t_hbm,
                   step.t_ecm, float(sum(w.traffic(machine.l2_bytes))))


def compose_ops(ops, machine: GPUMachineModel = H100_SXM, *,
                name: str = "model") -> StepPrediction:
    """Price the bound ops on ``machine`` and compose a
    :class:`StepPrediction`.

    A one-op composition is its workload: ``cy_per_unit`` is the direct
    ``gpu_*_ecm`` prediction a unit, and the step total the product of the
    module's docstring.
    """
    ops = list(ops)
    if not ops:
        raise ValueError("compose_ops: empty op list")
    clock = machine.clock_hz
    records = []
    for o in ops:
        p = _price(o, machine)
        units = o.units()
        scale = clock * o.count
        per_elem = p.workload.work_per_elem()[0]
        records.append(OpPrediction(
            name=o.name, layer=o.layer, phase=o.phase, kind=o.kind,
            count=o.count, units=units,
            cy_per_unit=p.t / p.rows * clock,
            t_ol_cy=p.t_comp / p.rows * scale * units,
            t_rest_cy=p.t_hbm / p.rows * scale * units,
            cycles=p.t / p.rows * scale * units,
            flops=float(per_elem) * o.out_elems * o.count,
            hbm_bytes=p.hbm_bytes / p.rows * units * o.count,
            block=p.block,
        ))
    return StepPrediction(name=name, machine=machine.name, clock_hz=clock,
                          alpha=overlap_alpha(machine), ops=tuple(records))


def _resolve_config(config):
    """(name, cfg) from an arch name, an ArchDef, or a raw config."""
    if isinstance(config, str):
        from ..configs import get_arch

        arch = get_arch(config)
        return arch.name, arch.cfg
    cfg = getattr(config, "cfg", None)
    if cfg is not None and hasattr(config, "spec_fn"):   # ArchDef
        return config.name, cfg
    return getattr(config, "name", type(config).__name__), config


def predict_step(config, machine: GPUMachineModel = H100_SXM, *,
                 batch: int = 1, seq_len: int = 4096,
                 context: int | None = None, phases=PHASES,
                 elem_bytes: int = 4) -> StepPrediction:
    """Compose the whole-model step prediction for a config on the card.

    ``config`` is an arch name from ``repro_torch.configs``, an
    ``ArchDef``, or a raw model config dataclass.  The returned record
    carries both a prefill step (``batch x seq_len`` tokens) and a decode
    step (one token per sequence at ``context``), each decomposable per op
    and per layer group; ``elem_bytes`` is the products' operand size.
    """
    name, cfg = _resolve_config(config)
    context = context or seq_len
    ops: list[OpSpec] = []
    for ph in phases:
        ops += model_ops(cfg, ph, batch=batch, seq_len=seq_len,
                         context=context, elem_bytes=elem_bytes)
    return compose_ops(ops, machine, name=name)


def _one_sm_terms(op: OpSpec, p: _Priced, machine: GPUMachineModel
                  ) -> tuple[float, float, float]:
    """One instance's one-SM Eq. 1 terms in cycles, ``(T_OL, T_L2,
    T_HBM)``: the terms ``one_sm_ecm`` uses (compute at one SM's share of
    the unit's peak; SM <- L2 at ``l2_bytes_per_s / sm_count``; L2 <- HBM
    at the sustained rate), over the bytes the op's priced traffic moves."""
    if op.kind == "stream":
        ecm = one_sm_ecm(p.workload.name, machine)
        return ecm.t_ol, ecm.transfers[0], ecm.transfers[1]
    w, c, sms = p.workload, machine.clock_hz, machine.sm_count
    if op.kind == "matmul" and w.elem_bytes == 2:
        peak = machine.peak_bf16_tensor_flops
    else:
        peak = machine.peak_f32_flops
    t_ol = w.flops * c / (peak / sms)
    t_l2 = p.hbm_bytes * c / (machine.l2_bytes_per_s / sms)
    t_hbm = p.hbm_bytes * c / machine.sustained_bw(op.kind, "_compute")
    return t_ol, t_l2, t_hbm


def model_lowered(config, machine: GPUMachineModel, *,
                  phase: str = "decode", batch: int = 1,
                  seq_len: int = 4096, context: int | None = None,
                  elem_bytes: int = 4) -> ECMBatch:
    """One phase of a config aggregated into a single one-SM
    :class:`~.ecm.ECMBatch` element (unit: one whole step), levels
    ``("REG", "L2", "HBM")`` — the adapter that feeds the Eq. 2
    chip-scaling engine (``core/scaling.py`` ``scale_model``).

    Each op's one-SM terms (:func:`_one_sm_terms`) scaled by its instances
    and units are summed, so the aggregate's Eq. 1 prediction is the
    pipelined composition ``max(sum T_OL, sum (T_L2 + T_HBM))``; its HBM
    term is the shared bottleneck Eq. 2 saturates on.  Needs a calibrated
    machine (the L2 plateau), as ``one_sm_ecm`` does.
    """
    if machine.l2_bytes_per_s is None:
        raise ValueError("the one-SM model needs the L2 plateau: calibrate "
                         "the machine first (repro_torch.launch.calibrate)")
    name, cfg = _resolve_config(config)
    ops = model_ops(cfg, phase, batch=batch, seq_len=seq_len,
                    context=context, elem_bytes=elem_bytes)
    t_ol = t_l2 = t_hbm = 0.0
    for o in ops:
        p = _price(o, machine)
        scale = o.count * o.units() / p.rows
        a, b, c = _one_sm_terms(o, p, machine)
        t_ol += a * scale
        t_l2 += b * scale
        t_hbm += c * scale
    return ECMBatch(t_ol=np.array([t_ol]), t_nol=np.array([0.0]),
                    transfers=np.array([[t_l2, t_hbm]]),
                    levels=("REG", "L2", "HBM"),
                    names=(f"{name}/{phase}",), unit="cy/step")
