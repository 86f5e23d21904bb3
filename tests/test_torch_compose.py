"""The port's whole-model composition (``repro_torch.core.compose``) against
the reference's ``repro.core.compose`` on the CPU.

* The walk: ``model_ops`` equals the reference's for every arch in both
  phases at two shapes (names, groups, counts, output sizes, element
  widths and the workloads' dims), and so do its FLOP counts; priced on
  the card, the FLOPs stay the reference's wherever the blocks do not
  enter, and causal prefill attention counts the reference's formula at
  the card's blocks.
* The rule: ``compose_cycles`` is bit-equal to the reference's.
* The reference's invariants restated on ``H100_SXM`` and on a
  calibrated-shaped machine: finite, positive and decomposable; decode
  not above prefill at equal context; the breakdown sums to the total;
  monotone in layers and hidden size; a one-op composition is its direct
  ``gpu_*_ecm`` product.
* ``scale_model``: Eq. 2 on a whole model step.
* The compose-backed ``BucketModel`` is bit-identical to the direct one,
  and the compose-backed engine's device-loss sequence is the
  attention-backed engine's, pinned.
"""
import dataclasses
import math

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.configs import get_arch as ref_arch  # noqa: E402
from repro.core import compose as RC  # noqa: E402
from repro_torch.configs import ARCH_NAMES, get_arch  # noqa: E402
from repro_torch.core import compose as C  # noqa: E402
from repro_torch.core.gpu_ecm import (gpu_attention_ecm,  # noqa: E402
                                      gpu_matmul_ecm, gpu_stream_ecm)
from repro_torch.core.machine import H100_SXM  # noqa: E402
from repro_torch.core.workload import (AttentionWorkload,  # noqa: E402
                                       MatmulWorkload)

#: a machine shaped as the calibration leaves it: an L2 plateau and
#: measured stream rates (tests/test_torch_scaling.py's)
H100_CAL = dataclasses.replace(
    H100_SXM, l2_bytes_per_s=7.18e12,
    measured_bw={"copy": 3.02e12, "update": 3.05e12, "striad": 3.10e12,
                 "_stream": 3.15e12})
MACHINES = {"data_sheet": H100_SXM, "calibrated": H100_CAL}
#: the reference's test shape, and the served models' (B 8, prompt 2048,
#: context after 32 decode steps)
SHAPES = {"b1_s4096": dict(batch=1, seq_len=4096),
          "b8_s2048_c2080": dict(batch=8, seq_len=2048, context=2080)}
SEQ = 4096


def _dims(w):
    if hasattr(w, "spec") and not hasattr(w, "m") and not hasattr(w, "sq"):
        return ("stream", w.spec.name, w.spec.flops_per_elem)
    if hasattr(w, "m"):
        return ("matmul", w.m, w.n, w.k)
    return ("attention", w.sq, w.skv, w.d, w.causal)


def _record(o):
    return (o.name, o.layer, o.phase, o.kind, o.count, o.out_elems,
            o.elem_bytes, _dims(o.workload))


# ---------------------------------------------------------------------------
# 1. the walk and its FLOPs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("phase", C.PHASES)
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_walk_equals_the_references(arch, phase, shape):
    got = C.model_ops(get_arch(arch).cfg, phase, **SHAPES[shape])
    want = RC.model_ops(ref_arch(arch).cfg, phase, **SHAPES[shape])
    assert [_record(o) for o in got] == [_record(o) for o in want]
    assert [o.flops for o in got] == [o.flops for o in want]


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_priced_flops_equal_the_references_where_blocks_do_not_enter(arch):
    for kw in SHAPES.values():
        sp = C.predict_step(arch, H100_SXM, **kw)
        want = [o for ph in C.PHASES
                for o in RC.model_ops(ref_arch(arch).cfg, ph, **kw)]
        assert len(sp.ops) == len(want)
        for got, ref in zip(sp.ops, want):
            w = ref.workload
            if got.kind == "attention" and w.causal:
                bq, bkv = got.block
                frac = min(1.0, 0.5 + max(min(bq, w.sq), min(bkv, w.skv))
                           / (2.0 * w.skv))
                assert got.flops == float(int(round(4.0 * w.skv * frac))) \
                    * ref.out_elems * ref.count, got.name
            else:
                assert got.flops == ref.flops, got.name


def test_attention_work_excludes_the_softmax():
    w = AttentionWorkload(512, 2048, 128, 128, 128, True)
    assert w.work_per_elem() == (int(round(4 * 2048 * w.kv_fraction())), 1)
    assert w.flops > w.work_per_elem()[0] * w.sq * w.d
    assert MatmulWorkload(64, 32, 96, 64, 32).work_per_elem() == (192, 1)


# ---------------------------------------------------------------------------
# 2. the overlap rule
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("alpha", [0.0, 0.3, 1.0])
def test_compose_cycles_bit_equal_to_the_references(alpha):
    rng = np.random.default_rng(7)
    for n in (1, 5, 64):
        t_ol, t_rest, serial = (rng.exponential(1e6, n) for _ in range(3))
        assert C.compose_cycles(t_ol, t_rest, serial, alpha) == \
            RC.compose_cycles(t_ol, t_rest, serial, alpha)


# ---------------------------------------------------------------------------
# 3. invariants on the card's machines
# ---------------------------------------------------------------------------


def _sp(arch, machine, elem_bytes=4):
    return C.predict_step(arch, MACHINES[machine], batch=1, seq_len=SEQ,
                          context=SEQ, elem_bytes=elem_bytes)


@pytest.mark.parametrize("machine", MACHINES)
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_prediction_finite_positive_and_decomposable(arch, machine):
    for eb in (4, 2):
        sp = _sp(arch, machine, eb)
        assert sp.ops and sp.alpha == 1.0
        for ph in C.PHASES:
            cy = sp.cycles(ph)
            assert math.isfinite(cy) and cy > 0, (ph, cy)
            assert sp.seconds(ph) == cy / sp.clock_hz
            assert sp.flops(ph) > 0 and sp.hbm_bytes(ph) > 0
            assert sp.dominant_op(ph)
            # decode not above prefill at equal context
            assert sp.cycles("decode") <= sp.cycles("prefill")
        for o in sp.ops:
            assert math.isfinite(o.cycles) and o.cycles > 0, o.name
            assert o.cy_per_unit > 0 and o.units > 0 and o.count > 0, o.name
            assert o.cycles == pytest.approx(max(o.t_ol_cy, o.t_rest_cy),
                                             rel=1e-12), o.name


@pytest.mark.parametrize("machine", MACHINES)
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_per_op_breakdown_sums_to_total_under_overlap_rule(arch, machine):
    sp = _sp(arch, machine)
    assert sp.alpha == C.overlap_alpha(MACHINES[machine])
    for ph in C.PHASES:
        ops = sp.phase_ops(ph)
        assert sp.cycles(ph) == C.compose_cycles(
            [o.t_ol_cy for o in ops], [o.t_rest_cy for o in ops],
            [o.cycles for o in ops], sp.alpha)
        assert sp.cycles(ph) == pytest.approx(sum(o.cycles for o in ops),
                                              rel=1e-12)
        assert sum(sp.per_layer(ph).values()) == pytest.approx(
            sp.cycles(ph), rel=1e-12)
        assert sum(sp.per_kind(ph).values()) == pytest.approx(
            sp.cycles(ph), rel=1e-12)


@pytest.mark.parametrize("machine", MACHINES)
@pytest.mark.parametrize("knob", ["n_layers", "d_model"])
def test_composition_monotone_in_layers_and_hidden_size(machine, knob):
    cfg = get_arch("internlm2-1.8b").cfg
    big = dataclasses.replace(cfg, **{knob: 2 * getattr(cfg, knob)})
    m = MACHINES[machine]
    for ph in C.PHASES:
        small_cy = C.compose_ops(
            C.model_ops(cfg, ph, batch=1, seq_len=512), m).cycles(ph)
        big_cy = C.compose_ops(
            C.model_ops(big, ph, batch=1, seq_len=512), m).cycles(ph)
        assert big_cy > small_cy, (knob, ph)


@pytest.mark.parametrize("machine", MACHINES)
def test_single_op_composition_is_the_direct_product(machine):
    """A one-op model is its workload: the composed per-unit cycles are
    the direct ``gpu_*_ecm`` prediction's, and the step total their
    product with the op's count and units."""
    m = MACHINES[machine]
    cases = [
        (C.matmul_op("mm", "l", "prefill", m=2048, n=2048, k=2048, count=7),
         gpu_matmul_ecm(MatmulWorkload(2048, 2048, 2048, *C.pick_block(
             "matmul", (2048, 2048, 2048), m)[:2]), m).t_ecm / 2048),
        (C.matmul_op("mm16", "l", "prefill", m=4096, n=1024, k=512,
                     count=3, elem_bytes=2),
         gpu_matmul_ecm(MatmulWorkload(4096, 1024, 512, *C.pick_block(
             "matmul", (4096, 1024, 512), m, elem_bytes=2)[:2], 2),
             m).t_ecm / 4096),
        (C.attention_op("att", "l", "decode", sq=1, skv=4096, d=128,
                        bq=1, bkv=256, count=32, causal=False),
         gpu_attention_ecm(AttentionWorkload(1, 4096, 128, 1, 256, False),
                           m, batch_heads=1).t_ecm),
        (C.stream_op("st", "l", "prefill", elems=128 * 1000, count=5,
                     spec=C._RESID_SPEC),
         gpu_stream_ecm("striad", m).prediction(-1) / m.clock_hz),
    ]
    for op, direct_s in cases:
        sp = C.compose_ops([op], m)
        rec = sp.ops[0]
        assert rec.cy_per_unit == direct_s * m.clock_hz, op.name
        assert sp.cycles(op.phase) == pytest.approx(
            direct_s * m.clock_hz * op.count * op.units(), rel=1e-12)
        assert sp.cycles(op.phase) == rec.cycles
    # batch_heads multiplies one head's terms
    w = AttentionWorkload(4096, 4096, 128, 128, 128, True)
    one = gpu_attention_ecm(w, m, batch_heads=1)
    many = gpu_attention_ecm(w, m, batch_heads=64)
    assert many.t_comp == pytest.approx(64 * one.t_comp, rel=1e-12)
    assert many.t_hbm == pytest.approx(64 * one.t_hbm, rel=1e-12)


def test_picks_are_ranked_and_memoized():
    from repro_torch.core.autotune import rank

    block = C.pick_block("attention", (2048, 2048, 128), H100_SXM, causal=True,
                         elem_bytes=2)
    assert block == rank((2048, 2048, 128), H100_SXM, objective="attention",
                         causal=True, elem_bytes=2)[0]["block"]
    assert C.pick_block("matmul", (16384, 4096, 2048), H100_SXM,
                        elem_bytes=2) == rank(
        (16384, 4096, 2048), H100_SXM, objective="matmul",
        elem_bytes=2)[0]["block"]
    # no compiled tiling divides an 8-row decode product: clamped
    assert C.pick_block("matmul", (8, 4096, 2048), H100_SXM,
                        elem_bytes=2) in ((64, 128, 64), (128, 128, 64),
                                          (128, 256, 64))
    n = len(C._PICKS)
    C.predict_step("internlm2-1.8b", H100_SXM)
    C.predict_step("internlm2-1.8b", dataclasses.replace(H100_SXM))
    assert len(C._PICKS) <= n + 20
    m = len(C._PICKS)
    C.predict_step("internlm2-1.8b", dataclasses.replace(H100_SXM))
    assert len(C._PICKS) == m


# ---------------------------------------------------------------------------
# 4. Eq. 2 on a model step
# ---------------------------------------------------------------------------


def test_scale_model_feeds_eq2_engine():
    """internlm2-1.8b's decode saturates within the card's SMs and is not
    core-bound; the aggregate's single-SM time is the pipelined
    composition of the walk's one-SM terms, whose compute is the
    whole-card composition's on one SM's share and whose HBM term is the
    composition's summed T_hbm."""
    from repro_torch.core.scaling import scale_model

    for eb in (4, 2):
        cs = scale_model("internlm2-1.8b", H100_CAL, phase="decode", batch=1,
                         seq_len=SEQ, elem_bytes=eb)
        n_sat = int(cs.n_saturation()[0, -1])
        assert 1 <= n_sat <= cs.cores_per_domain == H100_CAL.sm_count
        assert not bool(cs.core_bound()[0, -1])

        lowered = C.model_lowered("internlm2-1.8b", H100_CAL, phase="decode",
                                  batch=1, seq_len=SEQ, elem_bytes=eb)
        t_ol = float(lowered.t_ol[0])
        t_l2, t_hbm = (float(x) for x in lowered.transfers[0])
        assert float(lowered.predictions()[0, -1]) == max(t_ol, t_l2 + t_hbm)
        assert cs.t_single[0, 0] == max(t_ol, t_l2 + t_hbm)
        assert cs.bottleneck[0, 0] == t_hbm
        sp = C.predict_step("internlm2-1.8b", H100_CAL, batch=1, seq_len=SEQ,
                            phases=("decode",), elem_bytes=eb)
        ops = sp.phase_ops("decode")
        assert t_hbm == pytest.approx(sum(o.t_rest_cy for o in ops), rel=1e-9)
        assert t_ol == pytest.approx(
            H100_CAL.sm_count * sum(o.t_ol_cy for o in ops), rel=1e-9)
    with pytest.raises(ValueError, match="calibrate"):
        scale_model("internlm2-1.8b", H100_SXM)


# ---------------------------------------------------------------------------
# 5. serving: the composition-backed BucketModel, zero behavior drift
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("machine", MACHINES)
@pytest.mark.parametrize("elem_bytes", [4, 2])
def test_bucket_model_compose_source_bit_identical(machine, elem_bytes):
    from repro_torch.serve.engine import BucketModel, ServingModel

    model = ServingModel(elem_bytes=elem_bytes)
    direct = BucketModel(MACHINES[machine], model)
    composed = BucketModel(MACHINES[machine], model, source="compose")
    assert composed.source == "compose"
    for cb in (130, 1000, 3000):
        for smallest in (False, True):
            assert composed.decode_cy_per_token(cb, smallest_block=smallest) \
                == direct.decode_cy_per_token(cb, smallest_block=smallest)
        assert composed.prefill_cy(cb) == direct.prefill_cy(cb)
        assert composed.decode_block(cb) == direct.decode_block(cb)


def test_bucket_model_rejects_unknown_source():
    from repro_torch.serve.engine import BucketModel

    with pytest.raises(ValueError, match="source"):
        BucketModel(H100_SXM, source="magic")


def test_compose_backed_engine_reproduces_pinned_recovery_sequence():
    """The device-loss trajectory with the brain's predictions sourced from
    the composition: the same requeues at the same step as the
    attention-backed engine, no request lost, two devices left, and its
    log and summary.  On the card's model (``H100_SXM``) the loss at step
    72 requeues rids 3 and 4; the reference's 3, 4, 7 and 8 are its
    tpu-v5e brain's, which the port's engine reproduces with the
    reference's ``BucketModel`` installed
    (``tests/test_torch_serve_engine.py``)."""
    from repro_torch.serve import (EngineConfig, FaultInjector, ServeEngine,
                                   TraceConfig, fault_plan, synthetic_trace)
    from repro_torch.serve.policy import DegradationPolicy

    trace_cfg = TraceConfig(mean_interarrival_s=0.001)
    engine = ServeEngine(EngineConfig(seed=0, bucket_source="compose"),
                         degrade=DegradationPolicy(step_budget_s=0.001))
    assert engine.buckets.source == "compose"
    summary = engine.run(synthetic_trace(trace_cfg, seed=0),
                         FaultInjector(fault_plan("device_loss")))
    seq = [(e["event"], e.get("rid"), e["step"])
           for e in engine.events("device_loss", "requeue", "fail")]
    assert seq == [("device_loss", None, 72),
                   ("requeue", 3, 72), ("requeue", 4, 72)]
    assert summary["lost"] == 0
    assert summary["n_devices_final"] == 2
    assert summary["recovery"] == {"requeued": 2, "retried": 2,
                                   "recovered": 2}

    baseline = ServeEngine(EngineConfig(seed=0),
                           degrade=DegradationPolicy(step_budget_s=0.001))
    base_summary = baseline.run(synthetic_trace(trace_cfg, seed=0),
                                FaultInjector(fault_plan("device_loss")))
    assert engine.log == baseline.log
    assert summary == base_summary
