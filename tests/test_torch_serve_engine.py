"""The port's serving engine (``repro_torch.serve``) against the
reference's ``repro.serve`` on the CPU.

* The framework-free pieces equal the reference's: the trace drawn from
  one seed field by field, the SLO classes, the retry backoff drawn from
  equal generators, the degradation ladder and every fault preset.
* The scheduler: the port's ``ServeEngine`` with a fresh reference
  ``BucketModel`` (tpu-v5e) installed as its ``buckets`` gives the
  reference engine's ``log``, ``steps`` and ``summary()`` bit for bit on
  the same trace, under the four fault plans at the reference's bench
  settings (``tests/test_serve.py``), for the hopeless-deadline
  rejection, the retry exhaustion and the ``max_steps`` guard; the
  reference's pinned recovery sequences hold on the port.
* The port's own ``BucketModel`` on ``H100_SXM``: its picks are
  ``rank``'s first, its cycles the folded ``t_ecm``, its re-calibration
  the reference's EWMA with no table rebuilt, a warm restart ranks
  nothing, another machine rebuilds every table, ``remesh`` takes the
  cheapest split under the NVLink prior, and an unknown source raises
  (``source="compose"`` is held in ``tests/test_torch_compose.py``).
* The port's engine on its own model loses no request under any plan,
  replays bit for bit, and re-calibrates in the slow window.
"""
import dataclasses

import numpy as np
import pytest

pytest.importorskip("torch")

from repro import serve as R  # noqa: E402
from repro.serve import engine as RE  # noqa: E402
from repro.serve import faults as RF  # noqa: E402
from repro.serve import policy as RP  # noqa: E402
from repro_torch import serve as S  # noqa: E402
from repro_torch.core import diskcache  # noqa: E402
from repro_torch.core.autotune import rank  # noqa: E402
from repro_torch.core.machine import H100_SXM  # noqa: E402
from repro_torch.serve import engine as SE  # noqa: E402
from repro_torch.serve import faults as SF  # noqa: E402
from repro_torch.serve import policy as SP  # noqa: E402

PLANS = ("none", "device_loss", "slow_step", "kv_corruption")
#: the reference's bench settings (tests/test_serve.py:36-37)
BENCH_TRACE = {"mean_interarrival_s": 0.001}
BENCH_BUDGET_S = 0.001
BUCKETS = (128, 256, 512, 1024, 2048, 4096, 8192, 16384)


def _request_fields(r):
    return (r.rid, r.arrival_s, r.prompt_len, r.gen_len, r.slo.name,
            r.slo.priority, r.slo.base_budget_s, r.slo.per_token_budget_s,
            r.state.value, r.tokens_done, r.retries, r.requeues,
            r.eligible_s, r.admitted_s, r.finish_s, r.reason, r.deadline_s)


# ---------------------------------------------------------------------------
# trace, policy and faults
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 3, 4])
@pytest.mark.parametrize("bench", [False, True], ids=["default", "bench"])
def test_trace_equals_the_references(seed, bench):
    kw = BENCH_TRACE if bench else {}
    got = S.synthetic_trace(S.TraceConfig(**kw), seed=seed)
    want = R.synthetic_trace(R.TraceConfig(**kw), seed=seed)
    assert [_request_fields(r) for r in got] == \
        [_request_fields(r) for r in want]
    assert [r.context_len for r in got] == [r.context_len for r in want]


def test_slo_classes_equal_the_references():
    assert [dataclasses.astuple(c) for c in S.SLO_CLASSES] == \
        [dataclasses.astuple(c) for c in R.SLO_CLASSES]
    for c in R.SLO_CLASSES:
        assert dataclasses.astuple(S.slo_class(c.name)) == \
            dataclasses.astuple(c)
        assert S.slo_class(c.name).deadline_s(0.25, 64) == \
            c.deadline_s(0.25, 64)
    with pytest.raises(KeyError, match="unknown SLO class 'gold'"):
        S.slo_class("gold")
    assert [s.value for s in S.RequestState] == \
        [s.value for s in R.RequestState]
    assert {s.value for s in SP.TERMINAL_STATES} == \
        {s.value for s in RP.TERMINAL_STATES}


@pytest.mark.parametrize("kw", [{}, {"max_retries": 1, "backoff_base_s": 0.01,
                                     "backoff_mult": 3.0, "jitter_frac": 0.5}])
def test_retry_backoff_equals_the_references(kw):
    got, want = S.RetryPolicy(**kw), R.RetryPolicy(**kw)
    g, w = np.random.default_rng(7), np.random.default_rng(7)
    assert [got.backoff_s(a, g) for a in range(-1, 6)] == \
        [want.backoff_s(a, w) for a in range(-1, 6)]
    assert [got.exhausted(n) for n in range(6)] == \
        [want.exhausted(n) for n in range(6)]


@pytest.mark.parametrize("kw", [{}, {"step_budget_s": 0.001},
                                {"restore_fraction": 0.8, "max_level": 2}])
def test_degradation_ladder_equals_the_references(kw):
    got, want = S.DegradationPolicy(**kw), R.DegradationPolicy(**kw)
    budget = want.step_budget_s
    for level in range(5):
        for p in (0.0, 0.1, 0.49, 0.5, 0.51, 0.79, 0.8, 1.0, 1.01, 40.0):
            assert got.next_level(level, p * budget) == \
                want.next_level(level, p * budget)


@pytest.mark.parametrize("name", sorted(R.PRESETS))
def test_fault_presets_equal_the_references(name):
    got, want = S.fault_plan(name), R.fault_plan(name)
    assert repr(got).replace("repro_torch.", "repro.") == repr(want)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    gi, wi = S.FaultInjector(got), R.FaultInjector(want)
    for step in range(0, 100):
        assert gi.step_factor(step) == wi.step_factor(step)
        assert [dataclasses.astuple(e) for e in gi.device_losses(step)] == \
            [dataclasses.astuple(e) for e in wi.device_losses(step)]
        assert [dataclasses.astuple(e) for e in gi.corruptions(step)] == \
            [dataclasses.astuple(e) for e in wi.corruptions(step)]
    assert sorted(S.PRESETS) == sorted(R.PRESETS)
    with pytest.raises(KeyError, match="unknown fault plan"):
        S.fault_plan("meteor")


# ---------------------------------------------------------------------------
# the scheduler against the reference, with the reference's buckets
# ---------------------------------------------------------------------------


def _with_reference_buckets(engine):
    """``engine`` (the port's) with a fresh reference ``BucketModel`` on
    tpu-v5e installed as its buckets, as the reference engine builds it."""
    cfg = engine.cfg
    engine.buckets = RE.BucketModel("tpu-v5e", RE.ServingModel(),
                                    min_ctx=cfg.min_ctx, max_ctx=cfg.max_ctx)
    engine.buckets.mesh_plan = {"data": cfg.n_devices, "model": 1,
                                "t_step_s": None, "ctx_bucket": None}
    return engine


def _same_run(got, want):
    """The two engines' logs, every StepRecord field and summaries."""
    assert got.log == want.log
    assert [dataclasses.asdict(s) for s in got.steps] == \
        [dataclasses.asdict(s) for s in want.steps]
    assert [_request_fields(r) for r in got.requests] == \
        [_request_fields(r) for r in want.requests]
    assert got.summary() == want.summary()


def _bench_pair(plan, *, retry=None, faults=None, **cfg_kw):
    port = _with_reference_buckets(S.ServeEngine(
        S.EngineConfig(**cfg_kw),
        retry=S.RetryPolicy(**(retry or {})),
        degrade=S.DegradationPolicy(step_budget_s=BENCH_BUDGET_S)))
    ref = R.ServeEngine(R.EngineConfig(**cfg_kw),
                        retry=R.RetryPolicy(**(retry or {})),
                        degrade=R.DegradationPolicy(step_budget_s=BENCH_BUDGET_S))
    got_faults, want_faults = faults or (S.fault_plan(plan), R.fault_plan(plan))
    port.run(S.synthetic_trace(S.TraceConfig(**BENCH_TRACE), seed=0),
             S.FaultInjector(got_faults))
    ref.run(R.synthetic_trace(R.TraceConfig(**BENCH_TRACE), seed=0),
            R.FaultInjector(want_faults))
    return port, ref


@pytest.fixture(scope="module")
def bench_pairs():
    return {plan: _bench_pair(plan) for plan in PLANS}


@pytest.mark.parametrize("plan", PLANS)
def test_scheduler_equals_the_references(bench_pairs, plan):
    port, ref = bench_pairs[plan]
    _same_run(port, ref)
    assert port.summary()["lost"] == 0
    assert port.summary()["completed"] == R.TraceConfig().n_requests


def test_pinned_device_loss_sequence_holds_on_the_port(bench_pairs):
    port, _ = bench_pairs["device_loss"]
    seq = [(e["event"], e.get("rid"), e["step"])
           for e in port.events("device_loss", "requeue", "fail")]
    assert seq == [("device_loss", None, 72),
                   ("requeue", 3, 72), ("requeue", 4, 72),
                   ("requeue", 7, 72), ("requeue", 8, 72)]
    loss = port.events("device_loss")[0]
    assert loss["n_devices_before"] == 4 and loss["n_devices_after"] == 2
    assert loss["resharded"] is False
    assert port.summary()["recovery"] == {"requeued": 4, "retried": 4,
                                          "recovered": 4}


def test_pinned_kv_corruption_sequence_holds_on_the_port(bench_pairs):
    port, _ = bench_pairs["kv_corruption"]
    seq = [(e["event"], e["rid"], e["step"])
           for e in port.events("kv_corrupt", "requeue", "fail")]
    assert seq == [("kv_corrupt", 1, 67), ("requeue", 1, 67),
                   ("kv_corrupt", 2, 81), ("requeue", 2, 81)]
    assert port.summary()["events"]["admit"] == R.TraceConfig().n_requests + 2


def test_slow_window_recalibrates_as_the_reference(bench_pairs):
    port, _ = bench_pairs["slow_step"]
    first = port.events("recalibrate")[0]
    assert 60 <= first["step"] <= 70 and first["ratio"] == pytest.approx(4.0)
    assert port.summary()["calibration"]


def test_retry_exhaustion_equals_the_references():
    steps = range(0, 400)
    faults = (SF.FaultPlan(name="hammer", kv_corruptions=tuple(
                  SF.KVCorrupt(step=s, slot=0) for s in steps)),
              RF.FaultPlan(name="hammer", kv_corruptions=tuple(
                  RF.KVCorrupt(step=s, slot=0) for s in steps)))
    port, ref = _bench_pair(None, retry={"max_retries": 2}, faults=faults)
    _same_run(port, ref)
    fails = port.events("fail")
    assert fails and all(port.requests[e["rid"]].state is S.RequestState.FAILED
                         and port.requests[e["rid"]].retries == 3
                         for e in fails)


def test_hopeless_deadline_rejection_equals_the_references():
    def requests(mod):
        impossible = mod.SLOClass("impossible", priority=0,
                                  base_budget_s=1e-9, per_token_budget_s=0.0)
        return [mod.Request(rid=0, arrival_s=0.0, prompt_len=2048,
                            gen_len=128, slo=impossible),
                mod.Request(rid=1, arrival_s=0.0, prompt_len=128, gen_len=16,
                            slo=mod.SLO_CLASSES[2])]

    port = _with_reference_buckets(S.ServeEngine(S.EngineConfig(seed=0)))
    ref = R.ServeEngine(R.EngineConfig(seed=0))
    port.run(requests(S))
    ref.run(requests(R))
    _same_run(port, ref)
    assert port.requests[0].state is S.RequestState.SHED
    assert port.requests[1].state is S.RequestState.DONE
    assert len(port.events("reject")) == 1


def test_max_steps_guard_equals_the_references():
    port = _with_reference_buckets(S.ServeEngine(S.EngineConfig(max_steps=3)))
    ref = R.ServeEngine(R.EngineConfig(max_steps=3))
    with pytest.raises(RuntimeError, match="max_steps") as got:
        port.run(S.synthetic_trace(S.TraceConfig(n_requests=8), seed=0))
    with pytest.raises(RuntimeError, match="max_steps") as want:
        ref.run(R.synthetic_trace(R.TraceConfig(n_requests=8), seed=0))
    assert str(got.value) == str(want.value)
    _same_run(port, ref)


# ---------------------------------------------------------------------------
# the port's own BucketModel on the H100 SXM
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("elem_bytes", [4, 2])
def test_bucket_picks_are_ranks_first(elem_bytes):
    model = S.ServingModel(elem_bytes=elem_bytes)
    b = S.BucketModel(H100_SXM, model)
    scale = H100_SXM.clock_hz * model.heads * model.layers
    for cb in BUCKETS:
        ranked = rank((1, cb, model.d), H100_SXM, objective="attention",
                      causal=False, elem_bytes=elem_bytes)
        assert (1, b.decode_block(cb)) == ranked[0]["block"]
        one_row = [r for r in ranked if r["block"][0] == 1]
        assert b.decode_block(cb, smallest=True) == 128
        assert {r["block"][1] for r in one_row} == (
            {128} if cb == 128 else {128, 256})
        for smallest in (False, True):
            bkv = b.decode_block(cb, smallest=smallest)
            t = next(r["t_ecm"] for r in one_row if r["block"][1] == bkv)
            assert b.decode_cy_per_token(cb, smallest_block=smallest) == \
                pytest.approx(t * scale, rel=1e-12)
        pre = rank((cb, cb, model.d), H100_SXM, objective="attention",
                   causal=True, elem_bytes=elem_bytes)[0]
        assert b._prefill_entry(cb)["block"] == pre["block"]
        assert b.prefill_cy(cb - 7) == pytest.approx(
            pre["t_ecm"] / cb * (cb - 7) * scale, rel=1e-12)
        assert b.seconds(b.decode_cy_per_token(cb), 4) == pytest.approx(
            t * model.heads * model.layers / 4, rel=1e-12)
    # contexts between buckets take the next power of two, clamped
    assert [b.ctx_bucket(x) for x in (1, 128, 129, 3000, 10**6)] == \
        [128, 128, 256, 4096, 16384]


def test_recalibrate_is_the_references_ewma_and_rebuilds_nothing():
    b = S.BucketModel()
    ref = RE.BucketModel("tpu-v5e")
    before = b.decode_cy_per_token(300, calibrated=False)
    tables, counters = dict(b._decode), dict(b.counters)
    for ratio in (4.0, 0.5, 1.25):
        assert b.recalibrate("decode", 300, ratio, 0.75) == \
            ref.recalibrate("decode", 300, ratio, 0.75)
    assert b.calib == {("decode", 512): ref.calib[("decode", 512)]}
    assert b.decode_cy_per_token(300) == before * b.calib[("decode", 512)]
    assert b.decode_cy_per_token(300, calibrated=False) == before
    assert b._decode == tables and b.counters == counters


def test_warm_restart_ranks_nothing(tmp_path):
    prev = diskcache.set_cache_dir(tmp_path)
    try:
        cold = S.BucketModel()
        want = [(cold.decode_cy_per_token(cb), cold.prefill_cy(cb))
                for cb in BUCKETS]
        assert cold.counters == {"ranked": 16, "from_cache": 0, "rebuilds": 0}
        diskcache.clear_memo()
        warm = S.BucketModel()
        assert [(warm.decode_cy_per_token(cb), warm.prefill_cy(cb))
                for cb in BUCKETS] == want
        assert warm.counters == {"ranked": 0, "from_cache": 16, "rebuilds": 0}
    finally:
        diskcache.restore_cache_dir(prev)


def test_another_machine_rebuilds_every_table():
    b = S.BucketModel()
    prior = [b.decode_cy_per_token(cb) for cb in BUCKETS]
    b.machine = dataclasses.replace(H100_SXM)        # the same content
    assert [b.decode_cy_per_token(cb) for cb in BUCKETS] == prior
    assert b.counters == {"ranked": 8, "from_cache": 0, "rebuilds": 0}
    b.machine = dataclasses.replace(H100_SXM, hbm_bytes_per_s=3.0e12)
    got = [b.decode_cy_per_token(cb) for cb in BUCKETS]
    assert b.counters == {"ranked": 16, "from_cache": 0, "rebuilds": 1}
    # decode is HBM-bound: the cycles scale with the data-sheet rate
    assert got == pytest.approx([p * 3.35 / 3.0 for p in prior], rel=1e-9)


@pytest.mark.parametrize("n,batch", [(4, 16), (4, 1), (2, 1), (1, 16)])
def test_remesh_takes_the_cheapest_split(n, batch):
    b = S.BucketModel()
    m = b.model
    cy = b.decode_cy_per_token(2048, calibrated=False)
    ar = 2.0 * m.layers * m.heads * m.d * m.elem_bytes
    want = []
    for ways in (w for w in (1, 2, 4) if n % w == 0 and w <= n):
        t_tok = cy / (H100_SXM.clock_hz * ways)
        if ways > 1:
            t_tok += ar * (ways - 1) / ways / H100_SXM.nvlink_bytes_per_s
        want.append((t_tok * -(-batch // (n // ways)), ways))
    plan = b.remesh(n, batch=batch)
    t, ways = min(want)
    assert (plan["model"], plan["data"], plan["ctx_bucket"]) == \
        (ways, n // ways, 2048)
    assert plan["t_step_s"] == pytest.approx(t, rel=1e-12)
    assert b.mesh_plan is plan
    if (n, batch) == (4, 1):
        assert plan["model"] == 4      # one request: the heads split wins
    if batch == 16:
        assert plan["model"] == 1      # a full batch: data ways win


def test_engine_config_equals_the_references():
    with pytest.raises(ValueError, match="unknown bucket source"):
        S.BucketModel(source="simulator")
    assert not hasattr(S.EngineConfig(), "bkv_candidates")
    assert S.EngineConfig().machine is H100_SXM
    assert {f.name: f.default for f in dataclasses.fields(S.EngineConfig)
            if f.name not in ("machine",)} == \
        {f.name: f.default for f in dataclasses.fields(R.EngineConfig)
         if f.name not in ("machine", "bkv_candidates")}


# ---------------------------------------------------------------------------
# the port's engine on its own model
# ---------------------------------------------------------------------------


def _own_run(plan):
    engine = S.ServeEngine(S.EngineConfig(),
                           degrade=S.DegradationPolicy(step_budget_s=BENCH_BUDGET_S))
    summary = engine.run(S.synthetic_trace(S.TraceConfig(**BENCH_TRACE), seed=0),
                         S.FaultInjector(S.fault_plan(plan)))
    return engine, summary


@pytest.mark.parametrize("plan", PLANS)
def test_own_model_loses_nothing_and_replays(plan):
    e1, s1 = _own_run(plan)
    e2, s2 = _own_run(plan)
    assert s1["lost"] == 0 and s1["completed"] == R.TraceConfig().n_requests
    assert all(r.terminal and r.finish_s is not None for r in e1.requests)
    assert e1.log == e2.log and s1 == s2
    assert [dataclasses.asdict(s) for s in e1.steps] == \
        [dataclasses.asdict(s) for s in e2.steps]
    if plan == "none":
        assert s1["step_pred_measured"]["max_ratio"] == 1.0
        assert s1["recovery"] == {"requeued": 0, "retried": 0, "recovered": 0}
    if plan == "slow_step":
        first = e1.events("recalibrate")[0]
        assert 60 <= first["step"] <= 70
        assert first["ratio"] == pytest.approx(4.0)
        assert first["calibration"] > 1.0
        assert s1["step_pred_measured"]["max_ratio"] == pytest.approx(4.0)
    if plan in ("device_loss", "kv_corruption"):
        assert s1["recovery"]["recovered"] == s1["recovery"]["retried"] > 0


def test_own_model_admits_against_its_predictions():
    engine, _ = _own_run("none")
    admits = engine.events("admit")
    assert len(admits) == R.TraceConfig().n_requests
    assert all(e["predicted_finish_s"] <= e["deadline_s"] for e in admits)
    assert {e["ctx_bucket"] for e in admits} <= set(BUCKETS)
    assert SE.ServingModel() == S.ServingModel(8, 16, 128, 4)
