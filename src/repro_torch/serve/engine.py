"""The continuous-batching engine: ECM predictions drive scheduling (the
reference's ``repro/serve/engine.py`` on the card's model).

The engine runs on a **virtual clock**: each iteration admits queued
requests, forms one decode step over the running batch (new admissions
piggyback their prefill onto the step, chunked-prefill style), predicts
the step time from the card's attention model, then "executes" it by
advancing the clock by the *measured* time (the same light-speed
prediction scaled by the configured hardware factor and any injected
faults).  Nothing reads a wall clock, so a (trace, config, fault plan,
seed) tuple reproduces the run bit-for-bit — which is what lets the
tests pin exact recovery sequences.  The engine's logic is the
reference's line for line; it calls only the public surface of its
``buckets`` (``ctx_bucket``, ``decode_cy_per_token``, ``prefill_cy``,
``seconds``, ``recalibrate``, ``calib``, ``remesh``, ``mesh_plan``), so
the reference's ``BucketModel`` can stand in for the port's.

The model is the scheduler's brain in three places:

* **bucket predictions** — :class:`BucketModel` ranks the compiled
  one-row (split-route) tilings of decode attention per power-of-two
  context bucket with ``core.autotune.rank(..., objective="attention")``
  on a ``GPUMachineModel`` and composes per-step time as the batch's
  summed per-request cycles over the data-parallel devices;
* **admission control** — a request is admitted only if its predicted
  finish (prefill + remaining decode steps at the would-be batch size)
  meets its deadline; hopeless requests are rejected *with the
  prediction logged*;
* **re-calibration** — when a measured step exceeds the prediction by
  more than ``recalib_threshold`` (an injected slow step, a degraded
  part), the involved buckets' calibration multipliers are pulled
  toward the measured ratio, and subsequent admission decisions use the
  calibrated times.

Degradation under pressure and fault handling are layered on by
:mod:`.policy` and :mod:`.faults`; the engine logs every transition with
the prediction that triggered it.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..core import diskcache
from ..core.autotune import rank
from ..core.machine import H100_SXM, GPUMachineModel
from .policy import DegradationPolicy, RequestState, RetryPolicy
from .trace import Request


# ---------------------------------------------------------------------------
# The served model and the per-bucket ECM predictions
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ServingModel:
    """First-order description of the served transformer's attention
    path (the decode bottleneck the ECM model predicts): head count,
    layer count, head dimension and KV dtype width."""

    heads: int = 8
    layers: int = 16
    d: int = 128
    elem_bytes: int = 4


def pow2_bucket(x: int, lo: int, hi: int) -> int:
    """Smallest power of two >= ``x``, clamped to ``[lo, hi]``."""
    b = lo
    while b < x and b < hi:
        b *= 2
    return b


class BucketModel:
    """Per-(kind, context-bucket) ECM step-time predictions + online
    calibration, on the card ``machine`` (a ``GPUMachineModel``).

    A decode bucket ``cb`` ranks ``(1, cb, d)`` — one query row streaming
    the whole KV, ``causal=False`` — and keeps the one-row tilings
    ``(1, bkv)``, the split route's: the compiled ones that divide ``cb``
    (``core/autotune.py``), so at ``cb`` 128 only ``(1, 128)``.  The
    engine serves from the first (``best_bkv``); degradation level 2
    falls back to the smallest (``min_bkv``).  A prefill bucket ranks the
    causal ``(cb, cb, d)`` and takes the first.

    **Units.**  The port's ``t_ecm`` is seconds for one head's whole
    ``(sq, skv)`` problem; the reference's ``cy_per_cl`` is cycles per
    cache line of attention output, which its ``o_lines_per_token`` (the
    output lines of a token over every head and layer) scales to a
    token.  Folding the per-line step into the whole problem, the cycles
    stay the reference's unit, so ``seconds(cycles, n) = cycles /
    (clock_hz * n)`` and the engine are unchanged::

        decode cycles a token = t_ecm(1, cb) * clock_hz * heads * layers
        prefill cycles        = t_ecm(cb, cb) / cb * prompt_len
                                * clock_hz * heads * layers

    (a decode token's output is one row of each head; a prefill bucket's
    ``t_ecm`` covers ``cb`` rows of it).

    **Rankings** are cached on disk (``core/diskcache.py``, kind
    ``"bucket-rank"``, keyed by the machine's fingerprint), so a warm
    restart ranks nothing.  A different machine handed in (``machine``
    assigned: the calibrated one for the prior) has another fingerprint,
    and every table is rebuilt on next access.  ``calib`` starts at 1.0
    per bucket and is pulled toward measured/predicted by
    :meth:`recalibrate`; the multiplier is applied after the prediction,
    so no table is rebuilt.  ``counters`` count rankings computed
    (``ranked``), served from the disk cache (``from_cache``) and whole
    rebuilds (``rebuilds``).
    """

    def __init__(self, machine: GPUMachineModel = H100_SXM,
                 model: ServingModel = ServingModel(), *,
                 min_ctx: int = 128, max_ctx: int = 16384,
                 source: str = "attention"):
        if source == "compose":
            raise NotImplementedError(
                "bucket source 'compose': the whole-model composition "
                "engine is not ported yet (ROADMAP §1 item 7)")
        if source != "attention":
            raise ValueError(f"unknown bucket source {source!r}: "
                             f"expected 'attention' or 'compose'")
        self.machine = machine
        self.model = model
        self.min_ctx = min_ctx
        self.max_ctx = max_ctx
        self.source = source
        self.calib: dict[tuple[str, int], float] = {}
        self.counters = {"ranked": 0, "from_cache": 0, "rebuilds": 0}
        self._decode: dict[int, dict] = {}
        self._prefill: dict[int, dict] = {}
        #: the machine the tables were built on, and its fingerprint
        self._token_machine = None
        self._model_token = None
        #: the ranked (data, model) device split; ``None`` until the
        #: engine installs one (trivially all-DP) or :meth:`remesh`
        #: re-ranks it after a device count change
        self.mesh_plan: dict | None = None

    # -- bucket construction ------------------------------------------------

    def ctx_bucket(self, ctx: int) -> int:
        return pow2_bucket(int(ctx), self.min_ctx, self.max_ctx)

    def _refresh_if_stale(self) -> None:
        """Rebuild every table when ``machine`` is another machine than
        the one they were built on (by content: its fingerprint)."""
        if self.machine is self._token_machine:
            return
        tok = diskcache.machine_fingerprint(self.machine)
        self._token_machine = self.machine
        if tok != self._model_token:
            if self._model_token is not None:
                self._decode.clear()
                self._prefill.clear()
                self.counters["rebuilds"] += 1
            self._model_token = tok

    def _ranking_cache_key(self, kind: str, cb: int) -> tuple:
        return ("bucket-rank", kind, cb, self.model.d, self.model.elem_bytes)

    def _cached_prior(self, kind: str, cb: int):
        """The bucket's ranking from the on-disk cache, or ``None``."""
        hit = diskcache.get("bucket-rank", self._ranking_cache_key(kind, cb),
                            machine=self.machine)
        if hit is not None:
            self.counters["from_cache"] += 1
        return hit

    def _persist_ranking(self, kind: str, cb: int, ranked) -> None:
        diskcache.put("bucket-rank", self._ranking_cache_key(kind, cb),
                      ranked, machine=self.machine)

    def _ranking(self, kind: str, cb: int) -> list[dict]:
        ranked = self._cached_prior(kind, cb)
        if ranked is None:
            d = self.model.d
            dims = (1, cb, d) if kind == "decode" else (cb, cb, d)
            ranked = rank(dims, self.machine, objective="attention",
                          causal=kind == "prefill",
                          elem_bytes=self.model.elem_bytes)
            self.counters["ranked"] += 1
            self._persist_ranking(kind, cb, ranked)
        return ranked

    def _per_head_layer(self) -> float:
        """Cycles a second times the heads and layers a token crosses."""
        return self.machine.clock_hz * self.model.heads * self.model.layers

    def _decode_entry(self, cb: int) -> dict:
        self._refresh_if_stale()
        ent = self._decode.get(cb)
        if ent is None:
            one_row = [r for r in self._ranking("decode", cb)
                       if r["block"][0] == 1]
            scale = self._per_head_layer()
            ent = {
                "best_bkv": one_row[0]["block"][1],
                "min_bkv": min(r["block"][1] for r in one_row),
                "cy_per_token": {r["block"][1]: r["t_ecm"] * scale
                                 for r in one_row},
            }
            self._decode[cb] = ent
        return ent

    def _prefill_entry(self, cb: int) -> dict:
        self._refresh_if_stale()
        ent = self._prefill.get(cb)
        if ent is None:
            best = self._ranking("prefill", cb)[0]
            ent = {"block": best["block"],
                   "cy_per_prompt_token":
                       best["t_ecm"] / cb * self._per_head_layer()}
            self._prefill[cb] = ent
        return ent

    def decode_block(self, ctx: int, *, smallest: bool = False) -> int:
        """The ranked KV block size for this context bucket (the
        degradation ladder's level-2 fallback picks the smallest)."""
        ent = self._decode_entry(self.ctx_bucket(ctx))
        return ent["min_bkv"] if smallest else ent["best_bkv"]

    # -- predictions --------------------------------------------------------

    def decode_cy_per_token(self, ctx: int, *, smallest_block: bool = False,
                            calibrated: bool = True) -> float:
        """Predicted core cycles to decode one token at this context."""
        cb = self.ctx_bucket(ctx)
        ent = self._decode_entry(cb)
        bkv = ent["min_bkv"] if smallest_block else ent["best_bkv"]
        cy = ent["cy_per_token"][bkv]
        if calibrated:
            cy *= self.calib.get(("decode", cb), 1.0)
        return cy

    def prefill_cy(self, prompt_len: int, *, calibrated: bool = True
                   ) -> float:
        """Predicted core cycles to prefill a prompt (all layers/heads)."""
        cb = self.ctx_bucket(prompt_len)
        cy = self._prefill_entry(cb)["cy_per_prompt_token"] * prompt_len
        if calibrated:
            cy *= self.calib.get(("prefill", cb), 1.0)
        return cy

    def seconds(self, cycles: float, n_devices: int = 1) -> float:
        """Cycles -> virtual seconds over ``n_devices`` data-parallel
        devices (requests partition across devices; the step ends when
        the slowest share does — modeled as an even split)."""
        return cycles / (self.machine.clock_hz * max(n_devices, 1))

    def remesh(self, n_devices: int, *, batch: int = 16) -> dict:
        """Re-rank the (data, model) split of the serving mesh for a new
        device count — the device-loss path.

        Tensor-parallel ``model`` ways shard the heads (cutting per-token
        decode latency by ``model``) but pay a ring all-reduce of the
        attention output over NVLink every token (the machine's
        ``nvlink_bytes_per_s``, a data-sheet prior), while data-parallel
        ways multiply throughput with no collective.  Splits are ranked
        by predicted step seconds at an even ``batch`` split over the
        data ways.  Only already-built decode buckets are consulted
        (falling back to ``min_ctx``), so re-ranking never grows the
        bucket tables.
        """
        link_bw = self.machine.nvlink_bytes_per_s
        if link_bw is None:
            raise ValueError(f"{self.machine.name}: no NVLink rate to price "
                             f"the all-reduce")
        n = max(int(n_devices), 1)
        cb = max(self._decode, default=self.min_ctx)
        cy = self.decode_cy_per_token(cb, calibrated=False)
        # row-parallel attention output: d_model activations per token
        # per layer, ring all-reduce moves 2*(m-1)/m of the payload
        ar_bytes = (2.0 * self.model.layers * self.model.heads
                    * self.model.d * self.model.elem_bytes)
        plans = []
        m_ways = 1
        while m_ways <= n:
            if n % m_ways == 0:
                data = n // m_ways
                t_tok = cy / (self.machine.clock_hz * m_ways)
                if m_ways > 1:
                    t_tok += ar_bytes * (m_ways - 1) / m_ways / link_bw
                t_step = t_tok * -(-max(batch, 1) // data)
                plans.append({"data": data, "model": m_ways,
                              "t_step_s": t_step, "ctx_bucket": cb})
            m_ways *= 2
        plans.sort(key=lambda p: (p["t_step_s"], p["model"]))
        self.mesh_plan = plans[0]
        return self.mesh_plan

    # -- calibration --------------------------------------------------------

    def recalibrate(self, kind: str, ctx: int, ratio: float,
                    alpha: float = 0.75) -> float:
        """Pull the bucket's multiplier toward ``measured/predicted``;
        returns the new value.  The multiplier is applied after the
        prediction, so no table is rebuilt."""
        key = (kind, self.ctx_bucket(ctx))
        old = self.calib.get(key, 1.0)
        new = (1.0 - alpha) * old + alpha * old * ratio
        self.calib[key] = new
        return new


# ---------------------------------------------------------------------------
# Engine configuration
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class EngineConfig:
    """Knobs of one engine instance (all deterministic).  ``machine`` is
    the card the buckets rank on (the data sheet's H100 SXM, or a
    calibrated ``GPUMachineModel``); the candidates are the compiled
    tilings, so the reference's ``bkv_candidates`` has no counterpart."""

    machine: GPUMachineModel = H100_SXM
    n_devices: int = 4
    max_batch: int = 16
    min_ctx: int = 128
    max_ctx: int = 16384
    #: true hardware time as a multiple of the light-speed prediction
    #: (1.0 = the model is exact; the fault harness perturbs per step)
    hw_factor: float = 1.0
    #: measured/predicted ratio beyond which a step triggers bucket
    #: re-calibration (either direction)
    recalib_threshold: float = 1.5
    recalib_alpha: float = 0.75
    #: slack multiplier on predicted finish vs deadline at admission
    admission_slack: float = 1.0
    max_steps: int = 100_000
    seed: int = 0
    #: where BucketModel sources its predictions: "attention" (the ranked
    #: attention model); "compose" waits for ROADMAP §1 item 7
    bucket_source: str = "attention"


@dataclass
class StepRecord:
    """One executed engine step (deterministic trajectory element)."""

    step: int
    t_start: float
    batch: int
    prefills: int
    predicted_s: float
    measured_s: float
    degrade_level: int
    n_devices: int
    buckets: tuple[int, ...] = ()

    @property
    def ratio(self) -> float:
        return self.measured_s / self.predicted_s if self.predicted_s else 1.0


# ---------------------------------------------------------------------------
# The engine
# ---------------------------------------------------------------------------


class ServeEngine:
    """Continuous batching on a virtual clock, scheduled by the ECM
    model.  See the module docstring for the loop structure; public
    results are ``log`` (the decision/event log), ``steps`` (per-step
    predicted vs measured) and :meth:`summary`."""

    def __init__(self, cfg: EngineConfig = EngineConfig(),
                 model: ServingModel = ServingModel(), *,
                 retry: RetryPolicy = RetryPolicy(),
                 degrade: DegradationPolicy = DegradationPolicy()):
        self.cfg = cfg
        self.model = model
        self.retry = retry
        self.degrade = degrade
        self.buckets = BucketModel(
            cfg.machine, model, min_ctx=cfg.min_ctx, max_ctx=cfg.max_ctx,
            source=cfg.bucket_source)
        # all-DP is the trivial split; device loss re-ranks via remesh()
        self.buckets.mesh_plan = {"data": cfg.n_devices, "model": 1,
                                  "t_step_s": None, "ctx_bucket": None}
        self.rng = np.random.default_rng(cfg.seed)
        self.now = 0.0
        self.step_idx = 0
        self.level = 0
        self.n_devices = cfg.n_devices
        self.log: list[dict] = []
        self.steps: list[StepRecord] = []
        self.requests: list[Request] = []
        # optional KV page store on a DeviceMesh (resharded on device loss)
        self.mesh = None
        self.kv_store = None
        self.kv_spec = None
        self.kv_profile = None

    # -- logging ------------------------------------------------------------

    def _log(self, event: str, **fields) -> dict:
        rec = {"t": round(self.now, 9), "step": self.step_idx,
               "event": event, **fields}
        self.log.append(rec)
        return rec

    def events(self, *names: str) -> list[dict]:
        return [e for e in self.log if not names or e["event"] in names]

    # -- optional real KV store (exercised by the device-loss fault) --------

    def attach_kv_store(self, mesh, *, n_pages: int = 64,
                        page_tokens: int = 16):
        """Attach a KV-page store of DTensors sharded over ``mesh``'s
        ``data`` axis (``dist.sharding.param_shardings``, the profile
        ``{"pages": "data"}``), the pages and the page table the
        reference's ``arange``s; the device-loss fault reshards it through
        ``repro_torch.train.elastic`` (values must survive bit-identically).
        Collective: every rank of the process group calls it."""
        import torch

        from ..dist.sharding import ShardingProfile, param_shardings
        from ..models.common import ParamSpec

        d = self.model.d
        spec = {"kv_pages": ParamSpec(shape=(n_pages, page_tokens, d),
                                      axes=("pages", None, None)),
                "page_table": ParamSpec(shape=(n_pages,), axes=("pages",),
                                        dtype=torch.int32)}
        profile = ShardingProfile("kv_pages", rules={"pages": "data"})
        whole = {
            "kv_pages": torch.arange(n_pages * page_tokens * d,
                                     dtype=torch.float32
                                     ).reshape(n_pages, page_tokens, d),
            "page_table": torch.arange(n_pages, dtype=torch.int32),
        }
        shardings = param_shardings(spec, mesh, profile)
        self.kv_store = {k: shardings[k].distribute(whole[k]) for k in spec}
        self.kv_spec = spec
        self.kv_profile = profile
        self.mesh = mesh
        return self.kv_store

    # -- derived settings ---------------------------------------------------

    @property
    def effective_max_batch(self) -> int:
        return max(self.cfg.max_batch // (2 if self.level >= 1 else 1), 1)

    @property
    def smallest_blocks(self) -> bool:
        return self.level >= 2

    # -- predictions --------------------------------------------------------

    def _batch_cycles(self, running: list[Request],
                      prefills: list[Request], *, calibrated: bool) -> float:
        cy = sum(self.buckets.decode_cy_per_token(
            r.context_len, smallest_block=self.smallest_blocks,
            calibrated=calibrated) for r in running)
        cy += sum(self.buckets.prefill_cy(r.prompt_len,
                                          calibrated=calibrated)
                  for r in prefills)
        return cy

    def predict_step_s(self, running: list[Request],
                       prefills: list[Request] = (), *,
                       calibrated: bool = True,
                       n_devices: int | None = None) -> float:
        """The scheduler's core query: predicted next-step seconds."""
        return self.buckets.seconds(
            self._batch_cycles(list(running), list(prefills),
                               calibrated=calibrated),
            n_devices if n_devices is not None else self.n_devices)

    def predict_finish_s(self, req: Request, batch_size: int) -> float:
        """Predicted completion time if ``req`` were admitted into a
        batch of ``batch_size`` now: prefill (if KV is cold) plus the
        remaining decode steps, each at the batch's predicted step
        time (context frozen at admission — first-order, like the
        paper's stream counting)."""
        per_req = self.buckets.decode_cy_per_token(
            req.context_len, smallest_block=self.smallest_blocks)
        step_s = self.buckets.seconds(per_req * max(batch_size, 1),
                                      self.n_devices)
        prefill_s = 0.0
        if req.tokens_done == 0:
            prefill_s = self.buckets.seconds(
                self.buckets.prefill_cy(req.prompt_len), self.n_devices)
        return self.now + prefill_s + req.remaining_tokens * step_s

    # -- the loop -----------------------------------------------------------

    def run(self, requests: list[Request], faults=None) -> dict:
        """Serve ``requests`` to completion; returns :meth:`summary`.

        ``faults`` is a :class:`.faults.FaultInjector` (or
        ``None``).  The loop ends when every request is terminal; it
        raises if ``cfg.max_steps`` is exceeded (a hung loop must fail,
        not stall)."""
        from .faults import apply_device_loss

        self.requests = list(requests)
        pending = sorted(self.requests, key=lambda r: (r.arrival_s, r.rid))
        queue: list[Request] = []
        running: list[Request] = []

        while pending or queue or running:
            if self.step_idx >= self.cfg.max_steps:
                raise RuntimeError(
                    f"serve loop exceeded max_steps={self.cfg.max_steps} "
                    f"({len(pending)} pending, {len(queue)} queued, "
                    f"{len(running)} running)")

            # 1. advance the clock when idle (to the next arrival or the
            #    earliest backoff-eligible queued request)
            if not running:
                times = [r.arrival_s for r in pending[:1]] \
                    + [r.eligible_s for r in queue]
                if times:
                    self.now = max(self.now, min(times))

            # 2. arrivals
            while pending and pending[0].arrival_s <= self.now:
                queue.append(pending.pop(0))

            # 3. deadline sweep: cancel queued requests that can no
            #    longer finish even solo (ECM-predicted floor)
            for r in list(queue):
                if self.predict_finish_s(r, 1) > r.deadline_s \
                        and self.now > r.arrival_s:
                    if self.predict_finish_s(r, 1) - r.deadline_s \
                            < self.buckets.seconds(
                                self.buckets.decode_cy_per_token(
                                    r.context_len), self.n_devices):
                        continue  # marginal: give admission a chance
                    r.state = RequestState.CANCELLED
                    r.finish_s = self.now
                    r.reason = "deadline unreachable"
                    queue.remove(r)
                    self._log("cancel", rid=r.rid,
                              predicted_finish_s=self.predict_finish_s(r, 1),
                              deadline_s=r.deadline_s)

            # 4. degradation ladder on the predicted next-step time
            pressure = self.predict_step_s(
                running if running else queue[: self.effective_max_batch])
            new_level = self.degrade.next_level(self.level, pressure)
            if new_level != self.level:
                self._log("degrade" if new_level > self.level else "restore",
                          level=new_level, from_level=self.level,
                          predicted_step_s=pressure,
                          step_budget_s=self.degrade.step_budget_s)
                self.level = new_level
            if self.level >= 3:
                self._shed_queue(queue)

            # 5. admission (priority, then deadline, then rid)
            prefills = self._admit(queue, running)

            if not running:
                if not pending and not queue:
                    break
                continue

            # 6. one continuous-batching step
            self._execute_step(running, prefills, queue, faults,
                               apply_device_loss)

        return self.summary()

    # -- loop pieces --------------------------------------------------------

    def _shed_queue(self, queue: list[Request]) -> None:
        """Level-3 action: shed the lowest-priority queued requests
        whose ECM-predicted finish misses their deadline."""
        for r in sorted(queue, key=lambda r: (-r.priority, r.rid)):
            predicted = self.predict_finish_s(r, self.effective_max_batch)
            if predicted * self.cfg.admission_slack > r.deadline_s:
                r.state = RequestState.SHED
                r.finish_s = self.now
                r.reason = "load shed"
                queue.remove(r)
                self._log("shed", rid=r.rid, priority=r.priority,
                          predicted_finish_s=predicted,
                          deadline_s=r.deadline_s)
                return  # one per step: pressure re-evaluated next round

    def _admit(self, queue: list[Request],
               running: list[Request]) -> list[Request]:
        prefills: list[Request] = []
        queue.sort(key=lambda r: (r.priority, r.deadline_s, r.rid))
        for r in list(queue):
            if len(running) >= self.effective_max_batch:
                break
            if r.eligible_s > self.now:
                continue  # backoff window still open
            if r.prompt_len + r.gen_len > self.cfg.max_ctx:
                r.state = RequestState.SHED
                r.finish_s = self.now
                r.reason = "context exceeds max_ctx"
                queue.remove(r)
                self._log("reject", rid=r.rid, reason=r.reason,
                          context=r.prompt_len + r.gen_len,
                          max_ctx=self.cfg.max_ctx)
                continue
            predicted = self.predict_finish_s(r, len(running) + 1)
            if predicted * self.cfg.admission_slack > r.deadline_s:
                # would blow the deadline at this batch size; if even a
                # solo run cannot make it, reject now (terminal,
                # logged) instead of queueing a hopeless request
                solo = self.predict_finish_s(r, 1)
                if solo * self.cfg.admission_slack > r.deadline_s:
                    r.state = RequestState.SHED
                    r.finish_s = self.now
                    r.reason = "deadline infeasible at admission"
                    queue.remove(r)
                    self._log("reject", rid=r.rid, reason=r.reason,
                              predicted_finish_s=solo,
                              deadline_s=r.deadline_s)
                continue
            queue.remove(r)
            r.state = RequestState.RUNNING
            r.admitted_s = self.now
            running.append(r)
            if r.tokens_done == 0:
                prefills.append(r)
            self._log("admit", rid=r.rid, batch=len(running),
                      predicted_finish_s=predicted, deadline_s=r.deadline_s,
                      ctx_bucket=self.buckets.ctx_bucket(r.context_len))
        return prefills

    def _execute_step(self, running: list[Request],
                      prefills: list[Request], queue: list[Request],
                      faults, apply_device_loss) -> None:
        cfg = self.cfg

        # fault: device loss lands before the step executes
        if faults is not None:
            for ev in faults.device_losses(self.step_idx):
                before = self.n_devices
                apply_device_loss(self, ev)
                self._bounce_lost_shard(running, queue, before,
                                        self.n_devices)
                self._requeue_overflow(running, queue, "device loss")
                # the surviving device count is a new machine shape:
                # re-rank the (data, model) split before the next step
                self.buckets.remesh(self.n_devices, batch=cfg.max_batch)

        predicted = self.predict_step_s(running, prefills)
        raw = self.predict_step_s(running, prefills, calibrated=False)
        factor = faults.step_factor(self.step_idx) if faults else 1.0
        measured = raw * cfg.hw_factor * factor

        bucket_set = tuple(sorted({self.buckets.ctx_bucket(r.context_len)
                                   for r in running}))
        self.steps.append(StepRecord(
            step=self.step_idx, t_start=self.now, batch=len(running),
            prefills=len(prefills), predicted_s=predicted,
            measured_s=measured, degrade_level=self.level,
            n_devices=self.n_devices, buckets=bucket_set))
        self.now += measured
        self.step_idx += 1

        # re-calibration: measured diverged from the calibrated
        # prediction beyond the threshold -> fold the ratio into every
        # bucket this step touched (the model must track the degraded
        # hardware before the next admission decision)
        ratio = measured / predicted if predicted > 0 else 1.0
        if ratio > cfg.recalib_threshold or ratio < 1.0 / cfg.recalib_threshold:
            for cb in bucket_set:
                new = self.buckets.recalibrate("decode", cb, ratio,
                                               cfg.recalib_alpha)
                self._log("recalibrate", kind="decode", ctx_bucket=cb,
                          predicted_s=predicted, measured_s=measured,
                          ratio=ratio, calibration=new)

        # token accounting + completions
        for r in list(running):
            r.tokens_done += 1
            if r.tokens_done >= r.gen_len:
                r.state = RequestState.DONE
                r.finish_s = self.now
                running.remove(r)
                self._log("complete", rid=r.rid,
                          latency_s=r.finish_s - r.arrival_s,
                          met_deadline=bool(r.finish_s <= r.deadline_s))

        # fault: corrupted KV page detected at step end -> drop the
        # request's pages and retry from prefill (bounded)
        if faults is not None:
            for ev in faults.corruptions(self.step_idx - 1):
                victim = self._pick_victim(running, ev)
                if victim is None:
                    continue
                self._log("kv_corrupt", rid=victim.rid,
                          ctx_bucket=self.buckets.ctx_bucket(
                              victim.context_len))
                self._bounce(victim, running, queue, "corrupted KV page")

    def _pick_victim(self, running: list[Request], ev) -> "Request | None":
        if not running:
            return None
        return running[ev.slot % len(running)]

    def _bounce_lost_shard(self, running: list[Request],
                           queue: list[Request], before: int,
                           after: int) -> None:
        """Re-admit the requests whose KV pages lived on the lost
        devices.  Pages round-robin over the data axis (request ``i``
        of the rid-sorted batch on device ``i mod n``), so losing the
        upper half of the axis loses the requests at positions with
        ``i mod before >= after`` — those re-prefill after re-admission
        (their pages are gone)."""
        if after >= before:
            return
        ordered = sorted(running, key=lambda r: r.rid)
        victims = [r for i, r in enumerate(ordered) if i % before >= after]
        for r in victims:
            self._bounce(r, running, queue, "device loss")

    def _requeue_overflow(self, running: list[Request],
                          queue: list[Request], why: str) -> None:
        """After capacity shrank (device loss), bounce the lowest-
        priority overflow back to the queue for re-admission."""
        running.sort(key=lambda r: (r.priority, r.deadline_s, r.rid))
        while len(running) > self.effective_max_batch:
            victim = running.pop()  # lowest priority, latest deadline
            self._bounce(victim, None, queue, why, drop_kv=False)

    def _bounce(self, req: Request, running: "list[Request] | None",
                queue: list[Request], why: str, *,
                drop_kv: bool = True) -> None:
        """Fault path re-admission: bounded retry with exponential
        backoff + jitter; KV drop forces a re-prefill."""
        if running is not None and req in running:
            running.remove(req)
        req.retries += 1
        req.requeues += 1
        if self.retry.exhausted(req.retries):
            req.state = RequestState.FAILED
            req.finish_s = self.now
            req.reason = f"retries exhausted after {why}"
            self._log("fail", rid=req.rid, reason=req.reason,
                      retries=req.retries)
            return
        if drop_kv:
            req.tokens_done = 0  # pages dropped: decode restarts cold
        backoff = self.retry.backoff_s(req.retries - 1, self.rng)
        req.state = RequestState.QUEUED
        req.eligible_s = self.now + backoff
        queue.append(req)
        self._log("requeue", rid=req.rid, reason=why, retries=req.retries,
                  backoff_s=backoff, eligible_s=req.eligible_s)

    # -- results ------------------------------------------------------------

    def summary(self) -> dict:
        """Deterministic run summary (virtual-clock throughput and
        latency, model accuracy, recovery accounting)."""
        reqs = self.requests
        done = [r for r in reqs if r.state is RequestState.DONE]
        lost = [r for r in reqs if not r.terminal]
        tokens = sum(r.tokens_done for r in reqs)
        t0 = min((r.arrival_s for r in reqs), default=0.0)
        makespan = max(self.now - t0, 1e-12)
        lat = sorted(r.finish_s - r.arrival_s for r in done)
        ratios = [s.ratio for s in self.steps]
        counts: dict[str, int] = {}
        for e in self.log:
            counts[e["event"]] = counts.get(e["event"], 0) + 1
        terminal: dict[str, int] = {}
        for r in reqs:
            terminal[r.state.value] = terminal.get(r.state.value, 0) + 1
        return {
            "requests": len(reqs),
            "completed": len(done),
            "lost": len(lost),
            "terminal": terminal,
            "tokens": int(tokens),
            "steps": len(self.steps),
            "makespan": float(makespan),
            "tok_rate": float(tokens / makespan),
            "latency_p50": float(np.percentile(lat, 50)) if lat else None,
            "latency_p99": float(np.percentile(lat, 99)) if lat else None,
            "deadline_hits": sum(1 for r in done
                                 if r.finish_s <= r.deadline_s),
            "step_pred_measured": {
                "mean_ratio": float(np.mean(ratios)) if ratios else 1.0,
                "max_ratio": float(np.max(ratios)) if ratios else 1.0,
            },
            "recovery": {
                "requeued": sum(r.requeues for r in reqs),
                "retried": sum(1 for r in reqs if r.retries),
                "recovered": sum(1 for r in done if r.retries),
            },
            "degrade_max_level": max(
                (s.degrade_level for s in self.steps), default=0),
            "events": counts,
            "n_devices_final": self.n_devices,
            "calibration": {f"{k}:{cb}": v
                            for (k, cb), v in sorted(self.buckets.calib.items())},
        }
