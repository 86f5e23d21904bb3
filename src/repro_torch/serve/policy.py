"""Request-lifecycle policy: SLO classes, bounded retry, degradation (a
copy of the reference's ``repro/serve/policy.py``; framework-free).

Everything here is *decision rules over ECM predictions* — none of it
looks at wall clocks or device state.  The engine feeds each rule the
model's predicted step/finish times and acts on the verdict, logging the
prediction that triggered it (so every scheduling decision is traceable
to a model output).
"""
from __future__ import annotations

import enum
from dataclasses import dataclass


class RequestState(str, enum.Enum):
    """Lifecycle of one serving request.

    ``QUEUED -> RUNNING -> DONE`` is the happy path.  Faults bounce a
    request back to ``QUEUED`` (with a retry/backoff budget); admission
    control may end it early: ``SHED`` (load shedding / hopeless
    deadline at admission), ``CANCELLED`` (deadline blown while
    queued), ``FAILED`` (retry budget exhausted).  Every request ends
    in exactly one terminal state — a request that vanishes without one
    counts as *lost* (asserted zero by the bench and tests).
    """

    QUEUED = "queued"
    RUNNING = "running"
    DONE = "done"
    SHED = "shed"
    CANCELLED = "cancelled"
    FAILED = "failed"


TERMINAL_STATES = frozenset(
    {RequestState.DONE, RequestState.SHED, RequestState.CANCELLED,
     RequestState.FAILED})


# ---------------------------------------------------------------------------
# SLO classes
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class SLOClass:
    """One service class: a priority and a deadline budget.

    The deadline is ``arrival + base_budget_s + per_token_budget_s *
    gen_len`` — a base allowance for queueing + prefill plus a per-token
    decode allowance.  Priority 0 is the highest (admitted first, shed
    last).
    """

    name: str
    priority: int
    base_budget_s: float
    per_token_budget_s: float

    def deadline_s(self, arrival_s: float, gen_len: int) -> float:
        return arrival_s + self.base_budget_s \
            + self.per_token_budget_s * gen_len


#: the shipped service classes, tightest deadline first
SLO_CLASSES: tuple[SLOClass, ...] = (
    SLOClass("interactive", priority=0, base_budget_s=1.0,
             per_token_budget_s=0.05),
    SLOClass("standard", priority=1, base_budget_s=4.0,
             per_token_budget_s=0.10),
    SLOClass("batch", priority=2, base_budget_s=20.0,
             per_token_budget_s=0.50),
)


def slo_class(name: str) -> SLOClass:
    for c in SLO_CLASSES:
        if c.name == name:
            return c
    raise KeyError(f"unknown SLO class {name!r}; "
                   f"known: {[c.name for c in SLO_CLASSES]}")


# ---------------------------------------------------------------------------
# Bounded retry with exponential backoff + deterministic jitter
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class RetryPolicy:
    """Fault-triggered re-admission budget.

    A request bounced by a fault (corrupted KV page, device loss) is
    re-queued but only becomes *eligible* for admission again after
    ``backoff_base_s * backoff_mult**attempt`` plus jitter — the jitter
    is drawn from the engine's seeded generator, so recovery sequences
    are bit-reproducible while still de-synchronized.  After
    ``max_retries`` bounces the request is ``FAILED`` (terminal,
    accounted — never silently lost).
    """

    max_retries: int = 3
    backoff_base_s: float = 0.005
    backoff_mult: float = 2.0
    jitter_frac: float = 0.25

    def backoff_s(self, attempt: int, rng) -> float:
        base = self.backoff_base_s * self.backoff_mult ** max(attempt, 0)
        return base * (1.0 + self.jitter_frac * float(rng.random()))

    def exhausted(self, retries: int) -> bool:
        return retries > self.max_retries


# ---------------------------------------------------------------------------
# Graceful degradation ladder
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class DegradationPolicy:
    """Pressure ladder driven by the ECM-predicted step time.

    The engine evaluates the predicted time of the *next* step (current
    batch at current settings) every iteration; when the prediction
    exceeds ``step_budget_s`` the ladder escalates one level, and when
    it falls back below ``restore_fraction * step_budget_s`` it
    de-escalates:

    =====  =====================================================
    level  effect
    =====  =====================================================
    0      normal operation
    1      max batch halved (shrinks the very term that blew the
           budget: predicted step time is the batch's summed
           per-request cycles)
    2      decode KV blocks fall back to the smallest ranked
           candidate (smaller resident tiles; the light-speed
           prediction ties, the working set shrinks)
    3      lowest-priority queued requests whose predicted finish
           misses their deadline are shed
    =====  =====================================================

    Every transition is logged with the predicted step time that
    triggered it.
    """

    step_budget_s: float = 0.02
    restore_fraction: float = 0.5
    max_level: int = 3

    def next_level(self, level: int, predicted_step_s: float) -> int:
        if predicted_step_s > self.step_budget_s:
            return min(level + 1, self.max_level)
        if predicted_step_s < self.restore_fraction * self.step_budget_s:
            return max(level - 1, 0)
        return level
