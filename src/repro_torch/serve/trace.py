"""Synthetic heavy-traffic request traces (seedable, deterministic): a
copy of the reference's ``repro/serve/trace.py``, so one ``(config,
seed)`` draws the reference's trace field for field.

Arrivals are a Poisson process (exponential interarrivals); prompt and
generation lengths are drawn from small categorical mixes (the
(batch, context-length) bucket structure the engine schedules over);
each request carries an SLO class that fixes its priority and deadline.
Everything is drawn from one ``numpy`` generator, so a (config, seed)
pair names one exact trace — the fault-injection tests replay the same
trace under different fault plans and pin the recovery sequences.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from .policy import SLO_CLASSES, RequestState, SLOClass


@dataclass
class Request:
    """One serving request plus its mutable lifecycle.

    The immutable half (lengths, SLO, deadline) comes from the trace;
    the mutable half is owned by the engine.  ``eligible_s`` is the
    earliest admission time (pushed forward by retry backoff);
    ``reason`` records why a terminal state was entered.
    """

    rid: int
    arrival_s: float
    prompt_len: int
    gen_len: int
    slo: SLOClass

    state: RequestState = RequestState.QUEUED
    tokens_done: int = 0
    retries: int = 0
    requeues: int = 0
    eligible_s: float = 0.0
    admitted_s: "float | None" = None
    finish_s: "float | None" = None
    reason: str = ""

    def __post_init__(self):
        if self.eligible_s < self.arrival_s:
            self.eligible_s = self.arrival_s

    @property
    def priority(self) -> int:
        return self.slo.priority

    @property
    def deadline_s(self) -> float:
        return self.slo.deadline_s(self.arrival_s, self.gen_len)

    @property
    def context_len(self) -> int:
        """Current KV length: prompt + decoded tokens."""
        return self.prompt_len + self.tokens_done

    @property
    def remaining_tokens(self) -> int:
        return self.gen_len - self.tokens_done

    @property
    def terminal(self) -> bool:
        from .policy import TERMINAL_STATES
        return self.state in TERMINAL_STATES


@dataclass(frozen=True)
class TraceConfig:
    """Shape of the synthetic traffic mix."""

    n_requests: int = 64
    mean_interarrival_s: float = 0.01
    prompt_lens: tuple[int, ...] = (128, 512, 2048)
    prompt_weights: tuple[float, ...] = (0.50, 0.35, 0.15)
    gen_lens: tuple[int, ...] = (16, 64, 128)
    gen_weights: tuple[float, ...] = (0.40, 0.40, 0.20)
    #: probability of each SLO class, aligned with ``SLO_CLASSES``
    slo_weights: tuple[float, ...] = (0.50, 0.30, 0.20)
    classes: tuple[SLOClass, ...] = field(default=SLO_CLASSES)


def _norm(w) -> np.ndarray:
    a = np.asarray(w, float)
    return a / a.sum()


def synthetic_trace(cfg: TraceConfig = TraceConfig(), *,
                    seed: int = 0) -> list[Request]:
    """Draw one deterministic trace: ``(cfg, seed)`` -> the exact same
    request list every time."""
    rng = np.random.default_rng(seed)
    n = cfg.n_requests
    arrivals = np.cumsum(rng.exponential(cfg.mean_interarrival_s, size=n))
    prompts = rng.choice(cfg.prompt_lens, size=n, p=_norm(cfg.prompt_weights))
    gens = rng.choice(cfg.gen_lens, size=n, p=_norm(cfg.gen_weights))
    slos = rng.choice(len(cfg.classes), size=n, p=_norm(cfg.slo_weights))
    return [
        Request(rid=i, arrival_s=float(arrivals[i]),
                prompt_len=int(prompts[i]), gen_len=int(gens[i]),
                slo=cfg.classes[int(slos[i])])
        for i in range(n)
    ]
