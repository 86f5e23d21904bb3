"""Model-guided serving: continuous batching with ECM admission control
(the reference's ``repro/serve``, on the card's model).

The ECM model predicts step time from first principles, which makes it
usable *online*: this package puts the card's attention predictions
(``core/autotune.py`` ``rank`` on a ``GPUMachineModel``) inside a
continuous-batching serving loop as the scheduler's brain.  Admission
control, degradation under pressure and fault recovery are all decided
against — and logged with — the model's predicted step times.  The
engine's clock is virtual; ``chip_smoke.py`` launches the split decode
route at the buckets' picks on the card.

Modules:

* :mod:`.trace` — seedable synthetic heavy-traffic traces;
* :mod:`.policy` — SLO classes, bounded retry with backoff, the
  degradation ladder;
* :mod:`.engine` — the continuous-batching engine on a virtual clock,
  with per-(batch, context) bucket predictions and online
  re-calibration;
* :mod:`.faults` — deterministic fault injection (device loss via
  ``repro_torch.train.elastic``, slow steps, corrupted KV pages).
"""
from .engine import BucketModel, EngineConfig, ServeEngine, ServingModel
from .faults import (
    PRESETS,
    DeviceLoss,
    FaultInjector,
    FaultPlan,
    KVCorrupt,
    SlowWindow,
    fault_plan,
)
from .policy import (
    SLO_CLASSES,
    DegradationPolicy,
    RequestState,
    RetryPolicy,
    SLOClass,
    slo_class,
)
from .trace import Request, TraceConfig, synthetic_trace

__all__ = [
    "BucketModel", "EngineConfig", "ServeEngine", "ServingModel",
    "DeviceLoss", "FaultInjector", "FaultPlan", "KVCorrupt", "PRESETS",
    "SlowWindow", "fault_plan",
    "SLO_CLASSES", "DegradationPolicy", "RequestState", "RetryPolicy",
    "SLOClass", "slo_class",
    "Request", "TraceConfig", "synthetic_trace",
]
