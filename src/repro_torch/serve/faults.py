"""Deterministic fault injection for the serving engine (the reference's
``repro/serve/faults.py``).

Three fault classes, mirroring what a real serving fleet sees:

* :class:`DeviceLoss` — half the devices on one mesh axis disappear at
  a given step.  The engine loses throughput capacity (its per-step
  devisor), overflow requests bounce back to the queue for
  re-admission, and — when a ``DeviceMesh`` and a KV page store are
  attached — the store is resharded onto the surviving sub-mesh through
  ``repro_torch.train.elastic`` (values must survive bit-identically).
* :class:`SlowWindow` — a ``[start, stop)`` step window in which the
  measured step time is ``factor`` times the light-speed prediction
  (thermal throttling, a straggler host).  Measured >> predicted is
  exactly the signal the engine's re-calibration watches for, so a slow
  window must produce ``recalibrate`` events.
* :class:`KVCorrupt` — a KV page checksum fails after a step; the
  victim request's pages are dropped and the request retries from
  prefill under the bounded backoff policy.

A :class:`FaultPlan` is a frozen set of events; :class:`FaultInjector`
is the engine-facing accessor (plus the seed for backoff jitter — one
seed, one exact recovery sequence).  Everything is pure data: replaying
the same (trace, plan, seed) reproduces the identical log, which is how
the tests pin recovery sequences.
"""
from __future__ import annotations

from dataclasses import dataclass, field


@dataclass(frozen=True)
class DeviceLoss:
    """Lose half of ``axis`` just before ``step`` executes."""

    step: int
    axis: str = "data"


@dataclass(frozen=True)
class SlowWindow:
    """Steps in ``[start, stop)`` run ``factor`` times slower than the
    light-speed prediction."""

    start: int
    stop: int
    factor: float = 4.0


@dataclass(frozen=True)
class KVCorrupt:
    """A KV page checksum fails after ``step``; ``slot`` picks the
    victim position within the running batch (mod batch size)."""

    step: int
    slot: int = 0


@dataclass(frozen=True)
class FaultPlan:
    """One named, reproducible fault scenario."""

    name: str = "none"
    device_losses: tuple[DeviceLoss, ...] = ()
    slow_windows: tuple[SlowWindow, ...] = ()
    kv_corruptions: tuple[KVCorrupt, ...] = ()

    @classmethod
    def none(cls) -> "FaultPlan":
        return cls(name="none")

    @classmethod
    def device_loss(cls, step: int = 72, axis: str = "data") -> "FaultPlan":
        return cls(name="device_loss",
                   device_losses=(DeviceLoss(step=step, axis=axis),))

    @classmethod
    def slow_steps(cls, start: int = 60, stop: int = 70,
                   factor: float = 4.0) -> "FaultPlan":
        return cls(name="slow_step",
                   slow_windows=(SlowWindow(start, stop, factor),))

    @classmethod
    def kv_corruption(cls, steps: tuple[int, ...] = (66, 80),
                      slot: int = 0) -> "FaultPlan":
        return cls(name="kv_corruption",
                   kv_corruptions=tuple(KVCorrupt(step=s, slot=slot)
                                        for s in steps))


#: the bench's fault matrix, one column per class
PRESETS: dict[str, FaultPlan] = {
    "none": FaultPlan.none(),
    "device_loss": FaultPlan.device_loss(),
    "slow_step": FaultPlan.slow_steps(),
    "kv_corruption": FaultPlan.kv_corruption(),
}


def fault_plan(name: str) -> FaultPlan:
    try:
        return PRESETS[name]
    except KeyError:
        raise KeyError(f"unknown fault plan {name!r}; "
                       f"known: {sorted(PRESETS)}") from None


@dataclass
class FaultInjector:
    """Engine-facing view of a :class:`FaultPlan`."""

    plan: FaultPlan = field(default_factory=FaultPlan.none)

    def step_factor(self, step: int) -> float:
        """Multiplier on the measured time of ``step`` (slow windows
        compound, though presets never overlap)."""
        f = 1.0
        for w in self.plan.slow_windows:
            if w.start <= step < w.stop:
                f *= w.factor
        return f

    def device_losses(self, step: int) -> list[DeviceLoss]:
        return [ev for ev in self.plan.device_losses if ev.step == step]

    def corruptions(self, step: int) -> list[KVCorrupt]:
        return [ev for ev in self.plan.kv_corruptions if ev.step == step]


def apply_device_loss(engine, event: DeviceLoss) -> None:
    """Shrink the engine's capacity after ``event``.

    If the engine carries a ``DeviceMesh`` whose ``event.axis`` can
    shrink, the loss goes through ``repro_torch.train.elastic``: the mesh
    is halved on ``event.axis`` and the attached KV page store is
    resharded onto the survivors (logged with the shard counts).  Both
    are collective: every rank of the process group applies the event.
    Without a mesh, or with the axis already at 1, the loss is logical:
    the engine's data-parallel device count is halved, which degrades
    every subsequent step-time prediction the same way.
    """
    before = engine.n_devices
    resharded = False
    mesh = getattr(engine, "mesh", None)
    if mesh is not None:
        shape = dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))
        if shape.get(event.axis, 1) > 1:
            from ..train.elastic import remesh_state, shrink_mesh

            new_mesh = shrink_mesh(mesh, event.axis)
            if engine.kv_store is not None:
                engine.kv_store = remesh_state(
                    engine.kv_store, engine.kv_spec, new_mesh,
                    engine.kv_profile)
            engine.mesh = new_mesh
            engine.n_devices = max(engine.n_devices // 2, 1)
            resharded = True
    if not resharded:
        engine.n_devices = max(engine.n_devices // 2, 1)
    engine._log("device_loss", axis=event.axis, n_devices_before=before,
                n_devices_after=engine.n_devices, resharded=resharded,
                predicted_slowdown=before / engine.n_devices)
