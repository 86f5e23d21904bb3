"""Chip scaling and energy on the card: Eq. 2 and §III-D as one batched
engine, the SM as the core.

A copy of the reference's ``repro/core/scaling.py`` building blocks and
engine on the port's ``ECMBatch`` and ``GPUMachineModel``:

* :func:`frequency_scale` appends a frequency axis to a batch: in-core
  and in-cache cycles are frequency-invariant in cycles, the memory edge
  is fixed in seconds, so in cycles it scales with ``f / f_nominal``
  (with the bandwidth-coupling floor where ``bw_freq_coupled``);
* :func:`fill_domains` is the domain-aware Eq. 2 curve; one card is one
  domain (``n_domains = 1``, ``cores_per_domain = sm_count``);
* :class:`ChipScaling` holds ``(workloads x frequencies)`` arrays and
  gives the saturation points, the performance surface, and the energy,
  EDP, runtime and power grids of the machine's :class:`~.machine.
  ChipPower` over ``(workloads x frequencies x SMs)``, with the ranked
  operating points and the best one per workload;
* :func:`scale_workloads` builds a ``ChipScaling`` from the one-SM ECMs
  (``core/gpu_ecm.py`` ``one_sm_ecm``) of the Table I ops named, on a
  calibrated machine at its one clock (the port sets no clock).  The port has no workload registry, so it takes op
  names where the reference takes registry workloads;
* :func:`scale_model` builds one from a whole model step: the one-SM
  aggregate of its op walk (``core/compose.py`` ``model_lowered``).

* :func:`gpu_dp_scaling` is Eq. 2 at card granularity: data-parallel
  scaling of one traced program over NVLink, delegating to
  ``core/mesh.py`` ``dp_scaling`` as the reference's ``tpu_dp_scaling``
  does.

Not copied: ``scaling_zoo`` and ``saturation_table`` (they walk a
registry of machines the port does not have).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .ecm import ECMBatch
from .gpu_ecm import one_sm_ecm
from .machine import GPUMachineModel

__all__ = ["ChipScaling", "fill_domains", "frequency_scale", "gpu_dp_scaling",
           "scale_model", "scale_workloads"]


def frequency_scale(batch: ECMBatch, f_ghz, *, f_nominal_ghz: float,
                    bw_freq_coupled: bool = False,
                    coupling_floor: float = 2.0 / 3.0) -> ECMBatch:
    """Vectorized DVFS view of a batch: appends a frequency axis.

    In-core and in-cache cycle counts live in the core clock domain and
    are frequency-invariant *in cycles*; the memory edge is fixed *in
    seconds*, so in core cycles it scales with ``f / f_nominal``.  On
    bandwidth-coupled machines the sustained bandwidth additionally
    degrades towards ``coupling_floor`` as the frequency drops.  Returns
    an :class:`ECMBatch` with batch shape ``B + (F,)``.
    """
    f = np.atleast_1d(np.asarray(f_ghz, float))                  # (F,)
    scale = f / f_nominal_ghz
    mem_cy = batch.transfers[..., -1, None] * scale              # B + (F,)
    if bw_freq_coupled:
        rel = np.minimum(1.0, coupling_floor
                         + (1 - coupling_floor) * scale)
        mem_cy = mem_cy / rel
    shape = mem_cy.shape
    cache = np.broadcast_to(batch.transfers[..., None, :-1],
                            shape + (batch.transfers.shape[-1] - 1,))
    transfers = np.concatenate([cache, mem_cy[..., None]], axis=-1)
    return ECMBatch(
        t_ol=np.broadcast_to(batch.t_ol[..., None], shape).copy(),
        t_nol=np.broadcast_to(batch.t_nol[..., None], shape).copy(),
        transfers=transfers, levels=batch.levels, names=batch.names,
        unit=batch.unit)


def fill_domains(p1, p_sat, n_cores: int, cores_per_domain: int,
                 n_domains: int, fill_domains_first: bool = True
                 ) -> np.ndarray:
    """Domain-aware Eq. 2 performance curves, vectorized over cores.

    ``p1`` (single-core performance) and ``p_sat`` (per-domain
    saturation performance; ``inf`` = no shared bottleneck) are
    broadcast-compatible arrays; the result appends a trailing axis of
    length ``n_cores``.  ``fill_domains_first=True`` fills one affinity
    domain after the other, each saturating on its own; ``False`` spreads
    the cores over one domain with ``n_domains`` times the bandwidth.  On
    one card (one domain) both are ``min(n p1, p_sat)``.
    """
    p1 = np.asarray(p1, float)[..., None]
    p_sat = np.asarray(p_sat, float)[..., None]
    n = np.arange(1, n_cores + 1, dtype=float)
    if not fill_domains_first:
        return np.minimum(n * p1, n_domains * p_sat)
    full = np.floor_divide(n, cores_per_domain)
    rem = n - full * cores_per_domain
    p = (full * np.minimum(cores_per_domain * p1, p_sat)
         + np.minimum(rem * p1, p_sat) * (rem > 0))
    return np.minimum(p, n_domains * p_sat)


@dataclass(frozen=True)
class ChipScaling:
    """Multicore scaling and energy of a workload batch on one machine,
    over a DVFS grid.  All arrays are ``(W, F)``-shaped (workloads x
    frequencies); performance and energy surfaces append a core axis
    ``(W, F, N)``.  Construct via :func:`scale_workloads`."""

    machine: GPUMachineModel
    names: tuple[str, ...]
    f_ghz: np.ndarray              # (F,)
    t_single: np.ndarray           # (W, F) mem-level cy per unit of work
    bottleneck: np.ndarray         # (W, F) per-domain bottleneck cy/unit
    t_ol: np.ndarray               # (W,) overlapping in-core cycles
    cores_per_domain: int
    n_domains: int

    @property
    def cores(self) -> int:
        return self.cores_per_domain * self.n_domains

    def _memo(self, key, build) -> np.ndarray:
        """Per-instance memo for derived grids: each is a pure function of
        the frozen fields; results are read-only, as they are shared."""
        grids = self.__dict__.get("_grids")
        if grids is None:
            grids = {}
            object.__setattr__(self, "_grids", grids)
        val = grids.get(key)
        if val is None:
            val = build()
            val.flags.writeable = False
            grids[key] = val
        return val

    def _n_sat_raw(self) -> np.ndarray:
        """(W, F) uncapped Eq. 2 points as floats; ``inf`` where the
        bottleneck term is zero (nothing to saturate)."""
        def build():
            bound = self.bottleneck > 0
            n = np.full(self.bottleneck.shape, np.inf)
            n[bound] = np.ceil(self.t_single[bound]
                               / self.bottleneck[bound])
            return n
        return self._memo("n_sat_raw", build)

    def core_bound(self) -> np.ndarray:
        """(W, F) booleans: the workload cannot saturate the shared
        bottleneck within one domain (no bottleneck term, or the Eq. 2
        point lies beyond the domain's core count)."""
        return self._memo(
            "core_bound",
            lambda: self._n_sat_raw() > self.cores_per_domain)

    def n_saturation(self) -> np.ndarray:
        """(W, F) Eq. 2 per-domain saturation points, capped at the
        domain's core count (core-bound workloads report the domain)."""
        return self._memo(
            "n_sat",
            lambda: np.minimum(self._n_sat_raw(),
                               self.cores_per_domain).astype(int))

    def n_saturation_chip(self) -> np.ndarray:
        """(W, F) chip-level saturation under balanced domain pinning:
        ``n_domains`` x the per-domain point; the chip for core-bound
        workloads."""
        return self._memo(
            "n_sat_chip",
            lambda: np.minimum(self.n_saturation() * self.n_domains,
                               self.cores))

    def saturation_summary(self, f_ghz: float | None = None
                           ) -> dict[str, dict]:
        """Per-workload Eq. 2 summary at one frequency (default: the
        machine's nominal clock)."""
        f = self.machine.nominal_ghz if f_ghz is None else f_ghz
        fi = int(np.argmin(np.abs(self.f_ghz - f)))
        n_dom, n_chip = self.n_saturation(), self.n_saturation_chip()
        core = self.core_bound()
        return {
            w: {"n_sat_domain": int(n_dom[i, fi]),
                "n_sat_chip": int(n_chip[i, fi]),
                "core_bound": bool(core[i, fi]),
                "t_single_cy": float(self.t_single[i, fi]),
                "bottleneck_cy": float(self.bottleneck[i, fi])}
            for i, w in enumerate(self.names)
        }

    def _p_sat(self, work_per_unit) -> np.ndarray:
        w = np.broadcast_to(np.asarray(work_per_unit, float),
                            self.bottleneck.shape)
        bound = self.bottleneck > 0
        return np.where(bound,
                        w / np.where(bound, self.bottleneck, 1.0), np.inf)

    def performance(self, n_cores: int | None = None,
                    work_per_unit=1.0, *,
                    fill_domains_first: bool = True) -> np.ndarray:
        """(W, F, N) performance surface in work units per core cycle
        (multiply by ``f * 1e9`` for units/s)."""
        def build():
            w = np.asarray(work_per_unit, float)
            p1 = w / self.t_single
            return fill_domains(p1, self._p_sat(work_per_unit),
                                n_cores or self.cores,
                                self.cores_per_domain,
                                self.n_domains, fill_domains_first)
        if type(work_per_unit) in (int, float):    # hashable -> memoizable
            return self._memo(("perf", n_cores, float(work_per_unit),
                               fill_domains_first), build)
        return build()

    def energy(self, total_work_units: float, *,
               n_cores: int | None = None,
               fill_domains_first: bool = True) -> dict[str, np.ndarray]:
        """(W, F, N) energy-to-solution [J], EDP [Js], runtime [s] and
        power [W] grids from the machine's ``ChipPower``."""
        perf = self.performance(n_cores, fill_domains_first=fill_domains_first)
        n_max = perf.shape[-1]
        f = self.f_ghz[None, :, None]
        n = np.arange(1, n_max + 1, dtype=float)[None, None, :]
        t_s = total_work_units / (perf * f * 1e9)
        watts = self.machine.power.watts(n, f) + np.zeros_like(t_s)
        energy = watts * t_s
        return {"energy_J": energy, "edp_Js": energy * t_s,
                "runtime_s": t_s, "watts": watts}

    def operating_points(self, total_work_units: float = 1.0, *,
                         objective: str = "edp",
                         n_cores: int | None = None,
                         fill_domains_first: bool = True,
                         top: int | None = None) -> list[dict]:
        """Every (workload, frequency, cores) operating point ranked by
        ``"performance"`` (min runtime), ``"energy"`` or ``"edp"``,
        best first (a stable sort, frequency-outer and cores-inner);
        ``top`` truncates."""
        key = {"performance": "runtime_s", "energy": "energy_J",
               "edp": "edp_Js"}
        if objective not in key:
            raise KeyError(f"unknown objective {objective!r}; "
                           f"pick one of {sorted(key)}")
        grids = self.energy(total_work_units, n_cores=n_cores,
                            fill_domains_first=fill_domains_first)
        obj = grids[key[objective]]                       # (W, F, N)
        flat = obj.reshape(-1)
        order = np.argsort(flat, kind="stable")
        if top is not None:
            order = order[:top]
        out = []
        for i in order:
            wi, fi, ni = np.unravel_index(i, obj.shape)
            out.append({
                "name": (self.names[wi] if self.names else str(int(wi))),
                "f_ghz": float(self.f_ghz[fi]),
                "n_cores": int(ni) + 1,
                "objective": objective,
                "value": float(flat[i]),
                "runtime_s": float(grids["runtime_s"][wi, fi, ni]),
                "energy_J": float(grids["energy_J"][wi, fi, ni]),
                "edp_Js": float(grids["edp_Js"][wi, fi, ni]),
            })
        return out

    def best(self, total_work_units: float = 1.0, *,
             objective: str = "edp", n_cores: int | None = None,
             fill_domains_first: bool = True) -> list[dict]:
        """The optimal ``(n, f)`` operating point per workload under
        ``objective``: the first minimum in the frequency-outer /
        cores-inner scan order."""
        pts = self.operating_points(total_work_units, objective=objective,
                                    n_cores=n_cores,
                                    fill_domains_first=fill_domains_first)
        seen: dict[str, dict] = {}
        for p in pts:
            seen.setdefault(p["name"], p)
        return [seen[n] for n in (self.names or sorted(seen))]


def _chip_scaling(batch: ECMBatch, machine: GPUMachineModel,
                  names: tuple[str, ...]) -> ChipScaling:
    """The chip-scaling engine of one-SM ECMs on ``machine`` at the card's
    one clock; one card is one domain of ``sm_count`` SMs."""
    f = np.asarray(machine.frequency_grid(), float)
    scaled = frequency_scale(batch, f, f_nominal_ghz=machine.nominal_ghz)
    return ChipScaling(
        machine=machine,
        names=names,
        f_ghz=f,
        t_single=scaled.predictions()[..., -1],
        bottleneck=scaled.transfers[..., -1],
        t_ol=np.asarray(batch.t_ol, float),
        cores_per_domain=machine.sm_count,
        n_domains=1,
    )


def scale_workloads(ops, machine: GPUMachineModel) -> ChipScaling:
    """The chip-scaling engine of the Table I ``ops`` on ``machine`` (a
    calibrated ``GPUMachineModel``: the one-SM ECM reads its L2 plateau),
    at the card's one clock.  One card is one domain of ``sm_count``
    SMs."""
    batch = ECMBatch.from_models([one_sm_ecm(op, machine) for op in ops])
    return _chip_scaling(batch, machine, tuple(ops))


def scale_model(config, machine: GPUMachineModel, *, phase: str = "decode",
                batch: int = 1, seq_len: int = 4096,
                context: int | None = None,
                elem_bytes: int = 4) -> ChipScaling:
    """Eq. 2 saturation / energy surfaces for a **whole model config** on a
    calibrated card.

    The composition (``core/compose.py``) walks one phase of the config
    and aggregates its ops into one one-SM record whose unit of work is
    one step (``model_lowered``); this function feeds that record to the
    same Eq. 2 machinery every single-kernel workload uses.  ``t_single``
    is the pipelined composed step time on one SM, the bottleneck term
    the step's summed HBM transfer cycles — so ``n_saturation()``,
    ``energy()`` and ``operating_points()`` answer "how many SMs does
    *this model step* need" directly.
    """
    from .compose import model_lowered

    lowered = model_lowered(config, machine, phase=phase, batch=batch,
                            seq_len=seq_len, context=context,
                            elem_bytes=elem_bytes)
    return _chip_scaling(lowered, machine, lowered.names)


# ---------------------------------------------------------------------------
# Eq. 2 over cards: the collectives as the shared bottleneck
# ---------------------------------------------------------------------------


def gpu_dp_scaling(resources, chip_counts=(1, 2, 4, 8, 16, 32, 64, 128,
                                           256), *,
                   machine: GPUMachineModel | None = None,
                   dtype_peak: float | None = None,
                   exposed_link_fraction: float | None = None) -> dict:
    """Eq. 2 at card granularity: data-parallel scaling of one program
    (the reference's ``tpu_dp_scaling``).

    ``resources`` describes the global program on one card (a
    ``core/hlo.py`` ``HLOResources``, or anything with ``flops``,
    ``bytes_accessed`` and a ``collectives`` list of ``CollectiveOp``).
    Spread over ``n`` cards the compute and HBM terms divide by ``n``,
    while the ring collectives' per-card wire bytes grow with ``(n-1)/n``
    towards a floor that plays the role of ``T_L3Mem`` in Eq. 2; the
    saturation count is ``n_S = ceil(T_single / T_link_floor)``.  Returns
    per-``n`` lists (``t_*_us`` in microseconds) and ``n_saturation``
    (``None`` without collectives).  Delegates to ``core/mesh.py``
    ``dp_scaling`` (``machine`` defaults to ``H100_SXM``)."""
    from .machine import H100_SXM
    from .mesh import dp_scaling

    return dp_scaling(resources, chip_counts, machine=machine or H100_SXM,
                      dtype_peak=dtype_peak,
                      exposed_link_fraction=exposed_link_fraction)
