"""Energy-to-solution and EDP of one ECM model (paper §III-D, Figs. 5/6).

The reference's ``repro/core/energy.py`` views over the engine in
:mod:`.scaling`: :class:`FrequencyScaledECM` (the frequency behaviour of
one model), :func:`energy_grid` (energy, EDP and runtime over frequency x
cores from a machine's :class:`~.machine.ChipPower`) and
:func:`best_config` (the minimum of a grid).  The power model is ``P(n, f) = P_idle + n (p0 + p1 f
+ p2 f^2)``; energy-to-solution is ``E = P T`` and ``EDP = P T^2``.

The reference's ``energy_grid`` takes a ``ChipPower`` and a core count
and puts them on its Haswell machine; the port's takes the machine
itself, whose ``power`` and ``sm_count`` they are.  The reference's
``PowerModel`` alias of ``ChipPower`` is not copied: the port has no
caller of it.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np

from .ecm import ECMBatch, ECMModel
from .machine import GPUMachineModel
from .scaling import ChipScaling, frequency_scale


@dataclass(frozen=True)
class FrequencyScaledECM:
    """Frequency behaviour of one ECM model: in-core and in-cache cycles
    are frequency-invariant in cycles, the memory term fixed in seconds
    (so it scales with ``f`` in cycles); with ``bw_freq_coupled`` the
    sustained bandwidth degrades at low frequency towards
    ``coupling_floor``."""

    ecm: ECMModel
    f_nominal_ghz: float
    bw_freq_coupled: bool = False
    coupling_floor: float = 2.0 / 3.0

    def at_frequency(self, f_ghz: float) -> ECMModel:
        batch = frequency_scale(
            ECMBatch.from_models([self.ecm]), [f_ghz],
            f_nominal_ghz=self.f_nominal_ghz,
            bw_freq_coupled=self.bw_freq_coupled,
            coupling_floor=self.coupling_floor)
        return dataclasses.replace(batch.scalar((0, 0)), name=self.ecm.name)


def energy_grid(
    fecm: FrequencyScaledECM,
    machine: GPUMachineModel,
    *,
    f_ghz_list: list[float],
    total_work_units: float,
) -> dict[str, list[list[float]]]:
    """Energy-to-solution [J], EDP [Js] and runtime [s] over (frequency x
    cores): a view over :class:`~.scaling.ChipScaling` on one domain of
    the machine's ``sm_count`` cores, at its ``power``."""
    batch = frequency_scale(
        ECMBatch.from_models([fecm.ecm]), f_ghz_list,
        f_nominal_ghz=fecm.f_nominal_ghz,
        bw_freq_coupled=fecm.bw_freq_coupled,
        coupling_floor=fecm.coupling_floor)
    cs = ChipScaling(
        machine=machine,
        names=(fecm.ecm.name,),
        f_ghz=np.asarray(f_ghz_list, float),
        t_single=batch.predictions()[..., -1],
        bottleneck=batch.transfers[..., -1],
        t_ol=np.asarray([fecm.ecm.t_ol], float),
        cores_per_domain=machine.sm_count, n_domains=1)
    g = cs.energy(total_work_units)
    return {k: [[float(x) for x in row] for row in g[k][0]]
            for k in ("energy_J", "edp_Js", "runtime_s")}


def best_config(grid_rows: list[list[float]], f_ghz_list: list[float]
                ) -> tuple[float, int, float]:
    """Return (f_ghz, n_cores, value) minimising a grid."""
    best = (f_ghz_list[0], 1, grid_rows[0][0])
    for fi, row in enumerate(grid_rows):
        for ni, v in enumerate(row):
            if v < best[2]:
                best = (f_ghz_list[fi], ni + 1, v)
    return best
