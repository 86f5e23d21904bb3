"""Chip-level bottleneck and saturation (paper §IV-B, Eq. 2), on the card.

A copy of the reference's ``repro/core/saturation.py`` (``ScalingModel``,
``batch_curve``, ``batch_saturation``) on the port's ``ECMModel`` and
``ECMBatch``.  The SM takes the place of the paper's core: one SM's
performance scales linearly with the number of SMs until the shared
bottleneck, HBM, is hit::

    P(n) = min(n * P_ECM^mem, I * b_S)

with the saturation point ``n_S = ceil(T_ECM^mem / T_HBM)``.

**Core-bound workloads** (no bottleneck term) never hit the shared
bottleneck: they scale linearly to the whole card, so ``n_S = cores`` and
``P(n) = n * P_ECM``; a zero ``bottleneck_cycles`` is never divided by.

The reference's ``domain_scaling`` (Cluster-on-Die affinity domains) is
not copied: one card has no affinity domains.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

from .ecm import ECMModel


@dataclass(frozen=True)
class ScalingModel:
    """Multicore scaling of one ECM model on one machine."""

    ecm: ECMModel
    #: transfer time over the shared bottleneck edge (cy per unit of work);
    #: on the card the L2 <- HBM term, the last transfer by default.
    bottleneck_cycles: float
    #: cores (SMs) available (0 = unknown).  Caps ``n_saturation`` and is
    #: the reported saturation point for core-bound workloads.
    cores: int = 0

    @classmethod
    def from_ecm(cls, ecm: ECMModel, bottleneck_level: int = -1,
                 cores: int = 0) -> "ScalingModel":
        return cls(ecm=ecm, bottleneck_cycles=ecm.transfers[bottleneck_level],
                   cores=cores)

    @property
    def t_single(self) -> float:
        """Single-core in-memory runtime, cy per unit of work."""
        return self.ecm.prediction(len(self.ecm.levels) - 1)

    @property
    def core_bound(self) -> bool:
        """No shared-bottleneck term: the workload scales linearly."""
        return self.bottleneck_cycles <= 0.0

    @property
    def n_saturation(self) -> int:
        """Eq. 2: cores needed to saturate the bottleneck.  Core-bound
        workloads report the whole chip (``cores``); a known core count
        also caps the bandwidth-bound ceiling."""
        if self.core_bound:
            return max(self.cores, 1)
        n = math.ceil(self.t_single / self.bottleneck_cycles)
        return min(n, self.cores) if self.cores else n

    def performance(self, n_cores: int, work_per_unit: float = 1.0,
                    clock_hz: float | None = None) -> float:
        """P(n) in work units per cycle (or per second with ``clock_hz``)."""
        p_one = work_per_unit / self.t_single
        p = (n_cores * p_one if self.core_bound
             else min(n_cores * p_one, work_per_unit / self.bottleneck_cycles))
        return p * clock_hz if clock_hz else p

    def curve(self, n_cores: int, work_per_unit: float = 1.0,
              clock_hz: float | None = None) -> list[float]:
        return [self.performance(n, work_per_unit, clock_hz)
                for n in range(1, n_cores + 1)]


def batch_curve(batch, n_cores: int, work_per_unit=1.0,
                clock_hz: float | None = None,
                bottleneck_level: int = -1):
    """Vectorized Eq. 2 scaling surface for an :class:`~.ecm.ECMBatch`:
    P(n) for every batch element x n = 1..n_cores, shape
    ``B + (n_cores,)``.  Zero-bottleneck (core-bound) elements scale
    linearly."""
    t_single = batch.prediction(len(batch.levels) - 1)       # (B,)
    bottleneck = batch.transfers[..., bottleneck_level]       # (B,)
    w = np.asarray(work_per_unit, float)
    p_one = w / t_single
    bound = bottleneck > 0
    p_sat = np.where(bound, w / np.where(bound, bottleneck, 1.0), np.inf)
    n = np.arange(1, n_cores + 1, dtype=float)
    p = np.minimum(n * p_one[..., None], p_sat[..., None])
    return p * clock_hz if clock_hz else p


def batch_saturation(batch, bottleneck_level: int = -1, cores: int = 0):
    """Vectorized Eq. 2 saturation points: ``ceil(T_ECM^mem /
    T_bottleneck)`` per batch element.  Elements with a zero bottleneck
    term report ``cores``; a non-zero ``cores`` also caps the
    bandwidth-bound points."""
    t_single = batch.prediction(len(batch.levels) - 1)
    bottleneck = batch.transfers[..., bottleneck_level]
    bound = bottleneck > 0
    out = np.full(bottleneck.shape, max(cores, 1), dtype=int)
    out[bound] = np.ceil(t_single[bound] / bottleneck[bound]).astype(int)
    if cores:
        out = np.minimum(out, cores)
    return out
