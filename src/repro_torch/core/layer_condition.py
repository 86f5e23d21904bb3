"""Layer conditions of the Jacobi stencils: which input streams miss a cache.

A copy of the stream-structure part of the reference's
``repro/core/layer_condition.py`` (after Stengel, Treibig, Hager & Wellein,
arXiv:1410.5010, §III).  A star stencil of radius ``r`` touches ``2r+1``
consecutive rows (2D) or layers (3D) of its input per sweep position.  If
a cache of capacity ``C`` holds that reuse set with room to spare,

    reuse_bytes * LC_SAFETY <= C,

only the leading row or layer misses: one load stream per element of
work.  Otherwise every distinct row stream misses (``2r+1`` in 2D; in 3D
the ``4r+1`` rows of one position, or ``2r+1`` where the rows but not the
layers fit).

The reference's ECM construction (``StencilSpec.ecm`` and the batch
constructors) is left out: it runs the CPU workload engine.  The capacities
have no default here, so the caller names the machine whose caches it
means (``core/gpu_ecm.py`` passes the card's L2).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

#: Rule-of-thumb safety factor of the LC literature: require the reuse set
#: to fit in *half* the cache (associativity conflicts, other data).
LC_SAFETY = 2.0


@dataclass(frozen=True)
class LayerCondition:
    """One reuse condition: if ``nbytes <= capacity / LC_SAFETY`` then
    only ``misses_if_held`` load streams miss in that cache level."""

    name: str
    nbytes: float
    misses_if_held: int

    def holds(self, capacity_bytes: float) -> bool:
        return self.nbytes * LC_SAFETY <= capacity_bytes


@dataclass(frozen=True)
class StencilSpec:
    """A Jacobi-style star stencil of radius ``radius`` in ``dim`` dims:
    the reference's stream-structure fields and its flop count (its uop
    counts feed only the CPU ECM construction left out here).

    The store side does not depend on the layer condition: the output is
    streamed, with one write-back stream (and one write-allocate stream
    where the machine allocates on a write).
    """

    name: str
    dim: int                    # 2 or 3
    radius: int = 1
    elem_bytes: int = 8         # double precision
    write_allocate: bool = True
    flops_per_elem: int = 6

    def __post_init__(self) -> None:
        if self.dim not in (2, 3):
            raise ValueError(f"dim must be 2 or 3, got {self.dim}")
        if self.radius < 1:
            raise ValueError("radius must be >= 1")

    @property
    def row_streams(self) -> int:
        """Distinct rows of the input touched per sweep position: ``2r+1``
        in 2D, ``4r+1`` in 3D (``2r+1`` rows in the centre layer plus one
        per outer layer)."""
        return (2 * self.radius + 1 if self.dim == 2
                else 4 * self.radius + 1)

    @property
    def rfo_streams(self) -> int:
        return 1 if self.write_allocate else 0

    @property
    def wb_streams(self) -> int:
        return 1

    def conditions(self, widths: tuple[int, ...],
                   block: tuple[int, ...] | None = None
                   ) -> tuple[LayerCondition, ...]:
        """Reuse conditions, strongest (fewest misses) first.

        ``widths`` are the inner problem dimensions, outermost sweep dim
        excluded: ``(W,)`` for 2D arrays of shape (H, W), ``(H, W)`` for 3D
        arrays of shape (D, H, W).  ``block`` optionally caps each width:
        the trailing-dim tile of a blocked sweep.
        """
        if len(widths) != self.dim - 1:
            raise ValueError(
                f"{self.dim}D stencil needs {self.dim - 1} inner widths, "
                f"got {widths!r}")
        w = [min(x, b) for x, b in zip(widths, block)] if block else \
            list(widths)
        r, eb = self.radius, self.elem_bytes
        if self.dim == 2:
            return (LayerCondition(
                "rows", (2 * r + 1) * w[0] * eb, misses_if_held=1),)
        return (
            LayerCondition(
                "layers", (2 * r + 1) * w[0] * w[1] * eb, misses_if_held=1),
            LayerCondition(
                "rows", (4 * r + 1) * w[1] * eb, misses_if_held=2 * r + 1),
        )

    def load_misses(self, capacity_bytes: float, widths: tuple[int, ...],
                    *, block: tuple[int, ...] | None = None) -> int:
        """Input load streams missing a cache of ``capacity_bytes``."""
        for cond in self.conditions(widths, block):
            if cond.holds(capacity_bytes):
                return cond.misses_if_held
        return self.row_streams

    def misses_per_level(self, widths: tuple[int, ...],
                         capacities: tuple[int, ...],
                         *, block: tuple[int, ...] | None = None
                         ) -> tuple[int, ...]:
        """Load-stream misses per cache level, innermost first: the inward
        load traffic on the edge below each level of ``capacities``."""
        return tuple(self.load_misses(c, widths, block=block)
                     for c in capacities)


def misses_batch(spec: StencilSpec, widths_arr: np.ndarray,
                 capacities: tuple[int, ...]) -> np.ndarray:
    """Load-miss table for a batch of effective inner widths: ``(B, L)``.

    ``widths_arr`` has shape ``(B, dim-1)`` (or ``(B,)`` for 2D) and holds
    the effective widths (problem width already capped by any blocking).
    """
    w = np.asarray(widths_arr, float)
    if w.ndim == 1:
        w = w[:, None]
    if w.shape[-1] != spec.dim - 1:
        raise ValueError(
            f"widths_arr last dim must be {spec.dim - 1}, got {w.shape}")
    r, eb = spec.radius, spec.elem_bytes
    caps = np.asarray(capacities, float)                     # (L,)
    if spec.dim == 2:
        nbytes = [(2 * r + 1) * w[:, 0] * eb]
        held_misses = [1]
    else:
        nbytes = [(2 * r + 1) * w[:, 0] * w[:, 1] * eb,
                  (4 * r + 1) * w[:, 1] * eb]
        held_misses = [1, 2 * r + 1]
    out = np.full((w.shape[0], caps.size), spec.row_streams, float)
    # weakest condition first so stronger ones overwrite
    for nb, m in list(zip(nbytes, held_misses))[::-1]:
        holds = nb[:, None] * LC_SAFETY <= caps[None, :]        # (B, L)
        out = np.where(holds, m, out)
    return out


# 2D 5-point star, r=1: flops/LUP 3 adds (neighbour sums) + 1 add + 2 muls.
JACOBI2D = StencilSpec(name="jacobi2d", dim=2, radius=1, flops_per_elem=6)

# 3D 7-point star, r=1: flops/LUP 5 adds + 1 add + 2 muls.
JACOBI3D = StencilSpec(name="jacobi3d", dim=3, radius=1, flops_per_elem=8)

STENCILS: dict[str, StencilSpec] = {s.name: s for s in (JACOBI2D, JACOBI3D)}
