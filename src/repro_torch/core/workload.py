"""The workloads of the GPU model: blocked GEMM, flash-attention tiles and
the Table I stream ops of a model step.

The port's copy of the part of the reference's ``repro/core/workload.py``
(``COMPUTE_LC_SAFETY``, ``MatmulWorkload``, ``AttentionWorkload``,
``StreamWorkload``) that the GPU model and the whole-model composition
(``core/compose.py``) read: the dimensions, the tiling, and the
device-memory traffic law of each kernel, evaluated at one cache level,
the card's L2, and returned in bytes; and each workload's
``work_per_elem``, the reference's useful-work count per output element.  The reference counts cache lines per line of output
at every level of a CPU hierarchy, with a write-allocate stream for the
output; here stores write whole sectors, so there is no RFO stream, as in
the port's stream and stencil models.  The reference's uop mixes and CPU
register-tile fields, ``route_traffic`` and the registry have no
counterpart: nothing in the port reads them.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

from .kernel_spec import StreamKernelSpec

#: reuse-set safety factor: a panel or KV set survives a cache level only if
#: it fits in half of it (the reference's, as for the layer conditions)
COMPUTE_LC_SAFETY = 2.0

#: FP32 operations per attention score besides the two products: the
#: reference's exp() polynomial (4 multiplies, 4 adds) plus the running-max
#: compare and the sum (``AttentionSpec.exp_mul_uops + exp_add_uops + 2``)
SOFTMAX_FLOPS_PER_SCORE = 10


class Traffic(NamedTuple):
    """Device-memory bytes of one call."""

    read: float
    write: float


@dataclass(frozen=True)
class MatmulWorkload:
    """``C[m, n] = A[m, k] @ B[k, n]`` in ``bm x bn`` output tiles, i-blocks
    outer, j-blocks inner, the K loop inside a tile.

    * **A**: each tile streams its ``bm x k`` panel; read once if the panel
      (times the safety factor) fits the cache across the j-loop, else once
      per j-block (``n / bn`` times).
    * **B**: read once if the whole matrix fits, else once per i-block
      (``m / bm`` times).
    * **C**: written once; the accumulator stays on chip through the K loop.
    """

    m: int
    n: int
    k: int
    bm: int
    bn: int
    elem_bytes: int = 4

    @property
    def flops(self) -> float:
        return 2.0 * self.m * self.n * self.k

    def work_per_elem(self) -> tuple[int, int]:
        """The reference's (FLOP, updates) per output element: ``2k``."""
        return 2 * self.k, 1

    def traffic(self, capacity: int) -> Traffic:
        eb = self.elem_bytes
        a, b = self.m * self.k * eb, self.k * self.n * eb
        a_panel = self.bm * self.k * eb
        read = (a if a_panel * COMPUTE_LC_SAFETY <= capacity
                else a * self.n / self.bn)
        read += (b if b * COMPUTE_LC_SAFETY <= capacity
                 else b * self.m / self.bm)
        return Traffic(read, self.m * self.n * eb)


@dataclass(frozen=True)
class AttentionWorkload:
    """One head of ``O[sq, d] = softmax(Q K^T / sqrt(d)) V`` in q-blocks of
    ``bq`` rows that stream over KV tiles of ``bkv`` rows.

    * **Q** is read once and stays on chip through the KV loop.
    * **K, V** are read once per q-block, over the visited fraction
      (:meth:`kv_fraction`) of the tiles, unless the whole KV set
      (``2 * skv * d`` elements, times the safety factor) fits the cache,
      where it is read once.
    * **O** is written once.

    Two counts of the work: :attr:`flops`, the operations the FFMA units
    issue (``4 * d`` FLOP a visited score for the two products and
    :data:`SOFTMAX_FLOPS_PER_SCORE` for the softmax, as the reference
    counts its uops; under 2 % of the work at d = 128), which the GPU model
    times; and :meth:`work_per_elem`, the reference's useful FLOP per
    output element (``round(4 * skv * kv_fraction)``, no softmax term),
    which the composition's FLOP totals count.
    """

    sq: int
    skv: int
    d: int
    bq: int
    bkv: int
    causal: bool
    elem_bytes: int = 4

    def kv_fraction(self) -> float:
        """Fraction of (q, kv) tile pairs the kernel visits: a causal tile is
        skipped only when its whole q-block lies above the diagonal
        (``qi*bq + bq - 1 < ki*bkv``), so ``0.5 + max(bq, bkv) / (2*skv)``
        (exact for power-of-two tilings of square problems; 1.0 when one
        tile spans the sequence)."""
        if not self.causal:
            return 1.0
        return min(1.0, 0.5 + max(self.bq, self.bkv) / (2.0 * self.skv))

    @property
    def flops(self) -> float:
        scores = self.sq * self.skv * self.kv_fraction()
        return scores * (4.0 * self.d + SOFTMAX_FLOPS_PER_SCORE)

    def work_per_elem(self) -> tuple[int, int]:
        """The reference's (FLOP, updates) per output element: the two
        products over the visited keys, ``round(4 * skv * kv_fraction)``."""
        return int(round(4.0 * self.skv * self.kv_fraction())), 1

    def traffic(self, capacity: int) -> Traffic:
        eb = self.elem_bytes
        kv = 2 * self.skv * self.d * eb
        qo = self.sq * self.d * eb
        read = qo + (kv if kv * COMPUTE_LC_SAFETY <= capacity
                     else kv * self.kv_fraction() * self.sq / self.bq)
        return Traffic(read, qo)


@dataclass(frozen=True)
class StreamWorkload:
    """A Table I stream op of a model step (a norm, a residual, a lookup):
    constant traffic per element, no reuse.  The GPU model prices it per
    128-lane f32 row (``core/gpu_ecm.py`` ``gpu_stream_ecm``) from its
    spec's name."""

    spec: StreamKernelSpec

    @property
    def name(self) -> str:
        return self.spec.name

    def work_per_elem(self) -> tuple[int, int]:
        """The spec's (FLOP, updates) per element."""
        return self.spec.flops_per_elem, self.spec.updates_per_elem
