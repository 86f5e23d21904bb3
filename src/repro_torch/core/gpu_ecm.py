"""Two-term ECM model of a GPU step, and the overlap calibration.

The counterpart of the reference's ``repro/core/tpu_ecm.py`` for one card:
``T_comp`` (SM execution, the paper's ``T_OL``) and ``T_hbm`` (device
memory streaming), composed by Eq. 1 with a fraction of the transfer
serialized with compute (the ``T_nOL`` role).  Collective terms (ICI/DCN
in the reference) wait for the multi-card slices of the port.

:func:`gpu_stream_ecm` is the per-row ECM of a Table I stream kernel;
:func:`gpu_stencil_ecm` builds the step model of one Jacobi sweep, with
its HBM traffic from the layer condition of the card's L2;
:func:`gpu_matmul_ecm` and :func:`gpu_attention_ecm` those of the
compute-bound kernels, with their traffic laws evaluated at the L2.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass

from .ecm import ECMModel
from .kernel_spec import BENCHMARKS
from .layer_condition import StencilSpec
from .machine import GPUMachineModel
from .workload import AttentionWorkload, MatmulWorkload

#: f32 elements of one row of the stream layout, the ECM's unit of work
LANES = 128


@dataclass(frozen=True)
class StepECM:
    """ECM model of one step on one card; times in seconds."""

    name: str
    t_comp: float
    t_hbm: float
    #: fraction of HBM time serialized with compute (ECM T_nOL role):
    #: 1.0 = fully exposed, 0.0 = fully hidden behind compute.
    exposed_hbm_fraction: float = 1.0

    @property
    def t_roofline(self) -> float:
        """Full-overlap (light-speed) bound."""
        return max(self.t_comp, self.t_hbm)

    @property
    def t_ecm(self) -> float:
        """ECM bound: compute overlaps only the non-exposed transfer part."""
        exposed = self.exposed_hbm_fraction * self.t_hbm
        hidden = (1 - self.exposed_hbm_fraction) * self.t_hbm
        return max(self.t_comp, hidden) + exposed


def overlap_coefficient(measured_s: float, t_comp_s: float,
                        t_transfer_s: float) -> float:
    """Invert Eq. 1 for the exposed-transfer fraction ``f``.

    ``T(f) = max(T_comp, (1-f)*T_x) + f*T_x``; return the smallest ``f``
    consistent with the measurement.
    """
    if t_transfer_s <= 0:
        return 0.0
    return min(1.0, max(0.0, (measured_s - t_comp_s) / t_transfer_s))


def measured_overlap(t_serial_s: float, t_pipelined_s: float,
                     t_transfer_s: float) -> float:
    """Exposed-transfer fraction from a serial/pipelined measurement pair.

    ``t_serial`` is the depth-1 runtime (fetch, compute and store strictly
    alternate); ``t_pipelined`` the multi-buffered one.  The hidden
    transfer time is their difference, so the exposed fraction is
    ``1 - (t_serial - t_pipelined) / T_x``.
    """
    if t_transfer_s <= 0:
        return 0.0
    hidden = max(0.0, t_serial_s - t_pipelined_s)
    return min(1.0, max(0.0, 1.0 - hidden / t_transfer_s))


def with_measured_overlap(step: StepECM, *, t_serial_s: float,
                          t_pipelined_s: float) -> StepECM:
    """Copy of ``step`` with its HBM exposure calibrated from a serial vs
    multi-buffered timing pair."""
    f = measured_overlap(t_serial_s, t_pipelined_s, step.t_hbm)
    return dataclasses.replace(step, exposed_hbm_fraction=f)


def stream_count(name: str) -> int:
    """HBM streams of the Table I kernel ``name``: its explicit loads and
    its stores; a card store writes whole sectors, so no RFO stream."""
    spec = BENCHMARKS[name]
    return spec.loads_explicit + spec.stores + spec.nt_stores


def lane_ops(name: str) -> float:
    """FP32 operations per element of the Table I kernel ``name``, at
    least one (the move): the spec counts AVX uops per 64 B line of
    doubles, 2 uops per operation on every element."""
    spec = BENCHMARKS[name]
    return max((spec.uop_fma + spec.uop_mul + spec.uop_add) / 2, 1)


def gpu_stream_ecm(name: str, machine: GPUMachineModel) -> ECMModel:
    """Analytic GPU-ECM for one stream kernel, cycles per 128-lane f32 row.

    In-core: every FP32 operation of an element takes one lane-cycle and
    the card has ``sm_count x 128`` FP32 lanes (at least one operation per
    element, the move).  Transfer: the row's streams cross HBM at the
    rate the card sustains for the kernel (``machine.sustained_bw(name,
    "_stream")``: the data-sheet rate until calibrated).  Stores write
    whole rows, so there is no RFO stream.
    """
    row_bytes = LANES * 4
    streams = stream_count(name)
    t_comp = lane_ops(name) * LANES / (machine.sm_count
                                       * machine.fp32_lanes_per_sm)
    t_hbm = streams * row_bytes / (machine.sustained_bw(name, "_stream")
                                   / machine.clock_hz)
    return ECMModel(t_ol=t_comp, t_nol=0.0, transfers=(t_hbm,),
                    levels=("REG", "HBM"), unit="cy/row", name=f"gpu-{name}")


#: rows of the sweep plane one CTA of the whole-array Jacobi kernels
#: covers (``csrc/stencil.cu``: 32 x 8 threads, one point each)
GRID_CTA_ROWS = 8


def stencil_hbm_streams(spec: StencilSpec, shape: tuple[int, ...], machine,
                        *, block: tuple[int, ...] | None = None) -> float:
    """Arrays the sweep of ``shape`` streams through HBM per update: the
    input streams that miss the card's L2 under the layer condition (of
    ``spec.elem_bytes`` elements, with ``LC_SAFETY``), plus the write-back
    of the output.  ``block`` caps the inner widths at the trailing-dim
    tile of a blocked sweep (the halo pipeline's).  Stores write whole
    sectors, so there is no write-allocate stream, as in the stream loop's
    model.

    Where no condition holds, the whole-array kernel (``block`` None)
    still reads each row of its sweep plane once per CTA: a CTA's
    ``GRID_CTA_ROWS`` rows run at once, so their neighbours' re-reads hit
    in L1 or L2, and only the ``2r`` halo rows are read again by the next
    CTA down.  The ``2r + 1`` row streams of the plane become ``(rows +
    2r) / rows``; in 3D the ``2r`` outer layers stay one stream each."""
    misses = spec.load_misses(machine.l2_bytes, tuple(shape[1:]), block=block)
    if block is None and misses == spec.row_streams:
        r = spec.radius
        misses = (GRID_CTA_ROWS + 2 * r) / GRID_CTA_ROWS + (spec.dim - 2) * 2 * r
    return misses + spec.wb_streams


def gpu_stencil_ecm(spec: StencilSpec, shape: tuple[int, ...], machine,
                    elem_bytes: int, *,
                    block: tuple[int, ...] | None = None) -> StepECM:
    """Two-term model of one sweep over an array of ``shape`` with
    ``elem_bytes`` elements on the card ``machine`` (a
    ``GPUMachineModel``); times in seconds.

    ``T_hbm = streams x elem_bytes x LUPs / b`` with the streams of
    :func:`stencil_hbm_streams` (``block`` as there) and ``b`` the
    bandwidth the card sustains for the stencil
    (``machine.sustained_bw(name, "_stencil")``: the data-sheet rate
    until calibrated); ``T_comp = flops_per_elem x LUPs / peak_f32_flops``.
    """
    if len(shape) != spec.dim:
        raise ValueError(f"{spec.name} takes a {spec.dim}D shape, got {shape}")
    spec = dataclasses.replace(spec, elem_bytes=elem_bytes)
    lups = math.prod(shape)
    streams = stencil_hbm_streams(spec, shape, machine, block=block)
    return StepECM(
        name=f"gpu-{spec.name}",
        t_comp=spec.flops_per_elem * lups / machine.peak_f32_flops,
        t_hbm=(streams * elem_bytes * lups
               / machine.sustained_bw(spec.name, "_stencil")),
        exposed_hbm_fraction=machine.exposed_hbm_fraction)


def gpu_matmul_ecm(w: MatmulWorkload, machine) -> StepECM:
    """Two-term model of one blocked product on the card ``machine``;
    seconds.  ``T_hbm``: the traffic law's bytes at the card's L2 over the
    HBM rate.  ``T_comp``: ``2mnk`` FLOP at the rate of the unit the
    kernel issues its products on (csrc/matmul.cu): the FP32 units for f32
    operands (4-byte elements), the tensor cores (``wgmma``) for bf16
    (2-byte)."""
    read, write = w.traffic(machine.l2_bytes)
    t_comp = (w.flops / machine.peak_bf16_tensor_flops if w.elem_bytes == 2
              else machine.compute_seconds(w.flops))
    return StepECM(name="gpu-matmul", t_comp=t_comp,
                   t_hbm=machine.hbm_seconds(read + write),
                   exposed_hbm_fraction=machine.exposed_hbm_fraction)


def gpu_attention_ecm(w: AttentionWorkload, machine, *,
                      batch_heads: int) -> StepECM:
    """Two-term model of flash attention over ``batch_heads`` fused heads
    on the card ``machine``; seconds.  Heads multiply the work and the
    traffic of one head (the traffic law at the card's L2); the products
    and the softmax run on FFMA (csrc/attention.cu)."""
    read, write = w.traffic(machine.l2_bytes)
    return StepECM(name="gpu-flash-attention",
                   t_comp=machine.compute_seconds(w.flops * batch_heads),
                   t_hbm=machine.hbm_seconds((read + write) * batch_heads),
                   exposed_hbm_fraction=machine.exposed_hbm_fraction)
