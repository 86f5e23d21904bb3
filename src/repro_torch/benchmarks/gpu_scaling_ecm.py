"""Eq. 2 over the SMs: the paper's Fig. 10 on the card.

The counterpart of the reference's §IV-B scaling validation
(``repro/core/saturation.py``), with the SM as the core.  For each
Table I kernel at 2^26 f32 elements a stream:

* run it through the pipeline, the map pipeline (store, update, copy,
  striad, schoenauer) or the reduce pipeline (load, ddot), at depth 2
  and 32-row blocks, on ``ctas`` CTAs for each ``ctas`` in :data:`CTAS`,
  with each CTA holding over half an SM's shared memory
  (``one_cta_per_sm``: ``pipeline.one_cta_reserve``), so ``ctas`` CTAs
  run on ``ctas`` SMs; the
  CUDA occupancy query on the launch confirms one CTA an SM;
* hold every point against the op's plain version
  (``kernels.check.compare``);
* report ``P(n)`` in GB/s and the measured saturation point, the first
  ``n`` whose ``P(n)`` reaches :data:`SATURATED` of ``P(132)``;
* predict ``P(n)`` with the port's ``ScalingModel`` on a one-SM ECM
  (:func:`one_sm_ecm`): ``T_OL`` the op's lane operations on one SM's
  128 lanes, then the row's bytes from L2 at ``l2_bytes_per_s /
  sm_count`` (SM <- L2) and from HBM at ``sustained_bw(op)`` (L2 <- HBM,
  the paper's ``T_L3Mem`` and the shared bottleneck), in cycles per row;
  ``n_S = ceil(T_ECM / T_HBM)``, beside ``ceil(T_1 / T_HBM)`` from the
  measured one-CTA time ``T_1`` (the paper reads both).

The model's rates come from the calibrated machine
(``launch/calibrate.py``'s machine file): the L2 plateau is measured
there and nowhere else.

Run ``PYTHONPATH=src python -m repro_torch.benchmarks.gpu_scaling_ecm
--machine results/h100.json`` on a machine with the card; it prints one
JSON object per op.
"""
from __future__ import annotations

import argparse
import json
import math

import torch

from ..core.ecm import ECMModel
from ..core.gpu_ecm import LANES, lane_ops, stream_count
from ..core.machine import GPUMachineModel, load_machine_file
from ..core.saturation import ScalingModel
from ..kernels import pipeline as P
from ..kernels.check import compare
from . import gpu_stream_ecm as G
from .timing import time_call

#: the CTA counts of the sweep: powers of two, the steps of 16 past 32, and
#: every SM of an H100
CTAS = (1, 2, 4, 8, 16, 32, 48, 64, 96, 128, 132)
DEPTH = 2
BLOCK_ROWS = 32
#: the share of P(all SMs) that counts as saturated
SATURATED = 0.95
OPS = ("load", "ddot", "store", "update", "copy", "striad", "schoenauer")
#: calls per timed repeat: a one-CTA call streams up to 1 GB through one SM
FEW_CTAS_INNER, FEW_CTAS = 2, 16


def one_sm_ecm(name: str, machine: GPUMachineModel) -> ECMModel:
    """The one-SM ECM of a Table I kernel, cycles per 128-lane f32 row:
    ``T_OL`` = its lane operations over one SM's lanes, transfers SM <- L2
    at ``l2_bytes_per_s / sm_count`` and L2 <- HBM at
    ``sustained_bw(name)``.  Needs a calibrated ``l2_bytes_per_s``."""
    if machine.l2_bytes_per_s is None:
        raise ValueError("the one-SM model needs the L2 plateau: calibrate "
                         "the machine first (repro_torch.launch.calibrate)")
    row_bytes = stream_count(name) * LANES * 4
    t_l2 = row_bytes * machine.clock_hz / (machine.l2_bytes_per_s
                                           / machine.sm_count)
    t_hbm = row_bytes * machine.clock_hz / machine.sustained_bw(name, "_stream")
    return ECMModel(t_ol=lane_ops(name) * LANES / machine.fp32_lanes_per_sm,
                    t_nol=0.0, transfers=(t_l2, t_hbm),
                    levels=("REG", "L2", "HBM"), unit="cy/row",
                    name=f"sm-{name}")


def saturation_point(gbps: dict, ctas=CTAS) -> int:
    """The first ``n`` whose ``P(n)`` reaches SATURATED of ``P`` at the
    largest ``n``."""
    top = gbps[ctas[-1]]
    return next(n for n in ctas if gbps[n] >= SATURATED * top)


def predicted(name: str, machine: GPUMachineModel,
              t_one_cta_cy: float | None = None) -> dict:
    """The model side for ``name``: ``P(n)`` in GB/s at each of
    :data:`CTAS`, ``n_S`` from the model and, given the measured one-CTA
    time in cycles per row, from the measurement."""
    e = one_sm_ecm(name, machine)
    sm = ScalingModel.from_ecm(e, cores=machine.sm_count)
    row_bytes = stream_count(name) * LANES * 4
    out = {
        "input": e.notation(), "prediction": e.prediction_notation(),
        "gbps": {n: sm.performance(n, row_bytes, machine.clock_hz) / 1e9
                 for n in CTAS},
        "n_s_model": sm.n_saturation,
    }
    if t_one_cta_cy is not None:
        out["n_s_from_one_cta"] = min(
            math.ceil(t_one_cta_cy / sm.bottleneck_cycles), machine.sm_count)
    return out


def _case(name: str, streams):
    """(kernel(ctas) -> output, plain version, input of the sum or None)."""
    a, b, c, d = streams
    rows, dev = a.numel() // LANES, a.device
    kw = dict(num_stages=DEPTH, block_rows=BLOCK_ROWS, one_cta_per_sm=True)
    view = (lambda *xs: tuple(x.view(rows, LANES) for x in xs))
    plain = G.cases(streams)[name][1]
    if name in P.REDUCE_OPS:
        ins = view(a, b)[:P.REDUCE_OPS[name][1]]
        return (lambda ctas: P.reduce_pipeline(name, ins, ctas=ctas, **kw)[0, 0],
                plain, a)
    scalars = (G.S,) if P.MAP_OPS[name][1] else ()
    ins = {"store": (), "update": view(a), "copy": view(b),
           "striad": view(b, c), "schoenauer": view(b, c, d)}[name]
    return (lambda ctas: P.map_pipeline(
        name, scalars, ins, rows=rows, dtype=a.dtype, device=dev,
        ctas=ctas, **kw).view(-1), plain, None)


def occupancy(name: str, machine: GPUMachineModel, dtype=torch.float32) -> int:
    """CTAs an SM holds at the sweep's launch (the CUDA occupancy query)."""
    rows = G.N_FULL_ROWS
    block, _, stages = P.chunking(rows, BLOCK_ROWS, DEPTH)
    if name in P.REDUCE_OPS:
        return P.reduce_ctas_per_sm(P.REDUCE_OPS[name][0], dtype, block,
                                    stages, one_cta_per_sm=True)
    n_in = P.MAP_OPS[name][2]
    out_slots = P.PipelineConfig(stages, block).map_out_slots(
        n_in, limit=machine.smem_per_block_optin)
    return P.map_ctas_per_sm(P.MAP_OPS[name][0], dtype, block, stages,
                             out_slots, one_cta_per_sm=True)


def run(machine: GPUMachineModel, device: str = "cuda") -> dict:
    """The sweep on the card: per op, the occupancy, every point's check
    and time, ``P(n)`` measured and predicted, and both ``n_S``."""
    dev = torch.device(device)
    if dev.type != "cuda" or not torch.cuda.is_available():
        raise RuntimeError("the Eq. 2 sweep runs on the card only")
    streams = G.make_streams(G.N_FULL_ROWS, dev)
    n = streams[0].numel()
    out = {"device": torch.cuda.get_device_name(dev), "n": n,
           "depth": DEPTH, "block_rows": BLOCK_ROWS,
           "reserve_smem": P.one_cta_reserve(dev), "ops": {}}
    for name in OPS:
        kernel, plain, summed = _case(name, streams)
        want = plain()
        nbytes = stream_count(name) * n * 4
        checks, ms = {}, {}
        for ctas in CTAS:
            checks[ctas] = compare(kernel(ctas), want, summed_from=summed)
            ms[ctas] = time_call(
                lambda ctas=ctas: kernel(ctas),
                inner=FEW_CTAS_INNER if ctas < FEW_CTAS else 20)[0]
        gbps = {k: nbytes / t / 1e6 for k, t in ms.items()}
        t1_cy = ms[1] * 1e-3 * machine.clock_hz / (n // LANES)
        out["ops"][name] = {
            "ctas_per_sm": occupancy(name, machine),
            "checks": checks, "ms": ms, "gbps": gbps,
            "n_s_measured": saturation_point(gbps),
            "one_cta_cy_per_row": t1_cy,
            "predicted": predicted(name, machine, t1_cy),
        }
    return out


def main() -> None:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.benchmarks.gpu_scaling_ecm",
        description="Eq. 2 over the SMs against a calibrated machine file")
    ap.add_argument("--machine", required=True,
                    help="machine file from repro_torch.launch.calibrate")
    args = ap.parse_args()
    report = run(load_machine_file(args.machine))
    print(json.dumps({k: v for k, v in report.items() if k != "ops"}))
    for name, rec in report["ops"].items():
        print(json.dumps({"op": name, **rec}))


if __name__ == "__main__":
    main()
