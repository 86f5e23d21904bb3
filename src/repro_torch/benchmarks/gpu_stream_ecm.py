"""The paper's §V stream microbenchmark loop on the GPU.

The counterpart of the reference's ``benchmarks/tpu_stream_ecm.py``.  For
each Table I kernel, plus the fused triad->update chain:

* hold every path (the grid kernel at the reference's 64-row block and the
  pipeline at depths 1, 2 and 3) against the op's plain version;
* time each path with CUDA events, beside the plain version and one
  PyTorch call computing the same function (a yardstick the port never
  calls), and, where the arrays are well beyond L2, the HBM bound;
* time ``striad`` through the pipeline on one CTA at depths 1 and 2 — on
  one SM depth 1 is serial, as on the TPU's single core — and turn the
  pair into the overlap coefficient of Eq. 1 (``measured_overlap``);
* build the GPU-ECM model per 128-lane row and set it against the
  measured time.

Run ``PYTHONPATH=src python -m repro_torch.benchmarks.gpu_stream_ecm`` on
a machine with the card; it prints one JSON object per line.
"""
from __future__ import annotations

import json

import torch

from ..core.ecm import ECMModel
from ..core.gpu_ecm import measured_overlap
from ..core.kernel_spec import BENCHMARKS, TRIAD_UPDATE_STREAMS
from ..core.machine import H100_SXM, GPUMachineModel
from ..kernels import pipeline as P
from ..kernels.check import compare
from ..kernels.stream import kernel as K
from ..kernels.stream import ops, ref
from .timing import time_call

LANES = P.LANES
#: 2^26 f32 elements per stream: 256 MiB per array, more than 4x the
#: 50 MB L2 (STREAM's rule), so every path streams from HBM.
N_FULL_ROWS = (1 << 26) // LANES
#: 2^20 elements per stream: 4 MiB per array, resident in L2.
N_L2_ROWS = (1 << 20) // LANES
SEED = 0
S, T = 1.7, -0.3
DEPTHS = (1, 2, 3)
OPS = ("load", "ddot", "store", "update", "copy", "striad", "schoenauer",
       "triad_update")


def gpu_stream_ecm(name: str, machine: GPUMachineModel) -> ECMModel:
    """Analytic GPU-ECM for one stream kernel, cycles per 128-lane f32 row.

    In-core: every FP32 operation of an element takes one lane-cycle and
    the card has ``sm_count x 128`` FP32 lanes (at least one operation per
    element, the move).  Transfer: the row's streams cross HBM at the
    data-sheet rate.  Stores write whole rows, so there is no RFO stream.
    """
    spec = BENCHMARKS[name]
    row_bytes = LANES * 4
    streams = spec.loads_explicit + spec.stores + spec.nt_stores
    # the spec counts AVX uops per 64 B line of doubles: 2 uops per
    # operation on every element
    lane_ops = max((spec.uop_fma + spec.uop_mul + spec.uop_add) / 2, 1)
    t_comp = lane_ops * LANES / (machine.sm_count * machine.fp32_lanes_per_sm)
    t_hbm = streams * row_bytes / machine.hbm_bytes_per_cycle()
    return ECMModel(t_ol=t_comp, t_nol=0.0, transfers=(t_hbm,),
                    levels=("REG", "HBM"), unit="cy/row", name=f"gpu-{name}")


def _stream_count(name: str) -> int:
    if name == "triad_update":
        return TRIAD_UPDATE_STREAMS[1]
    spec = BENCHMARKS[name]
    return spec.loads_explicit + spec.stores + spec.nt_stores


def _flops_per_elem(name: str) -> int:
    if name == "triad_update":
        return BENCHMARKS["striad"].flops_per_elem + BENCHMARKS["update"].flops_per_elem
    return BENCHMARKS[name].flops_per_elem


def pipeline_block(machine: GPUMachineModel) -> int:
    """Largest power-of-two block <= the reference's 64 rows whose
    deepest ring fits every op (3 input streams, f32, with two output
    slots) in one block's shared memory: 32 rows on an H100 (3 x 3 + 2
    slots of 16 KiB = 176 KiB, and the mbarriers)."""
    n_in = max(n for _, _, n in P.MAP_OPS.values())
    b = K.BLOCK_ROWS
    while P.PipelineConfig(max(DEPTHS), b).ring_bytes(n_in, out_slots=2) \
            > machine.smem_per_block_optin:
        b //= 2
    if b < 1:
        raise ValueError(f"no ring fits {machine.smem_per_block_optin} B")
    return b


def make_streams(rows: int, device) -> tuple[torch.Tensor, ...]:
    """The loop's four f32 streams of ``rows * 128`` N(0, 1) values, drawn
    on ``device`` from SEED."""
    g = torch.Generator(device=device).manual_seed(SEED)
    return tuple(torch.randn(rows * LANES, generator=g, device=device)
                 for _ in range(4))


def cases(streams) -> dict:
    """op -> (kernel path (num_stages, block_rows) -> output, plain
    version, input of the sum or None for an elementwise op)."""
    a, b, c, d = streams
    n, dt, dev = a.numel(), a.dtype, a.device
    return {
        "load": (lambda ns, br: ops.load(a, num_stages=ns, block_rows=br),
                 lambda: ref.load(a), a),
        "ddot": (lambda ns, br: ops.ddot(a, b, num_stages=ns, block_rows=br),
                 lambda: ref.ddot(a, b), a),
        "store": (lambda ns, br: ops.store(S, (n,), dt, device=dev,
                                           num_stages=ns, block_rows=br),
                  lambda: ref.store(S, (n,), dt, device=dev), None),
        "update": (lambda ns, br: ops.update(S, a, num_stages=ns,
                                             block_rows=br),
                   lambda: ref.update(S, a), None),
        "copy": (lambda ns, br: ops.copy(b, num_stages=ns, block_rows=br),
                 lambda: ref.copy(b), None),
        "striad": (lambda ns, br: ops.striad(S, b, c, num_stages=ns,
                                             block_rows=br),
                   lambda: ref.striad(S, b, c), None),
        "schoenauer": (lambda ns, br: ops.schoenauer(b, c, d, num_stages=ns,
                                                     block_rows=br),
                       lambda: ref.schoenauer(b, c, d), None),
        "triad_update": (lambda ns, br: ops.triad_update(
                             S, T, b, c, num_stages=ns, block_rows=br),
                         lambda: ref.triad_update(S, T, b, c), None),
    }


def paths(machine: GPUMachineModel) -> list[tuple[str, int | None, int]]:
    """(label, num_stages, block_rows): the grid kernels at the
    reference's block, the pipeline at the block whose rings all fit."""
    pb = pipeline_block(machine)
    return [("grid", None, K.BLOCK_ROWS)] + [(str(d), d, pb) for d in DEPTHS]


def validate(streams, machine: GPUMachineModel) -> dict:
    """Every op on every path, held against its plain version by
    ``kernels.check.compare``: ``{op: {path: (ok, max_abs_err, tol)}}``."""
    out = {}
    for name, (kernel, plain, summed) in cases(streams).items():
        want = plain()
        out[name] = {path: compare(kernel(ns, br), want, summed_from=summed)
                     for path, ns, br in paths(machine)}
    return out


def _library_calls(streams) -> dict:
    """One PyTorch call per op computing the same function into a
    preallocated output: a yardstick only, never called by the port."""
    a, b, c, d = streams
    out = torch.empty_like(a)
    return {
        "load": lambda: torch.sum(a),
        "ddot": lambda: torch.dot(a, b),
        "store": lambda: out.fill_(S),
        "update": lambda: torch.mul(a, S, out=out),
        "copy": lambda: out.copy_(b),
        "striad": lambda: torch.add(b, c, alpha=S, out=out),
        "schoenauer": lambda: torch.addcmul(b, c, d, out=out),
    }


def _bound(name: str, n: int, nbytes: int, machine: GPUMachineModel
           ) -> tuple[float, str]:
    """(ms, "bytes" or "operations"): the least time the card could take,
    each input read once and each output written once at the HBM rate,
    or the op's FP32 operations at the FP32 peak, whichever is longer."""
    bytes_ms = machine.hbm_seconds(nbytes) * 1e3
    ops_ms = machine.compute_seconds(_flops_per_elem(name) * n) * 1e3
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms, "operations")


def pipeline_timings(streams, machine: GPUMachineModel) -> dict:
    """Time every op on every path, the one-SM overlap pair, the fused
    chain against its two-launch composition and ``striad`` against
    ``striad_rmw``; set the ECM model against the times."""
    a, b, c, _ = streams
    n = a.numel()
    rows = n // LANES
    # the HBM bound holds only where no array fits in L2 (STREAM's rule)
    bounded = n * a.element_size() >= 4 * machine.l2_bytes
    lib = _library_calls(streams)
    route = paths(machine)
    out: dict = {"ops": {}}
    for name, (kernel, plain, _) in cases(streams).items():
        ms, host = {}, {}
        for path, ns, br in route:
            ms[path], host[path] = time_call(lambda ns=ns, br=br: kernel(ns, br))
        nbytes = _stream_count(name) * n * a.element_size()
        bound = _bound(name, n, nbytes, machine) if bounded else None
        out["ops"][name] = {
            "ms": ms,
            "host_us": host,
            "gbps": {p: nbytes / t / 1e6 for p, t in ms.items()},
            "bound_ms": bound[0] if bound else None,
            "bound_by": bound[1] if bound else None,
            "bound_share": {p: bound[0] / t for p, t in ms.items()} if bound else None,
            "plain_ms": time_call(plain)[0],
            "library_ms": time_call(lib[name])[0] if name in lib else None,
        }

    pb = pipeline_block(machine)
    b2, c2 = b.view(rows, LANES), c.view(rows, LANES)
    one_sm = {d: time_call(lambda d=d: P.map_pipeline(
        "striad", (S,), (b2, c2), rows=rows, dtype=b.dtype, device=b.device,
        num_stages=d, block_rows=pb, ctas=1))[0] for d in (1, 2)}
    card = out["ops"]["striad"]["ms"]
    out["overlap"] = {
        "kernel": "striad", "scope": "one SM (ctas=1)",
        "t_serial_ms": one_sm[1], "t_pipelined_ms": one_sm[2],
        "serial_over_pipelined": one_sm[1] / one_sm[2],
        "exposed_hbm_fraction": measured_overlap(one_sm[1], one_sm[2], one_sm[2]),
        "card_t_serial_ms": card["1"], "card_t_pipelined_ms": card["2"],
    }

    t_fused = out["ops"]["triad_update"]["ms"]["2"]
    t_unfused = time_call(lambda: ops.triad_update_unfused(
        S, T, b, c, num_stages=2, block_rows=pb))[0]
    unfused_streams, fused_streams = TRIAD_UPDATE_STREAMS
    out["fused_triad_update"] = {
        "fused_ms": t_fused, "unfused_ms": t_unfused,
        "speedup": t_unfused / t_fused,
        "predicted_stream_ratio": unfused_streams / fused_streams,
    }

    e = gpu_stream_ecm("striad", machine)
    t_rmw_hbm = (_stream_count("striad") + 1) * LANES * 4 / machine.hbm_bytes_per_cycle()
    t_rmw = time_call(lambda: ops.striad_rmw(S, a, b, c))[0]
    out["rmw"] = {
        "striad_ms": card["grid"], "striad_rmw_ms": t_rmw,
        "ratio": t_rmw / card["grid"],
        "ecm_ratio": max(e.t_nol + t_rmw_hbm, e.t_ol) / e.prediction("HBM"),
        "note": "striad_rmw is plain PyTorch: three kernels, not one pass",
    }

    # the model has no L2 level: its HBM prediction, like the bound, holds
    # only where the arrays stream from HBM
    out["ecm"] = _ecm_against(out["ops"], rows, machine) if bounded else None
    return out


def _ecm_against(timed: dict, rows: int, machine: GPUMachineModel) -> dict:
    """The GPU-ECM prediction of each Table I op beside its fastest path."""
    out = {}
    for name in OPS:
        if name not in BENCHMARKS:
            continue
        e = gpu_stream_ecm(name, machine)
        measured = min(timed[name]["ms"].values())
        predicted = e.prediction("HBM") * rows / machine.clock_hz * 1e3
        out[name] = {
            "input": e.notation(), "prediction": e.prediction_notation(),
            "predicted_ms": predicted, "measured_ms": measured,
            "measured_cy_per_row": measured * 1e-3 * machine.clock_hz / rows,
            "measured_over_predicted": measured / predicted,
        }
    return out


def run(device: str = "cuda", rows: int = N_FULL_ROWS) -> dict:
    """The stream-ECM loop at ``rows * 128`` elements per stream.

    On the card: every op's outputs, its checks on every path, and the
    timings.  On the CPU (``device="cpu"``) the ops take their plain
    versions and nothing is timed: a CPU time is no device metric.
    """
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device; pass device='cpu' to run the "
                               "plain versions")
        machine = GPUMachineModel.from_device(dev)
        name = torch.cuda.get_device_name(dev)
    else:
        machine, name = H100_SXM, str(dev)
    streams = make_streams(rows, dev)
    report = {
        "device": name,
        "n": rows * LANES,
        "block_rows": {"grid": K.BLOCK_ROWS, "pipeline": pipeline_block(machine)},
        "outputs": {op: kernel(None, K.BLOCK_ROWS)
                    for op, (kernel, _, _) in cases(streams).items()},
        "checks": validate(streams, machine),
    }
    if dev.type == "cuda":
        report["timings"] = pipeline_timings(streams, machine)
    return report


def summary(report: dict) -> list[dict]:
    """The report as JSON-ready records, one per printed line."""
    n = report["n"]
    tm = report.get("timings")
    lines = []
    for op, checks in report["checks"].items():
        rec = {"n": n, "op": op, "checks": checks}
        if tm:
            rec.update({k: v for k, v in tm["ops"][op].items() if k != "host_us"})
        lines.append(rec)
    if tm:
        lines.append({"n": n, "host_us_per_call":
                      {op: v["host_us"] for op, v in tm["ops"].items()}})
        for key in ("overlap", "fused_triad_update", "rmw", "ecm"):
            lines.append({"n": n, key: tm[key]})
    return lines


def main() -> None:
    report = run()
    print(json.dumps({"device": report["device"],
                      "block_rows": report["block_rows"]}))
    for rec in summary(report):
        print(json.dumps(rec))


if __name__ == "__main__":
    main()
