"""Energy-to-solution over the SMs: the paper's Figs. 5/6 on the card.

The counterpart of the reference's ``benchmarks/scaling_bench.py``
``energy_payload``, measured.  For ``ddot`` (the reduce pipeline),
``copy`` and ``striad`` (the map pipeline, 2 and 3 streams), at 2^26 f32
elements a stream, depth 2, 32-row blocks, one CTA an SM, at each count
of ``gpu_scaling_ecm.CTAS`` (the Eq. 2 sweep's own launches,
``gpu_scaling_ecm._case``):

* hold the point's output against the op's plain version;
* measure it with ``power.PowerReader.run`` (a plain loop of calls, the
  energy counter read at two of its updates at least a second apart):
  the energy of one pass over the arrays (J), the mean power (W), the
  time of a pass (s), their EDP (J s), and the SM clock with the clock
  event reasons sampled beside the window;
* predict the same with ``ChipScaling.energy`` (``core/scaling.py``) of
  the one-SM ECMs on the calibrated machine at its one clock: the model's
  time is Eq. 2 over the SMs, its power the machine's fitted
  ``ChipPower``;
* report the two factors apart, measured W / model W and measured s /
  model s (their product is the energy's), so that an error of the time
  model does not read as one of the power model;
* report the energy-optimal and EDP-optimal SM counts, measured (over
  the counts swept) and modelled (``ChipScaling.best`` over every count,
  and the model's minimum over the counts swept), beside the measured
  saturation point ``n_S`` of this sweep's own ``P(n)``;
* report, not assert, the paper's claim (ii): past saturation, more SMs
  add only energy.

Every point's SM clock must stay within ``power.CLOCK_RTOL`` of the first
point's; a point outside it is listed in ``clock_failures`` with its
reasons, and a failed check in ``check_failures``.

Run ``PYTHONPATH=src python -m repro_torch.benchmarks.gpu_energy_ecm
--machine results/h100.json`` on a machine with the card; it prints one
JSON object per op.
"""
from __future__ import annotations

import argparse
import dataclasses
import json

import numpy as np
import torch

from ..core.gpu_ecm import LANES, stream_count
from ..core.machine import GPUMachineModel, load_machine_file
from ..core.scaling import scale_workloads
from ..kernels.check import compare
from . import gpu_scaling_ecm as SC
from . import gpu_stream_ecm as G
from .power import CLOCK_RTOL, PowerReader

OPS = ("ddot", "copy", "striad")


def predicted(machine: GPUMachineModel, rows: int, ops=OPS) -> dict:
    """The model of each op at the machine's one clock: J, W, s and EDP
    at every count of CTAS, and the energy- and EDP-optimal counts (over
    every count, and over CTAS)."""
    cs = scale_workloads(ops, machine)
    g = cs.energy(rows)
    best = {obj: {b["name"]: b["n_cores"] for b in cs.best(rows, objective=obj)}
            for obj in ("energy", "edp")}
    idx = [n - 1 for n in SC.CTAS]
    out = {}
    for i, op in enumerate(ops):
        e, t = g["energy_J"][i, 0, idx], g["runtime_s"][i, 0, idx]
        out[op] = {
            "joules": dict(zip(SC.CTAS, e.tolist())),
            "watts": dict(zip(SC.CTAS, g["watts"][i, 0, idx].tolist())),
            "seconds": dict(zip(SC.CTAS, t.tolist())),
            "edp": dict(zip(SC.CTAS, (e * t).tolist())),
            "n_s": int(cs.n_saturation()[i, 0]),
            "energy_optimal": best["energy"][op],
            "edp_optimal": best["edp"][op],
            "energy_optimal_swept": SC.CTAS[int(np.argmin(e))],
            "edp_optimal_swept": SC.CTAS[int(np.argmin(e * t))],
        }
    return out


def claim_ii(joules: dict, n_s: int, ctas=SC.CTAS) -> dict:
    """The paper's claim (ii) on measured energies: past the saturation
    point ``n_s`` the time gains at most 1 - SATURATED, so more SMs add
    only energy if ``E`` at the last count exceeds ``E(n_s)``."""
    past = [n for n in ctas if n >= n_s]
    ratio = joules[past[-1]] / joules[n_s]
    return {"n_s": n_s, "joules_past_n_s": {n: joules[n] for n in past},
            "last_over_n_s": ratio, "shows": bool(ratio > 1.0)}


def run(machine: GPUMachineModel, device: str = "cuda") -> dict:
    """The sweep on the card (module notes)."""
    dev = torch.device(device)
    if dev.type != "cuda" or not torch.cuda.is_available():
        raise RuntimeError("the energy sweep runs on the card only")
    reader = PowerReader(dev)
    period = reader.update_period()
    streams = G.make_streams(G.N_FULL_ROWS, dev)
    n = streams[0].numel()
    rows = n // LANES
    model = predicted(machine, rows)
    out = {"device": torch.cuda.get_device_name(dev), "n": n,
           "depth": SC.DEPTH, "block_rows": SC.BLOCK_ROWS,
           "f_ghz": machine.nominal_ghz,
           "power": dataclasses.asdict(machine.power),
           "counter_period_s": period,
           "counter_updates_per_s": reader.updates_per_s,
           "counter_read_s": reader.read_s,
           "power_limit_w": reader.power_limit_w(), "bus_id": reader.bus_id,
           "ops": {}, "check_failures": [], "clock_failures": []}
    first_mhz = None
    for op in OPS:
        kernel, plain, summed = SC._case(op, streams)
        want = plain()
        nbytes = stream_count(op) * n * 4
        pts, m = {}, model[op]
        for ctas in SC.CTAS:
            check = compare(kernel(ctas), want, summed_from=summed)
            if not check[0]:
                out["check_failures"].append(f"{op} ctas={ctas}: {check}")
            w = reader.run(lambda ctas=ctas: kernel(ctas))
            s = w.summary()
            first_mhz = first_mhz or s["sm_mhz"]
            off = max(abs(s["sm_mhz_min"] - first_mhz),
                      abs(s["sm_mhz_max"] - first_mhz)) / first_mhz
            if off > CLOCK_RTOL:
                out["clock_failures"].append(
                    f"{op} ctas={ctas}: SM clock {s['sm_mhz_min']}-"
                    f"{s['sm_mhz_max']} MHz against {first_mhz} MHz at the "
                    f"first point; reasons {s['reasons']}")
            joules, secs = w.joules_per_call, w.s_per_call
            pts[ctas] = {
                "check": check, "joules": joules, "watts": w.watts,
                "seconds": secs, "edp": joules * secs,
                "gbps": nbytes / secs / 1e9,
                "sm_mhz": s["sm_mhz"], "sm_mhz_min": s["sm_mhz_min"],
                "sm_mhz_max": s["sm_mhz_max"], "temp_c_max": s["temp_c_max"],
                "reasons": s["reasons"], "window_s": w.seconds, "calls": w.calls,
                "model_joules": m["joules"][ctas], "model_watts": m["watts"][ctas],
                "model_seconds": m["seconds"][ctas],
                "watts_factor": w.watts / m["watts"][ctas],
                "seconds_factor": secs / m["seconds"][ctas],
                "joules_factor": joules / m["joules"][ctas],
            }
        joules = {c: p["joules"] for c, p in pts.items()}
        edp = {c: p["edp"] for c, p in pts.items()}
        n_s = SC.saturation_point({c: p["gbps"] for c, p in pts.items()})
        out["ops"][op] = {
            "points": pts,
            "energy_optimal": min(joules, key=joules.get),
            "edp_optimal": min(edp, key=edp.get),
            "n_s_measured": n_s,
            "claim_ii": claim_ii(joules, n_s),
            "model": {k: v for k, v in m.items()
                      if k not in ("joules", "watts", "seconds", "edp")},
        }
    return out


def main() -> None:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.benchmarks.gpu_energy_ecm",
        description="Energy-to-solution over the SMs against a calibrated "
                    "machine file")
    ap.add_argument("--machine", required=True,
                    help="machine file from repro_torch.launch.calibrate")
    args = ap.parse_args()
    report = run(load_machine_file(args.machine))
    print(json.dumps({k: v for k, v in report.items() if k != "ops"}))
    for name, rec in report["ops"].items():
        print(json.dumps({"op": name, **rec}))
    if report["check_failures"] or report["clock_failures"]:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
