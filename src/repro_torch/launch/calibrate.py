"""Calibrate the card's model: measure, fit, emit a machine file.

    python -m repro_torch.launch.calibrate --machine-out results/h100.json

builds the card's prior (``GPUMachineModel.from_device``: what the card
reports, the data sheet's rates), measures it with the card backend
(``benchmarks/gpu_calibrate.py``), fits every calibration field
(``core/calibrate.py``), prints the fit table and writes the machine file.
It checks that the file loads back to the fitted machine, and exits 1
when a field's fit residual exceeds the bound or the RFO check decides
neither way.  With ``--cache-dir`` (or
``REPRO_TORCH_CACHE_DIR``) the report is cached: a repeat run fits
nothing.  There is no CPU fallback: without a card it exits non-zero.
"""
from __future__ import annotations

import argparse
import sys


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.calibrate",
        description="Calibrate the card's ECM model from its own "
                    "measurements and emit a versioned machine file.")
    ap.add_argument("--machine-out", metavar="PATH",
                    help="write the fitted machine file here")
    ap.add_argument("--snap-rtol", type=float, default=None,
                    help="snap-to-prior tolerance (default: "
                         "calibrate.SNAP_RTOL)")
    ap.add_argument("--no-snap", action="store_true",
                    help="adopt raw fits (snap_rtol=0)")
    ap.add_argument("--cache-dir", metavar="DIR",
                    help="enable the on-disk calibration cache at DIR")
    ap.add_argument("--no-cache", action="store_true",
                    help="ignore the disk cache even when configured")
    ap.add_argument("--max-residual", type=float, default=None,
                    help="exit 1 if any field's fit residual exceeds this "
                         "(default: calibrate.MAX_FIT_RESIDUAL)")
    ap.add_argument("--quiet", action="store_true",
                    help="print the summary line only")
    ap.add_argument("--device", default="cuda",
                    help="the card to calibrate (default: cuda)")
    return ap


def run(argv=None, *, backend=None):
    """The CLI's work: ``(exit code, CalibrationReport or None)``.
    ``backend`` replaces the card backend (its ``machine`` is the prior),
    as the tests do."""
    args = _parser().parse_args(argv)

    from repro_torch.core import calibrate as cal
    from repro_torch.core import diskcache
    from repro_torch.core.machine import load_machine_file

    if backend is None:
        import torch

        if not torch.cuda.is_available():
            print("calibrate: no CUDA device; the calibration measures the "
                  "card and has no CPU fallback", file=sys.stderr)
            return 2, None
        from repro_torch.benchmarks.gpu_calibrate import CardBackend
        from repro_torch.core.machine import GPUMachineModel

        backend = CardBackend(GPUMachineModel.from_device(args.device),
                              args.device)
    snap_rtol = 0.0 if args.no_snap else (
        cal.SNAP_RTOL if args.snap_rtol is None else args.snap_rtol)
    prev = diskcache.set_cache_dir(args.cache_dir) if args.cache_dir else None
    try:
        report = cal.calibrate(backend.machine, backend=backend,
                               snap_rtol=snap_rtol,
                               use_cache=not args.no_cache)
    finally:
        if prev is not None:
            diskcache.restore_cache_dir(prev)

    if args.quiet:
        print(f"calibrated {report.base!r}: {len(report.fits)} fields, "
              f"max residual {report.residual_max():.5f}"
              + (" (cached)" if report.from_cache else ""))
    else:
        print(cal.format_report(report))

    if args.machine_out:
        path = report.save(args.machine_out)
        if load_machine_file(path) != report.machine:
            print(f"FAIL: {path} does not load back to the fitted machine",
                  file=sys.stderr)
            return 1, report
        print(f"wrote {path}")

    bound = (cal.MAX_FIT_RESIDUAL if args.max_residual is None
             else args.max_residual)
    rc = 0
    if report.residual_max() > bound:
        print(f"FAIL: max fit residual {report.residual_max():.5f} "
              f"exceeds the bound {bound:g}", file=sys.stderr)
        rc = 1
    rfo = report.checks["rfo"]
    if rfo["verdict"] == "undetermined":
        print(f"FAIL: striad_rmw / striad = {rfo['ratio']:.4f} lies within "
              f"{rfo['band']:g} of neither {rfo['ecm_ratio_no_rfo']:.4f} (no "
              f"RFO) nor {rfo['ecm_ratio_rfo']:.4f} (RFO)", file=sys.stderr)
        rc = 1
    return rc, report


def main(argv=None) -> int:
    return run(argv)[0]


if __name__ == "__main__":
    raise SystemExit(main())
