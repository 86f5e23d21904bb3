"""The per-(arch x shape x mesh) three-term ECM / roofline table, read from
the port's dry-run records (``results/dryrun_torch/*.json``; the
reference's ``benchmarks/tpu_roofline.py``).

Terms per cell, seconds a step, per card, as ``launch/dryrun.py`` wrote
them from the machine it ran with (``core/gpu_ecm.py`` ``from_resources``):

    compute    = traced FLOPs / peak_bf16_tensor_flops
                 (H100 SXM data sheet: 989e12, dense bf16)
    memory     = traced bytes / hbm_bytes_per_s
                 (data sheet: 3.35e12; bytes per eager op, an upper bound)
    collective = wire bytes over NVLink / nvlink_bytes_per_s
                 (data sheet: 450e9 each way) + those over the network /
                 net_bytes_per_s (DGX H100, one 400 Gb/s ConnectX-7 NDR
                 port a card: 50e9 each way)

plus MODEL_FLOPS / traced FLOPs (the useful-compute fraction), the
dominant term and the peak memory per card against the machine's
``memory_bytes`` (``!`` where it does not fit).  Run ``python -m
repro_torch.launch.dryrun`` first (``--all`` for every cell); then::

    PYTHONPATH=src python -m repro_torch.benchmarks.gpu_roofline [DIR]
"""
from __future__ import annotations

import glob
import json
import os
import sys

from ..launch.dryrun import DEFAULT_OUT, MESHES


def fmt(x, nd: int = 1) -> str:
    if x is None:
        return "-"
    r = round(float(x), nd)
    if abs(r - round(r)) < 1e-9:
        return str(int(round(r)))
    return f"{r:.{nd}f}"


def table(headers: list[str], rows: list[list]) -> str:
    widths = [max(len(str(headers[c])), *(len(str(r[c])) for r in rows)) + 2
              for c in range(len(headers))]

    def line(cells):
        return "".join(str(c).ljust(w) for c, w in zip(cells, widths)).rstrip()
    out = [line(headers), line(["-" * (w - 2) for w in widths])]
    return "\n".join(out + [line(r) for r in rows])


def load_records(results: str, mesh: str | None = None) -> list[dict]:
    recs = []
    for path in sorted(glob.glob(os.path.join(results, "*.json"))):
        with open(path) as f:
            r = json.load(f)
        if mesh and r.get("mesh") != mesh:
            continue
        recs.append(r)
    return recs


def roofline_rows(recs: list[dict]) -> list[list]:
    rows = []
    for r in recs:
        if r["status"] != "ok":
            why = r.get("reason") or r.get("error", "")
            rows.append([r["arch"], r["shape"], r["mesh"],
                         r["status"].upper()[:5], "-", "-", "-", "-", "-",
                         "-", why[:38]])
            continue
        e = r["ecm"]
        rows.append([
            r["arch"], r["shape"], r["mesh"], "ok",
            fmt(e["t_comp_s"] * 1e3, 2), fmt(e["t_hbm_s"] * 1e3, 2),
            fmt((e["t_link_s"] + e["t_net_s"]) * 1e3, 2),
            e["dominant"][:4],
            fmt(e["useful_flops_fraction"], 3),
            fmt(e["roofline_fraction"], 3),
            fmt(r["peak_bytes_per_chip"] / 2**30, 1) + "GiB"
            + ("" if r.get("fits_hbm") else "!"),
        ])
    return rows


def run(results: str = DEFAULT_OUT) -> str:
    out = []
    for mesh in MESHES:
        recs = load_records(results, mesh)
        if not recs:
            out.append(f"== {mesh}: no dry-run records in {results} ==")
            continue
        out.append(f"== roofline, mesh {mesh} ({len(recs)} cells) ==")
        out.append(table(
            ["arch", "shape", "mesh", "st", "comp_ms", "hbm_ms", "coll_ms",
             "dom", "useful", "roofline", "mem/card"],
            roofline_rows(recs)))
        ok = [r for r in recs if r["status"] == "ok"]
        if ok:
            worst = min(ok, key=lambda r: r["ecm"]["roofline_fraction"])
            def coll_s(r):
                return r["ecm"]["t_link_s"] + r["ecm"]["t_net_s"]
            coll = max(ok, key=coll_s)
            out.append(f"  worst roofline fraction: {worst['arch']} x "
                       f"{worst['shape']} "
                       f"({worst['ecm']['roofline_fraction']:.3f})")
            out.append(f"  most collective-bound:  {coll['arch']} x "
                       f"{coll['shape']} ({coll_s(coll) * 1e3:.2f} ms)")
        out.append("")
    return "\n".join(out)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    print(run(argv[0] if argv else DEFAULT_OUT))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
