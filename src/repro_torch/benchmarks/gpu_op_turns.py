"""The flash-attention op at internlm2-1.8b's served prefill shape (B 8,
S 2048, H 16, Hkv 8, d 128, bf16, causal), timed from two source trees in
turns: another tree's ``src`` and this one's, each turn a fresh process
that builds the kernels from its tree and runs
``benchmarks/gpu_compute_ecm.py`` ``run`` at the point (the op's ms
through ``ops.flash_attention``, the kernel's at each compiled tiling,
CUDA events behind a busy-wait, median of 5).  Card only::

    PYTHONPATH=src python -m repro_torch.benchmarks.gpu_op_turns OTHER_SRC

prints the card's name and power limit and one JSON line a turn, in the
order of :data:`TURNS`.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

#: internlm2-1.8b's served prefill (phase 10 of ``chip_smoke.py``)
DIMS = (8, 2048, 2048, 16, 8, 128)
#: the trees in turn, each first as often as the other
TURNS = ("other", "this", "this", "other", "other", "this")

_TURN = r"""
import json, torch
from repro_torch import kernels
from repro_torch.benchmarks import gpu_compute_ecm as GC
from repro_torch.kernels import _build
_build.build(kernels.SOURCES)
point = GC.Point("attention", %r, torch.bfloat16, causal=True)
r = GC.run(point=point)
tm = r["timings"]
print(json.dumps({"op_ms": tm["op_ms"], "ms": tm["ms"], "block": r["block"],
                  "check": r["check"]}))
"""


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.benchmarks."
                                      "gpu_op_turns")
    ap.add_argument("other", help="the other tree's src directory")
    args = ap.parse_args(argv)
    this = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    trees = {"this": this, "other": os.path.abspath(args.other)}
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(card.strip())
    for turn in TURNS:
        out = subprocess.run(
            [sys.executable, "-c", _TURN % (DIMS,)], capture_output=True,
            text=True, env=dict(os.environ, PYTHONPATH=trees[turn]))
        if out.returncode:
            print(out.stderr[-3000:], file=sys.stderr)
            return 1
        rec = json.loads(out.stdout.strip().splitlines()[-1])
        print(json.dumps({"tree": turn, "src": trees[turn], "dims": DIMS}
                         | rec))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
