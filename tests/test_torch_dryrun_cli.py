"""The port's dry-run CLI at full width on the CPU (``--device cpu``, fake
tensors): ``internlm2-1.8b train_4k --both-meshes`` writes two ok records
with FLOPs, bytes, collectives and a peak, and ``--predict`` prints
``best_mesh``.  Each world runs in a child process of the CLI (one
default process group a process), the two at once; each traces the
full-width sharded train step, ~440k dispatched ops, in ~50-65 s.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
ENV = {"PYTHONPATH": str(ROOT / "src"), "PATH": os.environ.get("PATH", ""),
       "JAX_PLATFORMS": "cpu", "OMP_NUM_THREADS": "1"}


def test_cli_full_width_both_meshes(tmp_path):
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun",
         "--arch", "internlm2-1.8b", "--shape", "train_4k", "--both-meshes",
         "--device", "cpu", "--predict", "--out", str(tmp_path)],
        capture_output=True, text=True, cwd=ROOT, env=ENV, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    recs = {}
    for mesh in ("16x16", "2x16x16"):
        path = tmp_path / f"internlm2-1.8b__train_4k__{mesh}.json"
        recs[mesh] = rec = json.loads(path.read_text())
        assert rec["status"] == "ok" and rec["mesh"] == mesh
        assert rec["cost"]["flops_per_chip"] > 0
        assert rec["cost"]["bytes_per_chip"] > 0
        assert rec["collectives"]["n_ops"] > 0
        kinds = rec["collectives"]["out_bytes_by_kind"]
        # the logits and a layer's wk and wv gathered over the model
        # axis, the row-parallel sums over it, the gradients reduced
        # over the data axes
        assert kinds["all-gather"] > 0 and kinds["all-reduce"] > 0
        assert rec["peak_bytes_per_chip"] > rec["memory"][
            "argument_size_in_bytes"] > 0
        assert rec["capacity_bytes"] == 80 * 1024**3
        assert rec["ecm"]["t_link_s"] > 0 and rec["ecm"]["t_ecm_s"] > 0
    # the rank's rows halve on two pods; its pod-axis reduce rides the
    # network
    assert recs["2x16x16"]["local_rows"] * 2 == recs["16x16"]["local_rows"]
    assert recs["16x16"]["ecm"]["t_net_s"] == 0
    assert recs["2x16x16"]["ecm"]["t_net_s"] > 0
    assert "best_mesh" in out.stdout and "2 cells, 0 failures" in out.stdout
    table = [line for line in out.stdout.splitlines()
             if line.startswith("internlm2-1.8b")]
    assert len(table) == 2 and all("dp" in line for line in table)
