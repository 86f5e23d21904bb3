"""The dry-run's serving cells of the LM family on fake production
worlds (``repro_torch.launch.dryrun``, ``--device cpu``), the gates of
``chip_smoke.py`` phase 20 on the CPU: internlm2-1.8b ``prefill_32k`` and
``decode_32k`` and granite-moe-1b-a400m ``decode_32k`` on the 256-rank
``16x16`` world, internlm2-1.8b ``decode_32k`` on the 512-rank
``2x16x16`` one, at full width with the attention on the flash op (the
served path; its plain version on fake CPU tensors).

* every cell traces ``ok`` and fits 80 GiB;
* the prefill's useful share (``dryrun.useful_share``: one card's traced
  FLOPs on a data group's rows over the cell's per-card FLOPs times the
  16 model ranks) is at least 0.5, where ranks that repeated the step
  would read 1/16;
* each decode runs the flash decode in every layer: one max and one
  denominator all-reduce over ``model`` a layer, and a numerator sum of
  ``(B, H, hd)`` f32 beside them;
* the multi-pod cell gathers the logits' rows over ``pod`` too.

The fake worlds run in one subprocess (one world at a time), as in
``tests/test_torch_dryrun.py``.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
ENV = {"PYTHONPATH": str(ROOT / "src"), "PATH": os.environ.get("PATH", ""),
       "JAX_PLATFORMS": "cpu", "OMP_NUM_THREADS": "1"}
#: (arch, shape, mesh); ("card", rows) traces a prefill of a data group's
#: rows on one card
CELLS = {"prefill": ("internlm2-1.8b", "prefill_32k", "16x16"),
         "rows": ("internlm2-1.8b", "prefill_32k", "card"),
         "decode": ("internlm2-1.8b", "decode_32k", "16x16"),
         "moe decode": ("granite-moe-1b-a400m", "decode_32k", "16x16"),
         "pods decode": ("internlm2-1.8b", "decode_32k", "2x16x16")}
DATA_RANKS = {"16x16": 16, "2x16x16": 32}

_TRACE = r"""
import dataclasses, json, sys
from repro_torch.configs import SHAPES, get_arch
from repro_torch.launch import dryrun

out = {}
for key, (name, shape, mesh) in json.loads(sys.argv[1]).items():
    arch = get_arch(name)
    arch = dataclasses.replace(arch, cfg=dataclasses.replace(
        arch.cfg, attn_impl="flash"))
    shape = SHAPES[shape]
    if mesh == "card":
        shape = dataclasses.replace(shape, global_batch=shape.global_batch // 16)
    rec = dryrun.trace_cell(arch, shape, mesh=mesh, device="cpu")
    rec.pop("memory", None)
    out[key] = rec
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def cells():
    out = subprocess.run([sys.executable, "-c", _TRACE, json.dumps(CELLS)],
                         capture_output=True, text=True, cwd=ROOT, env=ENV,
                         timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("key", CELLS)
def test_cell_traces_and_fits(cells, key):
    rec = cells[key]
    assert rec["status"] == "ok", rec
    assert rec["cost"]["flops_per_chip"] > 0
    if rec["mesh"] != "card":
        assert rec["fits_hbm"], rec["peak_bytes_per_chip"]
        assert rec["collectives"]["n_ops"] > 0


def test_prefill_is_tensor_parallel(cells):
    """The model ranks split the prefill's work: the useful share is at
    least 0.5 (ranks repeating the step read 1/16), the collectives are
    over ``model`` but the logits' gather over ``data``."""
    rec = cells["prefill"]
    share = dryrun.useful_share(rec, cells["rows"], DATA_RANKS["16x16"])
    assert 0.5 <= share <= 1.0, share
    groups = rec["collectives"]["ops_by_kind_axis_group"]
    assert groups["all-reduce/model/16"] == 2 * 24 + 1      # wo, mlp; embed
    assert groups["all-gather/data/16"] == 1                # the logits' rows
    assert rec["kv_divisible"] is False and rec["local_rows"] == 2


@pytest.mark.parametrize("key", ["decode", "moe decode", "pods decode"])
def test_decode_runs_the_flash_decode_in_every_layer(cells, key):
    rec = cells[key]
    cfg = get_arch(CELLS[key][0]).cfg
    got = dryrun.flash_decode_reduces(rec, cfg)
    assert rec["cache_seq_axis"] == "model"
    assert got["max"] == got["denominator"] == cfg.n_layers, got
    numerator = rec["local_rows"] * cfg.n_heads * cfg.head_dim_ * 4
    ops = rec["collectives"]["ops_by_kind_axis_bytes"]
    assert ops.get(f"all-reduce.sum/model/{numerator}", 0) >= cfg.n_layers
    if key == "pods decode":
        assert rec["local_rows"] == 4
        assert rec["collectives"]["ops_by_kind_axis_group"].get(
            "all-gather/pod/2") == 1
