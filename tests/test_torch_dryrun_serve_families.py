"""The dry-run's serving cells of the families outside ``models/lm.py``
on the fake 256-rank ``16x16`` world (``repro_torch.launch.dryrun``,
``--device cpu``), at full width with the attention on the flash op
(its plain version on fake CPU tensors): zamba2-1.2b ``prefill_32k``,
whisper-base ``decode_32k`` and xlstm-125m ``decode_32k``.  zamba2's
depth is cut to one Mamba2 layer and the shared block before it here,
to keep the file's time (a full-depth ``prefill_32k`` takes ~3 minutes
to trace a side); ``chip_smoke.py`` phase 20 and ``PERF.md`` §5 trace
it at full depth.

* every cell traces ``ok`` and fits 80 GiB;
* zamba2's prefill useful share (``dryrun.useful_share``: one card's
  traced FLOPs on a data group's rows over the cell's per-card FLOPs
  times the 16 model ranks) is at least 0.5, where ranks that repeated
  the mixer would read about 1/16;
* the Mamba2 mixer's own collectives over ``model`` are there in every
  layer: the gated RMSNorm's sum of squares (an f32 all-reduce of one
  value a row and position) and the conv cache's x columns (an
  all-gather of K-1 positions);
* whisper's decode reads its self cache through the flash decode and its
  cross cache through the split softmax: two max all-reduces a layer.

Each cell traces in its own subprocess (a fake world needs a process of
its own), all at once.
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
#: zamba2's depth here (one Mamba2 layer, the shared block before it)
ZAMBA2_LAYERS = 1
#: (arch, shape, mesh); "card" traces a prefill of a data group's rows on
#: one card
CELLS = {"zamba2 prefill": ("zamba2-1.2b", "prefill_32k", "16x16"),
         "zamba2 rows": ("zamba2-1.2b", "prefill_32k", "card"),
         "whisper decode": ("whisper-base", "decode_32k", "16x16"),
         "xlstm decode": ("xlstm-125m", "decode_32k", "16x16")}

_TRACE = r"""
import dataclasses, json, sys
from repro_torch.configs import SHAPES, get_arch
from repro_torch.launch import dryrun

name, shape, mesh, layers = json.loads(sys.argv[1])
arch = get_arch(name)
kw = {"attn_impl": "flash"} if hasattr(arch.cfg, "attn_impl") else {}
if name == "zamba2-1.2b":
    kw["n_layers"] = layers
arch = dataclasses.replace(arch, cfg=dataclasses.replace(arch.cfg, **kw))
shape = SHAPES[shape]
if mesh == "card":
    shape = dataclasses.replace(shape, global_batch=shape.global_batch // 16)
rec = dryrun.trace_cell(arch, shape, mesh=mesh, device="cpu")
rec.pop("memory", None)
print(json.dumps(rec))
"""


@pytest.fixture(scope="module")
def cells():
    procs = {key: subprocess.Popen(
        [sys.executable, "-c", _TRACE, json.dumps([*cell, ZAMBA2_LAYERS])],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=ROOT,
        env=ENV) for key, cell in CELLS.items()}
    out = {}
    for key, proc in procs.items():
        stdout, stderr = proc.communicate(timeout=240)
        assert proc.returncode == 0, (key, stderr[-3000:])
        out[key] = json.loads(stdout.strip().splitlines()[-1])
    return out


@pytest.mark.parametrize("key", CELLS)
def test_cell_traces_and_fits(cells, key):
    rec = cells[key]
    assert rec["status"] == "ok", rec
    assert rec["cost"]["flops_per_chip"] > 0
    if rec["mesh"] != "card":
        assert rec["fits_hbm"], rec["peak_bytes_per_chip"]
        assert rec["collectives"]["n_ops"] > 0


def test_zamba2_prefill_splits_the_mixer(cells):
    rec = cells["zamba2 prefill"]
    share = dryrun.useful_share(rec, cells["zamba2 rows"], 16)
    assert 0.5 <= share <= 1.0, share
    m = get_arch("zamba2-1.2b").cfg.mamba_cfg
    rows, seq = rec["local_rows"], 32_768
    ops = rec["collectives"]["ops_by_kind_axis_bytes"]
    norm = f"all-reduce.sum/model/{rows * seq * 4}"
    conv = f"all-gather/model/{rows * (m.conv_kernel - 1) * m.d_inner * 2}"
    assert ops.get(norm) == ops.get(conv) == ZAMBA2_LAYERS, ops
    assert rec["kv_divisible"] is True and rows == 2


def test_whisper_decode_reads_both_caches_split(cells):
    rec = cells["whisper decode"]
    cfg = get_arch("whisper-base").cfg
    got = dryrun.flash_decode_reduces(rec, cfg)
    assert rec["cache_seq_axis"] == "model" and rec["local_rows"] == 8
    assert got["max"] == got["denominator"] == 2 * cfg.n_layers, got


def test_xlstm_decode_gathers_its_weights(cells):
    """``dp_vocab`` shards every large block weight over ``model`` for
    storage (``ensure_model_axis``): each is gathered at its use, and the
    vocabulary's logits once."""
    rec = cells["xlstm decode"]
    groups = rec["collectives"]["ops_by_kind_axis_group"]
    assert groups["all-gather/model/16"] > get_arch("xlstm-125m").cfg.n_layers
    assert groups["all-gather/data/16"] == 1
