"""The dry-run's train cell with the tensor-parallel step
(``repro_torch.launch.dryrun``, ``--device cpu``): internlm2-1.8b at full
width cut to 2 layers, ``train_4k`` on fake CPU tensors on the fake
256-rank ``16x16`` world, and its rows cell (a data group's 16 rows on one
card, no mesh), both in one subprocess (a fake world needs a process of
its own):

* both trace ``ok``, and the mesh cell fits 80 GiB below the rows cell's
  peak;
* the useful share (``dryrun.useful_share``: the rows cell's FLOPs over
  the mesh cell's per-card FLOPs times the 16 model ranks) is at least
  0.5, where model ranks that repeated the whole step would read 1/16;
* no parameter is gathered whole over ``model`` for the step: every
  all-gather over ``model`` is of one layer's block of a stacked leaf in
  the compute dtype (internlm2's ``wk`` and ``wv``, whose 8 KV heads do
  not split over 16 ranks, come with ``model`` on their embed dim), or of
  the logits; each gather's adjoint is a reduce-scatter over ``model``;
* the forward's and backward's sums over ``model`` (the row-parallel
  products and the embedding) and the gradients' sums over ``data``.
"""
import dataclasses
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
ENV = {"PYTHONPATH": str(ROOT / "src"), "PATH": os.environ.get("PATH", ""),
       "JAX_PLATFORMS": "cpu", "OMP_NUM_THREADS": "1"}
LAYERS = 2
DATA_RANKS = 16

_TRACE = r"""
import dataclasses, json, sys
from repro_torch.configs import SHAPES, get_arch
from repro_torch.launch import dryrun

arch = get_arch("internlm2-1.8b")
arch = dataclasses.replace(arch, cfg=dataclasses.replace(
    arch.cfg, n_layers=int(sys.argv[1])))
shape = SHAPES["train_4k"]
rows = dataclasses.replace(shape, global_batch=shape.global_batch
                           // int(sys.argv[2]))
print(json.dumps({"mesh": dryrun.trace_cell(arch, shape, mesh="16x16",
                                            device="cpu"),
                  "rows": dryrun.trace_cell(arch, rows, mesh="card",
                                            device="cpu")}))
"""


def _arch():
    from repro_torch.configs import get_arch

    arch = get_arch("internlm2-1.8b")
    return dataclasses.replace(arch, cfg=dataclasses.replace(
        arch.cfg, n_layers=LAYERS))


@pytest.fixture(scope="module")
def cells():
    out = subprocess.run([sys.executable, "-c", _TRACE, str(LAYERS),
                          str(DATA_RANKS)], capture_output=True, text=True,
                         cwd=ROOT, env=ENV, timeout=240)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_cells_trace_and_fit(cells):
    mesh, rows = cells["mesh"], cells["rows"]
    assert mesh["status"] == rows["status"] == "ok"
    assert mesh["local_rows"] == rows["local_rows"] == 16
    assert mesh["accum"] == rows["accum"] == 2
    assert mesh["fits_hbm"] and mesh["capacity_bytes"] == 80 * 1024**3
    assert 0 < mesh["peak_bytes_per_chip"] < rows["peak_bytes_per_chip"]


def test_useful_share(cells):
    from repro_torch.launch.dryrun import useful_share

    share = useful_share(cells["mesh"], cells["rows"], DATA_RANKS)
    assert 0.5 <= share <= 1.0, share


def test_no_parameter_is_gathered_whole_over_model(cells):
    from repro_torch.models.common import tree_leaves

    arch = _arch()
    cfg = arch.cfg
    leaves = tree_leaves(arch.param_spec())
    whole = {math.prod(s.shape) * b for s in leaves for b in (2, 4)}
    layer = {math.prod(s.shape[1:]) * 2 for s in leaves
             if s.axes[0] == "layers"}
    micro = cells["mesh"]["local_rows"] // cells["mesh"]["accum"]
    logits = micro * 4096 * cfg.vocab_padded * 2
    ops = cells["mesh"]["collectives"]["ops_by_kind_axis_bytes"]
    gathers = {int(k.split("/")[-1]): n for k, n in ops.items()
               if k.startswith("all-gather/model/")}
    assert gathers and set(gathers) <= layer | {logits}, gathers
    assert not set(gathers) & whole, gathers
    assert gathers[logits] == cells["mesh"]["accum"]
    groups = cells["mesh"]["collectives"]["ops_by_kind_axis_group"]
    # every gather over model but the logits' has its adjoint in the
    # backward; the remat recompute gathers a layer's weights again
    assert groups["reduce-scatter/model/16"] > 0
    assert groups["all-reduce/model/16"] > 0
    assert groups["all-reduce/data/16"] > 0
