"""The port's dry-run (``repro_torch.launch.dryrun``) on the CPU: fake
tensors, fake worlds of 256 and 512 ranks, ``--device cpu``.

* Smoke cells: a train cell on both production meshes in one child
  process (the world destroyed between them), its collectives by kind,
  mesh axis and group, the pod axis on the network; the roofline reader
  over the records; one-card cells whose traced FLOPs equal
  ``FlopCounterMode`` on the real CPU step; a serving cell of a family
  outside ``models/lm.py`` traced on a production mesh (zamba2's
  ``decode_32k``); ``predict_table``'s ``best_mesh`` beside a cell the
  reference skips; ``--device cuda`` refused without a card.

The CLI at full width is ``tests/test_torch_dryrun_cli.py``.  Every fake
world runs in a subprocess: a default process group left in
a test process would be reused by ``launch/mesh.py`` ``_start_group`` in
another file on the same worker.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import SHAPES, get_arch  # noqa: E402
from repro_torch.configs.base import ShapeSpec  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.models.common import cast_params, materialize  # noqa: E402
from repro_torch.train.steps import (make_prefill_step,  # noqa: E402
                                     make_serve_step)

ROOT = Path(__file__).resolve().parents[1]
ENV = {"PYTHONPATH": str(ROOT / "src"), "PATH": os.environ.get("PATH", ""),
       "JAX_PLATFORMS": "cpu", "OMP_NUM_THREADS": "1"}


def _run(args, timeout):
    return subprocess.run(args, capture_output=True, text=True, cwd=ROOT,
                          env=ENV, timeout=timeout)


_SMOKE_WORLDS = r"""
import json, sys
from repro_torch.configs import get_arch
from repro_torch.configs.base import ShapeSpec
from repro_torch.launch import dryrun

arch = get_arch("internlm2-1.8b", smoke=True)
shape = ShapeSpec("train_4k", 32, 64, "train")
out = {m: dryrun.trace_cell(arch, shape, mesh=m, device="cpu")
       for m in ("16x16", "2x16x16")}
print(json.dumps(out))
"""


def test_smoke_train_cell_on_both_worlds(tmp_path):
    out = _run([sys.executable, "-c", _SMOKE_WORLDS], timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    recs = json.loads(out.stdout.strip().splitlines()[-1])
    one, two = recs["16x16"], recs["2x16x16"]
    assert one["status"] == two["status"] == "ok"
    assert (one["local_rows"], two["local_rows"]) == (4, 2)
    groups = one["collectives"]["ops_by_kind_axis_group"]
    # the logits gathered over model (the tensor-parallel step), the
    # gradients of the data-replicated parameters all-reduced over data
    assert groups.get("all-gather/model/16", 0) > 0
    assert groups.get("all-reduce/data/16", 0) > 0
    groups2 = two["collectives"]["ops_by_kind_axis_group"]
    assert groups2.get("all-reduce/pod/2", 0) > 0
    assert one["ecm"]["t_net_s"] == 0 < two["ecm"]["t_net_s"]
    assert one["cost"]["flops_per_chip"] == 2 * two["cost"]["flops_per_chip"]
    # the roofline reader over the records
    from repro_torch.benchmarks import gpu_roofline

    for mesh, rec in recs.items():
        (tmp_path / f"a__b__{mesh}.json").write_text(json.dumps(rec))
    text = gpu_roofline.run(str(tmp_path))
    assert "mesh 16x16 (1 cells)" in text and "mesh 2x16x16 (1 cells)" in text
    assert "no dry-run records" in text      # the card mesh


def _real_flops(step, args) -> int:
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as fc:
        step(*args)
    return fc.get_total_flops()


@pytest.mark.parametrize("kind", ["prefill", "decode"])
@pytest.mark.parametrize("name", ["internlm2-1.8b", "granite-moe-1b-a400m",
                                  "xlstm-125m"])
def test_card_cells_count_the_real_steps_flops(name, kind):
    arch = get_arch(name, smoke=True)
    shape = ShapeSpec(kind, 32, 2, kind)
    rec = dryrun.trace_cell(arch, shape, mesh="card", device="cpu")
    assert rec["status"] == "ok" and rec["collectives"]["n_ops"] == 0
    gen = torch.Generator().manual_seed(0)
    params = cast_params(materialize(arch.param_spec(), gen, device="cpu"),
                         arch.cfg.dtype)
    batch = {k: torch.as_tensor(v) for k, v in arch.make_batch(shape).items()}
    if kind == "prefill":
        real = _real_flops(make_prefill_step(arch, max_len=shape.seq_len),
                           (params, batch))
    else:
        cache = materialize(arch.cache_spec(2, shape.seq_len), gen,
                            device="cpu")
        cache["length"] = shape.seq_len - 1
        real = _real_flops(make_serve_step(arch), (params, cache, batch))
    assert rec["cost"]["flops_per_chip"] == real > 0
    assert rec["ecm"]["t_link_s"] == rec["ecm"]["t_net_s"] == 0
    assert rec["fits_hbm"] and rec["peak_bytes_per_chip"] > 0


def test_serving_cell_on_a_production_mesh_is_skipped():
    """No serving cell is skipped for want of a port any more: zamba2's
    hybrid ``decode_32k`` traces ``ok`` on the 256-rank world (in a
    subprocess: a fake world needs a process of its own), its Mamba2
    mixers and shared attention tensor parallel over ``model``.  Only the
    reference's own skips stay (``test_run_cell_records_the_reference_skips``)."""
    code = ("import json; from repro_torch.configs import SHAPES, get_arch; "
            "from repro_torch.launch import dryrun; "
            "rec = dryrun.trace_cell(get_arch('zamba2-1.2b'), "
            "SHAPES['decode_32k'], mesh='16x16', device='cpu'); "
            "rec.pop('memory'); print(json.dumps(rec))")
    out = _run([sys.executable, "-c", code], timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    rec = json.loads(out.stdout.strip().splitlines()[-1])
    assert rec["status"] == "ok" and rec["fits_hbm"], rec
    assert rec["local_rows"] == 8 and rec["kv_divisible"] is True
    assert rec["collectives"]["ops_by_kind_axis_group"]["all-reduce/model/16"] > 0


def test_run_cell_records_the_reference_skips(tmp_path):
    rec = dryrun.run_cell("internlm2-1.8b", "long_500k", mesh="16x16",
                          out=str(tmp_path), device="cpu", verbose=False)
    assert rec["status"] == "skipped" and "long_500k" in rec["reason"]
    assert json.loads((tmp_path / "internlm2-1.8b__long_500k__16x16.json")
                      .read_text()) == rec


def test_predict_table_carries_best_mesh():
    pred = dryrun.composed_step_s("internlm2-1.8b", SHAPES["decode_32k"], 1)
    rec = {"arch": "internlm2-1.8b", "shape": "decode_32k", "mesh": "card",
           "status": "ok", "ecm": {"t_ecm_s": pred}}
    ok, reason = get_arch("internlm2-1.8b").shape_supported(SHAPES["long_500k"])
    skipped = {"arch": "internlm2-1.8b", "shape": "long_500k",
               "mesh": "16x16", "status": "skipped", "reason": reason}
    rows = dryrun.predict_table([rec, skipped])
    assert rows[0]["ratio"] == 1.0 and rows[0]["agrees"]
    assert rows[0]["best_mesh"].startswith("dp1/")
    assert not ok and rows[1]["status"] == "skipped"
    assert "long_500k" in rows[1]["reason"]
    text = dryrun.format_predict_table(rows)
    assert "best_mesh" in text and "SKIPPED" in text


def test_cuda_device_refused_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        dryrun.main(["--arch", "internlm2-1.8b", "--shape", "train_4k"])
