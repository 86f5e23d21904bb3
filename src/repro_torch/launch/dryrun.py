"""Multi-pod dry-run: trace every (architecture x input shape x mesh) cell
on a fake world and read the ECM / roofline resource terms off the trace
(the reference's ``repro/launch/dryrun.py``).

The reference lowers and compiles each cell with XLA over 256 or 512
fake host devices.  Here the cell's step runs once, eagerly, on fake
tensors (``FakeTensorMode``: no storage, no launch) on rank 0 of a
``"fake"`` process group of 256 or 512 ranks, through the production mesh
of ``launch/mesh.py`` (``(16, 16)`` over ``("data", "model")``, or
``(2, 16, 16)`` over ``("pod", "data", "model")``), or on one card with
no mesh (``--mesh card``).  ``core/hlo.py`` ``analyze`` counts the FLOPs,
the bytes, the collectives and the memory; ``core/gpu_ecm.py``
``from_resources`` turns them into the three-term model on the machine.

The step traced is the one the port runs there:

* *train* cells on a production mesh go through ``train/steps.py``
  ``make_sharded_train_step`` on a state sharded by ``param_shardings``
  with the rank's rows of the batch, tensor parallel: each rank
  computes on its parameter blocks, a weight gathered over an axis its
  use does not split at that use, layer by layer, and each gather's
  adjoint (a reduce-scatter) and each sum's (a sum) in the backward; the
  record shows those collectives by kind and mesh axis, and
  :func:`useful_share` against the cell of a data group's rows on one
  card reads how little of the step the model ranks repeat;
* *prefill* and *decode* cells on a production mesh trace
  ``make_prefill_step`` and ``make_serve_step`` tensor parallel, as
  ``launch/serve.py`` serves on a mesh: the parameters cast to the
  compute dtype and placed by ``param_shardings`` (``ensure_model_axis``)
  under the arch's profile, the batch and the cache by the input profile
  (``dist.sharding.input_profile``: the cache's KV heads over ``model``
  where they divide it, else its sequence, decoded by the flash decode
  under ``cache_seq_axis="model"``; the Mamba2 and xLSTM states by their
  heads where those divide it), under the serving profile
  (``dist.sharding.serving_profile``).  On ``card`` every serving cell
  traces the same steps on the cast parameters, with no mesh;
* ``long_500k`` and the encoder-only decode cells are skipped by
  ``ArchDef.shape_supported``, as in the reference.

Usage::

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch internlm2-1.8b \\
        --shape train_4k [--multi-pod | --both-meshes | --mesh card] \\
        [--device cpu] [--predict] [--machine results/h100.json]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --device cpu

``--device`` is ``cuda`` by default (fake tensors of the card: a backward
on fake CUDA tensors needs a torch built for CUDA, and the flash op's
fake version stands in for the kernel) and raises without a card;
``cpu`` traces fake CPU tensors (the plain attention).  One process
holds one default process group, so a run of several cells starts each
in a fresh process (:data:`JOBS` at once).  Each cell writes
``<out>/<arch>__<shape>__<mesh>.json`` (resumable: a cell with a record
is skipped unless ``--force``).  ``--predict`` prints the composed
prediction (``core/compose.py``) beside the traced ``t_ecm`` with the
ranked mesh (``core/mesh.py`` ``rank_meshes``) of each cell's card count.
The records' capacity is the machine's ``memory_bytes``.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
import traceback
from contextlib import contextmanager

import torch
import torch.distributed as dist

from ..configs import ARCH_NAMES, SHAPES, get_arch
from ..configs.base import ArchDef, ShapeSpec
from ..core import hlo as hlo_mod
from ..core.gpu_ecm import MeshSpec, from_resources
from ..core.machine import H100_SXM, GPUMachineModel, load_machine_file
from ..dist.sharding import (get_profile, input_profile,
                             kv_divisible, param_shardings, serving_profile,
                             use_mesh_context)
from ..models.common import abstract, cast_params, tree_leaves, tree_map
from ..optim import AdamWConfig
from ..optim.schedule import linear_warmup_cosine
from ..train.steps import (make_prefill_step, make_serve_step,
                           make_sharded_train_step, make_train_step,
                           state_spec)
from .mesh import make_production_mesh

#: mesh name -> (shape, axes); ``card`` is one card with no mesh
MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "card": ((1,), ("data",))}
DEFAULT_OUT = "results/dryrun_torch"
#: cells traced at once when a run has several, each in its own process
JOBS = 2


# ---------------------------------------------------------------------------
# input construction
# ---------------------------------------------------------------------------


def input_specs(arch: ArchDef, shape: ShapeSpec, *, device) -> dict:
    """Fake stand-ins for the step's data inputs (no storage under the
    caller's ``FakeTensorMode``): the dry-run's replacement for a data
    pipeline."""
    return arch.abstract_batch(shape, device=device)


def _local_batch(arch: ArchDef, shape: ShapeSpec, mesh, in_prof, *,
                 device) -> dict:
    """Rank 0's block of each batch input under the input profile (the
    rows the sharded step takes)."""
    spec = arch.batch_spec(shape)
    shardings = param_shardings(spec, mesh, in_prof)
    origin = (0,) * len(mesh.mesh_dim_names)

    def block(s, sh):
        size = tuple(sl.stop - sl.start for sl in sh.index(origin, s.shape))
        return torch.empty(size, dtype=s.dtype, device=device)
    return {k: block(spec[k], shardings[k]) for k in spec}


@contextmanager
def fake_world(n_ranks: int):
    """A ``"fake"`` process group of ``n_ranks`` ranks with this process as
    rank 0, destroyed on exit; refuses to start beside another group."""
    if dist.is_initialized():
        raise RuntimeError("a process group is already running here: a fake "
                           "world needs a process of its own")
    # the fake backend registers itself where torch defines it
    import torch.testing._internal.distributed.fake_pg  # noqa: F401

    dist.init_process_group("fake", store=dist.HashStore(), rank=0,
                            world_size=n_ranks)
    try:
        yield
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# tracing one cell
# ---------------------------------------------------------------------------


def _check_device(device: str) -> None:
    if device not in ("cuda", "cpu"):
        raise ValueError(f"device {device!r}: 'cuda' or 'cpu'")
    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the dry-run traces fake CUDA "
                           "tensors on the card unless the caller asks for "
                           "the CPU (--device cpu)")


def _placed(tree, shardings):
    """Fake leaves on their shardings (each rank's block; no
    communication)."""
    it = iter([sh.distribute(t) for t, sh in
               zip(tree_leaves(tree), tree_leaves(shardings))])
    return tree_map(lambda _: next(it), tree)


def _sharded_state(sspec, shardings, device):
    return _placed(abstract(sspec, device=device), shardings)


def _train_accum(arch: ArchDef, rows: int) -> int:
    """The arch's accumulation, at most the rank's rows and dividing them."""
    accum = min(arch.train_accum, rows)
    while rows % accum:
        accum -= 1
    return max(accum, 1)


def _trace_train_on_mesh(arch, shape, mesh, multi_pod, opt_cfg, device):
    profile = get_profile(arch.profile, multi_pod=multi_pod)
    kv_div = kv_divisible(arch.cfg, mesh)
    batch_axes = profile.activation_rules.get("batch")
    in_prof = input_profile(multi_pod=multi_pod, kv_divisible=kv_div,
                            batch_axes=batch_axes)
    sspec = state_spec(arch, opt_cfg)
    shardings = param_shardings(sspec, mesh, profile, ensure_model_axis=True)
    state = _sharded_state(sspec, shardings, device)
    batch = _local_batch(arch, shape, mesh, in_prof, device=device)
    rows = next(iter(batch.values())).shape[0]
    accum = _train_accum(arch, rows)
    axes = batch_axes if isinstance(batch_axes, tuple) else (batch_axes,)
    step = make_sharded_train_step(
        arch, opt_cfg, linear_warmup_cosine(3e-4, 100, 10_000), mesh=mesh,
        shardings=shardings, batch_axes=axes, accum=accum)
    return step, (state, batch), {"accum": accum, "local_rows": rows,
                                  "kv_divisible": kv_div}


def _trace_serve_on_mesh(arch, shape, mesh, multi_pod, device, max_len,
                         cache_spec):
    """A serving cell on a production mesh: the steps ``launch/serve.py``
    runs there, on rank 0's blocks."""
    profile = get_profile(arch.profile, multi_pod=multi_pod)
    kv_div = kv_divisible(arch.cfg, mesh)
    in_prof = input_profile(multi_pod=multi_pod, kv_divisible=kv_div,
                            batch_axes=profile.activation_rules.get("batch"))
    pspec = arch.param_spec()
    params = _placed(cast_params(abstract(pspec, device=device),
                                 arch.cfg.dtype),
                     param_shardings(pspec, mesh, profile,
                                     ensure_model_axis=True))
    batch = _placed(input_specs(arch, shape, device=device),
                    param_shardings(arch.batch_spec(shape), mesh, in_prof))
    context = {"mesh": mesh, "multi_pod": multi_pod,
               "profile": serving_profile(profile, shape.kind,
                                          kv_divisible=kv_div)}
    if shape.kind == "prefill":
        inner = make_prefill_step(arch, max_len=max_len,
                                  cache_profile=in_prof)
        args = (params, batch)
    else:
        cspec = cache_spec or arch.cache_spec(shape.global_batch, max_len)
        cache = _placed(abstract(cspec, device=device),
                        param_shardings(cspec, mesh, in_prof))
        cache["length"] = shape.seq_len - 1
        context["cache_seq_axis"] = None if kv_div else "model"
        inner = make_serve_step(arch)
        args = (params, cache, batch)

    def step(*a):
        with use_mesh_context(**context):
            return inner(*a)
    return step, args, {"kv_divisible": kv_div,
                        "local_rows": batch["tokens"].to_local().shape[0],
                        "cache_seq_axis": context.get("cache_seq_axis")}


def _serve_cache(arch, shape, device, max_len, spec=None):
    """A fake decode cache of ``max_len`` positions (or of the spec tree
    ``spec``) holding ``seq_len - 1`` tokens (the one decoded makes
    ``seq_len``)."""
    spec = spec or arch.cache_spec(shape.global_batch, max_len)
    cache = abstract(spec, device=device)
    cache["length"] = shape.seq_len - 1
    return cache


def _trace_on_card(arch, shape, opt_cfg, device, max_len, cache_spec):
    if shape.kind == "train":
        state = abstract(state_spec(arch, opt_cfg), device=device)
        batch = input_specs(arch, shape, device=device)
        accum = _train_accum(arch, shape.global_batch)
        step = make_train_step(arch, opt_cfg,
                               linear_warmup_cosine(3e-4, 100, 10_000),
                               accum=accum)
        return step, (state, batch), {"accum": accum,
                                      "local_rows": shape.global_batch}
    params = cast_params(abstract(arch.param_spec(), device=device),
                         arch.cfg.dtype)
    batch = input_specs(arch, shape, device=device)
    if shape.kind == "prefill":
        return make_prefill_step(arch, max_len=max_len), (params, batch), {}
    return (make_serve_step(arch),
            (params, _serve_cache(arch, shape, device, max_len, cache_spec),
             batch), {})


def trace_cell(arch: ArchDef, shape: ShapeSpec, *, mesh: str = "16x16",
               device: str = "cuda",
               machine: GPUMachineModel | None = None,
               max_len: int | None = None, cache_spec=None) -> dict:
    """Trace one (arch x shape x mesh) cell on fake tensors and return its
    record (the reference's ``lower_cell`` record, ``t_trace_s`` for its
    lowering and compile times, ``t_link_s`` / ``t_net_s`` for its
    ICI / DCN terms).  A production mesh runs inside a fake world of its
    rank count; ``card`` needs none.  ``max_len``: the cache positions of
    a serving cell (``shape.seq_len`` by default; a decode cell holds
    ``seq_len - 1`` tokens and decodes one); ``cache_spec``: a decode
    cell's cache spec tree where ``arch.cache_spec`` is not the served one
    (whisper's cross K/V at the prompt's frames, not the config's
    ``max_frames``), on one card or placed by the input profile."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    _check_device(device)
    machine = machine or _default_machine(device)
    opt_cfg = AdamWConfig(moment_dtype=arch.moment_dtype)
    dims, axes = MESHES[mesh]
    head = {"arch": arch.name, "shape": shape.name, "mesh": mesh,
            "profile": arch.profile, "kind": shape.kind, "device": device}
    spec = MeshSpec(shape=dims, axes=axes)
    t0 = time.perf_counter()
    with _world(mesh):
        # the mesh's own tensors are real: build it outside the fake mode
        dmesh = (None if mesh == "card" else
                 make_production_mesh(multi_pod=mesh == "2x16x16",
                                      device=device))
        with FakeTensorMode():
            if dmesh is None:
                step, args, info = _trace_on_card(
                    arch, shape, opt_cfg, device, max_len or shape.seq_len,
                    cache_spec)
                info.setdefault("kv_divisible", True)
            elif shape.kind == "train":
                step, args, info = _trace_train_on_mesh(
                    arch, shape, dmesh, mesh == "2x16x16", opt_cfg, device)
            else:
                step, args, info = _trace_serve_on_mesh(
                    arch, shape, dmesh, mesh == "2x16x16", device,
                    max_len or shape.seq_len, cache_spec)
            t_setup = time.perf_counter() - t0
            axes = {} if dmesh is None else hlo_mod.mesh_axes(dmesh)
            trace = hlo_mod.analyze(step, *args, mesh_axes=axes)
            del args
    t_trace = time.perf_counter() - t0 - t_setup
    res, mem = trace.resources, hlo_mod.memory_analysis_dict(trace)
    ecm = from_resources(res, spec, name=f"{arch.name}/{shape.name}",
                         machine=machine, model_flops=arch.model_flops(shape),
                         flops_are_global=False)
    peak = mem["peak_size_in_bytes"]
    groups: dict[str, int] = {}
    sizes: dict[str, int] = {}
    for c in res.collectives:
        key = f"{c.kind}/{c.axis or '-'}/{c.group_size}"
        groups[key] = groups.get(key, 0) + 1
        key = (f"{c.kind}{'.' + c.op if c.op else ''}/{c.axis or '-'}/"
               f"{int(c.out_bytes)}")
        sizes[key] = sizes.get(key, 0) + 1
    return head | {
        "status": "ok",
        "kv_divisible": info.pop("kv_divisible"),
        **info,
        "t_setup_s": round(t_setup, 2),
        "t_trace_s": round(t_trace, 2),
        "memory": mem,
        "peak_bytes_per_chip": peak,
        "capacity_bytes": machine.memory_bytes,
        "fits_hbm": bool(peak < machine.memory_bytes),
        "cost": {"flops_per_chip": res.flops,
                 "bytes_per_chip": res.bytes_accessed,
                 "transcendentals": res.transcendentals},
        "collectives": {
            "n_ops": len(res.collectives),
            "out_bytes_by_kind": res.by_kind(),
            "wire_bytes_per_chip": res.wire_bytes_per_chip,
            "ops_by_kind_axis_group": groups,
            "ops_by_kind_axis_bytes": sizes,
        },
        "machine": machine.name,
        "ecm": ecm.summary(),
    }


def flash_decode_reduces(rec: dict, cfg) -> dict[str, int]:
    """The all-reduces over ``model`` of a decode record by what they
    reduce, on its ``local_rows`` B: ``max`` and ``denominator``, the
    flash decode's ``(B, kvH, rep)`` f32 max and sum (one each a layer);
    ``sums``, every sum over ``model``.  The flash decode's numerator
    ``(B, kvH, rep, hd)`` is a sum beside the tensor-parallel ones."""
    small = rec["local_rows"] * cfg.n_heads * 4
    ops = rec["collectives"]["ops_by_kind_axis_bytes"]
    return {"max": sum(n for k, n in ops.items()
                       if k.startswith("all-reduce.max/model/")),
            "denominator": ops.get(f"all-reduce.sum/model/{small}", 0),
            "sums": sum(n for k, n in ops.items()
                        if k.startswith("all-reduce.sum/model/"))}


def useful_share(mesh_rec: dict, rows_rec: dict, data_ranks: int) -> float:
    """The share of a cell's work that is not repeated across ranks: the
    traced FLOPs of one data group's rows on one card (``rows_rec``)
    over the per-card FLOPs of the cell on the mesh times the ranks of a
    data group, ``n_chips / data_ranks`` (1/that where the model ranks
    repeat the whole step)."""
    n_chips, _ = _chips(mesh_rec["mesh"])
    return (rows_rec["cost"]["flops_per_chip"]
            / (mesh_rec["cost"]["flops_per_chip"] * n_chips / data_ranks))


@contextmanager
def _world(mesh: str):
    if mesh == "card":
        yield
        return
    dims, _ = MESHES[mesh]
    n = 1
    for d in dims:
        n *= d
    with fake_world(n):
        yield


def _default_machine(device: str) -> GPUMachineModel:
    if device == "cuda":
        return GPUMachineModel.from_device(torch.device("cuda"))
    return H100_SXM


# ---------------------------------------------------------------------------
# composed-prediction table (--predict)
# ---------------------------------------------------------------------------

#: a train step is forward + backward; the backward runs each product
#: twice (dL/dx and dL/dW), so a step is ~3x the composed forward
TRAIN_STEP_MULT = 3.0


def _elem_bytes(arch_name: str) -> int:
    """The operand size of the arch's products (its compute dtype)."""
    dtype = getattr(get_arch(arch_name).cfg, "dtype", torch.float32)
    return torch.empty((), dtype=dtype).element_size()


def composed_step_s(arch_name: str, shape: ShapeSpec, n_chips: int, *,
                    machine: GPUMachineModel = H100_SXM,
                    elem_bytes: int | None = None) -> float:
    """Per-card composed step time for one cell (ideal weak scaling: the
    whole-model composition divided over the mesh's cards), products at
    the arch's compute dtype unless ``elem_bytes`` says otherwise."""
    from ..core import compose

    eb = _elem_bytes(arch_name) if elem_bytes is None else elem_bytes
    if shape.kind == "decode":
        pred = compose.predict_step(
            arch_name, machine, batch=shape.global_batch,
            seq_len=shape.seq_len, context=shape.seq_len,
            phases=("decode",), elem_bytes=eb)
        t = pred.decode_s
    else:
        pred = compose.predict_step(
            arch_name, machine, batch=shape.global_batch,
            seq_len=shape.seq_len, phases=("prefill",), elem_bytes=eb)
        t = pred.prefill_s
        if shape.kind == "train":
            t *= TRAIN_STEP_MULT
    return t / n_chips


def _chips(mesh: str) -> tuple[int, int]:
    """(cards, pods) of a mesh name."""
    dims, axes = MESHES[mesh]
    spec = MeshSpec(shape=dims, axes=axes)
    return spec.n_chips, spec.n_pods


def predict_table(records, *, machine: GPUMachineModel = H100_SXM
                  ) -> list[dict]:
    """One row per dry-run record: the composed whole-model prediction
    against the traced three-term model, and ``best_mesh``, the ranked
    winner of ``core/mesh.py`` ``rank_meshes`` at the cell's card count.
    Skipped and errored cells stay in the table with their reason."""
    from ..core.compose import DRYRUN_TOLERANCE
    from ..core.mesh import rank_meshes

    lo, hi = DRYRUN_TOLERANCE
    rows = []
    for rec in records:
        row = {"arch": rec["arch"], "shape": rec["shape"],
               "mesh": rec["mesh"], "status": rec["status"]}
        if rec["status"] != "ok":
            row["reason"] = rec.get("reason") or rec.get("error", "")
            rows.append(row)
            continue
        shape = SHAPES[rec["shape"]]
        n_chips, pods = _chips(rec["mesh"])
        pred = composed_step_s(rec["arch"], shape, n_chips, machine=machine)
        sim = float(rec["ecm"]["t_ecm_s"])
        ratio = pred / sim if sim > 0 else float("inf")
        phase = shape.kind if shape.kind in ("train", "decode") else "prefill"
        best = rank_meshes(
            rec["arch"], n_chips, machine, batch=shape.global_batch,
            seq_len=shape.seq_len,
            context=shape.seq_len if phase == "decode" else None,
            phase=phase, pods=pods, include_blocks=False, top=1)[0]
        row.update(predicted_s=pred, simulated_s=sim, ratio=ratio,
                   agrees=bool(lo <= ratio <= hi),
                   best_mesh=f"{best['mesh']}/{best['profile']}")
        rows.append(row)
    return rows


def format_predict_table(rows) -> str:
    header = (f"{'arch':<24} {'shape':<12} {'mesh':<8} "
              f"{'predicted_s':>12} {'simulated_s':>12} {'ratio':>7}  "
              f"{'ok':<3} best_mesh")
    lines = [header, "-" * len(header)]
    for r in rows:
        if r["status"] != "ok":
            lines.append(f"{r['arch']:<24} {r['shape']:<12} {r['mesh']:<8} "
                         f"{r['status'].upper()}: {r.get('reason', '')}")
            continue
        lines.append(
            f"{r['arch']:<24} {r['shape']:<12} {r['mesh']:<8} "
            f"{r['predicted_s']:>12.4g} {r['simulated_s']:>12.4g} "
            f"{r['ratio']:>7.2f}  {'yes' if r['agrees'] else 'NO':<3} "
            f"{r.get('best_mesh', '')}")
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------


def _result_path(out: str, arch_name: str, shape_name: str, mesh: str) -> str:
    safe = arch_name.replace("/", "_")
    return os.path.join(out, f"{safe}__{shape_name}__{mesh}.json")


def run_cell(arch_name: str, shape_name: str, *, mesh: str, out: str,
             force: bool = False, verbose: bool = True, device: str = "cuda",
             machine: GPUMachineModel | None = None) -> dict:
    """Trace one cell (or read its record) and write its record."""
    os.makedirs(out, exist_ok=True)
    path = _result_path(out, arch_name, shape_name, mesh)
    if os.path.exists(path) and not force:
        with open(path) as f:
            return json.load(f)
    arch = get_arch(arch_name)
    shape = SHAPES[shape_name]
    ok, reason = arch.shape_supported(shape)
    if not ok:
        record = {"arch": arch_name, "shape": shape_name, "mesh": mesh,
                  "status": "skipped", "reason": reason}
    else:
        try:
            record = trace_cell(arch, shape, mesh=mesh, device=device,
                                machine=machine)
        # a grid survey records a failed cell as data, not a crash
        except Exception as e:  # noqa: BLE001
            record = {"arch": arch_name, "shape": shape_name, "mesh": mesh,
                      "status": "error", "error": f"{type(e).__name__}: {e}",
                      "traceback": traceback.format_exc()[-4000:]}
    if verbose:
        tag = f"[dryrun] {arch_name} x {shape_name} ({mesh})"
        if record["status"] == "ok":
            print(f"{tag}: trace ok, "
                  f"{record['peak_bytes_per_chip'] / 2**30:.2f} GiB/card, "
                  f"dominant={record['ecm']['dominant']}")
            print(json.dumps(record["memory"], indent=1))
            print(json.dumps(record["cost"], indent=1))
        else:
            print(f"{tag}: {record['status'].upper()}: "
                  f"{record.get('reason') or record.get('error')}")
    with open(path, "w") as f:
        json.dump(record, f, indent=1)
    return record


def _machine(path: str | None, device: str) -> GPUMachineModel:
    return load_machine_file(path) if path else _default_machine(device)


def _in_children(cells, args) -> list[dict]:
    """Each cell in a fresh process (one process group each), JOBS at a
    time; the records as the children wrote them."""
    base = [sys.executable, "-m", "repro_torch.launch.dryrun",
            "--out", args.out, "--device", args.device]
    if args.force:
        base.append("--force")
    if args.machine:
        base += ["--machine", args.machine]
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [root] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep)
                  if p]))
    pending, running = list(cells), []
    while pending or running:
        while pending and len(running) < JOBS:
            a, s, m = pending.pop(0)
            running.append(subprocess.Popen(
                base + ["--arch", a, "--shape", s, "--mesh", m], env=env))
        running.pop(0).wait()
    records = []
    for a, s, m in cells:
        with open(_result_path(args.out, a, s, m)) as f:
            records.append(json.load(f))
    return records


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.dryrun",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", choices=ARCH_NAMES)
    ap.add_argument("--shape", choices=tuple(SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--mesh", choices=tuple(MESHES),
                    help="one mesh by name (default: 16x16, or 2x16x16 "
                         "with --multi-pod)")
    ap.add_argument("--all", action="store_true",
                    help="every (arch x shape) cell on both meshes")
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--predict", action="store_true",
                    help="print the composed-vs-traced step-time table "
                         "(core/compose.py) over the run's cells")
    ap.add_argument("--machine", default=None,
                    help="a calibrated machine file (default: the card's "
                         "data sheet, H100_SXM with --device cpu)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="the fake tensors' device (default: cuda)")
    return ap


def main(argv=None) -> int:
    args = _parser().parse_args(argv)
    _check_device(args.device)
    machine = _machine(args.machine, args.device)
    if args.all:
        cells = [(a, s, m) for a in ARCH_NAMES for s in SHAPES
                 for m in ("16x16", "2x16x16")]
    else:
        if not (args.arch and args.shape):
            _parser().error("--arch and --shape, or --all")
        if args.both_meshes:
            meshes = ["16x16", "2x16x16"]
        else:
            meshes = [args.mesh or ("2x16x16" if args.multi_pod else "16x16")]
        cells = [(args.arch, args.shape, m) for m in meshes]
    if len(cells) == 1:
        records = [run_cell(*cells[0][:2], mesh=cells[0][2], out=args.out,
                            force=args.force, device=args.device,
                            machine=machine)]
    else:
        records = _in_children(cells, args)
    failures = sum(r["status"] == "error" for r in records)
    skipped = sum(r["status"] == "skipped" for r in records)
    if args.predict:
        print(format_predict_table(predict_table(records, machine=machine)))
    print(f"[dryrun] done: {len(cells)} cells, {failures} failures, "
          f"{skipped} skipped")
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
