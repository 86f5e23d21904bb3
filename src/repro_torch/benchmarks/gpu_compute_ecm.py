"""The compute-bound ECM loop on the GPU: blocked matmul and flash attention.

The counterpart of the reference's ``benchmarks/compute_bench.py``: its
light-speed model of each kernel, its ranking of tilings
(``rank(..., objective="matmul"|"attention")``) and its kernel validation
at the tuned tiling (``kernel_payload``), plus the measurement on the
card that validates the ranking.  For one point:

* rank the tilings the kernel is compiled for by the GPU model
  (``core.autotune.rank``) and take the first;
* run the op at that tiling and hold its output against the plain version
  through ``kernels.check.compare`` at the reference's tolerances;
* on the card, time the kernel at every candidate tiling of the pick's
  route (is the model's pick the measured fastest, and if not, where does
  it rank?), the plain
  version, one library call that computes the same function (a yardstick
  the port never calls, with its own error against the plain version),
  and set the pick against the model and the card's least time for the
  work (``bound_ms``).

f32 runs in full f32: ``torch.backends.cuda.matmul.allow_tf32`` is off
while the plain versions and the yardsticks run (:func:`full_f32`).  The
matmul kernel takes f32 on its FFMA route and bf16 on its wgmma route
(``kernels/matmul/kernel.py``); each matmul point ranks and times its
route's tilings, and its report names the route.  Attention's kernel is
timed on the operands the op hands it, q, k and v as they are, no KV
head repeated; its bound counts those bytes.  The prefill point times
the tile route's tilings, the decode point the split route's.  A decode pick also
reports its split plan and times the combine kernel alone.  The plain
version and the library call take the reference's operands, KV repeated
to the query heads, prepared outside the timed call.

Run ``PYTHONPATH=src python -m repro_torch.benchmarks.gpu_compute_ecm`` on
a machine with the card; it prints JSON lines for each point in
:data:`POINTS`.
"""
from __future__ import annotations

import contextlib
import json
from dataclasses import asdict, dataclass

import torch
import torch.nn.functional as F

from ..core.autotune import rank
from ..core.gpu_ecm import gpu_attention_ecm, gpu_matmul_ecm
from ..core.machine import H100_SXM, GPUMachineModel
from ..kernels.attention import kernel as AK
from ..kernels.attention import ops as AO
from ..kernels.attention import ref as AR
from ..kernels.check import compare
from ..kernels.matmul import kernel as MK
from ..kernels.matmul import ops as MO
from ..kernels.matmul import ref as MR
from .timing import time_call


@dataclass(frozen=True)
class Point:
    """One call of the loop.  ``dims``: matmul ``(m, n, k)``; attention
    ``(b, sq, sk, h, hkv, d)``, the order of the reference's kernel
    tests."""

    op: str
    dims: tuple[int, ...]
    dtype: torch.dtype = torch.float32
    causal: bool = False


#: The full-size points: the reference benchmark's GEMM
#: (``compute_bench.MATMUL_DIMS``) in f32 and in bf16, and its attention
#: (``ATTENTION_DIMS``, S = 4096, d = 128) at internlm2-1.8b's width
#: (16 heads, 8 KV heads): causal prefill, and decode of one token for a
#: batch of 8 against a 4096-token cache (the reference's decode case).
POINTS = {
    "matmul": Point("matmul", (4096, 4096, 4096)),
    "matmul_bf16": Point("matmul", (4096, 4096, 4096), torch.bfloat16),
    "attention_prefill": Point("attention", (1, 4096, 4096, 16, 8, 128),
                               causal=True),
    "attention_decode": Point("attention", (8, 1, 4096, 16, 8, 128)),
}
SEED = 0
TOLERANCE = {"matmul": MR.TOLERANCE, "attention": AR.TOLERANCE}


@contextlib.contextmanager
def full_f32():
    """f32 products of ``torch.matmul`` in full f32 on the card (TF32 off)
    inside the block; the setting is restored after it."""
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


def make_inputs(point: Point, device) -> tuple[torch.Tensor, ...]:
    """The point's operands, N(0, 1) drawn in f32 on ``device`` from SEED,
    then cast: matmul ``(x, y)``; attention ``(q, k, v)`` in the op's
    ``(B, S, H, d)`` layout."""
    if point.op == "matmul":
        m, n, k = point.dims
        shapes = [(m, k), (k, n)]
    else:
        b, sq, sk, h, hkv, d = point.dims
        shapes = [(b, sq, h, d), (b, sk, hkv, d), (b, sk, hkv, d)]
    g = torch.Generator(device=device).manual_seed(SEED)
    return tuple(torch.randn(s, generator=g, device=device).to(point.dtype)
                 for s in shapes)


def _model_dims(point: Point) -> tuple[int, int, int]:
    """``rank``'s dims: the product's, or one head's ``(sq, sk, d)``."""
    if point.op == "matmul":
        return point.dims
    _, sq, sk, _, _, d = point.dims
    return sq, sk, d


def _heads(point: Point) -> int:
    """Independent problems the model's time is multiplied by."""
    return 1 if point.op == "matmul" else point.dims[0] * point.dims[3]


def _elem_bytes(point: Point) -> int:
    return torch.empty((), dtype=point.dtype).element_size()


def op(point: Point, inputs, block) -> torch.Tensor:
    """The public op at ``block``; on the CPU its plain version."""
    if point.op == "matmul":
        bm, bn, bk = block
        return MO.matmul(*inputs, bm=bm, bn=bn, bk=bk)
    bq, bk = block
    return AO.flash_attention(*inputs, causal=point.causal, bq=bq, bk=bk)


def plain_op(point: Point, inputs) -> torch.Tensor:
    """The plain version of :func:`op`, in the op's layout."""
    if point.op == "matmul":
        return MR.matmul(*inputs)
    b, sq, _, h, _, d = point.dims
    out = AR.attention(*AO.fused_inputs(*inputs), causal=point.causal)
    return out.reshape(b, h, sq, d).permute(0, 2, 1, 3)


def model(point: Point, block, machine: GPUMachineModel) -> dict:
    """The GPU model of the point at ``block``, in ms."""
    eb = _elem_bytes(point)
    if point.op == "matmul":
        m, n, k = point.dims
        step = gpu_matmul_ecm(MO.matmul_workload(m, n, k, bm=block[0],
                                                 bn=block[1], elem_bytes=eb),
                              machine)
    else:
        sq, sk, d = _model_dims(point)
        w = AO.attention_workload(sq, sk, d, bq=block[0], bk=block[1],
                                  causal=point.causal, elem_bytes=eb)
        step = gpu_attention_ecm(w, machine, batch_heads=_heads(point))
    return {"t_comp_ms": step.t_comp * 1e3, "t_hbm_ms": step.t_hbm * 1e3,
            "t_ecm_ms": step.t_ecm * 1e3,
            "bound_by": "comp" if step.t_comp >= step.t_hbm else "hbm"}


def bound(point: Point, machine: GPUMachineModel) -> dict:
    """The card's least time for the kernel's work, in ms: the larger of
    its bytes (each operand as the kernel receives it read once, the
    output written once) over the HBM rate, and its products' FLOP over
    the peak rate of the operands' type (f32: FFMA; bf16: the tensor
    cores).  Attention's kernel receives K and V at their own Hkv heads,
    each read once whatever the query heads sharing it, and does the
    exact causal work, ``S (S + 1) / 2`` scores a head."""
    eb = _elem_bytes(point)
    peak = (machine.peak_bf16_tensor_flops if point.dtype == torch.bfloat16
            else machine.peak_f32_flops)
    if point.op == "matmul":
        m, n, k = point.dims
        nbytes = (m * k + k * n + m * n) * eb
        flops = 2.0 * m * n * k
    else:
        b, sq, sk, h, hkv, d = point.dims
        nbytes = 2 * (sq * h + sk * hkv) * d * b * eb
        scores = sq * (sq + 1) / 2 if point.causal else sq * sk
        flops = 4.0 * scores * d * b * h
    bytes_ms = machine.hbm_seconds(nbytes) * 1e3
    ops_ms = flops / peak * 1e3
    return {"bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "bytes_ms": bytes_ms, "operations_ms": ops_ms}


def _kernel_call(point: Point, inputs, block):
    """A call of the kernel wrapper at ``block`` on the operands the op
    hands it: matmul's as they are; attention's q, k and v as they are,
    the KV heads unrepeated, on the route of ``bq``."""
    if point.op == "matmul":
        x, y = inputs
        bm, bn, bk = block
        return lambda: MK.matmul_tiled(x, y, bm=bm, bn=bn, bk=bk,
                                       out_dtype=x.dtype)
    bq, bk = block
    scale = point.dims[5] ** -0.5
    if bq == 1:
        return lambda: AK.flash_attention_split(*inputs, causal=point.causal,
                                                bk=bk, scale=scale)
    return lambda: AK.flash_attention_tile(*inputs, causal=point.causal,
                                           bq=bq, bk=bk, scale=scale)


def _library(point: Point, operands):
    """``(name, call)`` of one PyTorch call computing the kernel's
    function on the plain version's operands (attention: KV repeated to
    the query heads, heads fused, so it reads twice the kernel's KV bytes
    at GQA 2)."""
    if point.op == "matmul":
        x, y = operands
        return "torch.matmul (cuBLAS, TF32 off)", lambda: torch.matmul(x, y)
    from torch.nn.attention import SDPBackend, sdpa_kernel

    q, k, v = (t.unsqueeze(0) for t in operands)

    def call():
        with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
            return F.scaled_dot_product_attention(
                q, k, v, is_causal=point.causal)[0]
    name = ("F.scaled_dot_product_attention, EFFICIENT_ATTENTION backend "
            "(CUTLASS; its f32 GEMMs run on the tensor cores as 3xTF32, "
            "OpMultiplyAddFastF32 in PyTorch's mem_eff_attention/"
            "gemm_kernel_utils.h), on KV repeated to the query heads")
    return name, call


def _combine_timings(point: Point, inputs, bk: int,
                     machine: GPUMachineModel) -> dict:
    """The decode route's plan, and its combine kernel alone on the
    partials of one first pass: its time, its plain version's
    (``ref.combine``), its bytes bound (the partials read once, the output
    written once) and its check against the plain version."""
    q, k, v = inputs
    m, l, acc, plan = AK.split_partials(q, k, v, causal=point.causal, bk=bk,
                                        scale=point.dims[5] ** -0.5)
    shape, dtype = tuple(q.shape), q.dtype

    def call():
        return AK.combine(m, l, acc, shape=shape, dtype=dtype)

    def plain():
        return AR.combine(m, l, acc).reshape(shape).to(dtype)
    nbytes = (m.numel() + l.numel() + acc.numel()) * 4 + q.numel() * q.element_size()
    return {"split_plan": asdict(plan),
            "combine": {"ms": time_call(call)[0],
                        "plain_ms": time_call(plain)[0],
                        "bound_ms": machine.hbm_seconds(nbytes) * 1e3,
                        "bound_by": "bytes", "library_ms": None,
                        "check": compare(call(), plain(),
                                         tol=TOLERANCE["attention"][dtype])}}


def timings(point: Point, inputs, ranked: list[dict],
            machine: GPUMachineModel) -> dict:
    """Time the kernel at every candidate tiling of the pick's route, the
    plain version and the library call; set the pick against the bound
    and the model."""
    pick = ranked[0]["block"]
    if point.op == "matmul":
        operands = inputs
        plain = lambda: MR.matmul(*inputs)  # noqa: E731
        blocks = [r["block"] for r in ranked]
    else:
        operands = AO.fused_inputs(*inputs)
        plain = lambda: AR.attention(*operands, causal=point.causal)  # noqa: E731
        blocks = [r["block"] for r in ranked
                  if AK.route_of(r["block"][0]) == AK.route_of(pick[0])]
    measured = {b: time_call(_kernel_call(point, inputs, b)) for b in blocks}
    ms = {b: t for b, (t, _) in measured.items()}
    fastest = sorted(blocks, key=ms.get)
    name, library = _library(point, operands)
    with full_f32():
        plain_ms = time_call(plain)[0]
        library_ms = time_call(library)[0]
        library_check = compare(library(), plain(),
                                tol=TOLERANCE[point.op][point.dtype])
    lim = bound(point, machine)
    predicted = {tuple(r["block"]): r["predicted_ms"] for r in ranked}
    split = (_combine_timings(point, inputs, pick[1], machine)
             if point.op == "attention" and pick[0] == 1 else {})
    return {
        "ms": ms[pick],
        "host_us": measured[pick][1],
        "op_ms": time_call(lambda: op(point, inputs, pick))[0],
        "measured_ms": {str(list(b)): t for b, t in ms.items()},
        "pick": list(pick),
        "fastest": list(fastest[0]),
        "pick_rank": fastest.index(pick) + 1,
        "measured_over_predicted": {str(list(b)): t / predicted[b]
                                    for b, t in ms.items()},
        "plain_ms": plain_ms,
        "library": name,
        "library_ms": library_ms,
        "library_check": library_check,
        **lim,
        "bound_share": {str(list(b)): lim["bound_ms"] / t for b, t in ms.items()},
        **split,
    }


def run(device: str = "cuda", point: Point = POINTS["matmul"]) -> dict:
    """The compute-bound loop at one point.

    On the card: the ranking, the op's output at the pick and its check,
    and the timings.  On the CPU (``device="cpu"``) the op takes its plain
    version and nothing is timed: a CPU time is no device metric.
    """
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device; pass device='cpu' to run the "
                               "plain versions")
        machine = GPUMachineModel.from_device(dev)
        name = torch.cuda.get_device_name(dev)
    else:
        machine, name = H100_SXM, str(dev)
    inputs = make_inputs(point, dev)
    ranked = rank(_model_dims(point), machine, objective=point.op,
                  causal=point.causal, elem_bytes=_elem_bytes(point))
    for r in ranked:
        r["predicted_ms"] = r.pop("t_ecm") * _heads(point) * 1e3
    pick = ranked[0]["block"]
    out = op(point, inputs, pick)
    with full_f32():
        want = plain_op(point, inputs)
    report = {
        "device": name,
        "op": point.op,
        "dims": list(point.dims),
        "dtype": str(point.dtype).removeprefix("torch."),
        "causal": point.causal,
        "block": list(pick),
        "route": MK.route_of(point.dtype) if point.op == "matmul" else None,
        "model": model(point, pick, machine),
        "ranked": [r | {"block": list(r["block"])} for r in ranked],
        "output": out,
        "check": compare(out, want, tol=TOLERANCE[point.op][point.dtype]),
    }
    if dev.type == "cuda":
        report["timings"] = timings(point, inputs, ranked, machine)
    return report


def summary(report: dict) -> list[dict]:
    """The report as JSON-ready records, one per printed line."""
    head = {k: report[k] for k in ("op", "dims", "dtype", "causal")}
    lines = [head | {"block": report["block"], "route": report["route"],
                     "check": report["check"], "model": report["model"]},
             head | {"ranked": report["ranked"]}]
    tm = report.get("timings")
    if tm:
        lines.append(head | {k: v for k, v in tm.items()
                             if k not in ("measured_ms", "bound_share",
                                          "measured_over_predicted")})
        lines.append(head | {k: tm[k] for k in ("measured_ms", "bound_share",
                                                "measured_over_predicted")})
    return lines


def main() -> None:
    for point in POINTS.values():
        report = run(point=point)
        print(json.dumps({"device": report["device"]}))
        for rec in summary(report):
            print(json.dumps(rec))
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
