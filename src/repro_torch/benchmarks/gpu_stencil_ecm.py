"""The Jacobi stencil loop on the GPU, held against the layer condition.

The counterpart of the kernel-validation half of the reference's
``benchmarks/stencil_sweep.py`` (``kernel_payload``), plus a measurement
on the card.  For one array (2D: the 5-point sweep; 3D: the 7-point):

* hold every path — the whole-array kernel and the halo pipeline at
  depths 1, 2 and 3 — against the plain version, bit for bit, through
  ``kernels.check.compare``;
* time each kernel on the padded array with CUDA events, beside the pad
  (the reference pads too), the plain version, one cuDNN convolution with
  the stencil's cross filter (a yardstick the port never calls) and, where
  the array is well beyond L2, the HBM bound;
* time the halo pipeline on one CTA at depths 1 and 2, as the stream loop
  does, and turn the pair into the exposed-HBM fraction of Eq. 1;
* set the measured times against ``core.gpu_ecm.gpu_stencil_ecm``, whose
  HBM traffic comes from the layer condition of the card's L2: over the
  whole width for the whole-array kernel, and over the trailing-dim tile
  (``pipeline.HALO_TILE``) for the halo pipeline, which sweeps tile by
  tile.

Run ``PYTHONPATH=src python -m repro_torch.benchmarks.gpu_stencil_ecm`` on
a machine with the card; it prints one JSON object per line for each of
the three points in :data:`POINTS`.
"""
from __future__ import annotations

import dataclasses
import json
import math

import torch
import torch.nn.functional as F

from ..core.gpu_ecm import gpu_stencil_ecm, measured_overlap, stencil_hbm_streams
from ..core.layer_condition import LC_SAFETY, STENCILS
from ..core.machine import H100_SXM, GPUMachineModel
from ..kernels import pipeline as P
from ..kernels.check import compare
from ..kernels.stencil import kernel as K
from ..kernels.stencil import ops, ref
from .timing import time_call

#: The memory-resident points, f32, each more than 4x the 50 MB L2: the
#: reference sweep's memory-resident end (``stencil_sweep.py`` BLOCK_N =
#: 8192) in 2D; a 3D cube whose three layers (3 MiB) hold in L2; and a 3D
#: slab whose three layers (48 MiB) do not, while five rows (40 KiB) do,
#: where the layer condition predicts twice the HBM traffic.
POINTS = {
    "2d": (8192, 8192),
    "3d": (512, 512, 512),
    "3d_lc_broken": (64, 2048, 2048),
}
#: coefficients with c0 != 0, so both products round (dimension -> pair)
COEFFS = {2: (0.3, 0.175), 3: (0.3, 0.1)}
SEED = 0
DEPTHS = (1, 2, 3)
#: calls per timed repeat of the one-CTA pair (one call streams the whole
#: array through one SM)
ONE_CTA_INNER = 2
_OPS = {2: (ops.jacobi2d, ref.jacobi2d, K.jacobi2d_grid, F.conv2d),
        3: (ops.jacobi3d, ref.jacobi3d, K.jacobi3d_grid, F.conv3d)}


def make_grid(shape: tuple[int, ...], device) -> torch.Tensor:
    """An f32 array of N(0, 1) values of ``shape``, drawn on ``device``
    from SEED."""
    g = torch.Generator(device=device).manual_seed(SEED)
    return torch.randn(shape, generator=g, device=device)


def paths() -> list[tuple[str, int | None]]:
    """(label, num_stages): the whole-array kernel, then the halo
    pipeline at each depth."""
    return [("grid", None)] + [(str(d), d) for d in DEPTHS]


def validate(a: torch.Tensor) -> dict:
    """Every path held against the plain version by ``compare``:
    ``{path: (ok, max_abs_err, tolerance)}``."""
    op, plain, _, _ = _OPS[a.dim()]
    c0, c1 = COEFFS[a.dim()]
    want = plain(a, c0, c1)
    return {label: compare(op(a, c0=c0, c1=c1, num_stages=ns), want)
            for label, ns in paths()}


def read_amplification(shape: tuple[int, ...], block_rows: int,
                       machine: GPUMachineModel) -> float:
    """Elements the halo pipeline copies into shared memory per element
    of the padded input: each chunk reads ``b + 2`` axis-0 rows, and each
    trailing-dim tile its own one-point halo.  What reaches HBM is at
    most this; L2 serves reads that neighbouring chunks share."""
    plan = P.halo_plan(tuple(n + 2 for n in shape), shape, torch.float32,
                       num_stages=1, block_rows=block_rows,
                       smem_limit=machine.smem_per_block_optin)
    fetched = plan.n_chunks * (plan.block + 2)
    for n, t in zip(shape[1:], plan.tile[-len(shape) + 1:]):
        fetched *= n + 2 * math.ceil(n / t)
    return fetched / math.prod(n + 2 for n in shape)


def _conv(a: torch.Tensor, p: torch.Tensor, c0: float, c1: float):
    """One cuDNN convolution of the padded array with the cross filter
    (centre c0, the 2*dim neighbours c1): the interior of the sweep in
    another summation order, without the boundary copy.  TF32 is off, so
    it computes in f32; ``benchmark`` is on, so cuDNN times its algorithms
    on the first (warm-up) call and keeps the fastest."""
    dim = a.dim()
    conv = _OPS[dim][3]
    w = torch.zeros((3,) * dim, device=a.device)
    w[(1,) * dim] = c0
    for ax in range(dim):
        for k in (0, 2):
            w[tuple(k if i == ax else 1 for i in range(dim))] = c1
    w = w.view((1, 1) + (3,) * dim)
    x = p.view((1, 1) + tuple(p.shape))

    def call():
        with torch.backends.cudnn.flags(enabled=True, benchmark=True,
                                        allow_tf32=False):
            return conv(x, w)
    return call


def timings(a: torch.Tensor, machine: GPUMachineModel) -> dict:
    """Time every path, the pad, the plain version, the cuDNN yardstick
    and the one-CTA depth-1/depth-2 pair; set the layer-condition model
    against the times."""
    dim, shape = a.dim(), tuple(a.shape)
    _, plain, grid, _ = _OPS[dim]
    eb = a.element_size()
    spec = dataclasses.replace(STENCILS[f"jacobi{dim}d"], elem_bytes=eb)
    c0, c1 = COEFFS[dim]
    p = ref.pad(a)
    # the halo pipeline sweeps one trailing-dim tile at a time
    blocks = {"grid": None, "halo": P.HALO_TILE[dim][-(dim - 1):]}

    def kernel(ns, ctas=None):
        if ns is None:
            return lambda: grid(p, c0=c0, c1=c1)
        return lambda: P.halo_pipeline(
            p, out_shape=shape, c0=c0, c1=c1, num_stages=ns,
            block_rows=K.BLOCK_ROWS, ctas=ctas)

    ms, host = {}, {}
    for label, ns in paths():
        ms[label], host[label] = time_call(kernel(ns))
    nbytes = (p.numel() + a.numel()) * eb
    lups = a.numel()
    # the HBM bound holds only where the array does not fit in L2
    bounded = p.numel() * eb >= 4 * machine.l2_bytes
    bytes_ms = machine.hbm_seconds(nbytes) * 1e3
    ops_ms = machine.compute_seconds(spec.flops_per_elem * lups) * 1e3
    bound = (max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms
             else "operations") if bounded else (None, None)
    one_cta = {d: time_call(kernel(d, ctas=1), inner=ONE_CTA_INNER)[0]
               for d in (1, 2)}
    models = {k: gpu_stencil_ecm(spec, shape, machine, eb, block=b)
              for k, b in blocks.items()}
    predicted = {label: models["grid" if ns is None else "halo"].t_ecm * 1e3
                 for label, ns in paths()}
    return {
        "ms": ms,
        "host_us": host,
        "gbps": {k: nbytes / t / 1e6 for k, t in ms.items()},
        "pad_ms": time_call(lambda: ref.pad(a))[0],
        "plain_ms": time_call(lambda: plain(a, c0, c1))[0],
        "library_ms": time_call(_conv(a, p, c0, c1))[0],
        "library": f"torch.nn.functional.conv{dim}d (cuDNN, TF32 off)",
        "bound_ms": bound[0],
        "bound_by": bound[1],
        "bound_share": ({k: bound[0] / t for k, t in ms.items()}
                        if bounded else None),
        "halo_read_amplification": read_amplification(shape, K.BLOCK_ROWS,
                                                      machine),
        "overlap": {
            "scope": "one SM (ctas=1)",
            "t_serial_ms": one_cta[1], "t_pipelined_ms": one_cta[2],
            "serial_over_pipelined": one_cta[1] / one_cta[2],
            "exposed_hbm_fraction": measured_overlap(one_cta[1], one_cta[2],
                                                     one_cta[2]),
        },
        "ecm": {
            "l2_bytes": machine.l2_bytes, "lc_safety": LC_SAFETY,
            "block": blocks,
            "conditions": {k: {c.name: {"bytes": c.nbytes,
                                        "holds": c.holds(machine.l2_bytes)}
                               for c in spec.conditions(shape[1:], b)}
                           for k, b in blocks.items()},
            "hbm_streams": {k: stencil_hbm_streams(spec, shape, machine,
                                                   block=b)
                            for k, b in blocks.items()},
            "model_bytes_per_lup": {
                k: m.t_hbm * machine.hbm_bytes_per_s / lups
                for k, m in models.items()},
            "predicted_ms": predicted,
            "measured_over_predicted": {k: t / predicted[k]
                                        for k, t in ms.items()},
        },
    }


def run(device: str = "cuda", shape: tuple[int, ...] = POINTS["2d"]) -> dict:
    """The stencil loop on an f32 array of ``shape`` (2D or 3D).

    On the card: the whole-array output, the checks of every path and the
    timings.  On the CPU (``device="cpu"``) the ops take their plain
    versions and nothing is timed: a CPU time is no device metric.
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
    a = make_grid(tuple(shape), dev)
    op = _OPS[a.dim()][0]
    c0, c1 = COEFFS[a.dim()]
    report = {
        "device": name,
        "shape": list(shape),
        "stencil": f"jacobi{a.dim()}d",
        "c0_c1": [c0, c1],
        "output": op(a, c0=c0, c1=c1),
        "checks": validate(a),
    }
    if dev.type == "cuda":
        report["timings"] = timings(a, machine)
    return report


def summary(report: dict) -> list[dict]:
    """The report as JSON-ready records, one per printed line."""
    head = {k: report[k] for k in ("shape", "stencil", "c0_c1")}
    lines = [head | {"checks": report["checks"]}]
    tm = report.get("timings")
    if tm:
        lines.append(head | {k: v for k, v in tm.items()
                             if k not in ("overlap", "ecm", "host_us")})
        lines.append(head | {"host_us_per_call": tm["host_us"]})
        lines.append(head | {"overlap": tm["overlap"]})
        lines.append(head | {"ecm": tm["ecm"]})
    return lines


def main() -> None:
    for shape in POINTS.values():
        report = run(shape=shape)
        print(json.dumps({"device": report["device"]}))
        for rec in summary(report):
            print(json.dumps(rec))


if __name__ == "__main__":
    main()
