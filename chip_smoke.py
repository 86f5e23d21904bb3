#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root on a machine with an H100:

    python3 chip_smoke.py

It drives the port's paths, the calibration of the card's model
(``repro_torch.launch.calibrate``), the paper's stream-ECM loop
(``repro_torch.benchmarks.gpu_stream_ecm.run``), the Jacobi stencil
loop (``repro_torch.benchmarks.gpu_stencil_ecm.run``), the
compute-bound loop (``repro_torch.benchmarks.gpu_compute_ecm.run``) and
Eq. 2 over the SMs (``repro_torch.benchmarks.gpu_scaling_ecm.run``), and
holds every CUDA kernel against its plain PyTorch version.  Phases:

1. require CUDA (there is no CPU fallback) and print the card's
   ``nvidia-smi`` name and power limit;
2. build the CUDA sources from ``src/repro_torch/kernels/csrc`` (one
   ``nvcc`` per source, in parallel);
3. correctness at small sizes: every op at rows 512/64/33/7, on the grid
   kernel and at pipeline depths 1/2/3, in f32 and bf16, through the one
   NaN-safe comparison (``kernels.check.compare``); sums bit-identical
   across depths, the pipeline bit-identical to the grid kernels, the
   fused chain equal to the unfused one; rings that wrap: every map op
   through the pipeline at 512 rows (16 chunks) on 1 and 3 CTAs at
   depths 1/2/3, and the grid map at blocks of 64, 33, 7 and 132 rows,
   f32 and bf16, bit-equal to the plain version and the grid path; a 64-row
   depth-3 ring that does not fit shared memory raises, and so do the
   map and reduce ops on a view at an odd element offset, the context
   usable afterwards; the one-pass ``striad_rmw`` on the grid map bit for
   bit against its plain version on the card, f32 and bf16, rows
   64/33/7, with a NaN and an inf in ``a``, and refused by the pipeline;
   the registers ``-Xptxas -v`` gave the stream and pipeline kernels;
4. the stencils at small sizes: the reference's test shapes and one 2D
   shape of three trailing-dim strips, whole-array and at depths 1/2/3,
   f32 and bf16, two or three coefficient pairs, bit for bit against the
   plain version on the card and on the CPU; every depth equal to the
   whole-array path; the boundary copied; a constant field a fixed
   point; an unpadded input and a ring over shared memory raise;
5. matmul and attention at small sizes: the reference's test shapes at
   every compiled tiling that divides them (matmul in f32 on the FFMA
   route and bf16 on the wgmma route, plus bf16 shapes whose K steps are
   fewer than, as many as and many times the TMA ring's stages, and bf16
   in with f32 out; attention causal and not, GQA 2/1/8, f32 and bf16),
   the reference's decode case at ``bq = 1``, each within the reference's
   tolerance of the plain version; the reference's own matmul call (128 x
   128 x 128) on both routes, f32 bit-equal to the compiled depth it runs
   at; blocks left at ``None`` (matmul and attention at 192) and head dims
   16 and 32; the prefill tile route on ragged shapes (sq = sk of 48, 100
   and 200, GQA 2 and 1, d 64; causal and not; f32 and bf16) through the
   op with blocks ``None`` and given and through its wrapper at every
   compiled tiling, on walks of one KV tile, of fewer ring panels than
   stages and of many tiles, and on strided q/k/v views, bit-equal to
   their contiguous copies; the split-KV decode in f32
   and bf16 with Sk one tile, one split and many splits, causal ``bq = 1``
   with wholly masked splits (their ``l`` exactly 0), GQA 1/2/4/8, d 16,
   32, 64 and 128, its combine kernel against the plain combine, and a
   strided cache view equal to the contiguous cache; a tiling a route is
   not compiled for, a tile over shared memory, a product no compiled
   tiling divides, bf16 rows that are no 16-byte multiple, misaligned
   views, an uncompiled head dim, more than 16 query heads a KV head,
   ``causal`` with ``sq != sk``, a non-dividing block and blocks left at
   ``None`` that the reference refuses raise; the
   registers, shared memory and spills ``-Xptxas -v`` gave each matmul
   and attention kernel;
6. the calibration, through the CLI: a cold run from an empty cache
   directory (``--no-snap``: the prior is a data sheet, so every field
   adopts what the card measured; the fields within ``SNAP_RTOL`` of it
   are listed), which writes the machine file under ``results/`` and must
   load back to the fitted machine, with every fitted field finite and
   positive and every residual within ``MAX_FIT_RESIDUAL``; the RFO
   ratio and verdict (the CLI fails on an undetermined one, and the
   one-CTA overlap pair must have run: no RFO); the L2 knee and the
   layer-condition estimate beside ``l2_bytes``; the overlap fit; then a
   warm run from the same directory, which must fit and measure nothing;
7. the stream loop at 2^26 and 2^20 f32 elements per stream, the stencil
   loop at its three full-size points (both loops' models under the prior
   and the calibrated machine), then the compute loop at its four
   points (f32 and bf16 4096^3 matmul, causal prefill and decode
   attention at S = 4096, 16 heads, 8 KV heads, d = 128), each path with
   every kernel's launch count set to 0 just before and read just after;
   every kernel's share of its bound at most 1.0 (for matmul and
   attention at every tiling timed); the f32 matmul point launched the
   FFMA route and the bf16 point the wgmma route, the prefill point the
   tile route alone at every compiled prefill tiling (the pick's rank
   among them reported), the decode point the split route alone and at
   least one combine per split launch (the combine is also timed alone);
8. Eq. 2 over the SMs against the calibrated machine: every Table I op
   through the pipeline at depth 2 on 1 to 132 CTAs, one an SM (the
   occupancy query says 1), every point checked, ``P(n)`` and both
   ``n_S``;
9. one JSON line with the ten kernels (the matmul and attention rows with
   their launches per route, the combine's with the decode's split plan),
   then the ``ok`` line.

The calibration and the Eq. 2 sweep count their launches from 0 too,
each kernel they run at least once.

Any failure exits non-zero and prints no ``ok`` line.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

SRC = Path(__file__).resolve().parent / "src"
#: where the calibration writes the card's machine file (``.gitignore``
#: lists ``results/``)
MACHINE_FILE = Path(__file__).resolve().parent / "results" / "chip_smoke_machine.json"
SMALL_ROWS = (512, 64, 33, 7)
#: rows of the ring checks: 16 chunks of the pipeline's 32-row block
RING_ROWS = 512
#: the grid map's blocks in the ring checks, on rows they all divide: the
#: reference's 64 (four 16-row pieces), 33 (16, 16 and 1 rows), 7 (one
#: piece) and 132 (eight pieces of 16 and one of 4, the four slots reused)
GRID_BLOCKS = (64, 33, 7, 132)
GRID_ROWS = 64 * 33 * 7
SEED = 0
#: the reference's stencil test shapes (tests/test_stencil.py), and a 2D
#: shape of three 1024-column strips, the last one ragged
STENCIL_SHAPES = ((24, 33), (40, 128), (23, 17), (24, 2100),
                  (12, 10, 17), (7, 9, 11))
#: coefficient pairs per dimension: the default, and c0 != 0
STENCIL_COEFFS = {2: ((0.0, 0.25), (0.3, 0.175)),
                  3: ((0.0, 1.0 / 6.0), (0.3, 0.175), (0.3, 0.1))}

#: the op (stream loop) or point (stencil and compute loops) and path whose
#: time stands for each kernel in the kernels line, the family, and the
#: paths (compute: points) it serves
KERNEL_VIEW = {
    "map_pipeline": ("striad", "2", "map", ("1", "2", "3")),
    "reduce_pipeline": ("ddot", "2", "reduce", ("1", "2", "3")),
    "grid_map": ("striad", "grid", "map", ("grid",)),
    "grid_reduce": ("ddot", "grid", "reduce", ("grid",)),
    "halo_pipeline": ("2d", "2", "stencil", ("1", "2", "3")),
    "jacobi2d_grid": ("2d", "grid", "stencil", ("grid",)),
    "jacobi3d_grid": ("3d", "grid", "stencil", ("grid",)),
    "matmul": ("matmul", "pick", "compute", ("matmul", "matmul_bf16")),
    "flash_attention": ("attention_prefill", "pick", "compute",
                        ("attention_prefill", "attention_decode")),
    "flash_combine": ("attention_decode", "combine", "compute",
                      ("attention_decode",)),
}
#: the reference's matmul and attention test shapes (tests/test_kernels.py):
#: (m, n, k), and (b, sq, sk, h, hkv, d) with GQA 2, 1 and 8
MATMUL_SHAPES = ((256, 256, 256), (512, 384, 640), (128, 128, 1024))
#: bf16 shapes whose 64-deep K steps are 1 and 2 (fewer than the wgmma
#: route's 4 stages), 4 (as many; also the first reference shape) and 64
#: (the ring wraps 16 times), and one with three row and column tiles
MATMUL_RING_SHAPES = ((128, 256, 64), (256, 256, 128), (256, 512, 4096),
                      (384, 768, 192))
ATTENTION_SHAPES = ((1, 256, 256, 4, 2, 64), (2, 512, 512, 8, 8, 64),
                    (2, 256, 256, 8, 1, 128))
#: the reference's decode case: q (2, 1, 8, 64) against k, v (2, 1024, 2, 64)
DECODE_SHAPE = (2, 1, 1024, 8, 2, 64)
#: the split route (bq = 1) at small sizes, f32 and bf16:
#: name -> ((b, sq, sk, h, hkv, d), bk, causal); the plan's split count
#: each case stands for is checked (_SPLITS)
DECODE_CASES = {
    "one_tile": ((2, 1, 128, 8, 8, 64), 128, False),         # GQA 1
    "one_split": ((72, 1, 512, 16, 8, 128), 128, False),     # GQA 2; 576 groups fill the card
    "many_splits": ((2, 1, 4096, 8, 1, 128), 256, False),    # GQA 8
    "causal_masked_splits": ((1, 256, 256, 4, 1, 64), 128, True),  # GQA 4, Sq = Sk
    "d16": ((2, 1, 1024, 8, 2, 16), 256, False),             # padded to 64
    "d32": ((2, 1, 1024, 8, 2, 32), 256, False),
    "reference": (DECODE_SHAPE, 256, False),
}
_SPLITS = {"one_tile": lambda n, sk, bk: n == 1 and sk == bk,
           "one_split": lambda n, sk, bk: n == 1 and sk > bk,
           "many_splits": lambda n, sk, bk: n > 1,
           "causal_masked_splits": lambda n, sk, bk: n >= 2}
#: ragged prefill (sq = sk no multiple of 64, GQA 2 and 1, d 64): the op
#: with blocks left at None and given as (sq, sk), and the tile wrapper at
#: every compiled tiling, causal and not, f32 and bf16
RAGGED_ATTENTION = tuple((1, s, s, 4, hkv, 64) for s in (48, 100, 200)
                         for hkv in (2, 4))
#: the tile route's walks over the KV tiles, at every compiled tiling, f32
#: and bf16: name -> ((b, sq, sk, h, hkv, d), causal); at d = 64 a 128 x 64
#: tile is two ring panels, so one KV tile is fewer panels than stages
TILE_WALKS = {"one_kv_tile": ((1, 64, 64, 2, 1, 128), True),
              "fewer_panels_than_stages": ((2, 64, 64, 4, 2, 64), True),
              "many_kv_tiles": ((1, 128, 2048, 4, 2, 128), False),
              "ragged_many_tiles": ((1, 300, 1000, 2, 1, 128), False)}
#: blocks left at None on the card, and head dims 16 and 32 on the tile
#: route: (b, sq, sk, h, hkv, d), causal
NONE_BLOCK_ATTENTION = (((1, 192, 192, 4, 2, 64), True),
                        ((1, 192, 192, 4, 2, 64), False),
                        ((2, 256, 256, 8, 2, 16), True),
                        ((2, 256, 256, 8, 2, 32), False))
#: the kernels the calibration times (grid sweeps, stencil sweeps, the
#: one-CTA pair)
CALIBRATE_KERNELS = ("grid_map", "grid_reduce", "jacobi2d_grid",
                     "jacobi3d_grid", "map_pipeline")
#: which points of the stencil loop each stencil kernel serves
STENCIL_POINTS = {"halo_pipeline": ("2d", "3d", "3d_lc_broken"),
                  "jacobi2d_grid": ("2d",),
                  "jacobi3d_grid": ("3d", "3d_lc_broken")}


def _fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def _card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def _small_checks() -> list[str]:
    """Phase 3; returns what failed."""
    from repro_torch import convert
    from repro_torch.benchmarks import gpu_stream_ecm as G
    from repro_torch.kernels.check import compare
    from repro_torch.kernels.stream import ops

    failures = []
    rng = np.random.default_rng(SEED)
    machine = G.GPUMachineModel.from_device(torch.device("cuda"))
    paths, pb = G.paths(machine), G.pipeline_block(machine)
    for rows in SMALL_ROWS:
        for dtype in (torch.float32, torch.bfloat16):
            arrays = [rng.standard_normal(rows * 128).astype(np.float32)
                      for _ in range(4)]
            streams = convert.streams_from_numpy(arrays, device="cuda",
                                                 dtype=dtype)
            where = f"rows={rows} {dtype}"
            for name, (kernel, plain, summed) in G.cases(streams).items():
                want = plain()
                outs = {}
                for path, ns, br in paths:
                    outs[path] = kernel(ns, br)
                    ok, err, tol = compare(outs[path], want, summed_from=summed)
                    if not ok:
                        failures.append(f"{name} {where} path {path}: "
                                        f"err {err} tol {tol}")
                ref_path = "1" if summed is not None else "grid"
                for path in ("1", "2", "3"):
                    if not torch.equal(outs[path], outs[ref_path]):
                        failures.append(f"{name} {where}: depth {path} differs "
                                        f"from path {ref_path}")
            _, b, c, _ = streams
            fused = ops.triad_update(G.S, G.T, b, c, num_stages=2, block_rows=pb)
            unfused = ops.triad_update_unfused(G.S, G.T, b, c, num_stages=2,
                                               block_rows=pb)
            if not compare(fused, unfused)[0]:
                failures.append(f"fused != unfused at {where}")
    torch.cuda.synchronize()
    return failures


def _ring_checks() -> list[str]:
    """Phase 3: rings that wrap.  The map pipeline at RING_ROWS rows in
    blocks of the benchmark's pipeline block (16 chunks) on 1 and 3 CTAs,
    so a 1-3 slot input ring and the output ring are reused many times,
    every map op at depths 1/2/3, f32 and bf16, bit-equal to the plain
    version and to the grid path; the grid map at blocks of GRID_BLOCKS
    rows on GRID_ROWS rows."""
    from repro_torch.benchmarks import gpu_stream_ecm as G
    from repro_torch.kernels import pipeline as P
    from repro_torch.kernels.check import compare
    from repro_torch.kernels.stream import kernel as K

    failures = []
    rng = np.random.default_rng(SEED + 1)
    pb = G.pipeline_block(G.GPUMachineModel.from_device(torch.device("cuda")))
    for rows, blocks in ((RING_ROWS, None), (GRID_ROWS, GRID_BLOCKS)):
        for dtype in (torch.float32, torch.bfloat16):
            x, y, z = (torch.from_numpy(rng.standard_normal((rows, 128))
                                        .astype(np.float32)).cuda().to(dtype)
                       for _ in range(3))
            kw = dict(rows=rows, dtype=dtype, device=x.device)
            for op, (_, n_scalars, n_in) in P.MAP_OPS.items():
                scalars, ins = (G.S, G.T)[:n_scalars], (x, y, z)[:n_in]
                want = _plain_map(op, scalars, ins, rows, dtype)
                grid = K.grid_map(op, scalars, ins, block_rows=64, **kw)
                got = {"grid": grid}
                if blocks is None and op not in P.GRID_ONLY_OPS:
                    for ctas in (1, 3):
                        for d in (1, 2, 3):
                            got[f"depth {d} ctas {ctas}"] = P.map_pipeline(
                                op, scalars, ins, num_stages=d, block_rows=pb,
                                ctas=ctas, **kw)
                elif blocks is not None:
                    for b in blocks:
                        got[f"grid block {b}"] = K.grid_map(
                            op, scalars, ins, block_rows=b, **kw)
                for path, out in got.items():
                    if not compare(out, want)[0] or not torch.equal(out, grid):
                        failures.append(f"{op} rows={rows} {dtype} {path}: "
                                        f"not bit-equal to the plain version "
                                        f"and the grid path")
    torch.cuda.synchronize()
    return failures


def _striad_rmw_checks() -> tuple[list[str], dict]:
    """The one-pass ``striad_rmw`` on the grid map against its plain
    version on the same card inputs, bit for bit (the outputs' bits, so a
    NaN compares too), f32 and bf16, rows 64/33/7, with a NaN and an inf
    placed in ``a``; and the pipeline's refusal of the op."""
    from repro_torch.benchmarks import gpu_stream_ecm as G
    from repro_torch.kernels import pipeline as P
    from repro_torch.kernels.stream import ops, ref

    failures = []
    rng = np.random.default_rng(SEED + 2)
    bits = {torch.float32: torch.int32, torch.bfloat16: torch.int16}
    for rows in (64, 33, 7):
        for dtype in (torch.float32, torch.bfloat16):
            a, b, c = (torch.from_numpy(rng.standard_normal(rows * 128)
                                        .astype(np.float32)).cuda().to(dtype)
                       for _ in range(3))
            a[5], a[rows * 128 - 1] = float("nan"), float("inf")
            got = ops.striad_rmw(G.S, a, b, c)
            want = ref.striad_rmw(G.S, a, b, c)
            where = f"striad_rmw rows={rows} {dtype}"
            if not torch.equal(got.view(bits[dtype]), want.view(bits[dtype])):
                failures.append(f"{where}: not bit-equal to the plain version")
            if not (bool(got[5].isnan()) and bool(got[-1].isnan())
                    and int(got.isnan().sum()) == 2):
                failures.append(f"{where}: the NaN and the inf of a do not "
                                f"give exactly two NaNs")
    x = torch.zeros((64, 128), device="cuda")
    try:
        P.map_pipeline("striad_rmw", (G.S,), (x, x, x), rows=64,
                       dtype=x.dtype, device=x.device, num_stages=2,
                       block_rows=32)
        failures.append("the pipeline did not refuse striad_rmw")
        refusal = ""
    except ValueError as e:
        refusal = str(e)
    torch.cuda.synchronize()
    return failures, {"striad_rmw_pipeline_raises": refusal}


def _plain_map(op, scalars, ins, rows, dtype):
    from repro_torch.kernels.stream import ref

    if op == "store":
        return ref.store(scalars[0], (rows, 128), dtype, device="cuda")
    return getattr(ref, op)(*scalars, *ins)


def _alignment_refusal() -> dict:
    """A flat view at an odd element offset is refused by the map and the
    reduce kernels alike, and the CUDA context is usable afterwards."""
    from repro_torch.benchmarks import gpu_stream_ecm as G
    from repro_torch.kernels.stream import ops, ref

    x = torch.randn(8 + 128 * 64, device="cuda")
    view = x[1:1 + 128 * 64]
    out = {}
    for name, call in {"striad": lambda: ops.striad(G.S, view, view),
                       "ddot": lambda: ops.ddot(view, view)}.items():
        try:
            call()
        except ValueError as e:
            out[f"misaligned_{name}_raises"] = str(e)
            continue
        _fail(f"{name} on a view at element offset 1 did not raise")
    aligned = x[4:4 + 128 * 64]
    if not torch.equal(ops.striad(G.S, aligned, aligned),
                       ref.striad(G.S, aligned, aligned)):
        _fail("striad after the refusals differs from its plain version")
    torch.cuda.synchronize()
    out["context_usable_after"] = True
    return out


def _shared_memory_refusal() -> str:
    """The reference's 64-row block at depth 3 does not fit for
    schoenauer (3 x 3 x 32 KiB); the op raises instead of shrinking."""
    from repro_torch.kernels.stream import ops

    x = torch.randn(512 * 128, device="cuda")
    try:
        ops.schoenauer(x, x, x, num_stages=3)
    except ValueError as e:
        return str(e)
    _fail("schoenauer at 64 rows and depth 3 did not raise")
    return ""


def _stencil_small_checks() -> list[str]:
    """Phase 4; returns what failed."""
    from repro_torch import convert
    from repro_torch.kernels.check import compare
    from repro_torch.kernels.stencil import ops, ref

    failures = []
    rng = np.random.default_rng(SEED)
    for shape in STENCIL_SHAPES:
        dim = len(shape)
        op, plain = ((ops.jacobi2d, ref.jacobi2d) if dim == 2
                     else (ops.jacobi3d, ref.jacobi3d))
        x = rng.standard_normal(shape).astype(np.float32)
        for dtype in (torch.float32, torch.bfloat16):
            a_cpu, a = (convert.streams_from_numpy([x], device=d, dtype=dtype)[0]
                        for d in ("cpu", "cuda"))
            for c0, c1 in STENCIL_COEFFS[dim]:
                where = f"jacobi{dim}d {shape} {dtype} c=({c0}, {c1})"
                want = plain(a, c0, c1)
                if not compare(want.cpu(), plain(a_cpu, c0, c1))[0]:
                    failures.append(f"{where}: plain version on the card "
                                    f"differs from the CPU's")
                outs = {}
                for ns in (None, 1, 2, 3):
                    outs[ns] = op(a, c0=c0, c1=c1, num_stages=ns)
                    ok, err, _ = compare(outs[ns], want)
                    if not ok:
                        failures.append(f"{where} depth {ns}: err {err}")
                    if not torch.equal(outs[ns], outs[None]):
                        failures.append(f"{where}: depth {ns} differs from "
                                        f"the whole-array path")
                edge = ref.edge_mask(shape, a.device)
                if not torch.equal(outs[2][edge], a[edge]):
                    failures.append(f"{where}: boundary is not the input")
    for dim, (op, c0, c1) in {2: (ops.jacobi2d, 0.0, 0.25),
                              3: (ops.jacobi3d, 0.25, 0.125)}.items():
        a = torch.full((24, 40) if dim == 2 else (12, 10, 17), 3.25,
                       device="cuda")
        for ns in (None, 1, 3):
            if not torch.equal(op(a, c0=c0, c1=c1, num_stages=ns), a):
                failures.append(f"jacobi{dim}d depth {ns}: a constant field "
                                f"is not a fixed point")
    torch.cuda.synchronize()
    return failures


def _stencil_refusals() -> dict:
    """An unpadded input and a ring over shared memory raise."""
    from repro_torch.kernels import pipeline as P
    from repro_torch.kernels.stencil import ops

    out = {}
    x = torch.zeros((8, 4), device="cuda")
    try:
        P.halo_pipeline(x, out_shape=(8, 4), c0=0.0, c1=0.25, num_stages=2,
                        block_rows=8)
        _fail("an unpadded input to the halo pipeline did not raise")
    except ValueError as e:
        out["unpadded_raises"] = str(e)
    x = torch.zeros((64, 64, 64), device="cuda")
    try:
        ops.jacobi3d(x, num_stages=3, block_rows=16)
        _fail("a 16-layer depth-3 3D ring did not raise")
    except ValueError as e:
        out["ring_16_layers_depth_3_raises"] = str(e)
    return out


def _compute_small_checks() -> tuple[list[str], dict]:
    """Phase 5; returns what failed, and what the decode plans and the
    reference's own test calls gave."""
    from repro_torch import convert
    from repro_torch.benchmarks import gpu_compute_ecm as GC
    from repro_torch.kernels.attention import kernel as AK
    from repro_torch.kernels.attention import ops as AO
    from repro_torch.kernels.attention import ref as AR
    from repro_torch.kernels.check import compare
    from repro_torch.kernels.matmul import kernel as MK
    from repro_torch.kernels.matmul import ops as MO
    from repro_torch.kernels.matmul import ref as MR

    failures, info = [], {"decode": {}, "matmul_bk_128": {}}
    rng = np.random.default_rng(SEED)

    def check(point, arrays, block):
        inputs = convert.streams_from_numpy(arrays, device="cuda",
                                            dtype=point.dtype)
        with GC.full_f32():
            want = GC.plain_op(point, inputs)
        ok, err, tol = compare(GC.op(point, inputs, block), want,
                               tol=GC.TOLERANCE[point.op][point.dtype])
        if not ok:
            failures.append(f"{point} block {block}: err {err} tol {tol}")

    for m, n, k in MATMUL_SHAPES + MATMUL_RING_SHAPES:
        arrays = [rng.standard_normal(s).astype(np.float32)
                  for s in ((m, k), (k, n))]
        dtypes = ((torch.float32, torch.bfloat16) if (m, n, k) in MATMUL_SHAPES
                  else (torch.bfloat16,))
        for dtype in dtypes:
            point = GC.Point("matmul", (m, n, k), dtype)
            for block in MK.TILINGS[MK.route_of(dtype)]:
                if not (m % block[0] or n % block[1] or k % block[2]):
                    check(point, arrays, block)
        # bf16 in, f32 out: the reference's contract
        x, y = convert.streams_from_numpy(arrays, device="cuda",
                                          dtype=torch.bfloat16)
        want = MR.matmul(x, y, torch.float32)
        for bm, bn, bk in MK.TILINGS["wgmma"]:
            if not (m % bm or n % bn or k % bk):
                got = MO.matmul(x, y, bm=bm, bn=bn, bk=bk,
                                out_dtype=torch.float32)
                ok, err, tol = compare(got, want,
                                       tol=MR.TOLERANCE[torch.bfloat16])
                if not ok:
                    failures.append(f"matmul {(m, n, k)} bf16 -> f32 block "
                                    f"{(bm, bn, bk)}: err {err} tol {tol}")
    for dims in ATTENTION_SHAPES + (DECODE_SHAPE,):
        b, sq, sk, h, hkv, d = dims
        arrays = [rng.standard_normal(s).astype(np.float32)
                  for s in ((b, sq, h, d), (b, sk, hkv, d), (b, sk, hkv, d))]
        for dtype in (torch.float32, torch.bfloat16):
            for causal in ((False,) if dims == DECODE_SHAPE else (True, False)):
                point = GC.Point("attention", dims, dtype, causal)
                blocks = ([(1, 256)] if dims == DECODE_SHAPE else
                          [t for t in AK.TILINGS if not (sq % t[0] or sk % t[1])])
                for block in blocks:
                    check(point, arrays, block)

    # the reference's own matmul call (tests/test_kernels.py:78): 128^3
    # blocks run at the compiled depth that divides 128, the same product
    for m, n, k in MATMUL_SHAPES:
        arrays = [rng.standard_normal(s).astype(np.float32)
                  for s in ((m, k), (k, n))]
        for dtype in (torch.float32, torch.bfloat16):
            x, y = convert.streams_from_numpy(arrays, device="cuda", dtype=dtype)
            got = MO.matmul(x, y, bm=128, bn=128, bk=128)
            depth = MK.compiled_depth(128, 128, 128, dtype)
            equal = torch.equal(got, MO.matmul(x, y, bm=128, bn=128, bk=depth))
            ok, err, tol = compare(got, MR.matmul(x, y), tol=MR.TOLERANCE[dtype])
            where = f"matmul {(m, n, k)} {dtype} at 128 x 128 x 128"
            info["matmul_bk_128"][f"{(m, n, k)} {dtype}"] = {
                "runs_at_bk": depth, "equal_to_that_depth": equal, "err": err}
            if not ok:
                failures.append(f"{where}: err {err} tol {tol}")
            if dtype == torch.float32 and not equal:
                failures.append(f"{where}: differs from bk = {depth}")
    # blocks left at None: a compiled tiling that divides the problem
    arrays = [rng.standard_normal((192, 192)).astype(np.float32) for _ in range(2)]
    x, y = convert.streams_from_numpy(arrays, device="cuda")
    ok, err, tol = compare(MO.matmul(x, y), MR.matmul(x, y),
                           tol=MR.TOLERANCE[torch.float32])
    if not ok:
        failures.append(f"matmul (192, 192, 192) f32, blocks None: err {err}")
    for dims, causal in NONE_BLOCK_ATTENTION:
        b, sq, sk, h, hkv, d = dims
        arrays = [rng.standard_normal(s).astype(np.float32)
                  for s in ((b, sq, h, d), (b, sk, hkv, d), (b, sk, hkv, d))]
        inputs = convert.streams_from_numpy(arrays, device="cuda")
        point = GC.Point("attention", dims, torch.float32, causal)
        with GC.full_f32():
            want = GC.plain_op(point, inputs)
        ok, err, tol = compare(AO.flash_attention(*inputs, causal=causal), want,
                               tol=GC.TOLERANCE["attention"][torch.float32])
        if not ok:
            failures.append(f"attention {dims} causal={causal}, blocks None: "
                            f"err {err} tol {tol}")

    # the tile route: the ragged edge, its walks over the KV tiles, views
    prefill = [t for t in AK.TILINGS if t[0] > 1]

    def tile_check(where, dims, causal, inputs, dtype, calls):
        point = GC.Point("attention", dims, dtype, causal)
        with GC.full_f32():
            want = GC.plain_op(point, inputs)
        for name, call in calls.items():
            ok, err, tol = compare(call(), want,
                                   tol=GC.TOLERANCE["attention"][dtype])
            if not ok:
                failures.append(f"{where} {dtype} causal={causal} {name}: "
                                f"err {err} tol {tol}")

    def wrapper_calls(inputs, causal, d):
        return {f"tile {t}": (lambda t=t: AK.flash_attention_tile(
            *inputs, causal=causal, bq=t[0], bk=t[1], scale=d ** -0.5))
            for t in prefill}

    for dims in RAGGED_ATTENTION:
        b, sq, sk, h, hkv, d = dims
        arrays = [rng.standard_normal(s).astype(np.float32)
                  for s in ((b, sq, h, d), (b, sk, hkv, d), (b, sk, hkv, d))]
        for dtype in (torch.float32, torch.bfloat16):
            inputs = convert.streams_from_numpy(arrays, device="cuda", dtype=dtype)
            for causal in (True, False):
                tile_check(f"ragged {dims}", dims, causal, inputs, dtype, {
                    "op, blocks None": lambda: AO.flash_attention(
                        *inputs, causal=causal),
                    "op, blocks (sq, sk)": lambda: AO.flash_attention(
                        *inputs, causal=causal, bq=sq, bk=sk),
                    **wrapper_calls(inputs, causal, d)})
    info["tile_walk_panels"] = {}
    for name, (dims, causal) in TILE_WALKS.items():
        b, sq, sk, h, hkv, d = dims
        arrays = [rng.standard_normal(s).astype(np.float32)
                  for s in ((b, sq, h, d), (b, sk, hkv, d), (b, sk, hkv, d))]
        for dtype in (torch.float32, torch.bfloat16):
            inputs = convert.streams_from_numpy(arrays, device="cuda", dtype=dtype)
            tile_check(f"walk {name} {dims}", dims, causal, inputs, dtype,
                       wrapper_calls(inputs, causal, d))
        # panels the longest q-block walks at each tiling
        info["tile_walk_panels"][name] = {
            str(t): -(-sk // t[1]) * (d // kc + t[1] // vc)
            for t in prefill for _, kc, vc in [AK.tile_panels(*t, d)]}
    walks = info["tile_walk_panels"]
    if not (min(walks["fewer_panels_than_stages"].values()) < AK.TILE_STAGES
            and max(walks["one_kv_tile"].values()) > AK.TILE_STAGES
            and min(walks["many_kv_tiles"].values()) > 8 * AK.TILE_STAGES):
        failures.append(f"the tile walks do not cover their cases: {walks}")
    # strided views (q a slice of wider heads, K and V of a longer cache)
    # give what their contiguous copies give, bit for bit
    b, sq, sk, h, hkv, d = 2, 200, 200, 4, 2, 128
    for dtype in (torch.float32, torch.bfloat16):
        wide = torch.randn((b, sq, 2 * h, d), device="cuda").to(dtype)
        caches = [torch.randn((b, 2 * sk, hkv, d), device="cuda").to(dtype)
                  for _ in range(2)]
        views = (wide[:, :, :h], caches[0][:, :sk], caches[1][:, :sk])
        copies = [t.contiguous() for t in views]
        for causal in (True, False):
            if not torch.equal(AO.flash_attention(*views, causal=causal),
                               AO.flash_attention(*copies, causal=causal)):
                failures.append(f"tile route {dtype} causal={causal}: a strided "
                                f"view differs from its contiguous copy")
        tile_check("strided views", (b, sq, sk, h, hkv, d), False, views, dtype,
                   {"op": lambda: AO.flash_attention(*views, causal=False)})

    # the split route: plans, partials, combine, and the op
    for name, (dims, bk, causal) in DECODE_CASES.items():
        b, sq, sk, h, hkv, d = dims
        arrays = [rng.standard_normal(s).astype(np.float32)
                  for s in ((b, sq, h, d), (b, sk, hkv, d), (b, sk, hkv, d))]
        for dtype in (torch.float32, torch.bfloat16):
            where = f"decode {name} {dims} {dtype}"
            inputs = convert.streams_from_numpy(arrays, device="cuda", dtype=dtype)
            point = GC.Point("attention", dims, dtype, causal)
            tol = GC.TOLERANCE["attention"][dtype]
            with GC.full_f32():
                want = GC.plain_op(point, inputs)
            ok, err, bound = compare(AO.flash_attention(*inputs, causal=causal,
                                                        bq=1, bk=bk), want, tol=tol)
            if not ok:
                failures.append(f"{where}: err {err} tol {bound}")
            if d not in AK.HEAD_DIMS:
                continue
            m, l, acc, plan = AK.split_partials(*inputs, causal=causal, bk=bk,
                                                scale=d ** -0.5)
            info["decode"][f"{name} {dtype}"] = {"n_split": plan.n_split,
                                                 "split_keys": plan.split_keys,
                                                 "ctas_per_sm": plan.ctas_per_sm}
            if name in _SPLITS and not _SPLITS[name](plan.n_split, sk, bk):
                failures.append(f"{where}: {plan} is not the case's split count")
            ok, err, bound = compare(
                AK.combine(m, l, acc, shape=tuple(inputs[0].shape), dtype=dtype),
                AR.combine(m, l, acc).reshape(inputs[0].shape).to(dtype), tol=tol)
            if not ok:
                failures.append(f"{where}: combine err {err} tol {bound}")
            if causal:  # split s is empty for the rows before its first key
                rows = torch.arange(sq, device="cuda")[None, :, None]
                lv = l.view(b, sq, h, plan.n_split)
                for sp in range(plan.n_split):
                    empty = (rows < sp * plan.split_keys).expand(b, sq, h)
                    if not (bool((lv[..., sp][empty] == 0).all())
                            and bool((lv[..., sp][~empty] > 0).all())):
                        failures.append(f"{where}: split {sp} is not empty "
                                        f"exactly for the rows before it")
            if name == "reference":  # a cache slice: its own strides, no copy
                caches = [torch.zeros((b, 2 * sk, hkv, d), device="cuda",
                                      dtype=dtype) for _ in range(2)]
                for c, t in zip(caches, inputs[1:]):
                    c[:, :sk] = t
                sliced = AO.flash_attention(inputs[0], caches[0][:, :sk],
                                            caches[1][:, :sk], causal=False,
                                            bq=1, bk=bk)
                if not torch.equal(sliced, AO.flash_attention(
                        *inputs, causal=False, bq=1, bk=bk)):
                    failures.append(f"{where}: a strided cache view differs")
    torch.cuda.synchronize()
    return failures, info


def _compute_refusals() -> dict:
    """What the matmul and attention ops refuse, each with its message."""
    from repro_torch.kernels.attention import kernel as AK
    from repro_torch.kernels.attention import ops as AO
    from repro_torch.kernels.matmul import kernel as MK
    from repro_torch.kernels.matmul import ops as MO

    x = torch.zeros((256, 256), device="cuda")
    xb = x.to(torch.bfloat16)
    x192 = torch.zeros((192, 192), device="cuda", dtype=torch.bfloat16)
    k100 = torch.zeros((128, 100), device="cuda", dtype=torch.bfloat16)
    shifted = torch.zeros(256 * 256 + 1, device="cuda",
                          dtype=torch.bfloat16)[1:].view(256, 256)
    q = torch.zeros((1, 256, 2, 128), device="cuda")
    shifted_kv = torch.zeros(256 * 2 * 128 + 1, device="cuda")[1:].view(1, 256, 2, 128)
    calls = {
        "matmul_uncompiled_tiling": lambda: MO.matmul(x, x, bm=128, bn=128, bk=8),
        "matmul_over_shared_memory": lambda: MO.matmul(x, x, bm=256, bn=256, bk=64),
        "matmul_block_does_not_divide": lambda: MO.matmul(x, x, bm=96),
        "matmul_bf16_uncompiled_tiling": lambda: MO.matmul(xb, xb, bk=32),
        "matmul_bf16_over_shared_memory": lambda: MO.matmul(xb, xb, bm=256, bn=256, bk=64),
        "matmul_bf16_no_compiled_tiling_divides": lambda: MO.matmul(x192, x192),
        "matmul_bf16_k_not_a_multiple_of_8": lambda: MK.matmul_tiled(
            k100, k100.T.contiguous(), bm=128, bn=128, bk=100,
            out_dtype=torch.bfloat16),
        "matmul_bf16_misaligned_view": lambda: MO.matmul(shifted, xb),
        "attention_over_shared_memory": lambda: AK.flash_attention_tile(
            q, q, q, causal=True, bq=128, bk=256, scale=0.125),
        "attention_none_blocks_the_reference_refuses": lambda: AO.flash_attention(
            *(torch.zeros((1, 600, 2, 64), device="cuda"),) * 3),
        "attention_block_does_not_divide": lambda: AO.flash_attention(
            *(torch.zeros((1, 100, 2, 64), device="cuda"),) * 3, bq=64),
        "attention_tile_misaligned_view": lambda: AO.flash_attention(
            shifted_kv, shifted_kv, shifted_kv, causal=True),
        "attention_uncompiled_head_dim": lambda: AO.flash_attention(
            q[..., :96].contiguous(), q[..., :96].contiguous(),
            q[..., :96].contiguous()),
        "attention_causal_sq_ne_sk": lambda: AO.flash_attention(
            q[:, :128], q, q, causal=True),
        "attention_decode_over_16_query_heads_a_kv_head": lambda: AO.flash_attention(
            torch.zeros((1, 1, 32, 64), device="cuda"), q[:, :, :1, :64].contiguous(),
            q[:, :, :1, :64].contiguous(), causal=False, bq=1),
        "attention_decode_misaligned_view": lambda: AO.flash_attention(
            q[:, :1], shifted_kv, shifted_kv, causal=False, bq=1, bk=128),
    }
    out = {}
    for name, call in calls.items():
        try:
            call()
        except ValueError as e:
            out[name] = str(e)
            continue
        _fail(f"{name} did not raise")
    return out


def _calibrate_phase() -> tuple[list[str], object, dict]:
    """Phase 6: the calibration CLI, cold from an empty cache directory,
    then warm from the same one.  Returns what failed, the calibrated
    machine and the record to print."""
    from repro_torch.core import calibrate as cal
    from repro_torch.core import diskcache
    from repro_torch.core.machine import load_machine_file
    from repro_torch.launch import calibrate as cli

    failures = []
    MACHINE_FILE.parent.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory() as cache:
        argv = ["--no-snap", "--cache-dir", cache, "--machine-out",
                str(MACHINE_FILE)]
        runs = {}
        for run in ("cold", "warm"):
            cal.reset_counters()
            diskcache.reset_counters()
            t0 = time.perf_counter()
            rc, report = cli.run(argv)
            runs[run] = {"rc": rc, "s": time.perf_counter() - t0,
                         "fits": cal.CAL_COUNTERS["fits"],
                         "measurements": cal.CAL_COUNTERS["measurements"],
                         "cache": dict(diskcache.COUNTERS),
                         "from_cache": report.from_cache if report else None}
            if rc != 0 or report is None:
                failures.append(f"calibrate {run} run exited {rc}")
                return failures, None, {"runs": runs}
            if run == "cold":
                cold = report
    warm = runs["warm"]
    if warm["fits"] or warm["measurements"] or not warm["from_cache"] \
            or warm["cache"]["hits"] < 1:
        failures.append(f"the warm calibration fitted or measured: {warm}")
    if runs["cold"]["cache"]["hits"]:
        failures.append("the cold calibration was served from a cache")
    loaded = load_machine_file(MACHINE_FILE)
    if loaded != cold.machine or report.machine != cold.machine:
        failures.append("the machine file does not load back to the fitted "
                        "machine")
    for f in cold.fits:
        if not (math.isfinite(f.fitted) and f.fitted > 0
                and math.isfinite(f.adopted) and f.adopted > 0):
            failures.append(f"{f.field}: fitted {f.fitted}, adopted "
                            f"{f.adopted}: not finite and positive")
    if cold.residual_max("bandwidth") > cal.MAX_FIT_RESIDUAL:
        failures.append(f"bandwidth residual {cold.residual_max('bandwidth')} "
                        f"over {cal.MAX_FIT_RESIDUAL}")
    lc = cold.checks["stencil_lc_breaks"]["L2"]
    record = {
        "phase": "calibrate", "runs": runs,
        "fits": [f.as_dict() for f in cold.fits],
        "within_snap_rtol": [f.field for f in cold.fits
                             if f.prior and abs(f.fitted - f.prior)
                             <= cal.SNAP_RTOL * abs(f.prior)],
        "residual_max": cold.group_summary(),
        "rfo": cold.checks["rfo"],
        "capacity": {**cold.checks["capacity"],
                     "fitted_l2_bytes": cold.machine.l2_bytes,
                     "lc_estimate_bytes": lc.get("capacity_est"),
                     "lc": lc},
        "backend": cold.checks["backend"],
        "machine_file": str(MACHINE_FILE.relative_to(SRC.parent)),
        "machine_file_round_trips": loaded == cold.machine,
        "calibrated": {k: getattr(cold.machine, k) for k in (
            "measured_bw", "l2_bytes", "l2_bytes_per_s", "write_allocate")},
    }
    return failures, cold.machine, record


def _scaling_phase(machine) -> tuple[list[str], dict]:
    """Phase 8: Eq. 2 over the SMs against the calibrated machine."""
    from repro_torch.benchmarks import gpu_scaling_ecm as SC

    report = SC.run(machine)
    failures = []
    for op, rec in report["ops"].items():
        if rec["ctas_per_sm"] != 1:
            failures.append(f"scaling {op}: {rec['ctas_per_sm']} CTAs an SM, "
                            f"not 1")
        failures += [f"scaling {op} ctas={n}: err {err} tol {tol}"
                     for n, (ok, err, tol) in rec["checks"].items() if not ok]
        if set(rec["ms"]) != set(SC.CTAS):
            failures.append(f"scaling {op}: timed {sorted(rec['ms'])}")
    return failures, report


def _check_compute_report(report: dict) -> list[str]:
    where = f"{report['op']} {report['dims']} {report['dtype']}"
    out, failures = report["output"], []
    dims = report["dims"]
    shape = ([dims[0], dims[1]] if report["op"] == "matmul"
             else [dims[0], dims[1], dims[3], dims[5]])
    if list(out.shape) != shape or not bool(torch.isfinite(out).all()):
        failures.append(f"{where}: output shape {tuple(out.shape)} or not finite")
    ok, err, tol = report["check"]
    if not ok:
        failures.append(f"{where}: err {err} tol {tol}")
    failures += [f"{where} block {b}: {v} of the bound, above 1.0"
                 for b, v in report["timings"]["bound_share"].items()
                 if not v <= 1.0]
    combine = report["timings"].get("combine")
    if combine is not None:
        ok, err, tol = combine["check"]
        if not ok:
            failures.append(f"{where}: combine err {err} tol {tol}")
        if not combine["bound_ms"] <= combine["ms"]:
            failures.append(f"{where}: combine {combine['ms']} ms under its "
                            f"bound {combine['bound_ms']} ms")
    return failures


def _check_stencil_report(report: dict) -> list[str]:
    where = f"{report['stencil']} {report['shape']}"
    out = report["output"]
    failures = []
    if list(out.shape) != report["shape"] or not bool(torch.isfinite(out).all()):
        failures.append(f"{where}: output shape {tuple(out.shape)} or not finite")
    for path, (ok, err, tol) in report["checks"].items():
        if not ok:
            failures.append(f"{where} path {path}: err {err} tol {tol}")
    shares = report["timings"]["bound_share"]
    if shares is None:
        failures.append(f"{where}: no HBM bound at a full-size point")
    else:
        failures += [f"{where} path {p}: {v} of the HBM bound, above 1.0"
                     for p, v in shares.items() if not v <= 1.0]
    return failures


def _check_report(report: dict, bounded: bool) -> list[str]:
    failures = []
    n = report["n"]
    for op, out in report["outputs"].items():
        shape = () if op in ("load", "ddot") else (n,)
        if tuple(out.shape) != shape or not bool(torch.isfinite(out).all()):
            failures.append(f"{op} output at n={n}: shape {tuple(out.shape)} "
                            f"or not finite")
    for op, checks in report["checks"].items():
        for path, (ok, err, tol) in checks.items():
            if not ok:
                failures.append(f"{op} path {path} at n={n}: err {err} tol {tol}")
    for op, rec in report["timings"]["ops"].items():
        if bounded:
            for path, share in rec["bound_share"].items():
                if not share <= 1.0:
                    failures.append(f"{op} path {path} at n={n}: {share} of "
                                    f"the HBM bound, above 1.0")
        elif rec["bound_ms"] is not None:
            failures.append(f"{op} at n={n}: a bound printed where the arrays "
                            f"fit in L2")
    return failures


def main() -> int:
    if not torch.cuda.is_available():
        _fail("no CUDA device; the port's smoke test runs on the card only")
    if not (SRC / "repro_torch").is_dir():
        _fail(f"{SRC / 'repro_torch'} not found: run from the repository")
    sys.path.insert(0, str(SRC))
    from repro_torch import kernels
    from repro_torch.benchmarks import gpu_compute_ecm as GC
    from repro_torch.benchmarks import gpu_stencil_ecm as GS
    from repro_torch.benchmarks import gpu_stream_ecm as G
    from repro_torch.kernels import _build

    # 1. the card
    print(_card_line())
    print(json.dumps({"python": sys.version.split()[0], "torch": torch.__version__,
                      "cuda": torch.version.cuda,
                      "device": torch.cuda.get_device_name(0)}))

    # 2. build
    t0 = time.perf_counter()
    _build.build(kernels.SOURCES)
    print(json.dumps({"build_s": time.perf_counter() - t0,
                      "sources": list(kernels.SOURCES)}))

    # 3. correctness at small sizes
    failures = _small_checks()
    failures += _ring_checks()
    rmw_failures, rmw_refusal = _striad_rmw_checks()
    failures += rmw_failures
    print(json.dumps({"phase": "small", "rows": SMALL_ROWS,
                      "ring_rows": RING_ROWS, "grid_blocks": GRID_BLOCKS,
                      "failures": failures}))
    print(json.dumps({"ring_64_rows_depth_3_raises": _shared_memory_refusal()}))
    print(json.dumps(_alignment_refusal() | rmw_refusal))
    print(json.dumps({"stream_ptxas": _build.ptxas_report("stream"),
                      "pipeline_ptxas": _build.ptxas_report("pipeline")}))
    if failures:
        _fail(f"{len(failures)} small-size checks failed")

    # 4. the stencils at small sizes
    failures = _stencil_small_checks()
    print(json.dumps({"phase": "stencil_small",
                      "shapes": [list(s) for s in STENCIL_SHAPES],
                      "failures": failures}))
    print(json.dumps(_stencil_refusals()))
    if failures:
        _fail(f"{len(failures)} small-size stencil checks failed")

    # 5. matmul and attention at small sizes
    failures, info = _compute_small_checks()
    print(json.dumps({"phase": "compute_small",
                      "matmul_shapes": [list(s) for s in MATMUL_SHAPES],
                      "attention_shapes": [list(s) for s in ATTENTION_SHAPES
                                           + (DECODE_SHAPE,)],
                      "decode_cases": {n: list(c[0]) for n, c in DECODE_CASES.items()},
                      **info, "failures": failures}))
    print(json.dumps(_compute_refusals()))
    print(json.dumps({"matmul_ptxas": [e for e in _build.ptxas_report("matmul")
                                       if e["kernel"].startswith("void matmul_")]}))
    print(json.dumps({"attention_ptxas": _build.ptxas_report("attention")}))
    if failures:
        _fail(f"{len(failures)} small-size matmul and attention checks failed")

    # 6. the calibration, its launches counted from 0
    t_path = time.perf_counter()
    kernels.reset_launches()
    failures, calibrated, record = _calibrate_phase()
    record["launches"] = {k.name: k.launches for k in kernels.KERNELS}
    record["s"] = time.perf_counter() - t_path
    print(json.dumps(record))
    failures += [f"{k} was not launched by the calibration"
                 for k in CALIBRATE_KERNELS if not record["launches"][k]]
    if failures:
        _fail(f"{len(failures)} calibration checks failed: {failures}")
    torch.cuda.empty_cache()

    # 7. the three paths, each with its launches counted from 0
    t_path = time.perf_counter()
    kernels.reset_launches()
    full = G.run(rows=G.N_FULL_ROWS)
    failures += _check_report(full, bounded=True)
    full.pop("outputs")
    l2 = G.run(rows=G.N_L2_ROWS)
    failures += _check_report(l2, bounded=False)
    launches = {k.name: k.launches for k in kernels.KERNELS}
    for report in (full, l2):
        print(json.dumps({"device": report["device"], "n": report["n"],
                          "block_rows": report["block_rows"]}))
        for rec in G.summary(report):
            print(json.dumps(rec))
    # the model under the calibrated machine, beside the prior's "ecm"
    print(json.dumps({"n": full["n"], "ecm_calibrated": G.ecm_against(
        full["timings"]["ops"], G.N_FULL_ROWS, calibrated)}))
    stream_s = time.perf_counter() - t_path

    t_path = time.perf_counter()
    kernels.reset_launches()
    stencil = {}
    for point, shape in GS.POINTS.items():
        report = GS.run(shape=shape)
        failures += _check_stencil_report(report)
        report.pop("output")
        stencil[point] = report
        torch.cuda.empty_cache()
    launches |= {k.name: k.launches for k in kernels.KERNELS
                 if k.name in STENCIL_POINTS}
    for report in stencil.values():
        print(json.dumps({"device": report["device"]}))
        for rec in GS.summary(report):
            print(json.dumps(rec))
        print(json.dumps({"shape": report["shape"],
                          "ecm_calibrated": GS.model_against(
                              tuple(report["shape"]), report["timings"]["ms"],
                              calibrated)}))
    stencil_s = time.perf_counter() - t_path

    t_path = time.perf_counter()
    kernels.reset_launches()
    compute = {}
    for point_name, point in GC.POINTS.items():
        before = {k.name: (dict(k.launches_by_route), k.launches)
                  for k in (kernels.MATMUL, kernels.FLASH_ATTENTION,
                            kernels.FLASH_COMBINE)}
        report = GC.run(point=point)
        failures += _check_compute_report(report)
        report.pop("output")
        for k in (kernels.MATMUL, kernels.FLASH_ATTENTION):
            report[f"{k.name}_launches_by_route"] = {
                r: n - before[k.name][0][r] for r, n in k.launches_by_route.items()}
        report["flash_combine_launches"] = (kernels.FLASH_COMBINE.launches
                                            - before["flash_combine"][1])
        if point.op == "matmul":
            route = kernels.matmul.kernel.route_of(point.dtype)
            if {r: n > 0 for r, n in report["matmul_launches_by_route"].items()} \
                    != {r: r == route for r in kernels.MATMUL.routes}:
                failures.append(f"{point_name} launched the matmul routes "
                                f"{report['matmul_launches_by_route']}, not "
                                f"{route} alone")
        elif point.dims[1] == 1:  # decode: the split route and its combine alone
            by_route = report["flash_attention_launches_by_route"]
            if by_route["tile"] or not by_route["split"] or \
                    report["flash_combine_launches"] < by_route["split"]:
                failures.append(f"{point_name} launched {by_route} and "
                                f"{report['flash_combine_launches']} combines")
        else:  # prefill: the tile route alone, at every compiled tiling
            by_route = report["flash_attention_launches_by_route"]
            timed = {tuple(json.loads(b)) for b in report["timings"]["measured_ms"]}
            if by_route["split"] or not by_route["tile"] or \
                    timed != {t for t in kernels.attention.kernel.TILINGS if t[0] > 1}:
                failures.append(f"{point_name} launched {by_route} and timed "
                                f"{sorted(timed)}")
        compute[point_name] = report
        torch.cuda.empty_cache()
    launches |= {k.name: k.launches for k in kernels.KERNELS
                 if KERNEL_VIEW[k.name][2] == "compute"}
    matmul_routes = dict(kernels.MATMUL.launches_by_route)
    attention_routes = dict(kernels.FLASH_ATTENTION.launches_by_route)
    for report in compute.values():
        print(json.dumps({"device": report["device"]}))
        for rec in GC.summary(report):
            print(json.dumps(rec))
    print(json.dumps({"path_s": {"stream": stream_s, "stencil": stencil_s,
                                 "compute": time.perf_counter() - t_path}}))
    failures += [f"{k} was not launched on its path"
                 for k, v in launches.items() if v == 0]

    # 8. Eq. 2 over the SMs, its launches counted from 0
    t_path = time.perf_counter()
    kernels.reset_launches()
    scaling_failures, scaling = _scaling_phase(calibrated)
    scaling_launches = {k.name: k.launches for k in kernels.KERNELS}
    scaling_failures += [f"{k} was not launched by the Eq. 2 sweep"
                         for k in ("map_pipeline", "reduce_pipeline")
                         if not scaling_launches[k]]
    print(json.dumps({k: v for k, v in scaling.items() if k != "ops"}
                     | {"phase": "scaling", "launches": scaling_launches,
                        "s": time.perf_counter() - t_path}))
    for op, rec in scaling["ops"].items():
        print(json.dumps({"phase": "scaling", "op": op, **rec}))
    failures += scaling_failures

    # 9. the kernels line
    ops_of = {"map": [o for o in G.OPS if o in kernels.pipeline.MAP_OPS],
              "reduce": [o for o in G.OPS if o in kernels.pipeline.REDUCE_OPS]}
    rows = []
    for k in kernels.KERNELS:
        op, path, family, served = KERNEL_VIEW[k.name]
        if k is kernels.FLASH_COMBINE:
            rec = compute[op]["timings"]["combine"]
            checks = [rec["check"]]
            rec = rec | {"ms": {path: rec["ms"]}}
            where = {"op": op, "path": path, "dims": compute[op]["dims"],
                     "split_plan": compute[op]["timings"]["split_plan"]}
        elif family == "compute":
            checks = [compute[pt]["check"] for pt in served]
            tm = compute[op]["timings"]
            rec = tm | {"ms": {path: tm["ms"]}}
            where = {"op": op, "path": path, "block": compute[op]["block"],
                     "dims": compute[op]["dims"]}
        elif family == "stencil":
            checks = [stencil[pt]["checks"][p] for pt in STENCIL_POINTS[k.name]
                      for p in served]
            rec = stencil[op]["timings"]
            where = {"op": stencil[op]["stencil"], "path": path,
                     "shape": stencil[op]["shape"]}
        else:
            checks = [full["checks"][o][p] for o in ops_of[family]
                      for p in served]
            rec = full["timings"]["ops"][op]
            where = {"op": op, "path": path, "n": full["n"]}
        if k is kernels.MATMUL:
            where["launches_by_route"] = matmul_routes
            where["by_route"] = {
                kernels.matmul.kernel.route_of(GC.POINTS[pt].dtype): {
                    "point": pt, "block": compute[pt]["block"],
                    "launches": compute[pt]["matmul_launches_by_route"],
                    **{key: compute[pt]["timings"][key] for key in (
                        "ms", "plain_ms", "library_ms", "bound_ms")}}
                for pt in served}
        if k is kernels.FLASH_ATTENTION:
            where["launches_by_route"] = attention_routes
            where["by_route"] = {
                kernels.attention.kernel.route_of(compute[pt]["block"][0]): {
                    "point": pt, "block": compute[pt]["block"],
                    "launches": compute[pt]["flash_attention_launches_by_route"],
                    **{key: compute[pt]["timings"][key] for key in (
                        "ms", "op_ms", "plain_ms", "library_ms", "bound_ms")}}
                for pt in served}
            where["by_route"]["split"]["split_plan"] = \
                compute["attention_decode"]["timings"]["split_plan"]
        worst = max(checks, key=lambda c: c[1])
        rows.append({
            "name": k.name, "route": k.route, "source": k.source_path,
            "replaces": k.replaces, "launches": launches[k.name],
            "max_abs_err": worst[1], "tolerance": worst[2],
            "ms": rec["ms"][path], "plain_ms": rec["plain_ms"],
            "bound_ms": rec["bound_ms"], "bound_by": rec["bound_by"],
            "library_ms": rec["library_ms"], **where,
        })
    print(json.dumps({"kernels": rows}))
    if failures:
        for f in failures:
            print(f"chip_smoke: {f}", file=sys.stderr)
        _fail(f"{len(failures)} main-path checks failed")

    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
