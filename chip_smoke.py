#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root on a machine with an H100:

    python3 chip_smoke.py

It drives the port's paths, the calibration of the card's model
(``repro_torch.launch.calibrate``), the paper's stream-ECM loop
(``repro_torch.benchmarks.gpu_stream_ecm.run``), the Jacobi stencil
loop (``repro_torch.benchmarks.gpu_stencil_ecm.run``), the
compute-bound loop (``repro_torch.benchmarks.gpu_compute_ecm.run``),
Eq. 2 over the SMs (``repro_torch.benchmarks.gpu_scaling_ecm.run``),
the energy over the SMs (``repro_torch.benchmarks.gpu_energy_ecm.run``)
and five models through the serve launcher
(``repro_torch.launch.serve.serve``): the dense internlm2-1.8b, the MoE
granite-moe-1b-a400m, the hybrid zamba2-1.2b, the encoder-decoder
whisper-base and the recurrent xlstm-125m; trains internlm2-1.8b
through the driver (``repro_torch.train.driver.Trainer``), also on a
one-rank NCCL mesh; runs the continuous-batching serving engine
(``repro_torch.serve``) and launches the split decode route at its
bucket picks; holds the whole-model composition and the dry-run's traces
against the served and trained models' device time; serves the five
models tensor parallel on a one-rank NCCL mesh and traces their
families' serving cells on a fake 256-rank world; and holds every CUDA kernel
against its plain PyTorch version.  Phases:

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
   stages and of many tiles, at the served MoE's and hybrid's heads (d 64,
   16 / 8 and 32 / 32, causal), and on strided q/k/v views, bit-equal to
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
   layer-condition estimate beside ``l2_bytes``; the overlap fit; the
   power fit (``ChipPower`` from the card's energy counter over a
   compute-bound load on 1-132 SMs, the flash tile route in f32, one CTA
   an SM, every count checked against its plain version;
   a visit whose SM clock leaves 1 % of the law's, or that shows a power
   cap or a slowdown, raises, which fails the phase, and no visit may draw
   more than POWER_MARGIN of the card's power limit), every power field
   finite and positive with its residual within ``MAX_FIT_RESIDUAL``,
   beside the idle card's reading and the counter's update period; every
   run's residuals printed; then a warm run from the same directory,
   which must fit and measure nothing;
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
9. the energy over the SMs against the calibrated machine: ``ddot``,
   ``copy`` and ``striad`` as in phase 8, each point held at least a
   second and checked; measured and modelled J, W and s a pass with the
   two factors (W and s) apart, each point's SM clock and clock event
   reasons (a clock more than 1 % off the first point's fails), the
   measured and modelled energy- and EDP-optimal SM counts beside the
   measured ``n_S`` of phase 8 and of this sweep, and the paper's claim
   (ii), reported; a reader error fails;
10. internlm2-1.8b at full width and all 24 layers, random weights
   drawn from SEED on the card: first the flash-attention op alone at the
   model's prefill shape (B 8, S 2048, 16 heads, 8 KV heads, d 128,
   causal, bf16) within the reference's tolerance of its plain version,
   timed at every compiled prefill tiling beside its plain version, SDPA
   (the compute loop's efficient backend on KV repeated, and the backend
   SDPA picks itself with ``enable_gqa``) and its bounds on the bf16
   tensor cores and on FFMA; then the model served (prompt 2048, batch 8)
   in f32 with ``attn_impl`` chunked (the plain version) and flash (the
   kernel), 4 decode steps each: every flash prefill launches the tile
   route exactly once a layer and the split route never, every logit is
   finite, the flash prefill's last-position logits are within 2e-3 of
   the chunked ones, and its prefill and decode logits within 2e-3 of a
   teacher-forced dense forward of the tokens it was fed; then in bf16
   (the parameters cast once), 32 decode steps each way: prefill and
   decode times and tokens/s, the model FLOP rate against the bf16 peak,
   decode against the bytes of the weights (and of the cache) a step
   reads, the device's idle share in decode (a CUDA graph's replay of one
   step against the eager step), the attention kernel's share of prefill,
   and the bf16 flash-chunked logit difference, reported, not gated;
11. granite-moe-1b-a400m at full width and all 24 layers (d 1024, 32
   experts, top 8, on the one-shard ``shard_map`` dispatch), as phase 10
   (the op alone at B 8, S 2048, 16 heads, 8 KV heads, d 64): the f32
   runs at ``capacity_factor = n_experts / top_k``, so nothing drops and
   the 8 x 2052-token forward routes as the 8-token decode steps do; the
   kernel held layer by layer on the model's own activations (flash
   against chunked attention on the same input within 2e-3, the flash
   output carried on); the routing decisions the flash and chunked
   prefills, and the decode steps and the teacher-forced forward, take
   differently counted, and each whole-model comparison gated only where
   none it spans flipped (reported otherwise); the bf16 runs at the
   config's capacity factor 1.25, with each layer's dropped share and
   busiest expert, and the device time of the dispatch against the
   expert products and the router;
12. zamba2-1.2b at full width and all 38 Mamba2 layers (d 2048), as
   phase 10: the shared attention block (32 heads, 32 KV heads, d 64)
   launches the tile route 7 times a flash prefill, once an application;
   decode carries the SSM, conv and KV caches; the device time of one
   Mamba2 layer and of its SSD chunk loop at the prefill's shape;
13. whisper-base at full width and depth (6 + 6 layers, d 512, 8 heads of
   64) at 1500 frames (Whisper's 30-second window) and the 11-token
   prompt the reference's batch spec gives: first the op alone at the
   encoder's shape (B 8, 1500, MHA, non-causal: a ragged last KV tile on
   every row block), bf16 and f32, within the reference's tolerance of
   its plain version, timed beside SDPA and its bounds; the encoder's
   attention layer by layer, flash against chunked; then served as phase
   10: the tile route exactly 12 times a flash prefill (6 encoder, 6
   decoder self-attention of 11 rows) and the split route never (the
   cross-attention is dense under flash, as in the reference), the f32
   flash prefill within 2e-3 of the chunked one and 4 decode steps of a
   teacher-forced ``encode`` + ``decode_train``; bf16 frames/s and prompt
   tokens/s, decode eager and as a graph, the device split;
14. xlstm-125m at full width and depth (12 blocks of d 768, sLSTM at 3
   and 7) at a 2048-token prompt: one mLSTM layer chunkwise against its
   recurrence in f32 (2e-3), the served prefill and 4 decode steps
   against the teacher-forced forward (2e-3), then bf16 times, the device
   ms and launches of the mLSTM chunk loop and the sLSTM loop, decode
   eager and as a graph; no attention kernel to launch (its count held
   at 0);
15. internlm2-1.8b trained at full width and depth (24 layers, f32
   masters, bf16 compute, AdamW at its defaults with f32 moments, lr
   3e-4, the config's ``remat="full"``, chunked attention and
   ``train_accum`` 2) on the reference's ``train_4k`` sequence (4096) at
   global batch 8 from ``ArchSyntheticDataset``: first the flash op alone
   at the eval's shape (B 4, S 4096, causal, bf16); the reduced-depth
   gates (two layers at full width, f32, B 2 x 256: one train step on the
   card against the same step on the CPU, the CPU's side in a fresh
   process with its threads and MKL branch fixed before torch loads and
   started from the card's parameters, the loss within 1e-5, the grad
   norm within 1e-4, every parameter within 1e-3 * lr and one rounding
   where the two first moments agree within 1e-4; remat full against
   none within 1e-6 and accum 2 against 1 within 1e-5 of each leaf's
   largest gradient, deterministic kernels);
   the restart gate (the smoke config, f32, bf16 and int8 moments: three
   steps straight equal to one step, an ``AsyncCheckpointer`` save,
   ``restore_tree`` onto the card and two more, every leaf bit for bit);
   the flash op refusing an operand that requires grad; then, its
   launches counted from 0, six train steps on batch 0 through the
   driver (``repro_torch.train.driver.Trainer`` without a mesh, no
   checkpoint written; the loss falls, every loss and parameter finite;
   each step timed from a device sync to a device sync beside the
   driver's wall time and straggler flags; steps 2-6 give the step
   time; the peak memory), one step under the profiler (its device time split into
   forward GEMMs, recompute, backward GEMMs, chunked attention, cross
   entropy, optimizer and the rest, the kernels, the idle share), and the
   eval step on one micro-batch with ``attn_impl`` flash (24 tile
   launches, no split launch) against chunked, f32 within 2e-3, bf16
   reported; last the optimizer alone with f32, bf16 and int8 moments
   against the bytes it must move;
16. the driver: the crash-and-resume at the smoke config (a crash
   injected at step 12 of 20, a fresh driver resumes from checkpoint 10;
   its losses and every state leaf bit-equal to an uninterrupted run's)
   and a one-rank NCCL mesh ``(1, 1)`` under ``tp_dp``
   (``repro_torch.launch.mesh.make_host_mesh``): the driver on the mesh,
   whose step is tensor parallel on the rank's blocks (every collective
   and its adjoint on the one-rank group), bit-equal to the driver
   without one over three steps, at the smoke config and at two layers at
   full width (f32); deterministic kernels; reported: phase 15's step
   (full width and depth, B 8 x 4096, bf16, remat full) three times on
   the mesh beside phase 15's step time without one, with the model's
   collectives a step and their host time;
17. the serving engine (``repro_torch.serve``): the reference's serving
   model (8 heads, 16 layers, d 128) in f32 and bf16, its ``BucketModel``
   on the card's data-sheet machine and then on phase 6's calibrated one
   (the swap must rebuild every table), each decode bucket from 128 to
   16384 keys with the model's pick and predicted seconds a
   request-token; at each bucket the split route for the engine's batch
   (16 requests, one query row, 8 heads, MHA) at every candidate tiling
   through the op, each held against the plain version, then timed with
   the compute loop's timings (every split tiling, the plain version,
   SDPA, the bound, the combine alone): measured seconds a request-token
   (kernel time x layers / 16) over predicted, the pick's rank among the
   measured tilings, no bound share where the batch's KV fits in the L2;
   the engine on the calibrated machine under the four fault plans at
   the reference's bench settings, twice each (no request lost, the two
   logs equal), and ``launch/serve.py --continuous`` as a subprocess; the
   KV page store on a one-rank NCCL mesh, where a device loss is logical
   and every page stays bit for bit;
18. the composed step against the card (``repro_torch.core.compose``),
   host arithmetic over the records of phases 6 and 10-17, no launch:
   each served model's prefill and decode step predicted at bf16 on the
   calibrated machine (the data-sheet prior beside it) against its
   measured device time, whole and by kind (attention against the tile
   route, matmuls against the libraries' GEMMs, stream ops against the
   rest), with the reference's dry-run agreement flag; the train step
   against 3x the composed prefill; the compose-backed ``BucketModel``
   bit-equal to the attention-backed one at every bucket, f32 and bf16;
   ``scale_model``'s Eq. 2 point of each decode step, printed;
19. the dry-run (``repro_torch.launch.dryrun``, ``core/hlo.py``): on fake
   CUDA tensors with the calibrated machine, in child processes, phase
   15's train step and each served arch's prefill and decode step at
   phase 18's shapes, and ``internlm2-1.8b train_4k`` on a fake world of
   256 ranks (the dry-run CLI); gated: the traced FLOPs of internlm2's
   flash prefill equal, exactly, ``FlopCounterMode``'s count of the same
   step run on the card, where the kernel launches (24 tile launches);
   reported: the traced peak against ``max_memory_allocated`` of phase
   15's step and of that prefill, the traced ``t_ecm`` against phases
   15's and 18's measured device ms beside phase 18's composed ratio,
   and ``rank_meshes``' winner at 8 cards on the calibrated machine;
   the 256-rank ``train_4k`` cell's tensor-parallel step against a data
   group's 16 rows traced on one card (a child): its useful share
   (``dryrun.useful_share``) at least 0.5 and its peak within the card's
   memory, gated; its per-card TFLOP, GB gathered and all-reduced by
   axis and peak reported beside the record of the step that gathered
   every parameter whole (PERF.md §5);
20. serving on a mesh (``launch/serve.py`` ``serve`` with ``mesh``, the
   tensor-parallel steps of ``train/steps.py``) on a one-rank NCCL mesh
   ``(1, 1)`` under the arch's profile, where every collective runs on
   the one-rank group: internlm2-1.8b as phase 10 serves it (bf16, flash,
   B 8, prompt 2048, 32 greedy steps), gated on 24 tile launches and its
   tokens equal to phase 10's, its prefill and decode times beside phase
   10's, and one decode step's host and device time on the mesh and
   without; the same arch at MESH_F32_LAYERS layers at full width, f32, with
   the cache split by sequence and ``cache_seq_axis="model"`` forced (the
   flash decode and its three all-reduces), the prefill's and
   MESH_F32_GEN steps' logits within MODEL_TOL of ``mesh=None``;
   granite-moe-1b-a400m (``shard_map``, bf16, flash) served MESH_MOE_GEN
   steps on the mesh, its logits and tokens bit-equal to ``mesh=None``
   (the multi-shard body on one model shard, its FSDP gathers over
   ``data``); zamba2-1.2b, whisper-base and xlstm-125m (MESH_FAMILIES)
   served on the mesh as phases 12-14 serve them (bf16, full width and
   depth, B 8, prompt 2048 or 1500 frames, 32 greedy steps), gated on
   their tokens equal to the phase's and 7, 12 and 0 tile launches a
   prefill, their prefill and decode times beside the phase's; in child
   processes (MESH_CHILDREN, at once), the dry-run's MESH_CELLS on fake
   CUDA tensors on the fake 256-rank ``16x16`` world (attention on the
   flash op; zamba2 at MESH_CUT's depth), their per-card TFLOP, bytes,
   collectives by kind and axis, ``t_link`` and peak, gated: each fits
   the card, each prefill's useful share (a data group's rows traced on
   one card, over the per-card FLOPs times the 16 model ranks) at least
   MESH_USEFUL_MIN, and each LM decode's flash decode in every layer (one
   max and one denominator all-reduce over ``model`` a layer, a
   numerator sum beside them);
21. one JSON line with the ten kernels (the matmul and attention rows
   with their launches per route, the matmul's per path too, the
   attention's per path with each model phase's, the train phase's and
   the serve phase's beside the compute loop's and its time at each
   model's shape and at the engine's largest bucket, the combine's with
   the decode's split plan), then the ``ok`` line.

The calibration, the Eq. 2 sweep, the energy sweep, the models' served
runs, the train phase's main path, the serve phase's buckets and the
mesh phase count their launches from 0 too, each kernel they run at
least once; the attention's count in the kernels line adds the power
fit's tile launches, the served runs', the train phase's evals', the
serve phase's split launches and the mesh phase's tile launches to the
compute loop's, the combine's the serve phase's.  The time of each phase is printed.

Any failure exits non-zero and prints no ``ok`` line.
"""
from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import json
import math
import os
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
#: tile is two ring panels, so one KV tile is fewer panels than stages;
#: the served MoE's and hybrid's heads at d 64 (granite-moe 16 / 8,
#: zamba2 32 / 32), causal, at a small S; whisper's encoder heads (8 / 8,
#: d 64), non-causal, with a ragged last tile as at its 1500 frames
TILE_WALKS = {"one_kv_tile": ((1, 64, 64, 2, 1, 128), True),
              "fewer_panels_than_stages": ((2, 64, 64, 4, 2, 64), True),
              "many_kv_tiles": ((1, 128, 2048, 4, 2, 128), False),
              "ragged_many_tiles": ((1, 300, 1000, 2, 1, 128), False),
              "d64_gqa2_16_heads": ((2, 256, 256, 16, 8, 64), True),
              "d64_mha_32_heads": ((2, 256, 256, 32, 32, 64), True),
              "d64_mha_ragged_non_causal": ((2, 300, 300, 8, 8, 64), False)}
#: blocks left at None on the card, and head dims 16 and 32 on the tile
#: route: (b, sq, sk, h, hkv, d), causal
NONE_BLOCK_ATTENTION = (((1, 192, 192, 4, 2, 64), True),
                        ((1, 192, 192, 4, 2, 64), False),
                        ((2, 256, 256, 8, 2, 16), True),
                        ((2, 256, 256, 8, 2, 32), False))
#: the model phases and the arch each serves at full width and depth
#: through the port's launcher, for a prompt batch of MODEL_BATCH x
#: MODEL_PROMPT tokens and MODEL_GEN greedy decode steps; the f32 gate run
#: decodes MODEL_F32_GEN steps, held against a teacher-forced forward
MODEL_PHASES = {10: "internlm2-1.8b", 11: "granite-moe-1b-a400m",
                12: "zamba2-1.2b", 13: "whisper-base", 14: "xlstm-125m"}
MODEL_BATCH, MODEL_PROMPT, MODEL_GEN, MODEL_F32_GEN = 8, 2048, 32, 4
#: the reference's attention tolerance (tests/test_kernels.py:102)
MODEL_TOL = (2e-3, 2e-3)
#: phase 15: the arch trained at full width and depth on the reference's
#: train_4k sequence at global batch TRAIN_BATCH (train_4k's 256, cut to
#: what one card holds beside the f32 state), TRAIN_STEPS steps at lr
#: TRAIN_LR on one batch
TRAIN_ARCH = "internlm2-1.8b"
TRAIN_SEQ, TRAIN_BATCH, TRAIN_STEPS, TRAIN_LR = 4096, 8, 6, 3e-4
#: the reduced-depth gates: GATE_LAYERS layers at full width, f32, B
#: GATE_BATCH x GATE_SEQ; the card's gradients are held to the CPU's leaf
#: by leaf within GATE_GRAD_REL of each leaf's largest |g| (as the CPU
#: tests hold them, tests/_torch_train.py), and a parameter after the step
#: to the CPU's where the two gradients agree within GATE_AGREE_REL: a
#: first AdamW step moves an entry by lr * g / (|g| + eps), so where g is
#: rounding noise (a sum that cancels, or |g| near eps) it follows the
#: last digits in which the two devices' sums part.  At most
#: GATE_MASKED_MAX of a leaf's entries may be left out that way: noise
#: leaves out ~1 % of the entries, a fault of a leaf or of a slice of it
#: far more
GATE_LAYERS, GATE_BATCH, GATE_SEQ = 2, 2, 256
GATE_GRAD_REL, GATE_AGREE_REL, GATE_MASKED_MAX = 2e-3, 1e-4, 0.05
#: the gates' CPU side runs in a fresh process with these set before torch
#: loads: a fixed thread count, and MKL's strict conditional numerical
#: reproducibility on its AVX2 branch (GEMM results independent of the
#: threads and of the operands' alignment); inside a long process the CPU
#: gradients varied from run to run
CPU_GATE_THREADS = 8
CPU_GATE_ENV = {"OMP_NUM_THREADS": str(CPU_GATE_THREADS),
                "MKL_NUM_THREADS": str(CPU_GATE_THREADS),
                "MKL_CBWR": "AVX2,STRICT"}
#: the optimizer's timed calls at each moment dtype
OPT_TIMED_CALLS = 3
#: phase 6: the most of the card's power limit a visit of the power sweep
#: may draw (its load is chosen to stay below it on every SM)
POWER_MARGIN = 0.95
#: phase 16: the driver's steps on the one-rank mesh and without one; the
#: steps of phase 15's shape timed on the mesh
DRIVER_MESH_STEPS, MESH_TRAIN_STEPS = 3, 3
#: phase 17: the reference's serve bench settings (tests/test_serve.py:36-37)
SERVE_INTERARRIVAL_S = 0.001
SERVE_STEP_BUDGET_S = 0.001
#: phase 18: the served and trained models' product operand size (bf16),
#: the walk's op kinds and the device split's families each is held
#: against, and a train step's multiple of the composed forward
#: (forward + backward, the backward each product twice; the reference's
#: ``repro/launch/dryrun.py`` ``TRAIN_STEP_MULT``)
COMPOSE_ELEM_BYTES = 2
COMPOSE_KINDS = {"attention": "flash_tile_ms", "matmul": "gemm_ms",
                 "stream": "other_ms"}
TRAIN_STEP_MULT = 3.0
#: phase 19: the one-card dry-run cells, traced on fake CUDA tensors in
#: child processes that run at once (one tuple of ``(kind, arch)`` a
#: child): phase 15's train step, a data group's rows of the world's
#: train cell, and each served arch's prefill and one decode step at
#: phase 18's shapes; the fake world's cell (the dry-run
#: CLI in its own child, 256 ranks); a child's time limit and the
#: phase's aim (reported)
DRYRUN_GROUPS = ((("train", TRAIN_ARCH),), (("train_rows", TRAIN_ARCH),),
                 (("prefill", "xlstm-125m"), ("decode", "xlstm-125m")),
                 (("prefill", "zamba2-1.2b"), ("decode", "zamba2-1.2b"),
                  ("prefill", "whisper-base"), ("decode", "whisper-base")),
                 (("prefill", "internlm2-1.8b"), ("decode", "internlm2-1.8b"),
                  ("prefill", "granite-moe-1b-a400m"),
                  ("decode", "granite-moe-1b-a400m")))
DRYRUN_WORLD = ("internlm2-1.8b", "train_4k")
#: the world cell's data ranks (its ``train_rows`` cell traces one data
#: group's rows on one card), and the record of the step that gathered
#: every parameter whole for each rank (PERF.md §5: traced on the host of
#: an H100 80GB HBM3, 700.00 W)
DRYRUN_DATA_RANKS = 16
DRYRUN_WORLD_WHOLE = {"tflop_per_card": 963.2, "useful_share": 0.048,
                      "gathered_gb": 7.58, "peak_gb": 82.61}
DRYRUN_CHILD_TIMEOUT_S, DRYRUN_AIM_S = 300, 90
#: phase 20: serving on a one-rank NCCL mesh ``(1, 1)``: MESH_ARCH as
#: phase 10 serves it (bf16, flash, MODEL_BATCH x MODEL_PROMPT,
#: MODEL_GEN greedy steps), through ``launch/serve.py`` ``serve`` on the
#: mesh, its tokens held equal to phase 10's; the decode split by sequence
#: (``cache_seq_axis="model"`` forced) at MESH_F32_LAYERS layers at full
#: width in f32, the prefill's and MESH_F32_GEN steps' logits held to
#: ``mesh=None`` within MODEL_TOL; MESH_MOE_ARCH (``shard_map``) served
#: MESH_MOE_GEN steps on the mesh, bit-equal to ``mesh=None``; the
#: dry-run's MESH_CELLS on the fake 256-rank ``16x16`` world (a child),
#: the prefill's useful share (a data group's rows on one card over the
#: per-card FLOPs times the model ranks) at least MESH_USEFUL_MIN and
#: each of MESH_FLASH_DECODES' flash decode in every layer; the phase's
#: aim (reported).  MESH_FAMILIES: the archs outside ``models/lm.py``
#: served on the mesh as phases 12-14 serve them, their tokens held equal
#: to the phase's, with the tile launches a prefill each must make.
#: MESH_CHILDREN: the cells each child traces, all children at once (a
#: ``card`` cell traces a data group's rows on one card); MESH_CUT: the
#: depth a cell of an arch is traced at here (zamba2's full-depth
#: ``prefill_32k`` takes minutes a side to trace: its SSD chunk loop;
#: six layers are one period of its shared block, at full width)
MESH_ARCH, MESH_MOE_ARCH = "internlm2-1.8b", "granite-moe-1b-a400m"
MESH_F32_LAYERS, MESH_F32_GEN, MESH_MOE_GEN = 2, 8, 4
MESH_FAMILIES = {"zamba2-1.2b": 7, "whisper-base": 12, "xlstm-125m": 0}
MESH_CELLS = (("internlm2-1.8b", "prefill_32k"),
              ("internlm2-1.8b", "decode_32k"),
              ("granite-moe-1b-a400m", "decode_32k"),
              ("zamba2-1.2b", "prefill_32k"),
              ("whisper-base", "decode_32k"),
              ("xlstm-125m", "decode_32k"))
MESH_FLASH_DECODES = MESH_CELLS[1:3]
MESH_WORLD, MESH_DATA_RANKS = "16x16", 16
MESH_CHILDREN = (tuple((n, s, MESH_WORLD) for n, s in MESH_CELLS
                       if n != "zamba2-1.2b")
                 + (("internlm2-1.8b", "prefill_32k", "card"),),
                 (("zamba2-1.2b", "prefill_32k", MESH_WORLD),),
                 (("zamba2-1.2b", "prefill_32k", "card"),))
MESH_CUT = {"zamba2-1.2b": 6}
MESH_USEFUL_MIN = 0.5
MESH_CHILD_TIMEOUT_S, MESH_AIM_S = 300, 120
#: the device split of a train step (``_train_split``)
TRAIN_SPLIT = ("forward_gemm_ms", "recompute_ms", "backward_gemm_ms",
               "chunked_attention_ms", "cross_entropy_ms", "optimizer_ms",
               "other_ms")
#: decode steps a CUDA graph replays to read the device's busy time
MODEL_GRAPH_STEPS = 3
#: whisper-base's frames: Whisper's 30-second window (arXiv:2212.04356
#: §2.2), which the launcher serves as ``--prompt-len 1500`` (the
#: reference's batch spec then gives an 11-token prompt); its chunked runs
#: take chunks of 750, the largest divisor of 1500 not above the config's
#: 1024 (the chunked attention's chunk divides the length, as the
#: reference's asserts)
WHISPER_FRAMES = 1500
WHISPER_CHUNK = 750
#: kernel-name fragments of the matmul libraries (cuBLAS, CUTLASS) in a
#: profile of the served model
GEMM_NAMES = ("gemm", "gemv", "nvjet", "cutlass", "xmma")
#: the kernels the calibration times (grid sweeps, stencil sweeps, the
#: one-CTA pair)
CALIBRATE_KERNELS = ("grid_map", "grid_reduce", "jacobi2d_grid",
                     "jacobi3d_grid", "map_pipeline", "flash_attention")
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
            try:
                rc, report = cli.run(argv)
            except Exception as e:  # noqa: BLE001 - a reader or sweep error fails the phase
                failures.append(f"calibrate {run} run raised "
                                f"{type(e).__name__}: {e}")
                return failures, None, {"runs": runs}
            runs[run] = {"rc": rc, "s": time.perf_counter() - t0,
                         "fits": cal.CAL_COUNTERS["fits"],
                         "measurements": cal.CAL_COUNTERS["measurements"],
                         "cache": dict(diskcache.COUNTERS),
                         "from_cache": report.from_cache if report else None,
                         "residuals": {f.field: f.residual for f in report.fits}
                         if report else None}
            if rc != 0 or report is None:
                failures.append(f"calibrate {run} run exited {rc}")
                return failures, None, {
                    "runs": runs,
                    "backend": report.checks.get("backend") if report else None}
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
    for group in ("bandwidth", "power"):
        if cold.residual_max(group) > cal.MAX_FIT_RESIDUAL:
            failures.append(f"{group} residual {cold.residual_max(group)} "
                            f"over {cal.MAX_FIT_RESIDUAL}")
    if sorted(f.field for f in cold.fits if f.group == "power") != sorted(
            f"power.{nm}" for nm in cal.POWER_FIELDS):
        failures.append("the calibration fitted no power")
    peak = cold.checks["backend"]["power"]["peak_share_of_limit"]
    if not peak <= POWER_MARGIN:
        failures.append(f"the power sweep drew {peak} of the card's limit, "
                        f"over {POWER_MARGIN}")
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
            "measured_bw", "l2_bytes", "l2_bytes_per_s", "write_allocate")}
        | {"power": vars(cold.machine.power)},
        "power": cold.checks.get("power"),
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


def _energy_phase(machine, scaling: dict) -> tuple[list[str], dict]:
    """Phase 9: the energy over the SMs against the calibrated machine,
    beside phase 8's measured ``n_S``."""
    from repro_torch.benchmarks import gpu_energy_ecm as EN
    from repro_torch.benchmarks import gpu_scaling_ecm as SC

    try:
        report = EN.run(machine)
    except Exception as e:  # noqa: BLE001 - a reader error fails the phase
        return [f"energy sweep raised {type(e).__name__}: {e}"], {}
    failures = report["check_failures"] + report["clock_failures"]
    for op, rec in report["ops"].items():
        rec["n_s_eq2"] = scaling["ops"][op]["n_s_measured"]
        if set(rec["points"]) != set(SC.CTAS):
            failures.append(f"energy {op}: measured {sorted(rec['points'])}")
        for n, p in rec["points"].items():
            if not all(math.isfinite(p[k]) and p[k] > 0 for k in (
                    "joules", "watts", "seconds", "model_joules")):
                failures.append(f"energy {op} ctas={n}: {p}")
    return failures, report


def _attention_at_model_shape(acfg, machine, batch: int = MODEL_BATCH,
                              seq: int = MODEL_PROMPT
                              ) -> tuple[list[str], dict]:
    """The attention op alone at a served model's prefill shape in bf16
    (``acfg``: its attention config; ``batch`` x ``seq``, causal), through
    the compute loop
    (``gpu_compute_ecm.run``: the check against the plain version, the
    kernel at every compiled prefill tiling, the plain version, SDPA's
    efficient backend on KV repeated), plus SDPA with the backend it picks
    itself on KV unrepeated (``enable_gqa``), and the bound on the bf16
    tensor cores and on FFMA."""
    import torch.nn.functional as F

    from repro_torch.benchmarks import gpu_compute_ecm as GC
    from repro_torch.benchmarks.timing import time_call

    dims = (batch, seq, seq, acfg.n_heads, acfg.n_kv_heads, acfg.head_dim)
    point = GC.Point("attention", dims, torch.bfloat16, causal=True)
    report = GC.run(point=point)
    failures = _check_compute_report(report)
    tm = report["timings"]
    q, k, v = (t.transpose(1, 2) for t in GC.make_inputs(point, "cuda"))
    sdpa_ms = time_call(lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=True, enable_gqa=True))[0]
    ffma_ms = tm["operations_ms"] * (machine.peak_bf16_tensor_flops
                                     / machine.peak_f32_flops)
    return failures, {
        "dims": list(dims), "dtype": "bfloat16", "block": report["block"],
        "check": report["check"],
        **{key: tm[key] for key in ("ms", "op_ms", "measured_ms", "plain_ms",
                                    "library", "library_ms", "bound_ms",
                                    "bound_by", "bytes_ms", "operations_ms")},
        "bound_ms_ffma": max(tm["bytes_ms"], ffma_ms),
        "share_of_bound": tm["bound_ms"] / tm["ms"],
        "share_of_ffma_bound": max(tm["bytes_ms"], ffma_ms) / tm["ms"],
        "sdpa_own_backend_gqa_ms": sdpa_ms}


def _contracted_fan_in(spec: dict, path: tuple, acfg) -> dict:
    """The model's spec tree with the attention projections of the
    subtree at ``path`` (``("layers", "attn")``, zamba2's ``("shared",
    "attn")``; ``acfg`` its attention config) scaled by the fan-in they
    contract over: ``wq``, ``wk``, ``wv`` by d_model, ``wo`` by heads x
    head_dim.  The reference's initializer (kept by the port's
    ``materialize``) takes the fan-in from axis -2, which for a ``(d, h,
    hd)`` projection is the head count: at internlm2-1.8b's width its
    scores have a standard deviation near 180, the softmax is one-hot, and
    rounding alone flips which key a row attends to, so two correct f32
    attention paths part by whole units in the logits after 24 layers."""
    if not path:
        fan_in = {"wq": acfg.d_model, "wk": acfg.d_model, "wv": acfg.d_model,
                  "wo": acfg.n_heads * acfg.head_dim}
        return {k: dataclasses.replace(p, scale=fan_in[k] ** -0.5)
                if k in fan_in else p for k, p in spec.items()}
    return spec | {path[0]: _contracted_fan_in(spec[path[0]], path[1:], acfg)}


def _device_split(fn) -> dict:
    """Device time of one call of ``fn`` by kernel, from torch.profiler's
    CUDA activity after a warm-up call: ms in the port's attention tile
    kernel, in the matmul libraries (GEMM_NAMES) and in every other
    kernel, the kernel count, and the five dearest kernels.  A profiler
    the machine refuses, or one that records no device time, is reported
    as not measured."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        rows = [(e.key, e.self_device_time_total / 1e3, e.count)
                for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    except Exception as e:  # noqa: BLE001 - a refused profiler is a reading not taken
        return {"not_measured": f"{type(e).__name__}: {e}"}
    total = sum(ms for _, ms, _ in rows)
    if not total:
        return {"not_measured": "the profiler recorded no device time"}
    split = {"flash_tile_ms": 0.0, "gemm_ms": 0.0, "other_ms": 0.0}
    for name, ms, _ in rows:
        fam = ("flash_tile_ms" if "flash_tile" in name else "gemm_ms"
               if any(g in name.lower() for g in GEMM_NAMES) else "other_ms")
        split[fam] += ms
    top = sorted(rows, key=lambda r: -r[1])[:5]
    return split | {"total_ms": total, "kernels": sum(n for *_, n in rows),
                    "top": [{"kernel": k[:120], "ms": ms, "count": n}
                            for k, ms, n in top]}


@contextlib.contextmanager
def _recorded_routes():
    """Every MoE routing decision made inside the block: the ids ``(N,
    k)`` of each ``moe._route`` call, in call order (a prefill's first,
    one a layer, then each decode step's)."""
    from repro_torch.models import moe

    route, calls = moe._route, []

    def recording(p, cfg, xf):
        out = route(p, cfg, xf)
        calls.append(out[1])
        return out

    moe._route = recording
    try:
        yield calls
    finally:
        moe._route = route


def _route_flips(a, b) -> int:
    """Tokens whose set of k experts differs between two ``(N, k)`` id
    tensors."""
    return int((a.sort(dim=-1).values != b.sort(dim=-1).values).any(-1).sum())


def _attention_walk(params, cfg, tokens) -> tuple[list[str], list[float]]:
    """The kernel's gate on the model's own activations: ``lm.prefill``'s
    layer loop by hand on the flash path; at each layer the flash
    attention output against the chunked one on the same input, within
    MODEL_TOL, the flash output carried on.  A routing flip in one layer
    cannot spoil a later layer's comparison, as it would between two whole
    runs.  Returns what failed and each layer's max abs difference."""
    from repro_torch.kernels.check import compare
    from repro_torch.models import lm
    from repro_torch.models.attention import attention
    from repro_torch.models.common import rmsnorm

    flash = dataclasses.replace(cfg, attn_impl="flash")
    chunked = dataclasses.replace(cfg, attn_impl="chunked")
    h = lm._embed(params, cfg, tokens, None)
    failures, errs = [], []
    for i, p_l in enumerate(lm._layers(params, cfg)):
        x = rmsnorm(p_l["ln_attn"], h, cfg.norm_eps)
        got, _ = attention(p_l["attn"], flash.attn_cfg, x)
        want, _ = attention(p_l["attn"], chunked.attn_cfg, x)
        ok, err, tol = compare(got, want, tol=MODEL_TOL)
        errs.append(err)
        if not ok:
            failures.append(f"layer {i}: flash attention off the chunked one "
                            f"by {err} (tol {tol})")
        h = h + got
        h = h + lm._ffn(p_l, flash, rmsnorm(p_l["ln_ffn"], h, cfg.norm_eps))[0]
    return failures, errs


def _moe_loads(calls, cfg) -> dict:
    """Per layer of a prefill's routing (its first ``n_layers`` calls):
    the share of the N*k assignments past their expert's capacity (the
    dispatch drops them) and the busiest expert's load over the mean."""
    from repro_torch.models import moe

    e = cfg.moe.n_experts
    dropped, peak = [], []
    for ids in calls[:cfg.n_layers]:
        cap = moe._capacity(ids.shape[0], cfg.moe)
        counts = moe._counts(ids.reshape(-1), e)
        dropped.append(float((counts - cap).clamp_min(0).sum()) / ids.numel())
        peak.append(float(counts.max()) / float(counts.float().mean()))
    return {"capacity": moe._capacity(calls[0].shape[0], cfg.moe),
            "dropped_share_per_layer": dropped,
            "dropped_share_max": max(dropped),
            "max_over_mean_load_per_layer": peak}


def _moe_timing(p_moe, cfg, d_model: int) -> dict:
    """Device ms of the MoE FFN at the prefill's N = B x S tokens (bf16,
    the first layer's weights, inputs N(0, 1) as after the RMSNorm): the
    whole FFN, its router, its expert products on the ``(E, cap, d)``
    buffer, and the dispatch (sort, gathers, scatters, combine) as the
    rest."""
    from repro_torch.benchmarks.timing import time_call
    from repro_torch.models import moe

    m = cfg.moe
    g = torch.Generator(device="cuda").manual_seed(SEED)
    x = torch.randn((MODEL_BATCH, MODEL_PROMPT, d_model), generator=g,
                    device="cuda").to(cfg.dtype)
    cap = moe._capacity(MODEL_BATCH * MODEL_PROMPT, m)
    buf = torch.randn((m.n_experts, cap, d_model), generator=g,
                      device="cuda").to(cfg.dtype)
    ms = {"ffn_ms": time_call(lambda: moe.moe_ffn(p_moe, m, x), inner=5)[0],
          "router_ms": time_call(lambda: moe._route(
              p_moe, m, x.reshape(-1, d_model)), inner=5)[0],
          "expert_products_ms": time_call(lambda: moe._expert_ffn(
              p_moe["w_gate"], p_moe["w_up"], p_moe["w_down"], buf), inner=5)[0]}
    ms["dispatch_ms"] = ms["ffn_ms"] - ms["router_ms"] - ms["expert_products_ms"]
    return ms | {"n_layers": cfg.n_layers, "tokens": MODEL_BATCH * MODEL_PROMPT,
                 "capacity": cap}


def _ssd_timing(p_layer, cfg) -> dict:
    """Device ms of one Mamba2 layer at the prefill's shape (bf16, the
    first layer's weights, input N(0, 1) as after the RMSNorm) and of its
    SSD chunk loop (``_ssd_chunked``) alone on inputs of its shapes."""
    from repro_torch.benchmarks.timing import time_call
    from repro_torch.models import mamba2

    m = cfg.mamba_cfg
    g = torch.Generator(device="cuda").manual_seed(SEED)

    def randn(*shape):
        return torch.randn(shape, generator=g, device="cuda").to(cfg.dtype)

    b, s = MODEL_BATCH, MODEL_PROMPT
    u = randn(b, s, cfg.d_model)
    x = randn(b, s, m.n_heads, m.head_dim)
    bmat, cmat = randn(b, s, m.n_groups, m.d_state), randn(b, s, m.n_groups, m.d_state)
    dt = mamba2._softplus(randn(b, s, m.n_heads).float())
    a_log = torch.zeros(m.n_heads, device="cuda")
    ms = {"layer_ms": time_call(lambda: mamba2.mamba2_layer(p_layer, m, u),
                                inner=3)[0],
          "ssd_ms": time_call(lambda: mamba2._ssd_chunked(
              m, x, bmat, cmat, dt, a_log), inner=3)[0]}
    return ms | {"ssd_share_of_layer": ms["ssd_ms"] / ms["layer_ms"],
                 "n_layers": cfg.n_layers, "chunk": m.chunk,
                 "chunks": -(-s // m.chunk)}


def _nbytes(tree) -> int:
    from repro_torch.models.common import tree_leaves

    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))


class _Runs:
    """The served runs of one model phase through the port's launcher
    (``launch/serve.py`` ``serve``) at MODEL_BATCH x ``prompt_len``: each
    run's times and rates in ``runs``, the attention kernel's launches
    by route held to ``tiles`` tile launches for an ``attn_impl="flash"``
    run and none otherwise, and every logit finite; ``failures`` collects
    what did not hold."""

    def __init__(self, name: str, arch, prompt_len: int, tiles: int,
                 rates: dict):
        self.name, self.arch, self.prompt_len = name, arch, prompt_len
        self.tiles, self.rates = tiles, rates
        self.runs, self.failures = {}, []

    def variant(self, **kw):
        return dataclasses.replace(self.arch, cfg=dataclasses.replace(
            self.arch.cfg, **kw))

    def __call__(self, params, gen: int, tag: str = "", **kw):
        from repro_torch import kernels
        from repro_torch.launch.serve import serve

        attn = kernels.FLASH_ATTENTION
        before = dict(attn.launches_by_route)
        arch = self.variant(**kw)
        served = serve(arch, params, batch=MODEL_BATCH,
                       prompt_len=self.prompt_len, gen=gen, seed=SEED)
        impl = getattr(arch.cfg, "attn_impl", None)
        run_name = f"{str(arch.cfg.dtype).removeprefix('torch.')} " \
                   f"{impl or 'model'}{tag}"
        launched = {r: n - before[r] for r, n in attn.launches_by_route.items()}
        want = {"tile": self.tiles if impl == "flash" else 0, "split": 0}
        if launched != want:
            self.failures.append(f"model {self.name} {run_name}: attention "
                                 f"launches {launched}, not {want}")
        logits = [served.prefill_logits, *served.step_logits]
        if not all(bool(torch.isfinite(t).all()) for t in logits):
            self.failures.append(f"model {self.name} {run_name}: a logit is "
                                 f"not finite")
        self.runs[run_name] = {
            "prefill_s": served.prefill_s, "decode_s": served.decode_s,
            "gen": gen, "attention_launches": launched,
            **{f"prefill_{k}_per_s": n / served.prefill_s
               for k, n in self.rates.items()},
            "decode_s_per_token": served.decode_s / gen if gen else None,
            "decode_tokens_per_s": MODEL_BATCH * gen / served.decode_s
            if gen else None}
        return served

    def gate(self, what: str, got, want) -> dict:
        from repro_torch.kernels.check import compare

        ok, err, tol = compare(got, want, tol=MODEL_TOL)
        if not ok:
            self.failures.append(f"model {self.name} f32: {what} off by {err} "
                                 f"(tol {tol})")
        return {"ok": ok, "max_abs_err": err, "tol": tol}


def _decode_idle(arch, params, served, vocab: int) -> tuple[float, object]:
    """The device's busy ms in one decode step: a CUDA graph replays the
    step (and its argmax) on a copy of ``served``'s cache with no host in
    between; returns it and the step."""
    from repro_torch.benchmarks.timing import time_graph

    cache = dict(served.cache)
    tok = served.tokens[:, -1:].to("cuda")

    def step():
        logits, _ = arch.decode(params, cache, {"tokens": tok})
        return logits[:, -1, :vocab].argmax(-1)

    return time_graph(step, launches=MODEL_GRAPH_STEPS), step


def _model_phase(name: str, machine) -> tuple[list[str], dict]:
    """Phases 10-12: the arch ``name`` at full width and depth through the
    port's serve function (``launch/serve.py``), random weights from SEED
    materialized on the card by the port's ``materialize``, the attention
    projections at their contracted fan-in (:func:`_contracted_fan_in`).

    f32 first (the gates): chunked, the plain version, then flash, the
    kernel; the flash prefill's last-position logits against the chunked
    ones, and its decode steps against a teacher-forced dense forward of
    the tokens it was fed, each within MODEL_TOL.  An MoE runs these at
    ``capacity_factor = n_experts / top_k`` (nothing can drop, so the
    8 x 2052-token forward routes as the 8-token decode steps do), holds
    the kernel layer by layer (:func:`_attention_walk`), and counts the
    routing decisions the two runs take differently: a whole-model
    comparison is gated only where no decision it spans flipped, and
    reported otherwise.  The same f32 prefills on the reference's own
    initializer are reported beside them, not gated.  Then the parameters
    cast once to bf16 (the config's dtype; the f32 copy freed) and served
    both ways at MODEL_GEN steps: prefill and decode times, the model FLOP
    rate (active parameters), the weight-bytes bound of a decode step, the
    device's idle share in decode (a CUDA graph's replay of one step
    against the eager step), the bf16 flash-chunked logit difference, an
    MoE's dropped share per layer and the device time of its dispatch, a
    hybrid's SSD chunk loop.  Returns what failed and the record;
    ``launches`` counts the served runs' kernel launches from 0."""
    from repro_torch import kernels
    from repro_torch.benchmarks import gpu_compute_ecm as GC
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.kernels.check import compare
    from repro_torch.models import lm, zamba2
    from repro_torch.models.common import (cast_params, materialize, unembed,
                                           unstack)

    arch = get_arch(name)
    cfg = arch.cfg
    hybrid = arch.family == "hybrid"
    moe = getattr(cfg, "moe", None)
    n_attn = cfg.n_shared if hybrid else cfg.n_layers
    failures, rec = [], {"phase": f"model {arch.name}", "arch": arch.name,
                         "family": arch.family, "n_layers": cfg.n_layers,
                         "d_model": cfg.d_model, "n_params": arch.n_params,
                         "n_active_params": arch.n_active_params,
                         "attention_applications": n_attn,
                         "batch": MODEL_BATCH, "prompt": MODEL_PROMPT}
    attn_failures, rec["attention"] = _attention_at_model_shape(
        cfg.attn_cfg, machine)
    failures += attn_failures
    torch.cuda.empty_cache()
    dev = torch.device("cuda")

    def weights(spec):
        return materialize(spec, torch.Generator(device=dev).manual_seed(SEED),
                           device=dev)

    def hidden(params, c, tokens):
        return (zamba2 if hybrid else lm).hidden_states(params, c, tokens)[0]

    prompt = torch.from_numpy(arch.make_batch(ShapeSpec(
        "cli_prefill", MODEL_PROMPT, MODEL_BATCH, "prefill"), seed=SEED)["tokens"])
    runs = _Runs(name, arch, MODEL_PROMPT, n_attn,
                 {"tokens": MODEL_BATCH * MODEL_PROMPT})
    variant = runs.variant

    def run(dtype, impl, gen, params, tag="", **kw):
        return runs(params, gen, tag, dtype=dtype, attn_impl=impl, **kw)

    # an MoE's f32 gates at capacity N: nothing drops
    gate_kw = {} if moe is None else {"moe": dataclasses.replace(
        moe, capacity_factor=moe.n_experts / moe.top_k)}
    path = ("shared", "attn") if hybrid else ("layers", "attn")
    with GC.full_f32():
        f32_cfg = variant(dtype=torch.float32, **gate_kw).cfg
        params = weights(_contracted_fan_in(arch.param_spec(), path,
                                            cfg.attn_cfg))
        if moe is not None:   # before the count: a comparison, not the path
            walk_failures, errs = _attention_walk(params, f32_cfg, prompt.to(dev))
            failures += [f"model {name} f32 walk, {f}" for f in walk_failures]
            rec["f32_attention_by_layer"] = {"max_abs_err": errs, "tol": MODEL_TOL}
        kernels.reset_launches()
        ref_params = weights(arch.param_spec())
        ref_init = [run(torch.float32, impl, 0, ref_params, " (reference init)",
                        **gate_kw) for impl in ("chunked", "flash")]
        diff = ref_init[1].prefill_logits - ref_init[0].prefill_logits
        rec["f32_reference_init_flash_vs_chunked_max_abs"] = float(diff.abs().max())
        del ref_params, ref_init, diff
        with _recorded_routes() as routes:
            chunked = run(torch.float32, "chunked", MODEL_F32_GEN, params, **gate_kw)
            n_calls = len(routes)
            flash = run(torch.float32, "flash", MODEL_F32_GEN, params, **gate_kw)
            # the teacher-forced forward of the prompt and the fed tokens:
            # positions MODEL_PROMPT - 1 .. + MODEL_F32_GEN
            dense = variant(dtype=torch.float32, attn_impl="dense", **gate_kw).cfg
            toks = torch.cat([prompt.to(dev), flash.fed], dim=1)
            full = unembed(params["unembed"],
                           hidden(params, dense, toks)[:, MODEL_PROMPT - 1:])
        chunked.cache = flash.cache = None
        # each whole-model comparison is gated where no routing decision
        # it spans flipped: flash against chunked, the prefill's; decode
        # step j against the teacher-forced forward, every position up to
        # its own (the prompt's through the cache)
        flips = {"prefill": 0, "decode_steps": [0] * (MODEL_F32_GEN + 1)}
        if moe is not None:
            layers, b, p = cfg.n_layers, MODEL_BATCH, MODEL_PROMPT
            c_routes, f_routes = routes[:n_calls], routes[n_calls:2 * n_calls]
            tf_routes = [t.view(b, p + MODEL_F32_GEN, -1) for t in routes[2 * n_calls:]]
            flips["prefill"] = sum(_route_flips(c, f) for c, f in
                                   zip(c_routes[:layers], f_routes[:layers]))
            seen = sum(_route_flips(f, t[:, :p].reshape(b * p, -1))
                       for f, t in zip(f_routes[:layers], tf_routes))
            flips["prefill_vs_teacher_forced"] = seen
            flips["decode_steps"][0] = seen
            for j in range(1, MODEL_F32_GEN + 1):
                step = f_routes[layers * j:layers * (j + 1)]
                seen += sum(_route_flips(d, t[:, p - 1 + j])
                            for d, t in zip(step, tf_routes))
                flips["decode_steps"][j] = seen
            flips["decisions_prefill"] = b * p * layers
            rec["f32_route_flips"] = flips
        del routes
        ok, err, tol = compare(flash.prefill_logits, chunked.prefill_logits,
                               tol=MODEL_TOL)
        gated = flips["prefill"] == 0
        rec["f32_flash_vs_chunked"] = {"ok": ok, "max_abs_err": err, "tol": tol,
                                       "gated": gated}
        if gated and not ok:
            failures.append(f"model {name} f32: flash prefill logits off the "
                            f"chunked ones by {err} (tol {tol})")
        errs, gates = [], []
        for j, got in enumerate([flash.prefill_logits, *flash.step_logits]):
            ok, err, tol = compare(got[:, 0], full[:, j], tol=MODEL_TOL)
            errs.append(err)
            gates.append(flips["decode_steps"][j] == 0)
            if gates[-1] and not ok:
                failures.append(f"model {name} f32: decode step {j} off the "
                                f"teacher-forced forward by {err} (tol {tol})")
        rec["f32_decode_vs_teacher_forced"] = {"max_abs_err": errs, "tol": tol,
                                               "gated": gates}
        del full, chunked, flash
    params = cast_params(params, cfg.dtype)
    torch.cuda.empty_cache()
    chunked = run(cfg.dtype, "chunked", MODEL_GEN, params)
    chunked.cache = None
    with _recorded_routes() as routes:
        flash = run(cfg.dtype, "flash", MODEL_GEN, params)
    diff = (flash.prefill_logits.float() - chunked.prefill_logits.float()).abs()
    rec["bf16_flash_vs_chunked_max_abs"] = float(diff.max())
    rec["bf16_tokens_equal_share"] = float(
        (flash.tokens == chunked.tokens).float().mean())
    rec["bf16_flash_tokens"] = flash.tokens.tolist()
    rec["launches"] = {k.name: k.launches for k in kernels.KERNELS}
    rec["attention_launches_by_route"] = dict(
        kernels.FLASH_ATTENTION.launches_by_route)
    del chunked

    if moe is not None:
        rec["moe"] = _moe_loads(routes, cfg) | _moe_timing(
            lm._layers(params, cfg)[0]["moe"], cfg, cfg.d_model)
    if hybrid:
        rec["ssd"] = _ssd_timing(unstack(params["layers"], cfg.n_layers)[0]["mamba"],
                                 cfg)
    del routes

    flash_arch = variant(attn_impl="flash")
    busy_ms, step = _decode_idle(flash_arch, params, flash, cfg.vocab)
    stats = runs.runs[f"{str(cfg.dtype).removeprefix('torch.')} flash"]
    stats["graph_decode_ms"] = busy_ms
    tokens = {"tokens": prompt.to(dev)}
    rec["device_split"] = {
        "prefill": _device_split(lambda: flash_arch.prefill(
            params, tokens, max_len=MODEL_PROMPT)),
        "decode_step": _device_split(step)}
    rec["runs"] = runs.runs
    eager_ms = stats["decode_s_per_token"] * 1e3
    table = params["embedding"]
    weight_bytes = (_nbytes(params) - _nbytes(table)
                    + MODEL_BATCH * table.shape[1] * table.element_size())
    cache_bytes = _nbytes({key: flash.cache[key] for key in ("k", "v")})
    flops = arch.model_flops(ShapeSpec("prefill", MODEL_PROMPT, MODEL_BATCH,
                                       "prefill"))
    prefill_ms = stats["prefill_s"] * 1e3
    rec["summary"] = {
        "prefill_s": stats["prefill_s"],
        "prefill_tokens_per_s": stats["prefill_tokens_per_s"],
        "decode_s_per_token": stats["decode_s_per_token"],
        "decode_tokens_per_s": stats["decode_tokens_per_s"],
        "model_flops": flops,
        "model_flop_per_s": flops / stats["prefill_s"],
        "model_flop_share_of_bf16_peak": flops / stats["prefill_s"]
        / machine.peak_bf16_tensor_flops,
        "decode_weight_bytes": weight_bytes,
        "decode_weight_bound_ms": machine.hbm_seconds(weight_bytes) * 1e3,
        "decode_share_of_weight_bound": machine.hbm_seconds(weight_bytes) * 1e3
        / eager_ms,
        "decode_cache_bytes_read": cache_bytes,
        "decode_share_of_weight_and_cache_bound": machine.hbm_seconds(
            weight_bytes + cache_bytes) * 1e3 / eager_ms,
        "decode_graph_ms": busy_ms, "decode_eager_ms": eager_ms,
        "decode_idle_share": 1.0 - busy_ms / eager_ms,
        "attention_ms_per_application": rec["attention"]["ms"],
        "attention_share_of_prefill": n_attn * rec["attention"]["ms"]
        / prefill_ms,
    }
    return failures + runs.failures, rec


def _attention_at_encoder_shape(acfg, machine) -> tuple[list[str], dict]:
    """The attention op alone at whisper-base's encoder shape (B 8, 1500
    frames, 8 heads of 64, MHA, non-causal: the last of 12 KV tiles of 128
    ragged), in bf16 and f32: the model's own call (one block of the whole
    sequence, so the ranking's tiling) held against the plain version
    within the reference's tolerance, and timed beside the kernel at every
    compiled tile tiling, the plain version, SDPA's efficient backend
    (``gpu_compute_ecm``'s yardstick) and the backend SDPA picks itself,
    with the bound on the type's peak and, for bf16, on FFMA."""
    import torch.nn.functional as F

    from repro_torch.benchmarks import gpu_compute_ecm as GC
    from repro_torch.benchmarks.timing import time_call
    from repro_torch.kernels.attention import kernel as AK
    from repro_torch.kernels.attention import ops as AO
    from repro_torch.kernels.attention import ref as AR
    from repro_torch.kernels.check import compare

    s = WHISPER_FRAMES
    dims = (MODEL_BATCH, s, s, acfg.n_heads, acfg.n_kv_heads, acfg.head_dim)
    block = AO.card_blocks((s, s), AO.ranked_blocks(s, s, acfg.head_dim,
                                                    causal=False))
    failures, out = [], {}
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).removeprefix("torch.")
        point = GC.Point("attention", dims, dtype, causal=False)
        inputs = GC.make_inputs(point, "cuda")
        operands = AO.fused_inputs(*inputs)

        def call(inputs=inputs):
            return AO.flash_attention(*inputs, causal=False, bq=s, bk=s)

        with GC.full_f32():
            want = GC.plain_op(point, inputs)
        check = compare(call(), want, tol=GC.TOLERANCE["attention"][dtype])
        del want
        if not check[0]:
            failures.append(f"encoder attention {name}: err {check[1]} "
                            f"tol {check[2]}")
        measured = {str(list(t)): time_call(GC._kernel_call(point, inputs, t))[0]
                    for t in AK.TILINGS if t[0] > 1}
        library, library_call = GC._library(point, operands)
        q, k, v = (t.transpose(1, 2) for t in inputs)
        with GC.full_f32():
            plain_ms = time_call(lambda: AR.attention(*operands, causal=False))[0]
            library_ms = time_call(library_call)[0]
            sdpa_ms = time_call(lambda: F.scaled_dot_product_attention(
                q, k, v, enable_gqa=True))[0]
        lim = GC.bound(point, machine)
        ffma_ms = lim["operations_ms"] * (
            machine.peak_bf16_tensor_flops / machine.peak_f32_flops
            if dtype == torch.bfloat16 else 1.0)
        ms = measured[str(list(block))]
        out[name] = {
            "dims": list(dims), "dtype": name, "causal": False,
            "block": list(block), "check": check, "ms": ms,
            "op_ms": time_call(call)[0], "measured_ms": measured,
            "plain_ms": plain_ms, "library": library, "library_ms": library_ms,
            "sdpa_own_backend_gqa_ms": sdpa_ms, **lim,
            "bound_ms_ffma": max(lim["bytes_ms"], ffma_ms),
            "share_of_bound": lim["bound_ms"] / ms,
            "share_of_ffma_bound": max(lim["bytes_ms"], ffma_ms) / ms}
        del inputs, operands, q, k, v
        torch.cuda.empty_cache()
    return failures, out


def _encoder_walk(params, cfg, frames) -> tuple[list[str], list[float]]:
    """The kernel's gate on whisper's own encoder activations:
    ``whisper.encode``'s layer loop by hand on the flash path; at each
    layer the flash attention output (the tile route, non-causal) against
    the chunked one on the same input, within MODEL_TOL, the flash output
    carried on.  Returns what failed and each layer's max abs
    difference."""
    from repro_torch.kernels.check import compare
    from repro_torch.models import whisper
    from repro_torch.models.attention import attention
    from repro_torch.models.common import gelu_mlp, layernorm, unstack

    flash = dataclasses.replace(cfg, attn_impl="flash").attn_cfg(causal=False)
    chunked = dataclasses.replace(cfg, attn_impl="chunked",
                                  attn_chunk=WHISPER_CHUNK).attn_cfg(causal=False)
    h = frames.to(cfg.dtype)
    h = h + whisper._sinusoid(h.shape[1], cfg.d_model, h.device).to(cfg.dtype)[None]
    failures, errs = [], []
    for i, p_l in enumerate(unstack(params["enc"]["layers"], cfg.n_layers)):
        x = layernorm(p_l["ln_attn"], h, cfg.norm_eps)
        got, _ = attention(p_l["attn"], flash, x)
        want, _ = attention(p_l["attn"], chunked, x)
        ok, err, tol = compare(got, want, tol=MODEL_TOL)
        errs.append(err)
        if not ok:
            failures.append(f"encoder layer {i}: flash attention off the "
                            f"chunked one by {err} (tol {tol})")
        h = h + got
        h = h + gelu_mlp(p_l["mlp"], layernorm(p_l["ln_ffn"], h, cfg.norm_eps))
    return failures, errs


def _whisper_phase(name: str, machine) -> tuple[list[str], dict]:
    """Phase 13: whisper-base at full width and depth (6 + 6 layers, d
    512) through the port's serve function at WHISPER_FRAMES frames and
    its 11-token prompt, random weights from SEED materialized on the
    card, the three attention subtrees' projections at their contracted
    fan-in.  First the attention op alone at the encoder's shape
    (:func:`_attention_at_encoder_shape`).  f32 (the gates): the encoder's
    attention layer by layer, flash against chunked
    (:func:`_encoder_walk`); the served prefill chunked (the plain
    version) and flash (the tile route: 6 non-causal encoder launches and
    6 causal decoder self-attention launches of 11 rows, the split route
    never: the cross-attention is dense under flash, and decode is the
    plain cache path), the flash prefill's logits against the chunked
    ones, and 4 decode steps against a teacher-forced dense pass
    (``encode`` then ``decode_train``) of the tokens fed, each within
    MODEL_TOL; the same f32 prefills on the reference's own initializer
    reported beside them.  Then the parameters cast once to bf16 (the
    layernorms kept in f32) and served both ways at MODEL_GEN steps:
    prefill time and frames/s and prompt tokens/s, decode time a token,
    eager and as a CUDA graph (the idle share), the decode's weight and
    cache bytes against HBM, the device split of prefill and decode."""
    from repro_torch import kernels
    from repro_torch.benchmarks import gpu_compute_ecm as GC
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.models import whisper
    from repro_torch.models.common import cast_params, materialize

    arch = get_arch(name)
    cfg = arch.cfg
    acfg = cfg.attn_cfg(causal=False)
    dev = torch.device("cuda")
    prompt = {k: torch.from_numpy(v).to(dev) for k, v in arch.make_batch(
        ShapeSpec("cli_prefill", WHISPER_FRAMES, MODEL_BATCH, "prefill"),
        seed=SEED).items()}
    n_tok = prompt["tokens"].shape[1]
    rec = {"phase": f"model {arch.name}", "arch": arch.name,
           "family": arch.family, "n_layers": cfg.n_layers,
           "d_model": cfg.d_model, "n_params": arch.n_params,
           "n_active_params": arch.n_active_params,
           "attention_applications": 2 * cfg.n_layers, "batch": MODEL_BATCH,
           "frames": WHISPER_FRAMES, "prompt_tokens": n_tok,
           "chunked_attn_chunk": WHISPER_CHUNK}
    failures, enc_attn = _attention_at_encoder_shape(acfg, machine)
    rec["attention"] = enc_attn["bfloat16"] | {"f32": enc_attn["float32"]}
    torch.cuda.empty_cache()
    runs = _Runs(name, arch, WHISPER_FRAMES, 2 * cfg.n_layers,
                 {"frames": MODEL_BATCH * WHISPER_FRAMES,
                  "prompt_tokens": MODEL_BATCH * n_tok})
    chunked_kw = {"attn_impl": "chunked", "attn_chunk": WHISPER_CHUNK}
    flash_kw = {"attn_impl": "flash"}

    def weights(spec):
        return materialize(spec, torch.Generator(device=dev).manual_seed(SEED),
                           device=dev)

    spec = arch.param_spec()
    for path in (("enc", "layers", "attn"), ("dec", "layers", "self_attn"),
                 ("dec", "layers", "cross_attn")):
        spec = _contracted_fan_in(spec, path, acfg)
    with GC.full_f32():
        f32 = torch.float32
        params = weights(spec)
        # before the count: a comparison, not the path
        walk_failures, errs = _encoder_walk(
            params, runs.variant(dtype=f32).cfg, prompt["frames"])
        failures += [f"model {name} f32 walk, {f}" for f in walk_failures]
        rec["f32_encoder_attention_by_layer"] = {"max_abs_err": errs,
                                                 "tol": MODEL_TOL}
        kernels.reset_launches()
        ref_params = weights(arch.param_spec())
        ref_init = [runs(ref_params, 0, " (reference init)", dtype=f32, **kw)
                    for kw in (chunked_kw, flash_kw)]
        rec["f32_reference_init_flash_vs_chunked_max_abs"] = float(
            (ref_init[1].prefill_logits - ref_init[0].prefill_logits).abs().max())
        del ref_params, ref_init
        chunked = runs(params, MODEL_F32_GEN, dtype=f32, **chunked_kw)
        flash = runs(params, MODEL_F32_GEN, dtype=f32, **flash_kw)
        chunked.cache = flash.cache = None
        # the teacher-forced pass of the prompt and the fed tokens:
        # positions n_tok - 1 .. + MODEL_F32_GEN
        dense = runs.variant(dtype=f32, attn_impl="dense").cfg
        toks = torch.cat([prompt["tokens"], flash.fed], dim=1)
        enc = whisper.encode(params, dense, prompt["frames"])
        full = whisper._logits(params, dense, whisper.decode_train(
            params, dense, toks, enc)[:, n_tok - 1:])
        del enc
        rec["f32_flash_vs_chunked"] = runs.gate(
            "flash prefill logits against the chunked ones",
            flash.prefill_logits, chunked.prefill_logits)
        rec["f32_decode_vs_teacher_forced"] = [
            runs.gate(f"decode step {j} against the teacher-forced pass",
                      got[:, 0], full[:, j])
            for j, got in enumerate([flash.prefill_logits, *flash.step_logits])]
        del full, chunked, flash
    params = cast_params(params, cfg.dtype)
    torch.cuda.empty_cache()
    chunked = runs(params, MODEL_GEN, **chunked_kw)
    chunked.cache = None
    flash = runs(params, MODEL_GEN, **flash_kw)
    rec["bf16_flash_vs_chunked_max_abs"] = float(
        (flash.prefill_logits.float() - chunked.prefill_logits.float()).abs().max())
    rec["bf16_tokens_equal_share"] = float(
        (flash.tokens == chunked.tokens).float().mean())
    rec["bf16_flash_tokens"] = flash.tokens.tolist()
    rec["launches"] = {k.name: k.launches for k in kernels.KERNELS}
    rec["attention_launches_by_route"] = dict(kernels.FLASH_ATTENTION.launches_by_route)
    del chunked
    flash_arch = runs.variant(**flash_kw)
    busy_ms, step = _decode_idle(flash_arch, params, flash, cfg.vocab)
    rec["device_split"] = {
        "prefill": _device_split(lambda: flash_arch.prefill(
            params, prompt, max_len=n_tok)),
        "decode_step": _device_split(step)}
    stats = runs.runs[f"{str(cfg.dtype).removeprefix('torch.')} flash"]
    stats["graph_decode_ms"] = busy_ms
    eager_ms = stats["decode_s_per_token"] * 1e3
    # a decode step reads the decoder's layers but the cross K/V
    # projections (their K/V are cached), the tied embedding whole (the
    # logits), and the whole self and cross caches
    dec = params["dec"]
    weight_bytes = (_nbytes(dec) - _nbytes(dec["pos"])
                    - _nbytes({k: dec["layers"]["cross_attn"][k]
                               for k in ("wk", "wv")}))
    cache_bytes = _nbytes({k: flash.cache[k] for k in (
        "self_k", "self_v", "cross_k", "cross_v")})
    flops = arch.model_flops(ShapeSpec("prefill", WHISPER_FRAMES, MODEL_BATCH,
                                       "prefill"))
    rec["runs"] = runs.runs
    rec["summary"] = {
        "prefill_s": stats["prefill_s"],
        "prefill_frames_per_s": stats["prefill_frames_per_s"],
        "prefill_prompt_tokens_per_s": stats["prefill_prompt_tokens_per_s"],
        "decode_s_per_token": stats["decode_s_per_token"],
        "decode_tokens_per_s": stats["decode_tokens_per_s"],
        "model_flops": flops,
        "model_flops_note": "2 N B S, the reference's model_flops, with S "
                            "the frames",
        "model_flop_per_s": flops / stats["prefill_s"],
        "model_flop_share_of_bf16_peak": flops / stats["prefill_s"]
        / machine.peak_bf16_tensor_flops,
        "decode_weight_bytes": weight_bytes,
        "decode_cache_bytes_read": cache_bytes,
        "decode_share_of_weight_and_cache_bound": machine.hbm_seconds(
            weight_bytes + cache_bytes) * 1e3 / eager_ms,
        "decode_graph_ms": busy_ms, "decode_eager_ms": eager_ms,
        "decode_idle_share": 1.0 - busy_ms / eager_ms,
        "attention_ms_per_application": rec["attention"]["ms"],
        "encoder_attention_share_of_prefill": cfg.n_layers
        * rec["attention"]["ms"] / (stats["prefill_s"] * 1e3),
    }
    return failures + runs.failures, rec


def _loop_timing(fn) -> dict:
    """Device ms of one call of a loop of small launches (``time_call``,
    one call a repeat) beside the host's enqueue time, and its kernel
    count and device split from the profiler."""
    from repro_torch.benchmarks.timing import time_call

    ms, host_us = time_call(fn, inner=1)
    split = _device_split(fn)
    return {"ms": ms, "host_ms": host_us / 1e3,
            "kernels": split.get("kernels"),
            "kernel_ms": split.get("total_ms"),
            "top": split.get("top", split.get("not_measured"))}


def _xlstm_phase(name: str, machine) -> tuple[list[str], dict]:
    """Phase 14: xlstm-125m at full width and depth (12 blocks of d 768, 4
    heads, sLSTM at 3 and 7) through the port's serve function at
    MODEL_BATCH x MODEL_PROMPT tokens, random weights from SEED
    materialized on the card (the reference's initializer: no attention
    here).  f32 (the gates): one mLSTM layer at the prefill's shape,
    chunkwise (``_mlstm_chunked``, chunk 256) against the recurrence
    (``_mlstm_core``) on the same input, at the reference's tolerance
    (2e-3; m at 1e-4, as tests/test_chunked_equivalence.py holds it); the
    served prefill and 4 decode steps (each mLSTM on its recurrence)
    against the teacher-forced forward of the tokens fed, within
    MODEL_TOL.  Then the parameters cast once to bf16 (the sLSTM's
    recurrent weights kept in f32) and served at MODEL_GEN steps: prefill
    time and tokens/s, decode time a token eager and as a CUDA graph (the
    idle share), and the device ms, host ms and launches of the mLSTM
    chunk loop and of the sLSTM loop at the prefill's shape.  The flash
    kernel has nothing to launch here: the count is held at 0."""
    from repro_torch import kernels
    from repro_torch.benchmarks import gpu_compute_ecm as GC
    from repro_torch.benchmarks.timing import time_call
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.kernels.check import compare
    from repro_torch.models import xlstm, xlstm_lm
    from repro_torch.models.common import cast_params, materialize, unembed

    arch = get_arch(name)
    cfg, bc = arch.cfg, arch.cfg.block_cfg
    dev = torch.device("cuda")
    rec = {"phase": f"model {arch.name}", "arch": arch.name,
           "family": arch.family, "n_layers": cfg.n_layers,
           "d_model": cfg.d_model, "n_params": arch.n_params,
           "n_active_params": arch.n_active_params,
           "slstm_at": list(cfg.slstm_at), "mlstm_head_dim": bc.head_dim,
           "chunk": bc.chunk, "batch": MODEL_BATCH, "prompt": MODEL_PROMPT}
    prompt = torch.from_numpy(arch.make_batch(ShapeSpec(
        "cli_prefill", MODEL_PROMPT, MODEL_BATCH, "prefill"), seed=SEED)["tokens"])
    runs = _Runs(name, arch, MODEL_PROMPT, 0,
                 {"tokens": MODEL_BATCH * MODEL_PROMPT})
    failures = []
    g = torch.Generator(device=dev).manual_seed(SEED)
    u = torch.randn((MODEL_BATCH, MODEL_PROMPT, cfg.d_model), generator=g,
                    device=dev)
    with GC.full_f32():
        params = materialize(arch.param_spec(), torch.Generator(
            device=dev).manual_seed(SEED), device=dev)
        first = next(f"layer_{i}" for i in range(cfg.n_layers)
                     if not cfg.is_slstm(i))
        _, core_in = xlstm._mlstm_project(params["layers"][first]["mlstm"], bc, u)
        got, (c1, _, m1) = xlstm._mlstm_chunked(*core_in, chunk=bc.chunk)
        want, (c0, _, m0) = xlstm._mlstm_core(*core_in)
        gate = {"h": compare(got, want, tol=(2e-3, 2e-3)),
                "C": compare(c1, c0, tol=(2e-3, 2e-3)),
                "m": compare(m1, m0, tol=(1e-4, 1e-4))}
        rec["f32_mlstm_chunked_vs_recurrence"] = gate | {"layer": first}
        failures += [f"model {name} f32: mLSTM chunked off the recurrence in "
                     f"{k} by {v[1]} (tol {v[2]})" for k, v in gate.items()
                     if not v[0]]
        del core_in, got, want, c0, c1
        kernels.reset_launches()
        f32 = runs.variant(dtype=torch.float32).cfg
        served = runs(params, MODEL_F32_GEN, dtype=torch.float32)
        served.cache = None
        toks = torch.cat([prompt.to(dev), served.fed], dim=1)
        full = unembed(params["unembed"], xlstm_lm.hidden_states(
            params, f32, toks)[:, MODEL_PROMPT - 1:])
        rec["f32_decode_vs_teacher_forced"] = [
            runs.gate(f"decode step {j} against the teacher-forced forward",
                      got[:, 0], full[:, j])
            for j, got in enumerate([served.prefill_logits, *served.step_logits])]
        del full, served
    params = cast_params(params, cfg.dtype)
    torch.cuda.empty_cache()
    served = runs(params, MODEL_GEN)
    rec["bf16_tokens"] = served.tokens.tolist()
    rec["launches"] = {k.name: k.launches for k in kernels.KERNELS}
    rec["attention_launches_by_route"] = dict(kernels.FLASH_ATTENTION.launches_by_route)
    # the two loops at the prefill's shape, bf16, the first layer of each kind
    x = u.to(cfg.dtype)
    p_m = params["layers"][first]["mlstm"]
    p_s = params["layers"][f"layer_{cfg.slstm_at[0]}"]["slstm"]
    _, core_in = xlstm._mlstm_project(p_m, bc, x)
    rec["loops"] = {
        "mlstm_chunks": _loop_timing(lambda: xlstm._mlstm_chunked(
            *core_in, chunk=bc.chunk)) | {"chunks": -(-MODEL_PROMPT // bc.chunk),
                                          "layers": cfg.n_layers - len(cfg.slstm_at)},
        "slstm_steps": _loop_timing(lambda: xlstm._slstm_core(p_s, bc, x))
        | {"steps": MODEL_PROMPT, "layers": len(cfg.slstm_at)},
        "mlstm_layer_ms": time_call(lambda: xlstm.mlstm_block(p_m, bc, x),
                                    inner=1)[0],
        "slstm_layer_ms": time_call(lambda: xlstm.slstm_block(p_s, bc, x),
                                    inner=1)[0]}
    del core_in, x, u
    busy_ms, step = _decode_idle(arch, params, served, cfg.vocab)
    tokens = {"tokens": prompt.to(dev)}
    rec["device_split"] = {
        "prefill": _device_split(lambda: arch.prefill(params, tokens)),
        "decode_step": _device_split(step)}
    stats = runs.runs[f"{str(cfg.dtype).removeprefix('torch.')} model"]
    stats["graph_decode_ms"] = busy_ms
    eager_ms = stats["decode_s_per_token"] * 1e3
    table = params["embedding"]
    weight_bytes = (_nbytes(params) - _nbytes(table)
                    + MODEL_BATCH * table.shape[1] * table.element_size())
    state_bytes = _nbytes({k: v for k, v in served.cache.items() if k != "length"})
    flops = arch.model_flops(ShapeSpec("prefill", MODEL_PROMPT, MODEL_BATCH,
                                       "prefill"))
    prefill_ms = stats["prefill_s"] * 1e3
    loops = rec["loops"]
    rec["runs"] = runs.runs
    rec["summary"] = {
        "prefill_s": stats["prefill_s"],
        "prefill_tokens_per_s": stats["prefill_tokens_per_s"],
        "decode_s_per_token": stats["decode_s_per_token"],
        "decode_tokens_per_s": stats["decode_tokens_per_s"],
        "model_flops": flops,
        "model_flop_per_s": flops / stats["prefill_s"],
        "model_flop_share_of_bf16_peak": flops / stats["prefill_s"]
        / machine.peak_bf16_tensor_flops,
        "decode_weight_bytes": weight_bytes,
        "decode_state_bytes": state_bytes,
        "decode_share_of_weight_and_state_bound": machine.hbm_seconds(
            weight_bytes + 2 * state_bytes) * 1e3 / eager_ms,
        "decode_graph_ms": busy_ms, "decode_eager_ms": eager_ms,
        "decode_idle_share": 1.0 - busy_ms / eager_ms,
        "slstm_loops_share_of_prefill": loops["slstm_steps"]["layers"]
        * loops["slstm_steps"]["ms"] / prefill_ms,
        "mlstm_chunk_loops_share_of_prefill": loops["mlstm_chunks"]["layers"]
        * loops["mlstm_chunks"]["ms"] / prefill_ms,
    }
    return failures + runs.failures, rec


# ---------------------------------------------------------------------------
# phase 15: training on the card
# ---------------------------------------------------------------------------


def _train_arch():
    """internlm2-1.8b's full config, its attention projections drawn at
    their contracted fan-in (:func:`_contracted_fan_in`)."""
    from repro_torch.configs import get_arch

    arch = get_arch(TRAIN_ARCH)
    spec_fn = arch.spec_fn
    return dataclasses.replace(arch, spec_fn=lambda c: _contracted_fan_in(
        spec_fn(c), ("layers", "attn"), c.attn_cfg))


def _variant(arch, **kw):
    return dataclasses.replace(arch, cfg=dataclasses.replace(arch.cfg, **kw))


def _tree_to(tree, device):
    from repro_torch.models.common import tree_map

    return tree_map(lambda t: t.to(device, copy=True), tree)


@contextlib.contextmanager
def _deterministic():
    """Deterministic kernels inside the block (the embedding's backward,
    an ``index_add_``, otherwise adds a token's rows by atomics in any
    order), so two runs of the same step compare bit for bit.  cuBLAS
    runs one stream here, where it is deterministic; its warning about
    ``CUBLAS_WORKSPACE_CONFIG`` is silenced."""
    import warnings

    old = (torch.are_deterministic_algorithms_enabled(),
           torch.is_deterministic_algorithms_warn_only_enabled())
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            yield
    finally:
        torch.use_deterministic_algorithms(old[0], warn_only=old[1])


def _digest(tree) -> str:
    """The first 16 hex digits of the sha256 of a tree's leaves' bytes, in
    leaf order: equal digests across runs mean bit-equal trees, so the
    digests of a gate's two sides tell which side moved when the gate
    fails in one run and passes in another."""
    from repro_torch.models.common import tree_leaves

    h = hashlib.sha256()
    for t in tree_leaves(tree):
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()[:16]


def _rel_max_diff(got, want) -> float:
    """The largest over leaves of max|got - want| / max|want|."""
    from repro_torch.models.common import tree_leaves

    worst = 0.0
    for a, b in zip(tree_leaves(got), tree_leaves(want)):
        a, b = a.float().cpu(), b.float().cpu()
        worst = max(worst, float((a - b).abs().max())
                    / max(float(b.abs().max()), 1e-30))
    return worst


def _gate_arch(smoke: bool = False):
    """The arch of phase 15's reduced-depth gates, f32: GATE_LAYERS layers
    of :func:`_train_arch`, or (``smoke``) the smoke config, which the CPU
    tests run."""
    from repro_torch.configs import get_arch

    if smoke:
        return _variant(get_arch(TRAIN_ARCH, smoke=True), dtype=torch.float32)
    return _variant(_train_arch(), n_layers=GATE_LAYERS, dtype=torch.float32)


def _gate_batch(small, device):
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.convert import batch_from_numpy
    from repro_torch.data import ArchSyntheticDataset

    host = ArchSyntheticDataset(small, ShapeSpec("gate", GATE_SEQ, GATE_BATCH,
                                                 "train"), seed=SEED).batch(0)
    return batch_from_numpy(host, device=device)


def _gate_cpu_side(out: str, smoke: bool) -> int:
    """The CPU side of the card-against-CPU gate, in the child process
    :func:`_cpu_gate_reference` starts: the gate's state drawn from SEED,
    its gradients and one train step, written to ``out`` with the
    digests of the initial parameters, the gradients and the parameters
    after the step."""
    from repro_torch.benchmarks import gpu_compute_ecm as GC
    from repro_torch.optim import AdamWConfig, constant
    from repro_torch.train.steps import (init_state, make_train_step,
                                         value_and_grad)

    torch.set_num_threads(CPU_GATE_THREADS)
    small, opt = _gate_arch(smoke), AdamWConfig()
    t0 = time.perf_counter()
    state = init_state(small, torch.Generator().manual_seed(SEED), opt,
                       device="cpu")
    init = _digest(state["params"])
    batch = _gate_batch(small, "cpu")
    step = make_train_step(small, opt, constant(TRAIN_LR))
    with GC.full_f32(), _deterministic():
        grads = value_and_grad(small, state["params"], batch)[2]
        state, metrics = step(state, batch)
    torch.save({"grads": grads, "params": state["params"],
                "loss": float(metrics["loss"]),
                "grad_norm": float(metrics["grad_norm"]),
                "sha256": {"init": init, "grads": _digest(grads),
                           "params": _digest(state["params"])},
                "threads": torch.get_num_threads(),
                "mkl": torch.backends.mkl.is_available(),
                "s": time.perf_counter() - t0}, out)
    return 0


def _cpu_gate_reference(out_dir: str, *, smoke: bool = False) -> dict:
    """Run :func:`_gate_cpu_side` in a fresh process whose thread counts
    and MKL branch (``CPU_GATE_ENV``, strict conditional numerical
    reproducibility) are set before torch loads, and load what it wrote:
    inside a long process the CPU's gradients varied from run to run."""
    out = os.path.join(out_dir, "cpu_gate.pt")
    argv = [sys.executable, str(Path(__file__).resolve()),
            "--cpu-gate-reference", out] + (["--smoke"] if smoke else [])
    env = dict(os.environ) | CPU_GATE_ENV
    env["PYTHONPATH"] = os.pathsep.join(
        [str(SRC)] + [p for p in [os.environ.get("PYTHONPATH")] if p])
    t0 = time.perf_counter()
    r = subprocess.run(argv, env=env, capture_output=True, text=True,
                       timeout=900)
    if r.returncode:
        raise RuntimeError(f"the CPU gate reference exited {r.returncode}: "
                           f"{r.stderr[-2000:]}")
    res = torch.load(out, weights_only=True)
    os.remove(out)
    return res | {"process_s": time.perf_counter() - t0,
                  "env": dict(CPU_GATE_ENV)}


def _train_gates() -> tuple[list[str], dict]:
    """Phase 15's reduced-depth gates: GATE_LAYERS layers at full width,
    f32 (TF32 off), B GATE_BATCH x GATE_SEQ, one state drawn from SEED on
    the CPU and copied to the card, deterministic kernels.  The CPU side
    runs in a fresh process with its threads and MKL branch fixed
    (:func:`_cpu_gate_reference`), which must start from the same
    parameters.  The card's gradients against the CPU's leaf by leaf
    (GATE_GRAD_REL); one train step on the card against the same step on
    the CPU (loss, grad norm, every parameter within 1e-3 * lr and one
    rounding where the two gradients agree within GATE_AGREE_REL, at most
    GATE_MASKED_MAX of a leaf left out); ``remat="full"`` against
    ``"none"`` and ``accum=2`` against 1 on the card."""
    from repro_torch import kernels
    from repro_torch.benchmarks import gpu_compute_ecm as GC
    from repro_torch.models.common import tree_leaves
    from repro_torch.optim import AdamWConfig, constant
    from repro_torch.train.steps import (init_state, make_train_step,
                                         value_and_grad)

    small = _gate_arch()
    opt, lr = AdamWConfig(), TRAIN_LR
    cpu_state = init_state(small, torch.Generator().manual_seed(SEED), opt,
                           device="cpu")
    card_batch = _gate_batch(small, "cuda")
    step = make_train_step(small, opt, constant(lr))
    failures, rec = [], {"layers": GATE_LAYERS, "batch": GATE_BATCH,
                         "seq": GATE_SEQ, "dtype": "float32",
                         "grads_agree_rel": GATE_AGREE_REL,
                         "masked_max_share": GATE_MASKED_MAX}
    with tempfile.TemporaryDirectory() as tmp:
        cpu = _cpu_gate_reference(tmp)
    cpu_grads, cpu_params = cpu.pop("grads"), cpu.pop("params")
    rec["cpu_reference"] = cpu
    if cpu["sha256"]["init"] != _digest(cpu_state["params"]):
        failures.append(f"train gate: the CPU reference started from "
                        f"{cpu['sha256']['init']}, the card from "
                        f"{_digest(cpu_state['params'])}")
    with GC.full_f32(), _deterministic():
        card_state = _tree_to(cpu_state, "cuda")
        del cpu_state
        kernels.reset_launches()
        card_grads = value_and_grad(small, card_state["params"], card_batch)[2]
        card_state, card = step(card_state, card_batch)
        launched = {k.name: k.launches for k in kernels.KERNELS if k.launches}
    rec["kernel_launches"] = launched
    if launched:
        failures.append(f"train gate: the plain path launched {launched}")
    for key, tol in (("loss", 1e-5), ("grad_norm", 1e-4)):
        got, want = float(card[key]), cpu[key]
        rel = abs(got - want) / abs(want)
        rec[f"{key}_card_vs_cpu"] = {"card": got, "cpu": want, "rel": rel,
                                     "tol": tol}
        if not rel <= tol:
            failures.append(f"train gate: {key} {got} on the card against "
                            f"{want} on the CPU, {rel} apart (tol {tol})")
    grad_rel = _rel_max_diff(card_grads, cpu_grads)
    rec["grads_card_vs_cpu"] = {"max_rel_to_leaf_max": grad_rel,
                                "tol": GATE_GRAD_REL,
                                "sha256": {"card": _digest(card_grads),
                                           "cpu": _digest(cpu_grads)}}
    if not grad_rel <= GATE_GRAD_REL:
        failures.append(f"train gate: the card's grads {grad_rel} of a leaf's "
                        f"largest off the CPU's (tol {GATE_GRAD_REL})")
    # off by more than 1e-3 * lr and one rounding of the parameter: the
    # largest excess over that, and the largest difference
    worst, excess, masked, total, shares = 0.0, -math.inf, 0, 0, []
    for i, (p, q, gc, g) in enumerate(zip(tree_leaves(card_state["params"]),
                                          tree_leaves(cpu_params),
                                          tree_leaves(card_grads),
                                          tree_leaves(cpu_grads))):
        keep = (gc.cpu() - g).abs() <= GATE_AGREE_REL * g.abs()
        masked += int((~keep).sum())
        total += keep.numel()
        shares.append(1.0 - float(keep.double().mean()))
        if shares[-1] > GATE_MASKED_MAX:
            failures.append(f"train gate: leaf {i} has {shares[-1]} of its "
                            f"grads apart by more than {GATE_AGREE_REL} "
                            f"(at most {GATE_MASKED_MAX})")
        if keep.any():
            err = (p.cpu() - q).abs()[keep]
            ulp = torch.finfo(q.dtype).eps * q.abs()[keep]
            worst = max(worst, float(err.max()))
            excess = max(excess, float((err - 1e-3 * lr - ulp).max()))
    rec["params_card_vs_cpu"] = {"max_abs": worst, "tol": "1e-3 * lr + ulp(p)",
                                 "lr": lr, "max_excess_over_tol": excess,
                                 "masked_entries": masked, "entries": total,
                                 "masked_share_by_leaf": shares}
    if not excess <= 0:
        failures.append(f"train gate: parameters after the step up to {worst} "
                        f"off the CPU's, {excess} past 1e-3 * lr and an ulp")
    del cpu_params, card_state, card_grads, cpu_grads
    with GC.full_f32(), _deterministic():
        state = init_state(small, torch.Generator(device="cuda").manual_seed(
            SEED), opt, device="cuda")
        params = state["params"]
        grads = {}
        for remat in ("full", "none"):
            grads[remat] = value_and_grad(_variant(small, remat=remat), params,
                                          card_batch)[2]
        grads["accum2"] = value_and_grad(small, params, card_batch, accum=2)[2]
    for what, got, want, tol in (("remat_full_vs_none", "full", "none", 1e-6),
                                 ("accum2_vs_accum1", "accum2", "full", 1e-5)):
        rel = _rel_max_diff(grads[got], grads[want])
        rec[what] = {"max_rel_to_leaf_max": rel, "tol": tol}
        if not rel <= tol:
            failures.append(f"train gate: {what} grads {rel} apart (tol {tol})")
    return failures, rec


def _restart_gate() -> tuple[list[str], dict]:
    """internlm2-1.8b's smoke config on the card, f32, bf16 and int8
    moments: three steps straight against one step, an
    ``AsyncCheckpointer`` save, ``restore_tree`` onto the card and two
    more; every leaf ``torch.equal`` (deterministic kernels), in a
    temporary directory removed after."""
    from repro_torch.ckpt import AsyncCheckpointer, restore_tree
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.convert import batch_from_numpy
    from repro_torch.data import ArchSyntheticDataset
    from repro_torch.models.common import tree_leaves
    from repro_torch.optim import AdamWConfig, constant
    from repro_torch.train.steps import init_state, make_train_step

    arch = get_arch(TRAIN_ARCH, smoke=True)
    data = ArchSyntheticDataset(arch, ShapeSpec("restart", 32, 2, "train"),
                                seed=SEED)
    batches = [batch_from_numpy(data.batch(i), device="cuda") for i in range(3)]
    failures, rec = [], {}
    for moments in ("f32", "bf16", "int8"):
        opt = AdamWConfig(moment_dtype=moments)
        step = make_train_step(arch, opt, constant(TRAIN_LR))

        def fresh():
            return init_state(arch, torch.Generator(device="cuda").manual_seed(
                SEED), opt, device="cuda")

        with _deterministic(), tempfile.TemporaryDirectory() as root:
            straight = fresh()
            for b in batches:
                straight, _ = step(straight, b)
            state, _ = step(fresh(), batches[0])
            ckpt = AsyncCheckpointer(root)
            ckpt.submit(1, state, metadata={"moments": moments})
            ckpt.close()
            state, meta = restore_tree(root, 1, state, device="cuda")
            for b in batches[1:]:
                state, _ = step(state, b)
        leaves = list(zip(tree_leaves(straight), tree_leaves(state)))
        differ = sum(not (a.dtype == b.dtype and torch.equal(a, b))
                     for a, b in leaves)
        rec[moments] = {"leaves": len(leaves), "differ": differ,
                        "restored_metadata": meta}
        if differ:
            failures.append(f"restart gate ({moments} moments): {differ} of "
                            f"{len(leaves)} leaves differ from three steps "
                            f"straight")
    return failures, rec


def _grad_refusal() -> tuple[list[str], str]:
    """The flash op on card tensors, one of which requires grad, raises
    (the kernel has no backward)."""
    from repro_torch.kernels.attention import ops

    q = torch.randn((1, 128, 4, 64), device="cuda", requires_grad=True)
    k = torch.randn((1, 128, 2, 64), device="cuda")
    try:
        ops.flash_attention(q, k, k, causal=True)
    except RuntimeError as e:
        return [], str(e)
    return ["the flash op took an operand that requires grad on the card"], ""


def _walk(event):
    while event is not None:
        yield event
        event = event.cpu_parent


def _ancestors(event) -> list[str]:
    return [e.name for e in _walk(event)]


class _BatchZero:
    """Phase 15's data: the dataset's batch 0 at every step."""

    def __init__(self, data):
        self.data = data

    def batch(self, step: int) -> dict:
        return self.data.batch(0)


def _train_split(fn) -> dict:
    """Device time of one call of ``fn`` (a train step) by what launched
    each kernel, from torch.profiler (:func:`_classify_kernels`), and the
    device's idle share of the call's wall time (both under the profiler).
    A profiler the machine refuses to start or stop, or one that records
    no device time, is reported as not measured; an error of ``fn``
    itself propagates."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    try:
        prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        prof.start()
    except Exception as e:  # noqa: BLE001 - a refused profiler is a reading not taken
        return {"not_measured": f"profiler start: {type(e).__name__}: {e}"}
    t0 = time.perf_counter()
    try:
        fn()
        torch.cuda.synchronize()
    except BaseException:
        with contextlib.suppress(Exception):
            prof.stop()
        raise
    wall_ms = (time.perf_counter() - t0) * 1e3
    try:
        prof.stop()
        events = [e for e in prof.events() if e.device_type == DeviceType.CPU]
    except Exception as e:  # noqa: BLE001 - a refused profiler is a reading not taken
        return {"not_measured": f"profiler stop: {type(e).__name__}: {e}"}
    split = _classify_kernels(events)
    if not split["total_ms"]:
        return {"not_measured": "the profiler recorded no device time"}
    return split | {"wall_ms": wall_ms,
                    "idle_share": 1.0 - split["total_ms"] / wall_ms}


def _classify_kernels(events) -> dict:
    """The device ms of the kernels the CPU ``events`` launched, by what
    launched them: the optimizer (under ``adamw``, on the main thread,
    the one ``adamw`` ran on); on any other thread (the backward's) the
    recompute (under ``remat``) and the backward of each forward op,
    which its autograd node's sequence number names; on the main thread
    the forward.  Forward and backward each split into the chunked
    attention (under ``chunked_attention``), the cross entropy (under
    ``masked_xent``), the GEMMs (kernel names) and the rest; the kernel
    count and the dearest kernels beside."""
    main_thread = next((e.thread for e in events if e.name == "adamw"), None)
    forward_op = {}
    for e in events:
        if e.sequence_nr >= 0 and not e.name.startswith("autograd::"):
            forward_op.setdefault((e.thread, e.sequence_nr), e)
    split = dict.fromkeys(TRAIN_SPLIT, 0.0)
    per_kernel, n = {}, 0
    for e in events:
        if not e.kernels:
            continue
        names = _ancestors(e)
        backward = e.thread != main_thread
        origin = names
        if backward and "remat" not in names:
            # the backward runs with grad off, so its first ancestor with
            # a sequence number is the autograd node
            node = next((a for a in _walk(e) if a.sequence_nr >= 0), None)
            fwd = node and forward_op.get(
                (getattr(node, "fwd_thread", None) or main_thread,
                 node.sequence_nr))
            origin = _ancestors(fwd) if fwd else []
        for k in e.kernels:
            n += 1
            ms = k.duration / 1e3
            if "adamw" in names:
                fam = "optimizer_ms"
            elif backward and "remat" in names:
                fam = "recompute_ms"
            elif "chunked_attention" in origin:
                fam = "chunked_attention_ms"
            elif "masked_xent" in origin:
                fam = "cross_entropy_ms"
            elif any(g in k.name.lower() for g in GEMM_NAMES):
                fam = "backward_gemm_ms" if backward else "forward_gemm_ms"
            else:
                fam = "other_ms"
            split[fam] += ms
            per_kernel[k.name] = per_kernel.get(k.name, 0.0) + ms
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:8]
    return split | {"total_ms": sum(split.values()), "kernels": n,
                    "top": [{"kernel": k[:120], "ms": ms} for k, ms in top]}


def _optimizer_timing(state, machine, calibrated) -> dict:
    """The optimizer alone (``adamw_step``, the train step's update) on
    the full-width parameters with synthetic f32 grads, with f32, bf16
    and int8 moments: device ms (CUDA events, median of
    OPT_TIMED_CALLS after one warm-up) against the bytes it must move,
    the grads read twice (the norm, then the update), each parameter and
    moment read and written once (an int8 moment's row scales too), at
    the data sheet's and the calibrated HBM rate."""
    import statistics

    from repro_torch.models.common import tree_leaves, tree_map
    from repro_torch.optim import AdamWConfig, adamw_init, adamw_step, constant

    params = state["params"]
    leaves = tree_leaves(params)
    n = sum(p.numel() for p in leaves)
    rows = sum(p.numel() // p.shape[-1] for p in leaves)
    g = torch.Generator(device="cuda").manual_seed(SEED)
    grads = tree_map(lambda p: torch.randn(p.shape, generator=g,
                                           device="cuda") * 1e-3, params)
    sustained = calibrated.sustained_bw("update", "_stream")
    out = {}
    for moments, per_param in (("f32", 32), ("bf16", 24), ("int8", 20)):
        cfg = AdamWConfig(moment_dtype=moments)
        opt_state = (state["opt_state"] if moments == "f32"
                     else adamw_init(params, cfg))
        nbytes = n * per_param + (16 * rows if moments == "int8" else 0)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        ms = []
        for i in range(OPT_TIMED_CALLS + 1):
            torch.cuda.synchronize()
            start.record()
            adamw_step(grads, opt_state, params, cfg, constant(TRAIN_LR))
            end.record()
            torch.cuda.synchronize()
            if i:
                ms.append(start.elapsed_time(end))
        bound = machine.hbm_seconds(nbytes) * 1e3
        out[moments] = {"ms": statistics.median(ms), "ms_all": ms,
                        "bytes": nbytes, "bytes_per_param": nbytes / n,
                        "bound_ms": bound,
                        "bound_ms_calibrated": nbytes / sustained * 1e3,
                        "share_of_bound": bound / statistics.median(ms)}
        del opt_state
        torch.cuda.empty_cache()
    return out | {"params": n, "rows": rows,
                  "calibrated_rate_bytes_per_s": sustained}


def _memory_split(arch, params, batch) -> dict:
    """Where a train step's peak comes from, by
    ``torch.cuda.max_memory_allocated``: the bytes resident between steps
    (the parameters, the moments, the batch), the peak above them of one
    micro-batch's ``value_and_grad`` (its grads, its remat stack, its
    loss) and of that micro-batch's loss alone (the logits and
    ``masked_xent``, forward and backward, from the final hidden states
    and the unembedding)."""
    from repro_torch.models import lm
    from repro_torch.models.common import tree_leaves
    from repro_torch.train.steps import value_and_grad

    def peak_above(fn) -> int:
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out = fn()
        torch.cuda.synchronize()
        del out
        return torch.cuda.max_memory_allocated() - base

    cfg = arch.cfg
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()
    grads = tree_leaves(value_and_grad(arch, params, batch)[2])
    grad_bytes = sum(g.numel() * g.element_size() for g in grads)
    del grads
    micro = peak_above(lambda: value_and_grad(arch, params, batch)[2])
    with torch.no_grad():
        h = lm.hidden_states(params, cfg, batch["tokens"])[0]
    unembed = tree_leaves(params["unembed"])

    def loss_alone():
        x = h.detach().requires_grad_()
        for w in unembed:
            w.requires_grad_(True)
        try:
            loss = lm.masked_xent(lm.logits_fn(params, cfg, x), batch["labels"],
                                  batch.get("mask"), cfg)
            return torch.autograd.grad(loss, [x, *unembed])
        finally:
            for w in unembed:
                w.requires_grad_(False)

    loss = peak_above(loss_alone)
    del h
    return {"resident": resident, "grads": grad_bytes,
            "micro_batch_peak_above_resident": micro,
            "loss_alone_peak_above_resident": loss}


def _train_phase(machine, calibrated) -> tuple[list[str], dict]:
    """Phase 15: internlm2-1.8b trained at full width and depth on the
    card (:data:`TRAIN_ARCH`; f32 masters, bf16 compute, AdamW at its
    defaults, ``constant(TRAIN_LR)``, the config's ``remat="full"``,
    ``attn_impl="chunked"`` and ``train_accum``), on the reference's
    ``train_4k`` sequence at global batch TRAIN_BATCH from
    ``ArchSyntheticDataset`` (seed SEED).  First the gates that compare
    (the flash op alone at the eval's shape, the reduced-depth and
    restart gates, the refusal); then, its launches counted from 0, the
    main path: TRAIN_STEPS steps on batch 0 through the driver
    (``train.driver.Trainer``, ``mesh=None``, no checkpoint written; the
    loss falls from the first to the last, every loss and parameter
    finite; each step timed from a device sync to a device sync by a hook
    at its start, beside the driver's own wall time and its straggler
    flags; steps 2.. give the step time), one more step under
    the profiler, where the peak memory comes from
    (:func:`_memory_split`), and the eval step on one micro-batch with
    ``attn_impl="flash"`` (24 tile launches, no split launch) against
    ``"chunked"``: f32 within MODEL_TOL, bf16 reported.  Last the
    optimizer alone at each moment dtype against its bytes bound."""
    import statistics

    from repro_torch import kernels
    from repro_torch.benchmarks import gpu_compute_ecm as GC
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.convert import batch_from_numpy
    from repro_torch.data import ArchSyntheticDataset
    from repro_torch.dist import get_profile
    from repro_torch.kernels.check import compare
    from repro_torch.models.common import tree_leaves
    from repro_torch.optim import AdamWConfig, constant
    from repro_torch.train import Trainer, TrainerConfig
    from repro_torch.train.steps import make_eval_step, make_train_step

    arch = _train_arch()
    cfg = arch.cfg
    micro = TRAIN_BATCH // arch.train_accum
    failures, rec = [], {
        "phase": f"train {arch.name}", "arch": arch.name,
        "n_layers": cfg.n_layers, "d_model": cfg.d_model,
        "n_params": arch.n_params, "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
        "accum": arch.train_accum, "micro_batch": micro, "remat": cfg.remat,
        "attn_impl": cfg.attn_impl, "dtype": str(cfg.dtype), "lr": TRAIN_LR,
        "reduced": {"global_batch": f"256 -> {TRAIN_BATCH} (train_4k's "
                                    f"global batch on one card)"}}
    attn_failures, rec["attention"] = _attention_at_model_shape(
        cfg.attn_cfg, machine, batch=micro, seq=TRAIN_SEQ)
    failures += attn_failures
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    gate_failures, rec["gates"] = _train_gates()
    failures += gate_failures
    restart_failures, rec["restart"] = _restart_gate()
    failures += restart_failures
    refusal_failures, rec["refusal"] = _grad_refusal()
    failures += refusal_failures
    rec["gates_s"] = time.perf_counter() - t0
    torch.cuda.empty_cache()

    # the main path, its launches counted from 0: TRAIN_STEPS steps through
    # the driver, each step's time from a device sync to a device sync (a
    # hook at its start) beside the driver's own wall time
    kernels.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    opt = AdamWConfig()
    shape = ShapeSpec("train_4k", TRAIN_SEQ, TRAIN_BATCH, "train")
    data = ArchSyntheticDataset(arch, shape, seed=SEED)
    batch = batch_from_numpy(data.batch(0), device="cuda")
    marks, retries = [], []

    def mark(trainer, step, state):
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        retries.append(torch.cuda.memory_stats()["num_alloc_retries"])

    with tempfile.TemporaryDirectory() as root:
        trainer = Trainer(arch, _BatchZero(data), None, get_profile(arch.profile),
                          opt, constant(TRAIN_LR),
                          TrainerConfig(total_steps=TRAIN_STEPS, ckpt_dir=root,
                                        ckpt_interval=TRAIN_STEPS + 1,
                                        accum=arch.train_accum, seed=SEED),
                          hooks=dict.fromkeys(range(TRAIN_STEPS), mark))
        out = trainer.run()
        mark(trainer, TRAIN_STEPS, None)
    state, losses = trainer.state, out["losses"]
    step_s = [b - a for a, b in zip(marks, marks[1:])]
    retries = [b - a for a, b in zip(retries, retries[1:])]
    rec["driver"] = {
        "steps": TRAIN_STEPS, "ckpt_interval": TRAIN_STEPS + 1,
        "straggler_factor": trainer.cfg.straggler_factor,
        "wall_s": [e.wall_s for e in trainer.events],
        "device_synced_s": step_s,
        "stragglers": out["stragglers"],
        "flagged": [e.step for e in trainer.events if e.straggler]}
    if rec["driver"]["flagged"] != out["stragglers"]:
        failures.append(f"train driver: events flag {rec['driver']['flagged']}, "
                        f"the run reports {out['stragglers']}")
    peak = torch.cuda.max_memory_allocated()
    peak_reserved = torch.cuda.max_memory_reserved()
    finite = all(math.isfinite(x) for x in losses) and all(
        bool(torch.isfinite(p).all()) for p in tree_leaves(state["params"]))
    if not finite:
        failures.append("train: a loss or parameter is not finite")
    if not losses[-1] < losses[0]:
        failures.append(f"train: the loss did not fall: {losses}")
    step = make_train_step(arch, opt, constant(TRAIN_LR), accum=arch.train_accum)
    rec["device_split"] = _train_split(lambda: step(state, batch))
    head = {k: v[:micro] for k, v in batch.items()}
    memory = _memory_split(arch, state["params"], head)

    # the eval step on one micro-batch, flash against chunked
    evals, attn = {}, kernels.FLASH_ATTENTION
    for dtype in (torch.float32, cfg.dtype):
        with GC.full_f32():
            for impl in ("chunked", "flash"):
                before = dict(attn.launches_by_route)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                loss = float(make_eval_step(_variant(
                    arch, dtype=dtype, attn_impl=impl))(state["params"],
                                                        head)["loss"])
                eval_s = time.perf_counter() - t0
                launched = {r: n - before[r]
                            for r, n in attn.launches_by_route.items()}
                want = {"tile": cfg.n_layers if impl == "flash" else 0,
                        "split": 0}
                if launched != want:
                    failures.append(f"train eval {dtype} {impl}: attention "
                                    f"launches {launched}, not {want}")
                evals[f"{str(dtype).removeprefix('torch.')} {impl}"] = {
                    "loss": loss, "s": eval_s, "attention_launches": launched}
    f32 = [evals[f"float32 {impl}"]["loss"] for impl in ("flash", "chunked")]
    ok, err, tol = compare(torch.tensor(f32[0]), torch.tensor(f32[1]),
                           tol=MODEL_TOL)
    rec["eval"] = evals | {"f32_flash_vs_chunked": {"ok": ok, "abs": err,
                                                    "tol": tol}}
    if not ok:
        failures.append(f"train eval: f32 flash loss {f32[0]} off the chunked "
                        f"{f32[1]} by {err} (tol {tol})")
    rec["launches"] = {k.name: k.launches for k in kernels.KERNELS}
    rec["attention_launches_by_route"] = dict(attn.launches_by_route)

    rec["optimizer"] = _optimizer_timing(state, machine, calibrated)
    n = arch.n_params
    timed = statistics.median(step_s[1:])
    flops = arch.model_flops(shape)
    busy = rec["device_split"].get("total_ms")
    layer_bytes = cfg.n_layers * micro * TRAIN_SEQ * cfg.d_model * 2
    logits = micro * TRAIN_SEQ * cfg.vocab_padded
    rec["summary"] = {
        "losses": losses, "step_s": step_s,
        "s_per_step": timed, "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / timed,
        "model_flops": flops, "model_flop_per_s": flops / timed,
        "model_flop_share_of_bf16_peak": flops / timed
        / machine.peak_bf16_tensor_flops,
        "device_ms_profiled_step": busy,
        "idle_share_profiled_step": rec["device_split"].get("idle_share"),
        "peak_bytes": peak, "peak_reserved_bytes": peak_reserved,
        "alloc_retries_by_step": retries,
        "memory_split_bytes": memory | {
            "step_peak_less_resident_grads_and_micro_batch":
                peak - memory["resident"] - memory["grads"]
                - memory["micro_batch_peak_above_resident"]},
        "reckoning_bytes": {
            "state_params_moments_grads_f32": 16 * n,
            "remat_stack_bf16": layer_bytes,
            "loss_logits_bf16_f32_masked_grad": logits * (2 + 4 + 4 + 4)},
        "optimizer_ms": {m: r["ms"] for m, r in rec["optimizer"].items()
                         if isinstance(r, dict)}}
    del state
    return failures, rec


# ---------------------------------------------------------------------------
# phase 16: the driver and the mesh
# ---------------------------------------------------------------------------


def _whole_leaves(state) -> list:
    from torch.distributed.tensor import DTensor

    from repro_torch.models.common import tree_leaves

    return [x.full_tensor() if isinstance(x, DTensor) else x
            for x in tree_leaves(state)]


def _bit_equal(a, b) -> int:
    """How many leaves of two states differ (dtype or any bit)."""
    return sum(not (x.dtype == y.dtype and torch.equal(x, y))
               for x, y in zip(_whole_leaves(a), _whole_leaves(b), strict=True))


def _trainer(arch, root: str, steps: int, mesh=None, hooks=None, *,
             interval: int = 5, batch: int = 2, seq: int = 32):
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.data import ArchSyntheticDataset
    from repro_torch.dist import get_profile
    from repro_torch.optim import AdamWConfig, constant
    from repro_torch.train import Trainer, TrainerConfig

    data = ArchSyntheticDataset(arch, ShapeSpec("driver", seq, batch, "train"),
                                seed=SEED)
    return Trainer(arch, data, mesh, get_profile(arch.profile), AdamWConfig(),
                   constant(TRAIN_LR),
                   TrainerConfig(total_steps=steps, ckpt_dir=root,
                                 ckpt_interval=interval, seed=SEED),
                   hooks=hooks, device="cuda")


def _mesh_train_report(mesh, train: dict) -> tuple[list[str], dict]:
    """Phase 16's report: phase 15's step (TRAIN_ARCH at full width and
    depth, B TRAIN_BATCH x TRAIN_SEQ, bf16 compute, remat full, the
    config's accumulation; a state drawn from SEED) MESH_TRAIN_STEPS
    times on batch 0 on the one-rank ``mesh``, each step from a device
    sync to a device sync, beside phase 15's median step without a mesh;
    the model's collectives (``dist/collectives.py``'s sums, gathers and
    reduce-scatters, forward and backward) counted and timed on the host
    where each is issued.  The losses must be finite."""
    import statistics

    from repro_torch.data import ArchSyntheticDataset, shard_batch
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.dist import collectives, get_profile, param_shardings
    from repro_torch.models.common import tree_leaves, tree_map
    from repro_torch.optim import AdamWConfig, constant
    from repro_torch.train import init_state, make_train_step, state_spec

    arch, opt = _train_arch(), AdamWConfig()
    shardings = param_shardings(state_spec(arch, opt), mesh,
                                get_profile(arch.profile))
    leaves = iter(tree_leaves(init_state(
        arch, torch.Generator(device="cuda").manual_seed(SEED), opt,
        device="cuda")))
    # a leaf placed by Shard on the one-rank axis is a copy: the drawn
    # leaves go once placed
    state = tree_map(lambda s: s.distribute(next(leaves)), shardings)
    del leaves
    shape = ShapeSpec("train_4k", TRAIN_SEQ, TRAIN_BATCH, "train")
    batch = shard_batch(ArchSyntheticDataset(arch, shape, seed=SEED).batch(0),
                        mesh, ("data",))
    step = make_train_step(arch, opt, constant(TRAIN_LR),
                           accum=arch.train_accum, mesh=mesh,
                           shardings=shardings)
    issued = {"n": 0, "host_s": 0.0}
    names = ("_sum", "_gather", "_scatter_sum")
    originals = {n: getattr(collectives, n) for n in names}

    def timed(fn):
        def run(*args):
            t0 = time.perf_counter()
            out = fn(*args)
            issued["host_s"] += time.perf_counter() - t0
            issued["n"] += 1
            return out
        return run

    step_s, counts, host_s, losses = [], [], [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for n in names:
        setattr(collectives, n, timed(originals[n]))
    try:
        for _ in range(MESH_TRAIN_STEPS):
            before = dict(issued)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, metrics = step(state, batch)
            losses.append(float(metrics["loss"]))
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
            counts.append(issued["n"] - before["n"])
            host_s.append(issued["host_s"] - before["host_s"])
    finally:
        for n in names:
            setattr(collectives, n, originals[n])
    peak = torch.cuda.max_memory_allocated()
    del state, batch, step
    torch.cuda.empty_cache()
    timed_s = statistics.median(step_s[1:])
    without = train["summary"]["s_per_step"]
    rec = {"card": _card_line(), "arch": arch.name, "batch": TRAIN_BATCH,
           "seq": TRAIN_SEQ, "accum": arch.train_accum,
           "dtype": str(arch.cfg.dtype), "remat": arch.cfg.remat,
           "steps": MESH_TRAIN_STEPS, "step_s": step_s, "losses": losses,
           "s_per_step": timed_s, "phase15_s_per_step": without,
           "mesh_over_phase15": _ratio(timed_s, without),
           "collectives_per_step": counts,
           "collective_host_s_per_step": host_s,
           "host_ms_per_collective": [1e3 * h / c if c else None
                                      for h, c in zip(host_s, counts)],
           "peak_bytes": peak,
           "phase15_peak_bytes": train["summary"]["peak_bytes"]}
    failures = []
    if not all(math.isfinite(x) for x in losses):
        failures.append(f"driver mesh train step: losses {losses}")
    return failures, rec


def _driver_phase(train: dict) -> tuple[list[str], dict]:
    """Phase 16: the driver's crash and resume at the smoke config (a
    crash injected at step 12 of 20, a fresh driver resumes from
    checkpoint 10; its losses and every state leaf bit-equal to an
    uninterrupted run's), then a one-rank NCCL mesh ``(1, 1)`` under the
    arch's ``tp_dp`` (``launch.mesh.make_host_mesh``, which starts the
    group): the driver on the mesh against ``mesh=None`` bit for bit over
    DRIVER_MESH_STEPS steps, at the smoke config and at GATE_LAYERS
    layers at full width (f32, TF32 off, B GATE_BATCH x GATE_SEQ).  All
    under deterministic kernels.  Then phase 15's step on the mesh
    (:func:`_mesh_train_report`, beside phase 15's record ``train``); the
    group is destroyed at the end."""
    import torch.distributed as dist

    from repro_torch.benchmarks import gpu_compute_ecm as GC
    from repro_torch.configs import get_arch
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.train import InjectedFailure

    failures, rec = [], {}
    smoke = get_arch(TRAIN_ARCH, smoke=True)

    def crash(trainer, step, state):
        raise InjectedFailure(f"injected at {step}")

    with _deterministic(), tempfile.TemporaryDirectory() as root:
        ref = _trainer(smoke, f"{root}/ref", 20)
        ref_out = ref.run()
        try:
            _trainer(smoke, f"{root}/ft", 20, hooks={12: crash}).run()
            failures.append("driver: the injected crash did not raise")
        except InjectedFailure:
            pass
        resumed = _trainer(smoke, f"{root}/ft", 20)
        out = resumed.run()
    differ = _bit_equal(resumed.state, ref.state)
    rec["restart"] = {"resumed_steps": [e.step for e in resumed.events],
                      "losses_equal": out["losses"] == ref_out["losses"][10:],
                      "leaves_differ": differ,
                      "final_loss": out["final_loss"]}
    if rec["restart"]["resumed_steps"] != list(range(10, 20)) or differ \
            or not rec["restart"]["losses_equal"]:
        failures.append(f"driver restart: {rec['restart']}")

    mesh = make_host_mesh(model=1, device="cuda")
    rec["mesh"] = {"shape": list(mesh.shape), "axes": list(mesh.mesh_dim_names),
                   "backend": dist.get_backend()}
    full = _variant(_train_arch(), n_layers=GATE_LAYERS, dtype=torch.float32)
    try:
        for name, arch, kw in (("smoke", smoke, {}),
                               ("full_width", full, {"batch": GATE_BATCH,
                                                     "seq": GATE_SEQ})):
            runs = []
            with GC.full_f32(), _deterministic(), \
                    tempfile.TemporaryDirectory() as root:
                for where in (None, mesh):
                    t = _trainer(arch, f"{root}/{where is None}",
                                 DRIVER_MESH_STEPS, where,
                                 interval=DRIVER_MESH_STEPS + 1, **kw)
                    runs.append((t.run()["losses"], t.state))
                    del t
            differ = _bit_equal(runs[1][1], runs[0][1])
            rec[f"mesh_{name}"] = {"losses": runs[1][0],
                                   "losses_equal": runs[0][0] == runs[1][0],
                                   "leaves": len(_whole_leaves(runs[0][1])),
                                   "leaves_differ": differ}
            if differ or runs[0][0] != runs[1][0]:
                failures.append(f"driver mesh {name}: {rec[f'mesh_{name}']} "
                                f"against mesh=None {runs[0][0]}")
            del runs
            torch.cuda.empty_cache()
        try:
            report_failures, rec["mesh_train_step"] = _mesh_train_report(
                mesh, train)
        except torch.OutOfMemoryError as e:
            # the later phases still run; the run fails
            report_failures = [f"driver mesh train step: {e}"]
        torch.cuda.empty_cache()
        failures += report_failures
    finally:
        dist.destroy_process_group()
    return failures, rec


# ---------------------------------------------------------------------------
# phase 17: the serving engine's decode buckets on the card
# ---------------------------------------------------------------------------


def _serve_buckets(cfg) -> tuple[int, ...]:
    """The engine's decode buckets: powers of two from min_ctx to max_ctx."""
    out = [cfg.min_ctx]
    while out[-1] < cfg.max_ctx:
        out.append(out[-1] * 2)
    return tuple(out)


def _bucket_point(cb: int, dtype, model, cfg, prior, picks: dict
                  ) -> tuple[list[str], dict]:
    """One decode bucket ``cb`` on the split route: ``cfg.max_batch``
    requests of the served model's heads (MHA) one query row each against
    a ``cb``-token cache.  Every candidate tiling is launched through the
    op and held against the plain version; the compute loop's timings
    (``gpu_compute_ecm.timings``: every split tiling, the plain version,
    SDPA, the bound, the combine) at the prior's ranking; the engine's
    pick set against the measured tilings and its predicted seconds a
    request-token against the measured ones (kernel time x layers / the
    batch).  No bound share where the batch's KV fits in the L2."""
    from repro_torch.benchmarks import gpu_compute_ecm as GC
    from repro_torch.core.autotune import rank
    from repro_torch.kernels.check import compare

    b, h, d = cfg.max_batch, model.heads, model.d
    point = GC.Point("attention", (b, 1, cb, h, h, d), dtype)
    inputs = GC.make_inputs(point, "cuda")
    with GC.full_f32():
        want = GC.plain_op(point, inputs)
    failures, checks = [], {}
    cands = [bk for bk in (128, 256) if cb % bk == 0]
    for bk in cands:
        out = GC.op(point, inputs, (1, bk))
        checks[bk] = compare(out, want, tol=GC.TOLERANCE["attention"][dtype])
        if not checks[bk][0] or out.shape != want.shape:
            failures.append(f"decode bucket {cb} {dtype} bk {bk}: "
                            f"{checks[bk]}")
    ranked = [r | {"predicted_ms": r["t_ecm"] * b * h * 1e3}
              for r in rank((1, cb, d), prior, objective="attention",
                            causal=False, elem_bytes=model.elem_bytes)]
    tm = GC.timings(point, inputs, ranked, prior)
    del inputs, want
    torch.cuda.empty_cache()
    kv_bytes = 2 * b * cb * h * d * model.elem_bytes
    resident = kv_bytes <= prior.l2_bytes
    measured_s = tm["ms"] * 1e-3 * model.layers / b
    pick = picks["prior"][cb]["bkv"]
    if [1, pick] != tm["pick"]:
        failures.append(f"decode bucket {cb} {dtype}: the engine picks "
                        f"{pick}, rank {tm['pick']}")
    if not tm["combine"]["check"][0]:
        failures.append(f"decode bucket {cb} {dtype}: combine "
                        f"{tm['combine']['check']}")
    rec = {
        "cb": cb, "kv_bytes": kv_bytes, "kv_in_l2": resident,
        "pick_bkv": pick, "smallest_bkv": picks["prior"][cb]["min_bkv"],
        "checks": {str(k): v for k, v in checks.items()},
        "measured_ms": tm["measured_ms"], "pick_rank": tm["pick_rank"],
        "fastest": tm["fastest"], "ms": tm["ms"],
        "measured_s_per_request_token": measured_s,
        "predicted_s_per_request_token": {
            k: v[cb]["s_per_token"] for k, v in picks.items()},
        "measured_over_predicted": {
            k: measured_s / v[cb]["s_per_token"] for k, v in picks.items()},
        "plain_ms": tm["plain_ms"], "library": tm["library"],
        "library_ms": tm["library_ms"], "library_check": tm["library_check"],
        "bound_ms": tm["bound_ms"], "bound_by": tm["bound_by"],
        "bound_share": None if resident else tm["bound_ms"] / tm["ms"],
        "split_plan": tm["split_plan"],
        "combine": {k: tm["combine"][k] for k in ("ms", "plain_ms", "bound_ms",
                                                  "check")},
    }
    return failures, rec


def _bucket_picks(buckets, cbs) -> dict:
    """The model's decode pick, its smallest tiling and its predicted
    seconds a request-token (uncalibrated) at each bucket."""
    return {cb: {"bkv": buckets.decode_block(cb),
                 "min_bkv": buckets.decode_block(cb, smallest=True),
                 "s_per_token": buckets.seconds(buckets.decode_cy_per_token(
                     cb, calibrated=False))} for cb in cbs}


def _serve_engine_runs(calibrated) -> tuple[list[str], dict]:
    """The engine on the calibrated machine under every fault preset at the
    reference's bench settings, twice each (the logs must be equal), and
    the launcher's ``--continuous`` as a subprocess on the card."""
    from repro_torch.serve import (PRESETS, DegradationPolicy, EngineConfig,
                                   FaultInjector, ServeEngine, TraceConfig,
                                   fault_plan, synthetic_trace)

    failures, rec = [], {}
    trace = TraceConfig(mean_interarrival_s=SERVE_INTERARRIVAL_S)
    for plan in PRESETS:
        runs = []
        for _ in range(2):
            engine = ServeEngine(
                EngineConfig(machine=calibrated),
                degrade=DegradationPolicy(step_budget_s=SERVE_STEP_BUDGET_S))
            summary = engine.run(synthetic_trace(trace, seed=SEED),
                                 FaultInjector(fault_plan(plan)))
            runs.append((engine.log, [dataclasses.astuple(s)
                                      for s in engine.steps], summary))
        summary = runs[0][2]
        rec[plan] = {k: summary[k] for k in (
            "requests", "completed", "lost", "steps", "tok_rate",
            "latency_p50", "latency_p99", "deadline_hits", "events",
            "recovery", "degrade_max_level", "n_devices_final",
            "step_pred_measured", "calibration")} | {
            "replay_equal": runs[0] == runs[1]}
        if summary["lost"] or summary["completed"] != trace.n_requests \
                or runs[0] != runs[1]:
            failures.append(f"serve engine {plan}: {rec[plan]}")
    t0 = time.perf_counter()
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--continuous",
         "--requests", "64"], env={**os.environ, "PYTHONPATH": str(SRC)},
        capture_output=True, text=True, timeout=600)
    rec["launcher"] = {"rc": r.returncode, "s": time.perf_counter() - t0}
    try:
        summary = json.loads(r.stdout)
        rec["launcher"] |= {k: summary[k] for k in ("lost", "completed",
                                                    "steps", "tok_rate")}
    except json.JSONDecodeError:
        rec["launcher"]["stderr"] = r.stderr[-2000:]
    if r.returncode != 0 or rec["launcher"].get("lost") != 0:
        failures.append(f"serve launcher --continuous: {rec['launcher']}")
    return failures, rec


def _serve_kv_store() -> tuple[list[str], dict]:
    """The KV page store on the one-rank NCCL mesh: attached as DTensors
    over ``data``, a device loss on a data axis of 1 is logical and leaves
    every page bit for bit; the group is destroyed after."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.serve import EngineConfig, ServeEngine
    from repro_torch.serve.faults import DeviceLoss, apply_device_loss

    failures = []
    mesh = make_host_mesh(model=1, device="cuda")
    try:
        engine = ServeEngine(EngineConfig(n_devices=1))
        store = engine.attach_kv_store(mesh)
        before = {k: v.full_tensor().clone() for k, v in store.items()}
        apply_device_loss(engine, DeviceLoss(step=0, axis="data"))
        event = engine.events("device_loss")[0]
        rec = {"mesh": list(mesh.shape), "backend": dist.get_backend(),
               "device": str(before["kv_pages"].device),
               "shapes": {k: list(v.shape) for k, v in before.items()},
               "event": {k: event[k] for k in ("resharded", "n_devices_before",
                                               "n_devices_after")},
               "pages_equal": all(torch.equal(v.full_tensor(), before[k])
                                  for k, v in engine.kv_store.items())}
    finally:
        dist.destroy_process_group()
    if rec["event"]["resharded"] or not rec["pages_equal"] \
            or rec["device"] == "cpu":
        failures.append(f"serve KV store: {rec}")
    return failures, rec


def _serve_phase(prior, calibrated) -> tuple[list[str], dict]:
    """Phase 17 (module notes): the decode buckets of the reference's
    serving model at f32 and bf16 on the split route, the engine under
    every fault plan on the calibrated machine, the launcher, the KV page
    store.  The split and combine launches are counted from 0."""
    from repro_torch import kernels
    from repro_torch.serve import BucketModel, EngineConfig, ServingModel

    cfg = EngineConfig()
    cbs = _serve_buckets(cfg)
    failures, rec = [], {"card": _card_line(), "batch": cfg.max_batch,
                         "buckets": list(cbs), "dtypes": {}}
    kernels.reset_launches()
    for dtype in (torch.float32, torch.bfloat16):
        model = ServingModel(elem_bytes=torch.empty((), dtype=dtype).element_size())
        buckets = BucketModel(prior, model, min_ctx=cfg.min_ctx,
                              max_ctx=cfg.max_ctx)
        picks = {"prior": _bucket_picks(buckets, cbs)}
        buckets.machine = calibrated
        picks["calibrated"] = _bucket_picks(buckets, cbs)
        counters = dict(buckets.counters)
        if counters != {"ranked": 2 * len(cbs), "from_cache": 0, "rebuilds": 1}:
            failures.append(f"serve buckets {dtype}: the calibrated machine did "
                            f"not rebuild the tables: {counters}")
        points = []
        for cb in cbs:
            f, point = _bucket_point(cb, dtype, model, cfg, prior, picks)
            failures += f
            points.append(point)
        rec["dtypes"][str(dtype).removeprefix("torch.")] = {
            "model": dataclasses.asdict(model), "counters": counters,
            "picks": picks, "points": points}
    rec["launches"] = {"flash_attention": kernels.FLASH_ATTENTION.launches,
                       "flash_attention_by_route": dict(
                           kernels.FLASH_ATTENTION.launches_by_route),
                       "flash_combine": kernels.FLASH_COMBINE.launches}
    by_route = rec["launches"]["flash_attention_by_route"]
    if by_route["tile"] or not by_route["split"] \
            or rec["launches"]["flash_combine"] < by_route["split"]:
        failures.append(f"serve buckets launched {rec['launches']}")
    f, rec["engine"] = _serve_engine_runs(calibrated)
    failures += f
    f, rec["kv_store"] = _serve_kv_store()
    failures += f
    return failures, rec


# ---------------------------------------------------------------------------
# phase 18: the composed step against the card
# ---------------------------------------------------------------------------


def _ms(sp, phase: str, kind: str | None = None) -> float:
    """A prediction's ms for ``phase``, or for its ops of ``kind``."""
    cy = sp.cycles(phase) if kind is None else sp.per_kind(phase).get(kind, 0.0)
    return cy / sp.clock_hz * 1e3


def _whisper_served_ops(cfg, phase: str, prompt: int) -> list:
    """whisper-base's walk at its served shape.  The reference's walk
    prices the encoder and the decoder's prompt at one ``seq_len``; here
    the encoder and the cross K/V it feeds at WHISPER_FRAMES, the decoder
    at its ``prompt`` tokens (decode: after MODEL_GEN steps), its
    cross-attention over the frames."""
    from repro_torch.core.compose import model_ops

    def walk(seq_len: int, context: int) -> dict:
        return {o.name: o for o in model_ops(
            cfg, phase, batch=MODEL_BATCH, seq_len=seq_len, context=context,
            elem_bytes=COMPOSE_ELEM_BYTES)}

    text = walk(prompt, prompt + (MODEL_GEN if phase == "decode" else 0))
    cross = walk(prompt, WHISPER_FRAMES)
    frames = walk(WHISPER_FRAMES, WHISPER_FRAMES)
    return [frames[n] if o.layer == "encoder" or n == "dec.cross_kv"
            else cross[n] if n == "dec.cross_attn" else o
            for n, o in text.items()]


def _held(pred_ms: float, measured_ms) -> dict:
    """Measured against predicted ms, and the reference's dry-run
    agreement flag (predicted / measured within DRYRUN_TOLERANCE); no
    ratio where either side is empty (a decode launches no tile kernel:
    its attention runs in the libraries' GEMMs and the rest)."""
    from repro_torch.core.compose import DRYRUN_TOLERANCE

    lo, hi = DRYRUN_TOLERANCE
    out = {"predicted_ms": pred_ms, "measured_ms": measured_ms}
    if not measured_ms or not pred_ms:
        return out
    out["measured_over_predicted"] = measured_ms / pred_ms
    out["agrees"] = bool(lo <= pred_ms / measured_ms <= hi)
    return out


def _prediction_faults(tag: str, sp) -> list[str]:
    """The composition's gates on one prediction: every total and op
    finite and positive, and each phase's breakdown (by op, layer and
    kind) summing to its total under the card's overlap rule."""
    from repro_torch.core.compose import compose_cycles

    faults = []
    for ph in {o.phase for o in sp.ops}:
        ops = sp.phase_ops(ph)
        total = sp.cycles(ph)
        if not (math.isfinite(total) and total > 0) or not all(
                math.isfinite(o.cycles) and o.cycles > 0 for o in ops):
            faults.append(f"compose {tag} {ph}: a prediction is not finite "
                          f"and positive")
            continue
        rule = compose_cycles([o.t_ol_cy for o in ops],
                              [o.t_rest_cy for o in ops],
                              [o.cycles for o in ops], sp.alpha)
        parts = [sum(sp.per_layer(ph).values()), sum(sp.per_kind(ph).values())]
        if rule != total or any(abs(p - total) > 1e-9 * total for p in parts):
            faults.append(f"compose {tag} {ph}: the breakdown {parts} does not "
                          f"sum to {total} under the rule")
    return faults


def _compose_phase(prior, calibrated, models: dict, serve: dict
                   ) -> tuple[list[str], dict]:
    """Phase 18: the whole-model composition (``core/compose.py``) held
    against what phases 10-17 measured; host arithmetic, no launch.

    (i) Each served arch (phases 10-14) at its served shape, products at
    bf16: the prefill of MODEL_BATCH x MODEL_PROMPT tokens against the
    profiled prefill's device ms, and one decode step at context
    MODEL_PROMPT + MODEL_GEN against the CUDA graph's; by kind, the walk's
    attention against the tile route's ms, its matmuls against the
    libraries' GEMMs, its stream ops against every other kernel (the
    eager decode's ms beside).  (ii) The train step (phase 15) against 3x
    the composed prefill of its batch, its matmuls against the forward
    and backward GEMMs.  (iii) The compose-backed ``BucketModel`` against
    the attention-backed one on the calibrated machine, f32 and bf16, at
    every decode and prefill bucket: picks and cycles bit-equal (gated).
    (iv) ``scale_model``'s Eq. 2 point of each arch's decode, printed: one
    card cannot run a model on a subset of its SMs from PyTorch, so it is
    not measured.  Gated: every prediction finite and positive, decode
    not above prefill at equal context, every breakdown summing to its
    total; the ratios are reported."""
    from repro_torch.configs import get_arch
    from repro_torch.core import compose as C
    from repro_torch.core.scaling import scale_model
    from repro_torch.serve import BucketModel, EngineConfig, ServingModel

    failures = []
    rec = {"card": _card_line(), "elem_bytes": COMPOSE_ELEM_BYTES,
           "tolerance": list(C.DRYRUN_TOLERANCE), "served": {}}
    context = MODEL_PROMPT + MODEL_GEN
    kw = dict(batch=MODEL_BATCH, elem_bytes=COMPOSE_ELEM_BYTES)
    for name in MODEL_PHASES.values():
        m, cfg = models[name], get_arch(name).cfg
        preds = {}
        for label, machine in (("calibrated", calibrated), ("prior", prior)):
            if name == "whisper-base":
                walk = {ph: _whisper_served_ops(cfg, ph, m["prompt_tokens"])
                        for ph in C.PHASES}
                sp = C.compose_ops(walk["prefill"] + walk["decode"], machine,
                                   name=name)
                one = C.predict_step(name, machine, seq_len=WHISPER_FRAMES,
                                     **kw)
                failures += _prediction_faults(f"{name} {label} walk", one)
            else:
                sp = C.predict_step(name, machine, seq_len=MODEL_PROMPT,
                                    context=context, **kw)
            failures += _prediction_faults(f"{name} {label}", sp)
            preds[label] = sp
        sp = preds["calibrated"]
        equal = C.predict_step(name, calibrated, seq_len=context,
                               context=context, **kw)
        failures += _prediction_faults(f"{name} equal context", equal)
        if not equal.cycles("decode") <= equal.cycles("prefill"):
            failures.append(f"compose {name}: decode above prefill at context "
                            f"{context}")
        split = m["device_split"]
        out = {"prior_ms": {ph: _ms(preds["prior"], ph) for ph in C.PHASES},
               "equal_context": {ph: _ms(equal, ph) for ph in C.PHASES}}
        for ph, key, total in (
                ("prefill", "prefill", split["prefill"].get("total_ms")),
                ("decode", "decode_step", m["summary"]["decode_graph_ms"])):
            measured = split[key]
            out[ph] = {"total": _held(_ms(sp, ph), total),
                       "by_kind": {kind: _held(_ms(sp, ph, kind),
                                               measured.get(fam))
                                   for kind, fam in COMPOSE_KINDS.items()},
                       "dominant_op": sp.dominant_op(ph),
                       "flops": sp.flops(ph), "hbm_bytes": sp.hbm_bytes(ph)}
        out["decode"]["eager_ms"] = m["summary"]["decode_eager_ms"]
        out["decode"]["profiled_step_ms"] = split["decode_step"].get("total_ms")
        if name == "whisper-base":
            out["compared"] = (
                "the walk with the encoder at the frames and the decoder at "
                "its prompt against the whole prefill's device time "
                "(_device_split does not separate encoder and decoder); the "
                "reference's one-seq_len walk beside")
            out["encoder_predicted_ms"] = sp.per_layer("prefill")[
                "encoder"] / sp.clock_hz * 1e3
            out["reference_walk_ms"] = {ph: _ms(one, ph) for ph in C.PHASES}
        rec["served"][name] = out

    # (ii) the train step
    train = models[f"train {TRAIN_ARCH}"]
    sp = C.predict_step(TRAIN_ARCH, calibrated, batch=TRAIN_BATCH,
                        seq_len=TRAIN_SEQ, phases=("prefill",),
                        elem_bytes=COMPOSE_ELEM_BYTES)
    failures += _prediction_faults("train", sp)
    tsplit = train["device_split"]
    gemm = (tsplit.get("forward_gemm_ms", 0.0)
            + tsplit.get("backward_gemm_ms", 0.0)) if "total_ms" in tsplit         else None
    rec["train"] = {
        "step_mult": TRAIN_STEP_MULT,
        "device": _held(TRAIN_STEP_MULT * _ms(sp, "prefill"),
                        tsplit.get("total_ms")),
        "wall": _held(TRAIN_STEP_MULT * _ms(sp, "prefill"),
                      train["summary"]["s_per_step"] * 1e3),
        "matmul_vs_forward_and_backward_gemm": _held(
            TRAIN_STEP_MULT * _ms(sp, "prefill", "matmul"), gemm),
        "by_kind_x3_ms": {k: TRAIN_STEP_MULT * _ms(sp, "prefill", k)
                          for k in COMPOSE_KINDS},
        "recompute_share": tsplit["recompute_ms"] / tsplit["total_ms"]
        if "total_ms" in tsplit else None,
        "chunked_attention_ms": tsplit.get("chunked_attention_ms"),
        "compared": "3 x the composed prefill of B 8 x 4096 (the tile "
                    "route's attention) against a step of chunked attention "
                    "with remat full"}

    # (iii) the compose brain against the attention-backed buckets
    cfg = EngineConfig()
    cbs = _serve_buckets(cfg)
    rec["brain"] = {}
    for dtype in (torch.float32, torch.bfloat16):
        eb = torch.empty((), dtype=dtype).element_size()
        model = ServingModel(elem_bytes=eb)
        pair = [BucketModel(calibrated, model, min_ctx=cfg.min_ctx,
                            max_ctx=cfg.max_ctx, source=src)
                for src in ("attention", "compose")]
        views = [[(b.decode_block(cb), b.decode_block(cb, smallest=True),
                   b.decode_cy_per_token(cb, calibrated=False),
                   b.decode_cy_per_token(cb, smallest_block=True,
                                         calibrated=False),
                   b._prefill_entry(cb)["block"],
                   b.prefill_cy(cb, calibrated=False)) for cb in cbs]
                 for b in pair]
        unequal = [cb for cb, a, c in zip(cbs, *views) if a != c]
        if unequal:
            failures.append(f"compose brain {dtype}: buckets {unequal} differ "
                            f"from the attention-backed model")
        name = str(dtype).removeprefix("torch.")
        launched = {cb: serve["dtypes"][name]["picks"]["calibrated"][cb]["bkv"]
                    for cb in cbs}
        rec["brain"][name] = {
            "bit_equal": not unequal,
            "decode_picks": {cb: v[0] for cb, v in zip(cbs, views[1])},
            "prefill_picks": {cb: list(v[4]) for cb, v in zip(cbs, views[1])},
            "picks_equal_phase_17s": all(
                v[0] == launched[cb] for cb, v in zip(cbs, views[1])),
            "decode_s_per_token": {cb: pair[1].seconds(v[2])
                                   for cb, v in zip(cbs, views[1])}}

    # (iv) Eq. 2 on each arch's decode step
    rec["eq2_decode"] = {"measured": "not measured: one card does not run a "
                                     "model on a subset of its SMs"}
    for name in MODEL_PHASES.values():
        seq = WHISPER_FRAMES if name == "whisper-base" else MODEL_PROMPT
        ctx = WHISPER_FRAMES if name == "whisper-base" else context
        cs = scale_model(name, calibrated, phase="decode", seq_len=seq,
                         context=ctx, **kw)
        rec["eq2_decode"][name] = cs.saturation_summary()[cs.names[0]]
    return failures, rec


# ---------------------------------------------------------------------------
# phase 19: the dry-run
# ---------------------------------------------------------------------------


def _dryrun_cell(kind: str, name: str):
    """``(arch, shape, kw)`` of a phase-19 cell (``kw``: ``trace_cell``'s
    keywords): phase 15's train step at its configuration, the world
    cell's train step on one data group's rows (``train_rows``), or a served
    arch at phase 10-14's shapes: the prefill of MODEL_BATCH x
    MODEL_PROMPT tokens (whisper: WHISPER_FRAMES frames) with the
    launcher's cache (``prompt + gen + 8`` positions), attention on the
    flash op, and one decode step at phase 18's context (the prompt's
    tokens and MODEL_GEN) on that cache (whisper's cross K/V at the
    frames, as its prefill leaves them)."""
    from repro_torch.configs import SHAPES, get_arch
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.models import whisper

    if kind == "train":
        return (_train_arch(),
                ShapeSpec("train_4k", TRAIN_SEQ, TRAIN_BATCH, "train"), {})
    if kind == "train_rows":
        shape = SHAPES[DRYRUN_WORLD[1]]
        return (_train_arch(), dataclasses.replace(
            shape, global_batch=shape.global_batch // DRYRUN_DATA_RANKS), {})
    arch = get_arch(name)
    if hasattr(arch.cfg, "attn_impl"):
        arch = _variant(arch, attn_impl="flash")
    prompt = WHISPER_FRAMES if name == "whisper-base" else MODEL_PROMPT
    kw = {"max_len": prompt + MODEL_GEN + 8}
    shape = ShapeSpec("prefill", prompt, MODEL_BATCH, "prefill")
    if kind == "prefill":
        return arch, shape, kw
    tokens = arch.batch_spec(shape)["tokens"].shape[1]
    if name == "whisper-base":
        kw["cache_spec"] = whisper.cache_spec(arch.cfg, MODEL_BATCH,
                                              kw["max_len"], WHISPER_FRAMES)
    return (arch, ShapeSpec("decode", tokens + MODEL_GEN, MODEL_BATCH,
                            "decode"), kw)


def _trace_cells_child(out: str, group: int) -> int:
    """A child of phase 19: trace ``DRYRUN_GROUPS[group]`` on fake CUDA
    tensors with phase 6's calibrated machine, the records to ``out``."""
    from repro_torch.core.machine import load_machine_file
    from repro_torch.launch.dryrun import trace_cell

    machine = load_machine_file(MACHINE_FILE)
    recs = []
    for kind, name in DRYRUN_GROUPS[group]:
        arch, shape, kw = _dryrun_cell(kind, name)
        recs.append(trace_cell(arch, shape, mesh="card", device="cuda",
                               machine=machine, **kw)
                    | {"cell": [kind, name]})
    Path(out).write_text(json.dumps(recs))
    return 0


def _flop_gate() -> tuple[list[str], dict]:
    """internlm2-1.8b's flash prefill (phase 10's, bf16, random weights
    from SEED) run on the card under ``FlopCounterMode`` (with the port's
    custom ops' formulas, ``core/hlo.py`` ``flop_counter``): its FLOPs,
    its tile launches (one a layer) and ``max_memory_allocated`` over the
    step, the bf16 parameters and the batch resident before it.  First the
    flash op alone at the model's shape: the counter must count it at the
    plain version's ``4 B H Sq Sk d``."""
    from repro_torch import kernels
    from repro_torch.core.hlo import flop_counter
    from repro_torch.kernels.attention import ops
    from repro_torch.models.common import cast_params, materialize
    from repro_torch.train.steps import make_prefill_step

    arch, shape, kw = _dryrun_cell("prefill", "internlm2-1.8b")
    dev = torch.device("cuda")
    failures = []
    a = arch.cfg.attn_cfg
    q = torch.randn(MODEL_BATCH, shape.seq_len, a.n_heads, a.head_dim,
                    device=dev, dtype=arch.cfg.dtype)
    k = torch.randn(MODEL_BATCH, shape.seq_len, a.n_kv_heads, a.head_dim,
                    device=dev, dtype=arch.cfg.dtype)
    with flop_counter() as fc:
        ops.flash_attention(q, k, k)
    op_flops = fc.get_total_flops()
    want_op = 4 * MODEL_BATCH * a.n_heads * shape.seq_len ** 2 * a.head_dim
    if op_flops != want_op:
        failures.append(f"dry-run gate: the counter counts the flash op at "
                        f"{op_flops} FLOP, not {want_op}")
    del q, k
    params = cast_params(materialize(
        arch.param_spec(), torch.Generator(device=dev).manual_seed(SEED),
        device=dev), arch.cfg.dtype)
    batch = {k: torch.from_numpy(v).to(dev)
             for k, v in arch.make_batch(shape, seed=SEED).items()}
    step = make_prefill_step(arch, max_len=kw["max_len"])
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    before = dict(kernels.FLASH_ATTENTION.launches_by_route)
    with flop_counter() as fc:
        out = step(params, batch)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    launched = {r: n - before[r]
                for r, n in kernels.FLASH_ATTENTION.launches_by_route.items()}
    finite = bool(torch.isfinite(out[0].float()).all())
    del out, params, batch
    torch.cuda.empty_cache()
    want = {"tile": arch.cfg.n_layers, "split": 0}
    if launched != want:
        failures.append(f"dry-run gate: the prefill launched {launched}, "
                        f"not {want}")
    if not finite:
        failures.append("dry-run gate: the prefill's logits are not finite")
    return failures, {"flops": fc.get_total_flops(), "launches": launched,
                      "peak_bytes": peak, "resident_bytes": resident,
                      "flash_op_flops": op_flops}


def _ratio(num, den):
    return num / den if num and den else None


def _world_train_gates(world: dict, rows: dict) -> tuple[list[str], dict]:
    """The 256-rank ``train_4k`` cell's tensor-parallel step against a
    data group's rows traced on one card: its useful share
    (``dryrun.useful_share``) at least MESH_USEFUL_MIN and its peak
    within the card's memory, gated; its per-card TFLOP, the GB each kind
    of collective moves over each mesh axis (output bytes) and its peak
    reported beside DRYRUN_WORLD_WHOLE."""
    from repro_torch.launch import dryrun

    by_axis: dict[str, float] = {}
    for key, n in world["collectives"]["ops_by_kind_axis_bytes"].items():
        kind, axis, nbytes = key.rsplit("/", 2)
        k = f"{kind.split('.')[0]}/{axis}"
        by_axis[k] = by_axis.get(k, 0.0) + n * int(nbytes) / 1e9
    share = dryrun.useful_share(world, rows, DRYRUN_DATA_RANKS)
    rec = {"card": _card_line(), "useful_share": share,
           "tflop_per_card": world["cost"]["flops_per_chip"] / 1e12,
           "rows_tflop_one_card": rows["cost"]["flops_per_chip"] / 1e12,
           "gb_by_kind_axis": by_axis,
           "gathered_gb": sum(v for k, v in by_axis.items()
                              if k.startswith("all-gather/")),
           "peak_gb": world["peak_bytes_per_chip"] / 1e9,
           "capacity_gb": world["capacity_bytes"] / 1e9,
           "fits_hbm": world["fits_hbm"],
           "ops_by_kind_axis_group": world["collectives"][
               "ops_by_kind_axis_group"],
           "t_link_ms": world["ecm"]["t_link_s"] * 1e3,
           "t_trace_s": {"world": world["t_trace_s"],
                         "rows": rows["t_trace_s"]},
           "gathered_whole": DRYRUN_WORLD_WHOLE}
    failures = []
    if share < MESH_USEFUL_MIN:
        failures.append(f"dry-run world train_4k: useful share {share} < "
                        f"{MESH_USEFUL_MIN}")
    if not world["fits_hbm"]:
        failures.append(f"dry-run world train_4k: peak "
                        f"{world['peak_bytes_per_chip']} B over the card's "
                        f"{world['capacity_bytes']}")
    return failures, rec


def _dryrun_phase(calibrated, models: dict, composed: dict
                  ) -> tuple[list[str], dict]:
    """Phase 19: the dry-run's traces on fake CUDA tensors held against
    what the card ran (module docstring, item 19).  The children (each
    group of DRYRUN_GROUPS, and the dry-run CLI on a fake world of 256
    ranks, so that the fake group never meets phase 16's NCCL group) run
    while this process runs the FLOP gate's prefill on the card."""
    from repro_torch.core.mesh import rank_meshes

    t0 = time.perf_counter()
    failures, rec = [], {"card": _card_line()}
    env = dict(os.environ, PYTHONPATH=str(SRC))
    with tempfile.TemporaryDirectory() as tmp:
        arch_name, shape_name = DRYRUN_WORLD
        commands = [(f"group {i}", os.path.join(tmp, f"group{i}.json"),
                     [sys.executable, __file__, "--trace-cells",
                      os.path.join(tmp, f"group{i}.json"), str(i)])
                    for i in range(len(DRYRUN_GROUPS))]
        commands.append((
            "world", os.path.join(tmp, f"{arch_name}__{shape_name}__16x16.json"),
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             arch_name, "--shape", shape_name, "--device", "cuda",
             "--machine", str(MACHINE_FILE), "--out", tmp, "--force"]))
        children = []
        for tag, out, cmd in commands:
            log = open(os.path.join(tmp, f"{tag}.log"), "w+")
            children.append((tag, out, log, subprocess.Popen(
                cmd, env=env, stdout=log, stderr=subprocess.STDOUT)))
        gate_failures, gate = _flop_gate()
        failures += gate_failures
        traced, child_s = {}, {}
        for tag, out, log, proc in children:
            try:
                proc.wait(timeout=DRYRUN_CHILD_TIMEOUT_S)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
            child_s[tag] = time.perf_counter() - t0
            log.seek(0)
            tail = log.read()[-2000:]
            log.close()
            if proc.returncode or not os.path.exists(out):
                failures.append(f"dry-run {tag}: exit {proc.returncode}: "
                                f"{tail}")
                continue
            got = json.loads(Path(out).read_text())
            for r in (got if isinstance(got, list) else [got]):
                if r["status"] != "ok":
                    failures.append(f"dry-run {tag}: {r.get('error')}")
                traced[tuple(r.get("cell", (tag, arch_name)))] = r
    rec["children_done_s"] = child_s
    if failures:
        rec["s"] = time.perf_counter() - t0
        return failures, rec

    # the gate: the traced FLOPs of the flash prefill, exactly the card's
    p = traced[("prefill", "internlm2-1.8b")]
    rec["flop_gate"] = gate | {"traced_flops": p["cost"]["flops_per_chip"],
                               "equal": p["cost"]["flops_per_chip"]
                               == gate["flops"]}
    if not rec["flop_gate"]["equal"]:
        failures.append(f"dry-run gate: traced FLOPs "
                        f"{p['cost']['flops_per_chip']} != the card's "
                        f"{gate['flops']}")

    # memory: the traced peak against max_memory_allocated
    train = models[f"train {TRAIN_ARCH}"]
    t = traced[("train", TRAIN_ARCH)]
    rec["memory"] = {
        "train": {"traced_peak": t["peak_bytes_per_chip"],
                  "traced": t["memory"],
                  "measured_peak": train["summary"]["peak_bytes"],
                  "traced_over_measured": _ratio(
                      t["peak_bytes_per_chip"],
                      train["summary"]["peak_bytes"])},
        "prefill internlm2-1.8b": {
            "traced_peak": p["peak_bytes_per_chip"], "traced": p["memory"],
            "measured_peak": gate["peak_bytes"],
            "traced_over_measured": _ratio(p["peak_bytes_per_chip"],
                                           gate["peak_bytes"])}}

    # time: the traced three-term t_ecm against the measured device ms
    tsplit = train["device_split"]
    rec["t_ecm"] = {"train": {
        "traced_ms": t["ecm"]["t_ecm_s"] * 1e3, "ecm": t["ecm"],
        "measured_device_ms": tsplit.get("total_ms"),
        "measured_over_traced": _ratio(tsplit.get("total_ms"),
                                       t["ecm"]["t_ecm_s"] * 1e3),
        "composed_measured_over_predicted": composed["train"]["device"].get(
            "measured_over_predicted")}}
    for name in MODEL_PHASES.values():
        m = models[name]
        for kind, measured in (
                ("prefill", m["device_split"]["prefill"].get("total_ms")),
                ("decode", m["summary"]["decode_graph_ms"])):
            e = traced[(kind, name)]["ecm"]
            rec["t_ecm"][f"{name} {kind}"] = {
                "traced_ms": e["t_ecm_s"] * 1e3,
                "t_comp_ms": e["t_comp_s"] * 1e3,
                "t_hbm_ms": e["t_hbm_s"] * 1e3, "dominant": e["dominant"],
                "traced_flops": traced[(kind, name)]["cost"]["flops_per_chip"],
                "traced_bytes": traced[(kind, name)]["cost"]["bytes_per_chip"],
                "measured_device_ms": measured,
                "measured_over_traced": _ratio(measured, e["t_ecm_s"] * 1e3),
                "composed_measured_over_predicted": composed["served"][name][
                    kind]["total"].get("measured_over_predicted"),
                "t_trace_s": traced[(kind, name)]["t_trace_s"]}
    best = rank_meshes(TRAIN_ARCH, 8, calibrated)[0]
    rec["rank_meshes_8"] = {k: best[k] for k in (
        "mesh", "profile", "t_step_us", "t_link_us", "n_saturation",
        "parallel_efficiency", "hbm_bytes_per_chip", "fits_hbm", "block")}
    rec["world"] = traced[("world", arch_name)]
    world_failures, rec["world_train"] = _world_train_gates(
        rec["world"], traced[("train_rows", TRAIN_ARCH)])
    failures += world_failures
    rec["t_trace_s"] = {f"{k[0]} {k[1]}": r["t_trace_s"]
                        for k, r in traced.items()}
    rec["s"] = time.perf_counter() - t0
    rec["aim_s"] = DRYRUN_AIM_S
    return failures, rec


# ---------------------------------------------------------------------------
# phase 20: serving on a mesh
# ---------------------------------------------------------------------------


def _mesh_cell_key(name: str, shape_name: str, mesh: str) -> str:
    return f"{name} {shape_name}" + (" rows" if mesh == "card" else "")


def _mesh_cells_child(out: str, group: int) -> int:
    """A child of phase 20: the cells of MESH_CHILDREN[group] on the fake
    MESH_WORLD world, or (``card``) a data group's rows of the cell on one
    card, on fake CUDA tensors with phase 6's calibrated machine,
    attention on the flash op (the served path), each arch at its
    MESH_CUT depth; the records to ``out``."""
    from repro_torch.configs import SHAPES, get_arch
    from repro_torch.core.machine import load_machine_file
    from repro_torch.launch.dryrun import trace_cell

    machine = load_machine_file(MACHINE_FILE)
    recs = {}
    for name, shape_name, mesh in MESH_CHILDREN[group]:
        arch = get_arch(name)
        kw = {"n_layers": MESH_CUT[name]} if name in MESH_CUT else {}
        if hasattr(arch.cfg, "attn_impl"):
            kw["attn_impl"] = "flash"
        shape = SHAPES[shape_name]
        if mesh == "card":
            shape = dataclasses.replace(
                shape, global_batch=shape.global_batch // MESH_DATA_RANKS)
        recs[_mesh_cell_key(name, shape_name, mesh)] = trace_cell(
            _variant(arch, **kw), shape, mesh=mesh, device="cuda",
            machine=machine)
    Path(out).write_text(json.dumps(recs))
    return 0


def _placed_params(arch, params, mesh):
    """``params`` (whole) placed on ``mesh`` by the arch's profile, as
    ``launch/serve.py`` places them."""
    from repro_torch.dist.sharding import get_profile, param_shardings
    from repro_torch.models.common import tree_leaves, tree_map

    psh = param_shardings(arch.param_spec(), mesh, get_profile(arch.profile),
                          ensure_model_axis=True)
    it = iter([sh.distribute(t) for t, sh in
               zip(tree_leaves(params), tree_leaves(psh))])
    return tree_map(lambda _: next(it), params)


def _family_params(name: str):
    """The bf16 weights phases 12-14 serve ``name`` with: drawn from SEED
    on the card by ``materialize``, the attention projections at their
    contracted fan-in (zamba2's shared block, whisper's three attention
    subtrees; xlstm has none), cast once to the config's dtype."""
    from repro_torch.configs import get_arch
    from repro_torch.models.common import cast_params, materialize

    arch = get_arch(name)
    cfg, spec = arch.cfg, arch.param_spec()
    if arch.family == "hybrid":
        spec = _contracted_fan_in(spec, ("shared", "attn"), cfg.attn_cfg)
    elif name == "whisper-base":
        for path in (("enc", "layers", "attn"), ("dec", "layers", "self_attn"),
                     ("dec", "layers", "cross_attn")):
            spec = _contracted_fan_in(spec, path, cfg.attn_cfg(causal=False))
    dev = torch.device("cuda")
    return cast_params(materialize(
        spec, torch.Generator(device=dev).manual_seed(SEED), device=dev),
        cfg.dtype)


def _mesh_families(mesh, models: dict) -> tuple[list[str], dict]:
    """MESH_FAMILIES served on ``mesh`` through ``launch/serve.py``
    ``serve`` as phases 12-14 serve them (bf16, their weights, flash where
    they attend, MODEL_BATCH x MODEL_PROMPT, whisper WHISPER_FRAMES
    frames, MODEL_GEN greedy steps): the tile launches a prefill and no
    split launch, the tokens equal to the phase's, the logits finite;
    the prefill and per-token decode times beside the phase's."""
    from repro_torch import kernels
    from repro_torch.configs import get_arch
    from repro_torch.launch.serve import serve

    failures, rec = [], {}
    attn = kernels.FLASH_ATTENTION
    for name, tiles in MESH_FAMILIES.items():
        arch = get_arch(name)
        flash = hasattr(arch.cfg, "attn_impl")
        if flash:
            arch = _variant(arch, attn_impl="flash")
        params = _family_params(name)
        before = dict(attn.launches_by_route)
        served = serve(arch, params, batch=MODEL_BATCH,
                       prompt_len=WHISPER_FRAMES if name == "whisper-base"
                       else MODEL_PROMPT, gen=MODEL_GEN, seed=SEED, mesh=mesh)
        launched = {r: n - before[r] for r, n in attn.launches_by_route.items()}
        phase = models[name]
        ran = phase["runs"]["bfloat16 flash" if flash else "bfloat16 model"]
        want_tokens = phase["bf16_flash_tokens" if flash else "bf16_tokens"]
        tokens_equal = served.tokens.tolist() == want_tokens
        finite = all(bool(torch.isfinite(t).all()) for t in
                      (served.prefill_logits, *served.step_logits))
        decode_s = served.decode_s / MODEL_GEN
        rec[name] = {
            "attention_launches": launched, "tokens_equal_phase":
            tokens_equal, "finite": finite, "prefill_s": served.prefill_s,
            "decode_s_per_token": decode_s,
            "phase_prefill_s": ran["prefill_s"],
            "phase_decode_s_per_token": ran["decode_s_per_token"],
            "prefill_over_phase": served.prefill_s / ran["prefill_s"],
            "decode_over_phase": decode_s / ran["decode_s_per_token"]}
        if launched != {"tile": tiles, "split": 0}:
            failures.append(f"mesh serve {name}: attention launches "
                            f"{launched}, not {tiles} tile and no split")
        if not tokens_equal or not finite:
            failures.append(f"mesh serve {name}: tokens equal to its phase's "
                            f"{tokens_equal}, logits finite {finite}")
        del served, params
        torch.cuda.empty_cache()
    return failures, rec


def _mesh_sequence_split(mesh) -> tuple[list[str], dict]:
    """MESH_ARCH at MESH_F32_LAYERS layers at full width, f32, flash: the
    prefill with the cache split by sequence (the input profile of KV
    heads that do not divide ``model``) and MESH_F32_GEN decode steps
    under ``cache_seq_axis="model"`` (the flash decode, its three
    all-reduces on the one-rank group), each step's logits against the
    same step with ``mesh=None`` fed the same tokens."""
    from repro_torch.benchmarks import gpu_compute_ecm as GC
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.dist.sharding import (get_profile, input_profile,
                                           param_shardings, use_mesh_context)
    from repro_torch.kernels.check import compare
    from repro_torch.models.common import materialize
    from repro_torch.train.steps import make_prefill_step, make_serve_step

    dev = torch.device("cuda")
    arch = _variant(get_arch(MESH_ARCH), n_layers=MESH_F32_LAYERS,
                    dtype=torch.float32, attn_impl="flash")
    vocab = arch.cfg.vocab
    shape = ShapeSpec("cli_prefill", MODEL_PROMPT, MODEL_BATCH, "prefill")
    max_len = MODEL_PROMPT + MESH_F32_GEN + 8
    in_prof = input_profile(multi_pod=False, kv_divisible=False)
    profile = get_profile(arch.profile)
    failures, errs = [], []
    with GC.full_f32():
        params = materialize(_contracted_fan_in(
            arch.param_spec(), ("layers", "attn"), arch.cfg.attn_cfg),
            torch.Generator(device=dev).manual_seed(SEED), device=dev)
        prompt = {k: torch.from_numpy(v).to(dev)
                  for k, v in arch.make_batch(shape, seed=SEED).items()}
        bsh = param_shardings(arch.batch_spec(shape), mesh, in_prof)
        placed = _placed_params(arch, params, mesh)
        want, want_cache = make_prefill_step(arch, max_len=max_len)(params,
                                                                    prompt)
        with use_mesh_context(mesh, profile):
            got, cache = make_prefill_step(arch, max_len=max_len,
                                           cache_profile=in_prof)(
                placed, {k: bsh[k].distribute(v) for k, v in prompt.items()})
        pairs = [(got, want)]
        tok = want[:, -1, :vocab].argmax(-1)[:, None]
        for _ in range(MESH_F32_GEN):
            want, want_cache = make_serve_step(arch)(params, want_cache,
                                                     {"tokens": tok})
            with use_mesh_context(mesh, profile, cache_seq_axis="model"):
                got, cache = make_serve_step(arch)(placed, cache,
                                                   {"tokens": tok})
            pairs.append((got, want))
            tok = want[:, -1, :vocab].argmax(-1)[:, None]
        for j, (got, want) in enumerate(pairs):
            ok, err, tol = compare(got, want, tol=MODEL_TOL)
            errs.append(err)
            if not ok:
                failures.append(f"mesh sequence split: "
                                f"{'prefill' if j == 0 else f'step {j}'} "
                                f"logits off mesh=None by {err} (tol {tol})")
        spec = cache["k"].placements
    return failures, {"layers": MESH_F32_LAYERS, "steps": MESH_F32_GEN,
                      "cache_placements": [str(p) for p in spec],
                      "max_abs_err": errs, "tol": MODEL_TOL}


def _mesh_moe(mesh) -> tuple[list[str], dict]:
    """MESH_MOE_ARCH (``shard_map``) bf16, flash, served MESH_MOE_GEN
    steps with ``mesh=None`` and on ``mesh`` (the multi-shard body on one
    model shard, its FSDP gathers and all-reduces on the one-rank group),
    twice in turn: the prefill's and every step's logits and the tokens
    bit-equal, under deterministic kernels; the times of the second
    turn."""
    from repro_torch.configs import get_arch
    from repro_torch.launch.serve import serve
    from repro_torch.models.common import cast_params, materialize

    dev = torch.device("cuda")
    arch = _variant(get_arch(MESH_MOE_ARCH), attn_impl="flash")
    params = cast_params(materialize(_contracted_fan_in(
        arch.param_spec(), ("layers", "attn"), arch.cfg.attn_cfg),
        torch.Generator(device=dev).manual_seed(SEED), device=dev),
        arch.cfg.dtype)
    with _deterministic():
        turns = [[serve(arch, params, batch=MODEL_BATCH,
                        prompt_len=MODEL_PROMPT, gen=MESH_MOE_GEN, seed=SEED,
                        mesh=where) for where in (None, mesh)]
                 for _ in range(2)]
    differ = 0
    for runs in turns:
        logits = [[r.prefill_logits, *r.step_logits] for r in runs]
        differ += sum(not torch.equal(a, b) for a, b in zip(*logits))
    runs = turns[1]
    rec = {"impl": arch.cfg.moe.impl, "steps": MESH_MOE_GEN,
           "logits_differ": differ,
           "tokens_equal": all(torch.equal(a.tokens, b.tokens)
                               for a, b in turns),
           "mesh_prefill_s": runs[1].prefill_s,
           "mesh_decode_s_per_token": runs[1].decode_s / MESH_MOE_GEN,
           "prefill_s": runs[0].prefill_s,
           "decode_s_per_token": runs[0].decode_s / MESH_MOE_GEN}
    failures = [] if not differ and rec["tokens_equal"] else [
        f"mesh moe: {differ} logits and the tokens "
        f"({rec['tokens_equal']}) against mesh=None"]
    return failures, rec


def _host_split(fn, calls: int = 3) -> dict:
    """The host's side of ``fn`` (a decode step, which is host-bound):
    the wall ms a call (``calls`` calls between two syncs, after a
    warm-up), and the eight ops of one profiled call with the most self
    CPU time.  A profiler the machine refuses is reported as not
    measured."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    rec = {"wall_ms": (time.perf_counter() - t0) / calls * 1e3}
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            fn()
            torch.cuda.synchronize()
        rows = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)
    except Exception as e:  # noqa: BLE001 - a refused profiler is a reading not taken
        return rec | {"not_measured": f"{type(e).__name__}: {e}"}
    return rec | {"self_cpu_ms": sum(e.self_cpu_time_total for e in rows) / 1e3,
                  "top": [{"op": e.key[:80], "self_cpu_ms":
                           e.self_cpu_time_total / 1e3, "count": e.count}
                          for e in rows[:8]]}


def _mesh_decode_split(arch, params, mesh) -> dict:
    """One decode step of ``arch`` on ``mesh`` (``launch/serve.py``'s
    mesh path) and with ``mesh=None``, after a prefill of MODEL_BATCH x
    MODEL_PROMPT: the host's side of each (:func:`_host_split`) and the
    device's (:func:`_device_split`)."""
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch.serve import _on_mesh

    shape = ShapeSpec("cli_prefill", MODEL_PROMPT, MODEL_BATCH, "prefill")
    prompt = {k: torch.from_numpy(v).cuda()
              for k, v in arch.make_batch(shape, seed=SEED).items()}
    max_len = MODEL_PROMPT + MODEL_GEN + 8
    run_prefill, run_decode = _on_mesh(arch, params, prompt, mesh, False,
                                       max_len)
    logits, cache = run_prefill()
    tok = logits[:, -1, :arch.cfg.vocab].argmax(-1)[:, None]
    plain_logits, plain_cache = arch.prefill(params, prompt, max_len=max_len)
    del logits, plain_logits
    split = {}
    for name, fn in (("mesh", lambda: run_decode(cache, tok)),
                     ("mesh_none", lambda: arch.decode(params, plain_cache,
                                                       {"tokens": tok}))):
        split[name] = {"host": _host_split(fn), "device": _device_split(fn)}
    return split


def _mesh_cell_gates(cells: dict) -> tuple[list[str], dict]:
    """The 256-rank serving cells: each ``ok`` and within the card's
    memory; each prefill's useful share at least MESH_USEFUL_MIN; each of
    MESH_FLASH_DECODES' flash decode in every layer (one max and one
    denominator all-reduce over ``model`` a layer, a numerator sum of
    ``(B, H, hd)`` f32 beside them); per-card TFLOP, bytes, collectives,
    ``t_link``, peak."""
    from repro_torch.configs import get_arch
    from repro_torch.launch import dryrun

    failures, rec = [], {}
    for key, r in cells.items():
        if r["status"] != "ok":
            failures.append(f"mesh cell {key}: {r.get('error')}")
            continue
        rec[key] = {"tflop_per_card": r["cost"]["flops_per_chip"] / 1e12,
                    "gb_per_card": r["cost"]["bytes_per_chip"] / 1e9,
                    "collectives": r["collectives"]["ops_by_kind_axis_group"],
                    "collective_gb_by_kind": {
                        k: v / 1e9 for k, v in
                        r["collectives"]["out_bytes_by_kind"].items()},
                    "wire_gb_per_card": r["collectives"]["wire_bytes_per_chip"]
                    / 1e9,
                    "t_link_ms": r["ecm"]["t_link_s"] * 1e3,
                    "t_ecm_ms": r["ecm"]["t_ecm_s"] * 1e3,
                    "peak_gb": r["peak_bytes_per_chip"] / 1e9,
                    "fits_hbm": r["fits_hbm"],
                    "local_rows": r.get("local_rows"),
                    "n_layers": MESH_CUT.get(r["arch"]),
                    "t_trace_s": r["t_trace_s"]}
        if r["mesh"] != "card" and not r["fits_hbm"]:
            failures.append(f"mesh cell {key}: peak {r['peak_bytes_per_chip']}"
                            f" B over the card's {r['capacity_bytes']}")
    if failures:
        return failures, rec
    for name, shape_name in MESH_CELLS:
        if shape_name != "prefill_32k":
            continue
        key = _mesh_cell_key(name, shape_name, MESH_WORLD)
        share = dryrun.useful_share(
            cells[key], cells[_mesh_cell_key(name, shape_name, "card")],
            MESH_DATA_RANKS)
        rec[key]["useful_share"] = share
        if share < MESH_USEFUL_MIN:
            failures.append(f"mesh cell {key}: useful share {share} < "
                            f"{MESH_USEFUL_MIN}")
    for name, shape_name in MESH_FLASH_DECODES:
        key = f"{name} {shape_name}"
        cfg = get_arch(name).cfg
        got = dryrun.flash_decode_reduces(cells[key], cfg)
        numerator = (cells[key]["local_rows"] * cfg.n_heads * cfg.head_dim_
                     * 4)
        got["numerator_sized"] = cells[key]["collectives"][
            "ops_by_kind_axis_bytes"].get(f"all-reduce.sum/model/{numerator}",
                                          0)
        rec[key]["flash_decode_reduces"] = got
        if not (got["max"] == got["denominator"] == cfg.n_layers
                and got["numerator_sized"] >= cfg.n_layers):
            failures.append(f"mesh cell {key}: the flash decode's all-reduces "
                            f"over model {got}, not one max, one denominator "
                            f"and a numerator in each of {cfg.n_layers} "
                            f"layers")
    return failures, rec


def _mesh_phase(models: dict) -> tuple[list[str], dict]:
    """Phase 20: serving on a one-rank NCCL mesh (module docstring, item
    20).  The dry-run's 256-rank cells trace in children
    (MESH_CHILDREN; a fake world needs a process without the NCCL group),
    started after the timed serves, while this process runs the gates on
    the card; the phase's launches are counted from 0."""
    import torch.distributed as dist

    from repro_torch import kernels
    from repro_torch.configs import get_arch
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.serve import serve
    from repro_torch.models.common import cast_params, materialize

    t0 = time.perf_counter()
    failures, rec = [], {"card": _card_line()}
    env = dict(os.environ, PYTHONPATH=str(SRC))
    with tempfile.TemporaryDirectory() as tmp:
        outs = [os.path.join(tmp, f"cells{g}.json")
                for g in range(len(MESH_CHILDREN))]
        log = open(os.path.join(tmp, "cells.log"), "w+")
        dev = torch.device("cuda")
        kernels.reset_launches()
        mesh = make_host_mesh(model=1, device="cuda")
        rec["mesh"] = {"shape": list(mesh.shape),
                       "axes": list(mesh.mesh_dim_names),
                       "backend": dist.get_backend()}
        try:
            # the communicators start at their first collective: before
            # the timed serve
            for axis in mesh.mesh_dim_names:
                dist.all_reduce(torch.zeros(1, device=dev),
                                group=mesh.get_group(axis))
            arch = _variant(get_arch(MESH_ARCH), attn_impl="flash")
            params = cast_params(materialize(_contracted_fan_in(
                arch.param_spec(), ("layers", "attn"), arch.cfg.attn_cfg),
                torch.Generator(device=dev).manual_seed(SEED), device=dev),
                arch.cfg.dtype)
            attn = kernels.FLASH_ATTENTION
            before = dict(attn.launches_by_route)
            served = serve(arch, params, batch=MODEL_BATCH,
                           prompt_len=MODEL_PROMPT, gen=MODEL_GEN, seed=SEED,
                           mesh=mesh)
            launched = {r: n - before[r]
                        for r, n in attn.launches_by_route.items()}
            phase10 = models[MESH_ARCH]
            ten = phase10["runs"]["bfloat16 flash"]
            tokens_equal = served.tokens.tolist() == phase10["bf16_flash_tokens"]
            finite = all(bool(torch.isfinite(t).all()) for t in
                         (served.prefill_logits, *served.step_logits))
            rec["serve"] = {
                "arch": MESH_ARCH, "dtype": "bf16", "attn_impl": "flash",
                "batch": MODEL_BATCH, "prompt": MODEL_PROMPT, "gen": MODEL_GEN,
                "attention_launches": launched, "tokens_equal_phase10":
                tokens_equal, "prefill_s": served.prefill_s,
                "decode_s_per_token": served.decode_s / MODEL_GEN,
                "phase10_prefill_s": ten["prefill_s"],
                "phase10_decode_s_per_token": ten["decode_s_per_token"],
                "prefill_over_phase10": served.prefill_s / ten["prefill_s"],
                "decode_over_phase10": served.decode_s / MODEL_GEN
                / ten["decode_s_per_token"]}
            want = {"tile": arch.cfg.n_layers, "split": 0}
            if launched != want:
                failures.append(f"mesh serve: attention launches {launched}, "
                                f"not {want}")
            if not tokens_equal or not finite:
                failures.append(f"mesh serve: tokens equal to phase 10's "
                                f"{tokens_equal}, logits finite {finite}")
            del served
            rec["decode_split"] = _mesh_decode_split(arch, params, mesh)
            del params
            torch.cuda.empty_cache()
            family_failures, rec["families"] = _mesh_families(mesh, models)
            failures += family_failures
            # the traces take a core each: started once the timed runs are
            # done
            children = [subprocess.Popen(
                [sys.executable, __file__, "--mesh-cells", out, str(g)],
                env=env, stdout=log, stderr=subprocess.STDOUT)
                for g, out in enumerate(outs)]
            split_failures, rec["sequence_split"] = _mesh_sequence_split(mesh)
            failures += split_failures
            torch.cuda.empty_cache()
            moe_failures, rec["moe"] = _mesh_moe(mesh)
            failures += moe_failures
            torch.cuda.empty_cache()
        finally:
            dist.destroy_process_group()
        rec["launches"] = {k.name: k.launches for k in kernels.KERNELS}
        rec["attention_launches_by_route"] = dict(
            kernels.FLASH_ATTENTION.launches_by_route)
        deadline = time.perf_counter() + MESH_CHILD_TIMEOUT_S
        for child in children:
            try:
                child.wait(timeout=max(deadline - time.perf_counter(), 1))
            except subprocess.TimeoutExpired:
                child.kill()
                child.wait()
        rec["child_done_s"] = time.perf_counter() - t0
        log.seek(0)
        tail = log.read()[-2000:]
        log.close()
        codes = [c.returncode for c in children]
        if any(codes) or not all(os.path.exists(o) for o in outs):
            failures.append(f"mesh cells: exits {codes}: {tail}")
        else:
            cells = {}
            for o in outs:
                cells.update(json.loads(Path(o).read_text()))
            cell_failures, rec["cells"] = _mesh_cell_gates(cells)
            failures += cell_failures
    rec["s"] = time.perf_counter() - t0
    rec["aim_s"] = MESH_AIM_S
    return failures, rec


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
    build_s = time.perf_counter() - t0
    print(json.dumps({"build_s": build_s, "sources": list(kernels.SOURCES)}))

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
    record["attention_launches_by_route"] = dict(
        kernels.FLASH_ATTENTION.launches_by_route)
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
    compute_s = time.perf_counter() - t_path
    print(json.dumps({"path_s": {"stream": stream_s, "stencil": stencil_s,
                                 "compute": compute_s}}))
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
    scaling_s = time.perf_counter() - t_path

    # 9. the energy over the SMs, its launches counted from 0
    t_path = time.perf_counter()
    kernels.reset_launches()
    energy_failures, energy = _energy_phase(calibrated, scaling)
    energy_launches = {k.name: k.launches for k in kernels.KERNELS}
    energy_failures += [f"{k} was not launched by the energy sweep"
                        for k in ("map_pipeline", "reduce_pipeline")
                        if not energy_launches[k]]
    energy_s = time.perf_counter() - t_path
    print(json.dumps({k: v for k, v in energy.items() if k != "ops"}
                     | {"phase": "energy", "launches": energy_launches,
                        "s": energy_s}))
    for op, rec in energy.get("ops", {}).items():
        print(json.dumps({"phase": "energy", "op": op, **rec}))
    failures += energy_failures

    # 10-14. the served models at full width, each one's served runs'
    # launches counted from 0
    machine = G.GPUMachineModel.from_device(torch.device("cuda"))
    models, model_s = {}, {}
    phase_of = {"whisper-base": _whisper_phase, "xlstm-125m": _xlstm_phase}
    apart = ("runs", "attention", "loops", "summary", "device_split",
             "bf16_flash_tokens", "bf16_tokens")
    for number, name in MODEL_PHASES.items():
        t_path = time.perf_counter()
        model_failures, model = phase_of.get(name, _model_phase)(name, machine)
        model_s[name] = time.perf_counter() - t_path
        tag = {"phase": f"{number} model", "arch": name}
        print(json.dumps({k: v for k, v in model.items() if k not in apart}
                         | {"s": model_s[name]}))
        for key in apart:
            if key in model:
                print(json.dumps(tag | {key: model[key]}))
        failures += model_failures
        models[name] = model
        torch.cuda.empty_cache()

    # 15. training at full width, its main path's launches counted from 0
    t_path = time.perf_counter()
    train_failures, train = _train_phase(machine, calibrated)
    name = f"train {TRAIN_ARCH}"
    model_s[name] = time.perf_counter() - t_path
    tag = {"phase": "15 train", "arch": TRAIN_ARCH}
    apart = ("attention", "gates", "restart", "device_split", "eval",
             "optimizer", "summary")
    print(json.dumps({k: v for k, v in train.items() if k not in apart}
                     | {"s": model_s[name]}))
    for key in apart:
        print(json.dumps(tag | {key: train[key]}))
    failures += train_failures
    models[name] = train
    torch.cuda.empty_cache()

    # 16. the driver: the full-width run's step times (phase 15), the
    # restart and the one-rank NCCL mesh
    t_path = time.perf_counter()
    driver_failures, driver = _driver_phase(train)
    model_s["driver"] = time.perf_counter() - t_path
    print(json.dumps({"phase": "16 driver", "full_width": train["driver"]}
                     | driver | {"s": model_s["driver"]}))
    failures += driver_failures
    torch.cuda.empty_cache()

    # 17. the serving engine: its decode buckets on the split route, the
    # engine and its KV page store; the split and combine launches counted
    # from 0
    t_path = time.perf_counter()
    serve_failures, serve = _serve_phase(machine, calibrated)
    model_s["serve"] = time.perf_counter() - t_path
    tag = {"phase": "17 serve"}
    for name, rec in serve["dtypes"].items():
        print(json.dumps(tag | {"dtype": name} | {
            k: v for k, v in rec.items() if k != "points"}))
        for point in rec["points"]:
            print(json.dumps(tag | {"dtype": name} | point))
    print(json.dumps(tag | {k: v for k, v in serve.items() if k != "dtypes"}
                     | {"s": model_s["serve"]}))
    failures += serve_failures
    torch.cuda.empty_cache()

    # 18. the composed step against the card: host arithmetic over the
    # records of phases 6 and 10-17, no launch
    t_path = time.perf_counter()
    compose_failures, composed = _compose_phase(machine, calibrated, models,
                                                serve)
    model_s["compose"] = time.perf_counter() - t_path
    tag = {"phase": "18 compose"}
    for name, rec in composed["served"].items():
        print(json.dumps(tag | {"arch": name} | rec))
    for key in ("train", "brain", "eq2_decode"):
        print(json.dumps(tag | {key: composed[key]}))
    print(json.dumps(tag | {"card": composed["card"],
                            "elem_bytes": composed["elem_bytes"],
                            "tolerance": composed["tolerance"],
                            "failures": compose_failures,
                            "s": model_s["compose"]}))
    failures += compose_failures
    torch.cuda.empty_cache()

    # 19. the dry-run: fake CUDA traces in child processes against phases
    # 10-18's records, and the FLOP gate's prefill on the card
    dryrun_failures, dryrun = _dryrun_phase(calibrated, models, composed)
    model_s["dryrun"] = dryrun["s"]
    tag = {"phase": "19 dryrun"}
    print(json.dumps(tag | {"world_256": dryrun.pop("world", None)}))
    print(json.dumps(tag | dryrun | {"failures": dryrun_failures}))
    failures += dryrun_failures

    # 20. serving on a one-rank NCCL mesh and the dry-run's 256-rank
    # serving cells, its launches counted from 0
    mesh_failures, mesh_rec = _mesh_phase(models)
    model_s["mesh"] = mesh_rec["s"]
    print(json.dumps({"phase": "20 mesh"} | mesh_rec
                     | {"failures": mesh_failures}))
    failures += mesh_failures
    print(json.dumps({"phase_s": {
        "build": build_s, "calibrate": record["s"], "stream": stream_s,
        "stencil": stencil_s, "compute": compute_s, "scaling": scaling_s,
        "energy": energy_s, **{f"model {n}": t for n, t in model_s.items()}}}))

    # 21. the kernels line; the attention's launches add the power fit's,
    # the model phases', the serve phase's and the mesh phase's, the
    # combine's the serve phase's
    model_launches = {name: m["launches"]["flash_attention"]
                      for name, m in models.items()}
    mesh_launches = mesh_rec["launches"]["flash_attention"]
    power_launches = record["launches"]["flash_attention"]
    launches["flash_attention"] += power_launches \
        + sum(model_launches.values()) + serve["launches"]["flash_attention"] \
        + mesh_launches
    launches["flash_combine"] += serve["launches"]["flash_combine"]
    serve_points = [p for rec in serve["dtypes"].values() for p in rec["points"]]
    ops_of = {"map": [o for o in G.OPS if o in kernels.pipeline.MAP_OPS],
              "reduce": [o for o in G.OPS if o in kernels.pipeline.REDUCE_OPS]}
    rows = []
    for k in kernels.KERNELS:
        op, path, family, served = KERNEL_VIEW[k.name]
        if k is kernels.FLASH_COMBINE:
            rec = compute[op]["timings"]["combine"]
            checks = [rec["check"]] + [p["combine"]["check"] for p in serve_points]
            rec = rec | {"ms": {path: rec["ms"]}}
            where = {"op": op, "path": path, "dims": compute[op]["dims"],
                     "split_plan": compute[op]["timings"]["split_plan"],
                     "launches_by_path": {
                         "compute": launches[k.name]
                         - serve["launches"]["flash_combine"],
                         "serve decode buckets": serve["launches"]["flash_combine"]}}
        elif family == "compute":
            checks = [compute[pt]["check"] for pt in served]
            if k is kernels.FLASH_ATTENTION:
                checks += [c for p in serve_points for c in p["checks"].values()]
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
            serve_launches = serve["launches"]["flash_attention"]
            where["launches_by_path"] = {
                "compute": launches[k.name] - power_launches
                - sum(model_launches.values()) - serve_launches
                - mesh_launches,
                "calibrate (power fit)": power_launches,
                **{f"model {n}": v for n, v in model_launches.items()},
                "serve decode buckets": serve_launches,
                "serve on a mesh": mesh_launches}
            where["launches_by_route"] = {
                r: n + record["attention_launches_by_route"][r]
                + sum(m["attention_launches_by_route"][r]
                      for m in (*models.values(), mesh_rec))
                + serve["launches"]["flash_attention_by_route"][r]
                for r, n in attention_routes.items()}
            where["at_engine_buckets"] = {
                name: {key: rec["points"][-1][key] for key in (
                    "cb", "pick_bkv", "pick_rank", "ms", "plain_ms",
                    "library_ms", "bound_ms", "bound_share",
                    "measured_over_predicted")}
                for name, rec in serve["dtypes"].items()}
            where["at_model_shape"] = {
                name: {key: m["attention"][key] for key in (
                    "dims", "dtype", "block", "check", "ms", "plain_ms",
                    "library_ms", "sdpa_own_backend_gqa_ms", "bound_ms",
                    "bound_ms_ffma")} | {"launches": model_launches[name]}
                | {key: m["attention"][key] for key in ("causal", "f32")
                   if key in m["attention"]}
                for name, m in models.items() if "attention" in m}
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
    if sys.argv[1:2] == ["--cpu-gate-reference"]:
        sys.path.insert(0, str(SRC))
        sys.exit(_gate_cpu_side(sys.argv[2], smoke="--smoke" in sys.argv[3:]))
    if sys.argv[1:2] == ["--trace-cells"]:
        sys.path.insert(0, str(SRC))
        sys.exit(_trace_cells_child(sys.argv[2], int(sys.argv[3])))
    if sys.argv[1:2] == ["--mesh-cells"]:
        sys.path.insert(0, str(SRC))
        sys.exit(_mesh_cells_child(sys.argv[2], int(sys.argv[3])))
    sys.exit(main())
