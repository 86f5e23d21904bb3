"""Multi-buffered pipeline engine: the host contract and the two wrappers.

A copy of the reference's host contract (``repro/kernels/pipeline.py``):

* **Block shapes.**  Work is chunked along axis 0 of a ``(rows, 128)``
  stream.  The requested ``block_rows`` is shrunk by :func:`_fit_block`
  to the largest divisor of the rows, so odd and prime sizes stay exact;
  ``n_chunks = rows // block_rows``.
* **``num_stages``.**  Ring slots per input stream, capped at the chunk
  count: ``max(1, min(num_stages, n_chunks))``.  1 is a fully serial
  fetch -> compute -> store loop (the no-overlap bound, T_nOL + T_data);
  ``>= 2`` overlaps the next chunks' reads with compute (the full-overlap
  bound, max(T_data, T_OL)).  Depth is a pure performance knob: outputs
  are bit-identical across depths.

On the card the ring lives in shared memory, so its size is checked
against the card's per-block limit (:meth:`PipelineConfig.smem_bytes`):
a ring that does not fit raises, the block is never shrunk silently.
The map pipeline adds an output ring and one mbarrier per stage
(:meth:`PipelineConfig.map_out_slots`): two output slots where they fit
beside the input ring, else one; a ring with one output slot that does
not fit raises.

The wrappers :func:`map_pipeline` and :func:`reduce_pipeline` launch the
CUDA kernels of ``csrc/pipeline.cu`` on CUDA tensors; CPU tensors take
the plain versions in ``stream/ref.py`` one level up, in ``stream/ops.py``.

**The halo pipeline** (the stencils' engine, :func:`halo_pipeline`, kernel
in ``csrc/stencil.cu``) keeps the reference's axis-0 contract
(``halo_pipeline_call``): the padded input's axis 0 must be
``rows + 2*halo`` or it raises; the block is fitted and the depth capped
as above; chunk ``c`` reads padded rows ``[c*b, c*b + b + 2*halo)`` and
writes output rows ``[c*b, (c+1)*b)``.  A whole padded row or layer does
not fit in shared memory at the sizes the card runs (ten 2D rows of 8194
f32 are 320 KiB), so each chunk is also cut along the trailing dims into
tiles of :data:`HALO_TILE` outputs, each fetched with its own halo
(:func:`halo_plan`).  The ring of a tile is checked against the card's
shared memory and raises; neither block nor tile is shrunk to fit.  CPU
tensors take the stencils' plain versions in ``stencil/ops.py``.
"""
from __future__ import annotations

import ctypes
import math
from dataclasses import dataclass
from typing import NamedTuple

import torch

from . import _build

LANES = 128
#: bytes of one mbarrier in the map pipeline's shared memory
MBARRIER_BYTES = 8

#: elementwise ops the kernels compute: name -> (op code in
#: csrc/common.cuh, scalars, input streams)
MAP_OPS: dict[str, tuple[int, int, int]] = {
    "copy": (0, 0, 1),
    "store": (1, 1, 0),
    "update": (2, 1, 1),
    "striad": (3, 1, 2),
    "schoenauer": (4, 0, 3),
    "triad_update": (5, 2, 2),
}
#: reductions: name -> (code in csrc/common.cuh, input streams)
REDUCE_OPS: dict[str, tuple[int, int]] = {"load": (0, 1), "ddot": (1, 2)}

#: dtypes the kernels take, with their code in csrc/common.cuh
DTYPES: dict[torch.dtype, int] = {torch.float32: 0, torch.bfloat16: 1}


@dataclass(frozen=True)
class PipelineConfig:
    """Knobs of the software pipeline.

    ``num_stages``: ring slots per stream (pipeline depth).
    ``block_rows``: rows of 128 lanes per chunk.
    """

    num_stages: int = 2
    block_rows: int = 64

    def vmem_bytes(self, n_streams: int, elem_bytes: int = 4) -> int:
        return (self.num_stages * n_streams
                * self.block_rows * LANES * elem_bytes)

    def ring_bytes(self, n_streams: int, elem_bytes: int = 4,
                   out_slots: int = 0) -> int:
        """Shared memory of one CTA: a slot per stage per input stream,
        then, for a kernel with an output ring (``out_slots > 0``, the map
        pipeline), ``out_slots`` output slots and one 8-byte mbarrier per
        stage (``csrc/pipeline.cu`` ``make_args``)."""
        slot = self.block_rows * LANES * elem_bytes
        extra = out_slots * slot + MBARRIER_BYTES * self.num_stages if out_slots else 0
        return self.vmem_bytes(n_streams, elem_bytes) + extra

    def smem_bytes(self, n_streams: int, elem_bytes: int = 4, *,
                   limit: int, out_slots: int = 0) -> int:
        """:meth:`ring_bytes`; raises ``ValueError`` when it exceeds
        ``limit``, the card's per-block opt-in maximum."""
        nbytes = self.ring_bytes(n_streams, elem_bytes, out_slots)
        if nbytes > limit:
            ring = f" and {out_slots} output slot(s)" if out_slots else ""
            raise ValueError(
                f"a {self.num_stages}-deep ring of {self.block_rows}-row "
                f"blocks for {n_streams} streams{ring} needs {nbytes} B of "
                f"shared memory, over the {limit} B a block may use; pass a "
                f"smaller block_rows or num_stages")
        return nbytes

    def map_out_slots(self, n_streams: int, elem_bytes: int = 4, *,
                      limit: int) -> int:
        """Output slots of the map pipeline: 1 for a generator (``store``
        fills its one slot once), else 2 where two fit beside the input
        ring, else 1.  Two let one barrier a chunk publish a slot while
        the other is still read by its bulk store; one costs a second
        barrier.  Schoenauer's 64-row depth-2 ring (192 KiB) leaves room
        for one 32 KiB slot only."""
        if n_streams == 0 or self.ring_bytes(n_streams, elem_bytes, 2) > limit:
            return 1
        return 2


def _fit_block(n_rows: int, block_rows: int) -> int:
    """Largest divisor of ``n_rows`` that is <= the requested block."""
    b = max(1, min(block_rows, n_rows))
    while n_rows % b:
        b -= 1
    return b


def _scal(s: float, dtype: torch.dtype) -> float:
    """``s`` rounded to ``dtype``, as the reference casts its scalars."""
    return float(torch.tensor(s, dtype=dtype))


def _ptr(x: torch.Tensor | None) -> int | None:
    return None if x is None else x.data_ptr()


def check_aligned(ins) -> None:
    """Raise ``ValueError`` unless every tensor starts on a 16-byte
    boundary.  The stream kernels read 16-byte vectors and move data by
    bulk copies, which need 16-byte addresses; a view at an odd element
    offset would otherwise fault on the card, which ends the CUDA
    context."""
    for x in ins:
        if x.data_ptr() % 16:
            raise ValueError(
                f"expected a tensor starting on a 16-byte boundary, "
                f"got one at address {x.data_ptr():#x} (storage offset "
                f"{x.storage_offset()})")


def check_streams(ins, *, rows: int, dtype: torch.dtype,
                  device: torch.device) -> None:
    """Raise ``ValueError`` unless every input is a contiguous CUDA
    ``(rows, 128)`` tensor of ``dtype`` on ``device``, in a dtype the
    kernels take, starting on a 16-byte boundary."""
    if device.type != "cuda":
        raise ValueError(f"the CUDA kernels take CUDA tensors, got {device}")
    if dtype not in DTYPES:
        raise ValueError(f"the CUDA kernels take {list(DTYPES)}, got {dtype}")
    for x in ins:
        if (x.shape != (rows, LANES) or x.dtype != dtype
                or x.device != device or not x.is_contiguous()):
            raise ValueError(
                f"expected a contiguous ({rows}, {LANES}) {dtype} tensor on "
                f"{device}, got {tuple(x.shape)} {x.dtype} on {x.device}")
    check_aligned(ins)


def chunking(rows: int, block_rows: int, num_stages: int
             ) -> tuple[int, int, int]:
    """``(block_rows, n_chunks, stages)``: the block fitted to the rows
    and the depth capped at the chunk count, as the reference's builders
    do."""
    block = _fit_block(rows, block_rows)
    n_chunks = rows // block
    return block, n_chunks, max(1, min(num_stages, n_chunks))


class Plan(NamedTuple):
    """Launch geometry of one pipelined call."""

    block_rows: int
    n_chunks: int
    stages: int
    ctas: int
    #: output-ring slots (map pipeline), 0 for a reduction
    out_slots: int


def plan(rows: int, *, block_rows: int, num_stages: int, n_in: int,
         dtype: torch.dtype, device: torch.device,
         ctas: int | None = None, map_op: str | None = None) -> Plan:
    """Launch geometry of one pipelined call after :func:`chunking`:
    the ring checked against the card's shared memory, with the map
    pipeline's output ring where ``map_op`` names a map op (a reduction
    has none), and a persistent grid of ``ctas`` CTAs or, by default,
    ``min(n_chunks, SMs)`` for a reduction and, for the map,
    ``min(n_chunks, SMs x the CTAs an SM holds (:func:`map_ctas_per_sm`),
    max(SMs, ceil(n_chunks / stages)))``: one CTA an SM, then every ring
    the SMs hold as long as each still gets as many chunks as it has
    slots."""
    block, n_chunks, stages = chunking(rows, block_rows, num_stages)
    props = torch.cuda.get_device_properties(device)
    limit = props.shared_memory_per_block_optin
    cfg, eb = PipelineConfig(stages, block), torch.finfo(dtype).bits // 8
    out_slots = 0 if map_op is None else cfg.map_out_slots(n_in, eb, limit=limit)
    cfg.smem_bytes(n_in, eb, limit=limit, out_slots=out_slots)
    sms = props.multi_processor_count
    if ctas is not None:
        grid = ctas
    elif map_op is None:
        grid = min(n_chunks, sms)
    else:
        per_sm = map_ctas_per_sm(MAP_OPS[map_op][0], dtype, block, stages, out_slots)
        grid = min(n_chunks, sms * per_sm, max(sms, -(-n_chunks // stages)))
    if not 1 <= grid <= n_chunks:
        raise ValueError(f"ctas must lie in [1, {n_chunks}], got {grid}")
    return Plan(block, n_chunks, stages, grid, out_slots)


_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_F = ctypes.c_float

MAP_PIPELINE = _build.Kernel(
    "map_pipeline", "pipeline", "rt_map_pipeline",
    [_I, _I, _P, _P, _P, _P, _F, _F, _LL, _I, _I, _I, _I, _P],
    replaces="src/repro/kernels/pipeline.py:234")
REDUCE_PIPELINE = _build.Kernel(
    "reduce_pipeline", "pipeline", "rt_reduce_pipeline",
    [_I, _I, _P, _P, _P, _P, _LL, _I, _I, _I, _P],
    replaces="src/repro/kernels/pipeline.py:258")


_OCCUPANCY: dict[tuple, int] = {}


def map_ctas_per_sm(code: int, dtype: torch.dtype, block_rows: int,
                    stages: int, out_slots: int) -> int:
    """How many map-pipeline CTAs one SM holds at once (the CUDA occupancy
    query on the compiled kernel, at the launch's shared memory)."""
    key = (code, dtype, block_rows, stages, out_slots)
    if key not in _OCCUPANCY:
        fn = _build.library("pipeline").rt_map_pipeline_occupancy
        fn.argtypes = [_I, _I, _I, _I, _I, ctypes.POINTER(_I)]
        fn.restype = _I
        n = _I(0)
        rc = fn(code, DTYPES[dtype], block_rows, stages, out_slots,
                ctypes.byref(n))
        if rc != 0 or n.value < 1:
            raise RuntimeError(f"rt_map_pipeline_occupancy: error {rc}, "
                               f"{n.value} CTAs an SM")
        _OCCUPANCY[key] = n.value
    return _OCCUPANCY[key]


def map_pipeline(op: str, scalars: tuple, ins: tuple, *, rows: int,
                 dtype: torch.dtype, device: torch.device, num_stages: int,
                 block_rows: int, ctas: int | None = None) -> torch.Tensor:
    """Launch the pipelined map ``op`` (a key of :data:`MAP_OPS`) on
    ``(rows, 128)`` CUDA streams; returns a new ``(rows, 128)`` tensor.

    ``ctas`` pins the persistent grid (the one-SM overlap pair uses 1);
    by default it is every CTA the SMs hold at once, as long as each gets
    as many chunks as its ring has slots, and at least one an SM
    (:func:`plan`).
    """
    code, n_scalars, n_in = MAP_OPS[op]
    if len(scalars) != n_scalars or len(ins) != n_in:
        raise ValueError(f"{op} takes {n_scalars} scalars and {n_in} streams")
    check_streams(ins, rows=rows, dtype=dtype, device=device)
    p = plan(rows, block_rows=block_rows, num_stages=num_stages, n_in=n_in,
             dtype=dtype, device=device, ctas=ctas, map_op=op)
    out = torch.empty((rows, LANES), dtype=dtype, device=device)
    s, t = [_scal(v, dtype) for v in scalars] + [0.0] * (2 - n_scalars)
    x, y, z = list(ins) + [None] * (3 - n_in)
    MAP_PIPELINE.launch(code, DTYPES[dtype], _ptr(x), _ptr(y), _ptr(z),
                        out.data_ptr(), s, t, p.n_chunks, p.block_rows,
                        p.stages, p.out_slots, p.ctas,
                        torch.cuda.current_stream(device).cuda_stream)
    return out


def reduce_pipeline(op: str, ins: tuple, *, num_stages: int,
                    block_rows: int) -> torch.Tensor:
    """Launch the pipelined reduction ``op`` (``load`` or ``ddot``) on
    ``(rows, 128)`` CUDA streams; returns the ``(1, 1)`` f32 sum."""
    code, n_in = REDUCE_OPS[op]
    if len(ins) != n_in:
        raise ValueError(f"{op} takes {n_in} streams")
    rows, dtype, device = ins[0].shape[0], ins[0].dtype, ins[0].device
    check_streams(ins, rows=rows, dtype=dtype, device=device)
    p = plan(rows, block_rows=block_rows, num_stages=num_stages, n_in=n_in,
             dtype=dtype, device=device)
    partial = torch.empty(p.ctas, dtype=torch.float32, device=device)
    out = torch.empty((1, 1), dtype=torch.float32, device=device)
    x, y = list(ins) + [None] * (2 - n_in)
    REDUCE_PIPELINE.launch(code, DTYPES[dtype], _ptr(x), _ptr(y),
                           partial.data_ptr(), out.data_ptr(), p.n_chunks,
                           p.block_rows, p.stages, p.ctas,
                           torch.cuda.current_stream(device).cuda_stream)
    return out


#: halo width of the stencils' pipeline: one point on every side
HALO = 1
#: trailing-dim tile of a halo-pipeline chunk, in output points: (1, w)
#: for a 2D strip, (h, w) for a 3D patch, each the 1024 points of the
#: kernel's 1024 threads.  A 3D slot of 8 + 2 layers of 18 x 66 f32 is
#: 47,520 B and a 2D one of 10 rows of 1026 is 41,040 B, so a depth-3 ring
#: at the reference's 8-row block fits in 227 KB.
HALO_TILE = {2: (1, 1024), 3: (16, 64)}


@dataclass(frozen=True)
class HaloPlan:
    """Geometry of one halo-pipeline call.

    ``tile`` is ``(tile_h, tile_w)`` (``tile_h == 1`` in 2D), cut to the
    array where it is narrower; ``tiles_x`` the tiles along the last axis
    and ``tiles`` those of one axis-0 chunk; ``pitch`` the elements of a
    slot row (the tile's width plus its halo, plus room for bf16's word
    alignment); ``lines`` the slot rows per axis-0 row; ``n_items`` the
    chunks times ``tiles``; ``smem_bytes`` the ring.  The kernel takes
    all of it as given.
    """

    block: int
    n_chunks: int
    stages: int
    tile: tuple[int, int]
    tiles_x: int
    tiles: int
    pitch: int
    lines: int
    n_items: int
    smem_bytes: int


def halo_plan(in_shape, out_shape, dtype: torch.dtype, *, num_stages: int,
              block_rows: int, smem_limit: int) -> HaloPlan:
    """The chunks, tiles and ring of a halo-pipeline call over a padded
    input of ``in_shape`` into ``out_shape`` (2D or 3D).  Raises
    ``ValueError`` on an input that is not padded by :data:`HALO` on
    every side, and on a ring over ``smem_limit`` bytes."""
    rows = out_shape[0]
    if in_shape[0] != rows + 2 * HALO:
        raise ValueError(
            f"padded input axis 0 must be rows + 2*halo = {rows + 2*HALO}, "
            f"got {in_shape[0]}")
    want = tuple(d + 2 * HALO for d in out_shape[1:])
    if len(out_shape) not in HALO_TILE or tuple(in_shape[1:]) != want:
        raise ValueError(
            f"the stencils take a 2D or 3D output and an input padded by "
            f"{HALO} on every side: trailing dims {want}, got "
            f"{tuple(in_shape[1:])} for output {tuple(out_shape)}")
    block, n_chunks, stages = chunking(rows, block_rows, num_stages)
    dim = len(out_shape)
    height = out_shape[1] if dim == 3 else 1
    width = out_shape[-1]
    th, tw = (min(t, n) for t, n in zip(HALO_TILE[dim], (height, width)))
    elem_bytes = torch.finfo(dtype).bits // 8
    # bf16 rows are copied in 4-byte words from an even element: room for
    # a shift of one element, and an even pitch so every row is aligned
    pitch = tw + 2 * HALO if elem_bytes == 4 else (tw + 2 * HALO + 2) & ~1
    lines = th + 2 * HALO if dim == 3 else 1
    # the ring: a slot per stage, each b + 2 axis-0 rows of `lines` rows
    smem = stages * (block + 2 * HALO) * lines * pitch * elem_bytes
    if smem > smem_limit:
        raise ValueError(
            f"a {stages}-deep halo ring of {block}-row blocks in "
            f"{th} x {tw} tiles needs {smem} B of shared memory, over the "
            f"{smem_limit} B a block may use; pass a smaller block_rows or "
            f"num_stages")
    tiles_x = math.ceil(width / tw)
    tiles = math.ceil(height / th) * tiles_x
    return HaloPlan(block, n_chunks, stages, (th, tw), tiles_x, tiles, pitch,
                    lines, n_chunks * tiles, smem)


HALO_PIPELINE = _build.Kernel(
    "halo_pipeline", "stencil", "rt_halo_pipeline",
    [_I, _I, _P, _P, _F, _F, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I,
     _LL, _I, _LL, _P],
    replaces="src/repro/kernels/pipeline.py:356")


def check_grid(p: torch.Tensor) -> None:
    """Raise ``ValueError`` unless ``p`` is a contiguous CUDA tensor of a
    dtype the kernels take, 2D or 3D, starting on a 4-byte boundary."""
    if p.device.type != "cuda":
        raise ValueError(f"the CUDA kernels take CUDA tensors, got {p.device}")
    if p.dtype not in DTYPES:
        raise ValueError(f"the CUDA kernels take {list(DTYPES)}, got {p.dtype}")
    if p.dim() not in HALO_TILE or not p.is_contiguous() or p.data_ptr() % 4:
        raise ValueError(f"expected a contiguous, 4-byte aligned 2D or 3D "
                         f"tensor, got {tuple(p.shape)} with strides "
                         f"{p.stride()}")


def check_dense(*ts: torch.Tensor) -> None:
    """Raise ``ValueError`` unless every tensor is a contiguous CUDA tensor
    of one dtype the kernels take, starting on a 16-byte boundary (the
    matmul and attention kernels load 16 bytes a thread)."""
    for t in ts:
        if t.device.type != "cuda":
            raise ValueError(f"the CUDA kernels take CUDA tensors, got {t.device}")
        if t.dtype not in DTYPES or t.dtype != ts[0].dtype:
            raise ValueError(f"the CUDA kernels take operands of one dtype of "
                             f"{list(DTYPES)}, got {[u.dtype for u in ts]}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"expected contiguous, 16-byte aligned operands, "
                             f"got {tuple(t.shape)} with strides {t.stride()}")


def halo_pipeline(p: torch.Tensor, *, out_shape: tuple, c0: float, c1: float,
                  num_stages: int, block_rows: int,
                  ctas: int | None = None) -> torch.Tensor:
    """Launch the Jacobi sweep of the padded CUDA array ``p`` (5-point in
    2D, 7-point in 3D) through the halo pipeline; returns a new tensor of
    ``out_shape``.

    ``ctas`` pins the persistent grid (the one-SM overlap pair uses 1);
    by default it is ``min(n_items, SMs)``.
    """
    check_grid(p)
    props = torch.cuda.get_device_properties(p.device)
    plan = halo_plan(tuple(p.shape), tuple(out_shape), p.dtype,
                     num_stages=num_stages, block_rows=block_rows,
                     smem_limit=props.shared_memory_per_block_optin)
    grid = min(plan.n_items, props.multi_processor_count) if ctas is None else ctas
    if not 1 <= grid <= plan.n_items:
        raise ValueError(f"ctas must lie in [1, {plan.n_items}], got {grid}")
    dim = len(out_shape)
    height = out_shape[1] if dim == 3 else 1
    out = torch.empty(tuple(out_shape), dtype=p.dtype, device=p.device)
    HALO_PIPELINE.launch(
        dim, DTYPES[p.dtype], p.data_ptr(), out.data_ptr(),
        _scal(c0, p.dtype), _scal(c1, p.dtype), out_shape[0], height,
        out_shape[-1], plan.block, plan.stages, *plan.tile, plan.tiles_x,
        plan.tiles, plan.pitch, plan.lines, plan.n_items, grid,
        plan.smem_bytes, torch.cuda.current_stream(p.device).cuda_stream)
    return out
