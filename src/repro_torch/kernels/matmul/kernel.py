"""Wrapper of the blocked matmul kernel (``csrc/matmul.cu`` ``rt_matmul``).

The counterpart of the reference's ``matmul_call``
(``repro/kernels/matmul/kernel.py``): one CTA per ``bm x bn`` output
tile, with the K loop inside the CTA in place of the TPU's sequential K
grid axis, and ``bk`` the depth of one shared-memory stage (the K extent
the TPU copies into VMEM per grid step).  One C entry has two routes,
chosen by the input dtype:

* ``"ffma"`` (f32): a ring of :data:`FFMA_STAGES` ``cp.async`` stages
  (A transposed on the way, its rows padded by :data:`FFMA_A_PAD`
  floats) feeding a register tile on the FP32 units;
* ``"wgmma"`` (bf16): a ring of :data:`WGMMA_STAGES` TMA stages, 128-byte
  swizzled, feeding ``wgmma`` on the tensor cores; ``bk`` is 64 (one
  128-byte swizzle row of bf16).

Each route is compiled for the tilings in its :data:`TILINGS` entry only;
any other raises, as does a tiling whose ring exceeds the card's shared
memory.  :func:`plan` is the one host description of a launch (stages,
boxes, swizzle, threads, shared bytes with the alignment slack), and the
C entry checks the shared bytes against its own layout.  The wrapper
takes CUDA tensors only; CPU tensors take the plain version in
``ref.py``, chosen in ``ops.py``.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from .. import _build
from ..pipeline import DTYPES, check_dense

#: the route of each input dtype
ROUTES = {torch.float32: "ffma", torch.bfloat16: "wgmma"}
#: (bm, bn, bk) each route is compiled for, in the order ``rank`` breaks
#: ties in (csrc/matmul.cu rt_matmul holds the same lists)
TILINGS = {
    "ffma": tuple((bm, bn, bk) for bk in (32, 16) for bm in (64, 128)
                  for bn in (64, 128, 256)),
    "wgmma": ((64, 128, 64), (128, 128, 64), (128, 256, 64)),
}
#: a compiled (bm, bn, bk) of each route that divides the reference's test
#: shapes: the output tiling ``ops.matmul_workload`` models by default
DEFAULTS = {"ffma": (128, 128, 16), "wgmma": (128, 128, 64)}
FFMA_STAGES = 3
FFMA_THREADS = 256
#: floats after each k-row of the FFMA route's transposed A panel
FFMA_A_PAD = 4
WGMMA_STAGES = 4
#: bytes of one swizzle row, the widest inner box dimension under it
SWIZZLE_BYTES = 128
#: the swizzled ring's base is aligned by hand to this, inside the
#: dynamic shared memory (promised 16-byte alignment only)
WGMMA_SLACK = 1024
_GRID_MAX = 65535

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong

MATMUL = _build.Kernel(
    "matmul", "matmul", "rt_matmul",
    [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _LL, _P],
    replaces="src/repro/kernels/matmul/kernel.py:37",
    routes=tuple(TILINGS))


@dataclass(frozen=True)
class Plan:
    """One route's launch of one tiling, as ``csrc/matmul.cu`` lays it out.

    ``boxes``: the ``(rows, cols)`` TMA boxes of one stage, A's first then
    B's (none on the FFMA route, whose threads copy 16 bytes each);
    ``swizzle``: the shared-memory swizzle in bytes (0: none);
    ``stage_bytes``: one stage of the ring; ``slack``: bytes reserved to
    align the ring; ``smem_bytes``: the dynamic shared memory of the
    launch (slack, ring, and the wgmma route's two mbarriers a stage)."""

    route: str
    block: tuple[int, int, int]
    stages: int
    threads: int
    boxes: tuple[tuple[int, int], ...]
    swizzle: int
    stage_bytes: int
    slack: int
    smem_bytes: int


def route_of(dtype: torch.dtype) -> str:
    if dtype not in ROUTES:
        raise ValueError(f"the matmul kernel takes {list(ROUTES)}, not {dtype}")
    return ROUTES[dtype]


def plan(bm: int, bn: int, bk: int, dtype: torch.dtype) -> Plan:
    """The launch of ``(bm, bn, bk)`` on ``dtype``'s route; the layout is
    computed for any tiling (``check_tiling`` says whether it is
    compiled)."""
    route = route_of(dtype)
    if route == "ffma":
        stage = (bm + FFMA_A_PAD + bn) * bk * 4
        return Plan(route, (bm, bn, bk), FFMA_STAGES, FFMA_THREADS, (), 0,
                    stage, 0, FFMA_STAGES * stage)
    # A: one bm x bk box; B: bn / 64 boxes of bk x 64 (128 bytes wide)
    cols = SWIZZLE_BYTES // 2
    boxes = ((bm, bk),) + ((bk, cols),) * -(-bn // cols)
    stage = (bm + bn) * bk * 2
    barriers = 2 * WGMMA_STAGES * 8
    return Plan(route, (bm, bn, bk), WGMMA_STAGES, 128 * (bm // 64 + 1),
                boxes, SWIZZLE_BYTES, stage, WGMMA_SLACK,
                WGMMA_SLACK + WGMMA_STAGES * stage + barriers)


def compiled_depth(bm: int, bn: int, bk: int, dtype: torch.dtype) -> int:
    """The stage depth that runs a ``(bm, bn, bk)`` request on ``dtype``'s
    route: ``bk`` where the tiling is compiled, else the largest compiled
    depth of ``(bm, bn)`` that divides ``bk``, else ``bk`` as asked (and
    :func:`check_tiling` says why it does not launch).

    ``bk`` moves no device-memory traffic: it is the depth of one stage
    of the ring, and both routes add each output's products in k order,
    one at a time on FFMA and 16 deep inside ``wgmma``.  So the f32 route
    gives the same bits at ``bk`` and at the depth it maps to."""
    depths = [t[2] for t in TILINGS[route_of(dtype)] if t[:2] == (bm, bn)]
    if bk in depths:
        return bk
    return max((d for d in depths if bk % d == 0), default=bk)


def smem_bytes(bm: int, bn: int, bk: int, dtype: torch.dtype) -> int:
    """The shared memory of a launch of the tiling on ``dtype``'s route."""
    return plan(bm, bn, bk, dtype).smem_bytes


def check_tiling(bm: int, bn: int, bk: int, smem_limit: int,
                 dtype: torch.dtype) -> int:
    """The tiling's shared memory in bytes; raises ``ValueError`` if it is
    over ``smem_limit`` or ``dtype``'s route is not compiled for it."""
    p = plan(bm, bn, bk, dtype)
    if p.smem_bytes > smem_limit:
        raise ValueError(f"a {bm} x {bn} x {bk} {p.route} matmul tiling needs "
                         f"{p.smem_bytes} B of shared memory, over the "
                         f"{smem_limit} B a block may use")
    if (bm, bn, bk) not in TILINGS[p.route]:
        raise ValueError(f"the matmul kernel's {p.route} route ({dtype}) is "
                         f"compiled for the (bm, bn, bk) tilings "
                         f"{TILINGS[p.route]}, not {(bm, bn, bk)}")
    return p.smem_bytes


def check_operands(x: torch.Tensor, y: torch.Tensor, *, bm: int, bn: int,
                   bk: int, smem_limit: int) -> Plan:
    """Everything the kernel requires of its operands and tiling, short of
    the device: shapes, alignment (TMA: 16-byte bases and rows, so bf16
    ``k`` and ``n`` multiples of 8), dividing blocks, the grid, and a
    compiled tiling that fits ``smem_limit``.  Returns the plan."""
    if x.dim() != 2 or y.dim() != 2 or x.shape[1] != y.shape[0]:
        raise ValueError(f"cannot multiply {tuple(x.shape)} by {tuple(y.shape)}")
    if x.dtype != y.dtype:
        raise ValueError(f"operands of one dtype, got {x.dtype} and {y.dtype}")
    (m, k), n = x.shape, y.shape[1]
    vec = 16 // x.element_size()
    if k % vec or n % vec:
        raise ValueError(f"rows of 16-byte multiples: k and n must be "
                         f"multiples of {vec} in {x.dtype}, got k={k}, n={n}")
    for t in (x, y):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"expected contiguous, 16-byte aligned operands, "
                             f"got {tuple(t.shape)} with strides {t.stride()} "
                             f"at {t.data_ptr() % 16} B past a 16-byte boundary")
    if m % bm or n % bn or k % bk:
        raise ValueError(f"blocks {(bm, bn, bk)} do not divide {(m, n, k)}")
    if m // bm > _GRID_MAX:
        raise ValueError(f"{m // bm} row tiles exceed the launch grid")
    check_tiling(bm, bn, bk, smem_limit, x.dtype)
    return plan(bm, bn, bk, x.dtype)


def matmul_tiled(x: torch.Tensor, y: torch.Tensor, *, bm: int, bn: int,
                 bk: int, out_dtype: torch.dtype) -> torch.Tensor:
    """Launch ``x (m, k) @ y (k, n)`` on CUDA tensors in ``bm x bn`` tiles,
    ``bk`` deep, on the route of ``x.dtype``; returns a new ``(m, n)``
    tensor of ``out_dtype``."""
    check_dense(x, y)
    if out_dtype not in DTYPES:
        raise ValueError(f"the matmul kernel writes {list(DTYPES)}, not {out_dtype}")
    props = torch.cuda.get_device_properties(x.device)
    p = check_operands(x, y, bm=bm, bn=bn, bk=bk,
                       smem_limit=props.shared_memory_per_block_optin)
    (m, k), n = x.shape, y.shape[1]
    out = torch.empty((m, n), dtype=out_dtype, device=x.device)
    MATMUL.launch(x.data_ptr(), y.data_ptr(), out.data_ptr(), m, n, k, bm, bn,
                  bk, DTYPES[x.dtype], DTYPES[out_dtype], p.smem_bytes,
                  torch.cuda.current_stream(x.device).cuda_stream,
                  route=p.route)
    return out
