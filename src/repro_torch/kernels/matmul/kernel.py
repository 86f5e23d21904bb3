"""Wrapper of the blocked matmul kernel (``csrc/matmul.cu`` ``rt_matmul``).

The counterpart of the reference's ``matmul_call``
(``repro/kernels/matmul/kernel.py``): one CTA per ``bm x bn`` output
tile, with the K loop inside the CTA in place of the TPU's sequential K
grid axis, and ``bk`` the depth of one shared-memory stage (the K extent
the TPU copies into VMEM per grid step).  The kernel is compiled for the
tilings in :data:`TILINGS` only; any other raises, as does a tiling whose
panels exceed the card's shared memory.  The wrapper takes CUDA tensors
only; CPU tensors take the plain version in ``ref.py``, chosen in
``ops.py``.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build
from ..pipeline import DTYPES, check_dense

#: (bm, bn, bk) the kernel is compiled for, in the order ``rank`` breaks
#: ties in (csrc/matmul.cu rt_matmul holds the same list)
TILINGS = tuple((bm, bn, bk) for bk in (16, 128) for bm in (64, 128)
                for bn in (64, 128))
DEFAULT_BM = 128
DEFAULT_BN = 128
DEFAULT_BK = 16
_GRID_MAX = 65535

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong

MATMUL = _build.Kernel(
    "matmul", "matmul", "rt_matmul",
    [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _LL, _P],
    replaces="src/repro/kernels/matmul/kernel.py:37")


def smem_bytes(bm: int, bn: int, bk: int) -> int:
    """Shared memory of one stage: the ``bm x bk`` and ``bk x bn`` panels,
    in f32 whatever the input dtype."""
    return (bm + bn) * bk * 4


def check_tiling(bm: int, bn: int, bk: int, smem_limit: int) -> int:
    """The tiling's shared memory in bytes; raises ``ValueError`` if it is
    over ``smem_limit`` or the kernel is not compiled for the tiling."""
    smem = smem_bytes(bm, bn, bk)
    if smem > smem_limit:
        raise ValueError(f"a {bm} x {bn} x {bk} matmul tiling needs {smem} B "
                         f"of shared memory, over the {smem_limit} B a block "
                         f"may use")
    if (bm, bn, bk) not in TILINGS:
        raise ValueError(f"the matmul kernel is compiled for the (bm, bn, bk) "
                         f"tilings {TILINGS}, not {(bm, bn, bk)}")
    return smem


def matmul_tiled(x: torch.Tensor, y: torch.Tensor, *, bm: int, bn: int,
                 bk: int, out_dtype: torch.dtype) -> torch.Tensor:
    """Launch ``x (m, k) @ y (k, n)`` on CUDA tensors in ``bm x bn`` tiles,
    ``bk`` deep; returns a new ``(m, n)`` tensor of ``out_dtype``."""
    check_dense(x, y)
    if x.dim() != 2 or y.dim() != 2 or x.shape[1] != y.shape[0]:
        raise ValueError(f"cannot multiply {tuple(x.shape)} by {tuple(y.shape)}")
    (m, k), n = x.shape, y.shape[1]
    if m % bm or n % bn or k % bk:
        raise ValueError(f"blocks {(bm, bn, bk)} do not divide {(m, n, k)}")
    if out_dtype not in DTYPES:
        raise ValueError(f"the matmul kernel writes {list(DTYPES)}, not {out_dtype}")
    if m // bm > _GRID_MAX:
        raise ValueError(f"{m // bm} row tiles exceed the launch grid")
    props = torch.cuda.get_device_properties(x.device)
    smem = check_tiling(bm, bn, bk, props.shared_memory_per_block_optin)
    out = torch.empty((m, n), dtype=out_dtype, device=x.device)
    MATMUL.launch(x.data_ptr(), y.data_ptr(), out.data_ptr(), m, n, k, bm, bn,
                  bk, DTYPES[x.dtype], DTYPES[out_dtype], smem,
                  torch.cuda.current_stream(x.device).cuda_stream)
    return out
