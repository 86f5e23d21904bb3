"""Wrappers of the grid stream kernels (``csrc/stream.cu``).

One CTA per ``(block_rows, 128)`` block, the reference's one block per
grid step (``repro/kernels/stream/kernel.py``); the map kernel moves its
block through shared memory by TMA bulk copies, in pieces of 16 rows,
four in flight.  The wrappers take CUDA tensors only; CPU tensors take
the plain versions in ``ref.py``, chosen in ``ops.py``.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build
from ..pipeline import (DTYPES, LANES, MAP_OPS, REDUCE_OPS, _fit_block, _ptr,
                        _scal, check_streams)

BLOCK_ROWS = 64
BLOCK_COLS = LANES

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_F = ctypes.c_float

GRID_MAP = _build.Kernel(
    "grid_map", "stream", "rt_grid_map",
    [_I, _I, _P, _P, _P, _P, _F, _F, _LL, _I, _P],
    replaces="src/repro/kernels/stream/kernel.py:102")
GRID_REDUCE = _build.Kernel(
    "grid_reduce", "stream", "rt_grid_reduce",
    [_I, _I, _P, _P, _P, _P, _LL, _I, _P],
    replaces="src/repro/kernels/stream/kernel.py:150")


def grid_map(op: str, scalars: tuple, ins: tuple, *, rows: int,
             dtype: torch.dtype, device: torch.device,
             block_rows: int) -> torch.Tensor:
    """Launch the grid map ``op`` (a key of ``pipeline.MAP_OPS``) over
    ``(rows, 128)`` CUDA streams; returns a new ``(rows, 128)`` tensor."""
    code, n_scalars, n_in = MAP_OPS[op]
    if len(scalars) != n_scalars or len(ins) != n_in:
        raise ValueError(f"{op} takes {n_scalars} scalars and {n_in} streams")
    check_streams(ins, rows=rows, dtype=dtype, device=device)
    block = _fit_block(rows, block_rows)
    out = torch.empty((rows, LANES), dtype=dtype, device=device)
    s, t = [_scal(v, dtype) for v in scalars] + [0.0] * (2 - n_scalars)
    x, y, z = list(ins) + [None] * (3 - n_in)
    GRID_MAP.launch(code, DTYPES[dtype], _ptr(x), _ptr(y), _ptr(z),
                    out.data_ptr(), s, t, rows // block, block,
                    torch.cuda.current_stream(device).cuda_stream)
    return out


def grid_reduce(op: str, ins: tuple, *, block_rows: int) -> torch.Tensor:
    """Launch the grid reduction ``op`` (``load`` or ``ddot``) over
    ``(rows, 128)`` CUDA streams; returns the ``(1, 1)`` f32 sum."""
    code, n_in = REDUCE_OPS[op]
    if len(ins) != n_in:
        raise ValueError(f"{op} takes {n_in} streams")
    rows, dtype, device = ins[0].shape[0], ins[0].dtype, ins[0].device
    check_streams(ins, rows=rows, dtype=dtype, device=device)
    block = _fit_block(rows, block_rows)
    partial = torch.empty(rows // block, dtype=torch.float32, device=device)
    out = torch.empty((1, 1), dtype=torch.float32, device=device)
    x, y = list(ins) + [None] * (2 - n_in)
    GRID_REDUCE.launch(code, DTYPES[dtype], _ptr(x), _ptr(y),
                       partial.data_ptr(), out.data_ptr(), rows // block, block,
                       torch.cuda.current_stream(device).cuda_stream)
    return out
