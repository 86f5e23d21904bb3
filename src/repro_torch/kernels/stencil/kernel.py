"""Wrappers of the whole-array Jacobi kernels (``csrc/stencil.cu``).

The counterparts of the reference's ``jacobi2d_call`` and
``jacobi3d_call`` (``repro/kernels/stencil/kernel.py``), the
``num_stages=None`` path: one thread per output point over the whole
padded array.  On the TPU that path holds the whole array in VMEM and
serves validation sizes; here it runs at any size.  The wrappers take
CUDA tensors only; CPU tensors take the plain versions in ``ref.py``,
chosen in ``ops.py``.  The pipelined path is ``pipeline.halo_pipeline``.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build
from ..pipeline import DTYPES, _scal, check_grid

#: default pipeline chunk: 8 rows (2D) / 8 layers (3D), the reference's
BLOCK_ROWS = 8
#: blocks of the whole-array kernels: 32 x 8 threads (csrc/stencil.cu)
_TY = 8
_GRID_MAX = 65535

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

JACOBI2D_GRID = _build.Kernel(
    "jacobi2d_grid", "stencil", "rt_jacobi2d_grid",
    [_I, _P, _P, _F, _F, _I, _I, _P],
    replaces="src/repro/kernels/stencil/kernel.py:97")
JACOBI3D_GRID = _build.Kernel(
    "jacobi3d_grid", "stencil", "rt_jacobi3d_grid",
    [_I, _P, _P, _F, _F, _I, _I, _I, _P],
    replaces="src/repro/kernels/stencil/kernel.py:108")


def _launch(kernel: _build.Kernel, dim: int, p: torch.Tensor, c0: float,
            c1: float) -> torch.Tensor:
    check_grid(p)
    if p.dim() != dim:
        raise ValueError(f"{kernel.name} takes a padded {dim}D array, got "
                         f"{tuple(p.shape)}")
    shape = tuple(n - 2 for n in p.shape)
    if min(shape) < 1:
        raise ValueError(f"a padded array is at least 3 wide, got "
                         f"{tuple(p.shape)}")
    grid_y = -(-shape[-2] // _TY)
    if grid_y > _GRID_MAX or (dim == 3 and shape[0] > _GRID_MAX):
        raise ValueError(f"{shape} exceeds the launch grid of {kernel.name}")
    out = torch.empty(shape, dtype=p.dtype, device=p.device)
    kernel.launch(DTYPES[p.dtype], p.data_ptr(), out.data_ptr(),
                  _scal(c0, p.dtype), _scal(c1, p.dtype), *shape,
                  torch.cuda.current_stream(p.device).cuda_stream)
    return out


def jacobi2d_grid(p: torch.Tensor, *, c0: float, c1: float) -> torch.Tensor:
    """The 5-point sweep of the padded CUDA array ``p`` (H+2, W+2) ->
    a new (H, W) tensor."""
    return _launch(JACOBI2D_GRID, 2, p, c0, c1)


def jacobi3d_grid(p: torch.Tensor, *, c0: float, c1: float) -> torch.Tensor:
    """The 7-point sweep of the padded CUDA array ``p`` (D+2, H+2, W+2) ->
    a new (D, H, W) tensor."""
    return _launch(JACOBI3D_GRID, 3, p, c0, c1)
