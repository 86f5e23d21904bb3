"""Public Jacobi stencil ops, with the reference's signatures and defaults
(``repro/kernels/stencil/ops.py``) less ``interpret``.

``num_stages=None`` runs the whole-array kernel; an int runs the halo
pipeline with that many ring slots (contract in :mod:`..pipeline`).  Both
pad the input with one zero ring first, as the reference does.  A CPU
tensor takes the plain version in :mod:`.ref`; any other tensor launches
the CUDA kernel, which raises on what it does not take — among that, a
ring over the card's shared memory (at the default 8-row block a 3D ring
fits up to depth 4; at 64 layers not even depth 1).  Every path computes
the reference oracle's rounding, so outputs are bit-identical across
depths and to ``ref.py``.
"""
from __future__ import annotations

from .. import pipeline as P
from . import kernel as K
from . import ref


def _sweep(a, plain, grid, *, c0, c1, num_stages, block_rows):
    if a.device.type == "cpu":
        return plain(a, c0, c1)
    p = ref.pad(a)
    if num_stages is None:
        return grid(p, c0=c0, c1=c1)
    return P.halo_pipeline(p, out_shape=tuple(a.shape), c0=c0, c1=c1,
                           num_stages=num_stages, block_rows=block_rows)


def jacobi2d(a, *, c0: float = 0.0, c1: float = 0.25, num_stages=None,
             block_rows: int = K.BLOCK_ROWS):
    """2D 5-point Jacobi sweep: ``b = c0*a + c1*(N+S+W+E)`` interior,
    ``b = a`` on the boundary."""
    return _sweep(a, ref.jacobi2d, K.jacobi2d_grid, c0=c0, c1=c1,
                  num_stages=num_stages, block_rows=block_rows)


def jacobi3d(a, *, c0: float = 0.0, c1: float = 1.0 / 6.0, num_stages=None,
             block_rows: int = K.BLOCK_ROWS):
    """3D 7-point Jacobi sweep over (D, H, W); the pipeline chunks along
    the outermost (layer) axis with a one-layer halo."""
    return _sweep(a, ref.jacobi3d, K.jacobi3d_grid, c0=c0, c1=c1,
                  num_stages=num_stages, block_rows=block_rows)
