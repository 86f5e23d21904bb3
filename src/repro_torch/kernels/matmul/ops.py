"""The public blocked matmul, with the reference's signature and contract
(``repro/kernels/matmul/ops.py``, ``kernel.py``) less ``interpret``, and
the bridges to the model: :func:`matmul_workload` builds the
``core.workload.MatmulWorkload`` of a tiling, :func:`tuned_blocks` asks
``core.autotune.rank`` for the tiling to pass back into :func:`matmul`.

Blocks are clamped to the problem (``min(b, dim)``) and a dimension the
clamped block does not divide raises; the product accumulates in f32 and
comes out in ``out_dtype or x.dtype``.  A CPU tensor takes the plain
version in :mod:`.ref`; any other launches the CUDA kernel, which is
compiled per route (f32: FFMA, bf16: wgmma) for the tilings in
``kernel.TILINGS`` and raises on any other.  So a block left at ``None``
takes the route's default in ``kernel.DEFAULTS`` (128 x 128, 16 deep in
f32; 128 x 128, 64 deep in bf16), not the reference's 256/256/512, which
are sized for a TPU's VMEM.
"""
from __future__ import annotations

import torch

from ...core.machine import H100_SXM, GPUMachineModel
from ...core.workload import MatmulWorkload
from . import kernel as K
from . import ref


def matmul(x: torch.Tensor, y: torch.Tensor, *, bm: int | None = None,
           bn: int | None = None, bk: int | None = None,
           out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """``x (m, k) @ y (k, n)`` in ``bm x bn`` output tiles, ``bk`` deep."""
    (m, k), (k2, n) = x.shape, y.shape
    if k != k2:
        raise ValueError(f"cannot multiply {tuple(x.shape)} by {tuple(y.shape)}")
    dm, dn, dk = K.DEFAULTS[K.route_of(x.dtype)]
    bm, bn, bk = min(bm or dm, m), min(bn or dn, n), min(bk or dk, k)
    if m % bm or n % bn or k % bk:
        raise ValueError(f"blocks {(bm, bn, bk)} do not divide {(m, n, k)}")
    out_dtype = out_dtype or x.dtype
    if x.device.type == "cpu":
        return ref.matmul(x, y, out_dtype)
    return K.matmul_tiled(x, y, bm=bm, bn=bn, bk=bk, out_dtype=out_dtype)


def matmul_workload(m: int, n: int, k: int, *, bm: int = K.DEFAULTS["ffma"][0],
                    bn: int = K.DEFAULTS["ffma"][1], elem_bytes: int = 4
                    ) -> MatmulWorkload:
    """The model of :func:`matmul` at an output tiling (clamped as the op
    clamps it).  ``bk`` moves no traffic in the model, so it is not an
    argument."""
    return MatmulWorkload(m=m, n=n, k=k, bm=min(bm, m), bn=min(bn, n),
                          elem_bytes=elem_bytes)


def tuned_blocks(m: int, n: int, k: int, *,
                 dtype: torch.dtype = torch.float32,
                 machine: GPUMachineModel = H100_SXM) -> tuple[int, int, int]:
    """The ``(bm, bn, bk)`` that ``rank`` puts first for a product of
    ``dtype`` operands on ``machine`` (candidates: the compiled tilings of
    the dtype's route that divide the problem and fit the card's shared
    memory).  The reference's on-disk cache of this pick is not ported."""
    from ...core.autotune import rank

    eb = torch.empty((), dtype=dtype).element_size()
    return rank((m, n, k), machine, objective="matmul", elem_bytes=eb)[0]["block"]
