"""The public blocked matmul, with the reference's signature and contract
(``repro/kernels/matmul/ops.py``, ``kernel.py``) less ``interpret``, and
the bridges to the model: :func:`matmul_workload` builds the
``core.workload.MatmulWorkload`` of a tiling, :func:`tuned_blocks` asks
``core.autotune.rank`` for the tiling to pass back into :func:`matmul`.

Blocks are clamped to the problem (``min(b, dim)``) and a dimension the
clamped block does not divide raises; the product accumulates in f32 and
comes out in ``out_dtype or x.dtype``.  A CPU tensor takes the plain
version in :mod:`.ref`; any other launches the CUDA kernel, which is
compiled for the tilings in ``kernel.TILINGS`` and raises on any other.
So the defaults are a tiling the kernel has (128 x 128, 16 deep), not the
reference's 256/256/512, which are sized for a TPU's VMEM.
"""
from __future__ import annotations

import torch

from ...core.machine import H100_SXM, GPUMachineModel
from ...core.workload import MatmulWorkload
from . import kernel as K
from . import ref


def matmul(x: torch.Tensor, y: torch.Tensor, *, bm: int = K.DEFAULT_BM,
           bn: int = K.DEFAULT_BN, bk: int = K.DEFAULT_BK,
           out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """``x (m, k) @ y (k, n)`` in ``bm x bn`` output tiles, ``bk`` deep."""
    (m, k), (k2, n) = x.shape, y.shape
    if k != k2:
        raise ValueError(f"cannot multiply {tuple(x.shape)} by {tuple(y.shape)}")
    bm, bn, bk = min(bm, m), min(bn, n), min(bk, k)
    if m % bm or n % bn or k % bk:
        raise ValueError(f"blocks {(bm, bn, bk)} do not divide {(m, n, k)}")
    out_dtype = out_dtype or x.dtype
    if x.device.type == "cpu":
        return ref.matmul(x, y, out_dtype)
    return K.matmul_tiled(x, y, bm=bm, bn=bn, bk=bk, out_dtype=out_dtype)


def matmul_workload(m: int, n: int, k: int, *, bm: int = K.DEFAULT_BM,
                    bn: int = K.DEFAULT_BN, elem_bytes: int = 4
                    ) -> MatmulWorkload:
    """The model of :func:`matmul` at an output tiling (clamped as the op
    clamps it).  ``bk`` moves no traffic in the model, so it is not an
    argument."""
    return MatmulWorkload(m=m, n=n, k=k, bm=min(bm, m), bn=min(bn, n),
                          elem_bytes=elem_bytes)


def tuned_blocks(m: int, n: int, k: int, *,
                 machine: GPUMachineModel = H100_SXM) -> tuple[int, int, int]:
    """The ``(bm, bn, bk)`` that ``rank`` puts first for an f32 product on
    ``machine`` (candidates: the compiled tilings that divide the problem
    and fit the card's shared memory).  The reference's on-disk cache of
    this pick is not ported."""
    from ...core.autotune import rank

    return rank((m, n, k), machine, objective="matmul")[0]["block"]
