"""The public blocked matmul, with the reference's signature and contract
(``repro/kernels/matmul/ops.py``, ``kernel.py``) less ``interpret``, and
the bridges to the model: :func:`matmul_workload` builds the
``core.workload.MatmulWorkload`` of a tiling, :func:`tuned_blocks` asks
``core.autotune.rank`` for the tiling to pass back into :func:`matmul`.

Blocks the caller passes are clamped to the problem (``min(b, dim)``) and
a dimension the clamped block does not divide raises; the product
accumulates in f32 and comes out in ``out_dtype or x.dtype``.  A CPU
tensor takes the plain version in :mod:`.ref`, and a block left at
``None`` there is the reference's default (256, 256, 512), clamped, so
the CPU accepts and refuses what the reference does.  Any other tensor
launches the CUDA kernel, which is compiled per route (f32: FFMA, bf16:
wgmma) for the tilings in ``kernel.TILINGS``: blocks left at ``None``
take the first tiling of :func:`tuned_blocks`' ranking that agrees with
the blocks given (raising only when no compiled tiling divides the
problem), and a ``bk`` the route is not compiled for runs at the largest
compiled depth that divides it (``kernel.compiled_depth``: the same
product, see there).  Any other tiling raises.  With grad mode on, an
operand that requires grad raises on both devices
(:func:`..autograd.refuse_grad`): the kernel has no backward.
"""
from __future__ import annotations

import torch

from ...core.machine import H100_SXM, GPUMachineModel
from ...core.workload import MatmulWorkload
from ..autograd import refuse_grad
from . import kernel as K
from . import ref

#: the reference's default blocks (repro/kernels/matmul/kernel.py
#: DEFAULT_BM, DEFAULT_BN, DEFAULT_BK), sized for a TPU's VMEM
REFERENCE_BLOCKS = (256, 256, 512)


def matmul(x: torch.Tensor, y: torch.Tensor, *, bm: int | None = None,
           bn: int | None = None, bk: int | None = None,
           out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """``x (m, k) @ y (k, n)`` in ``bm x bn`` output tiles, ``bk`` deep."""
    refuse_grad("matmul", x, y)
    (m, k), (k2, n) = x.shape, y.shape
    if k != k2:
        raise ValueError(f"cannot multiply {tuple(x.shape)} by {tuple(y.shape)}")
    dims = (m, n, k)
    asked = tuple(None if b is None else min(b, d)
                  for b, d in zip((bm, bn, bk), dims))
    out_dtype = out_dtype or x.dtype
    if x.device.type == "cpu":
        blocks = tuple(min(b, d) if a is None else a
                       for a, b, d in zip(asked, REFERENCE_BLOCKS, dims))
        _check_divides(blocks, dims)
        return ref.matmul(x, y, out_dtype)
    _check_divides(asked, dims)
    bm, bn, bk = _card_blocks(dims, x.dtype, asked)
    return K.matmul_tiled(x, y, bm=bm, bn=bn,
                          bk=K.compiled_depth(bm, bn, bk, x.dtype),
                          out_dtype=out_dtype)


def _check_divides(blocks: tuple, dims: tuple) -> None:
    if any(b is not None and d % b for b, d in zip(blocks, dims)):
        raise ValueError(f"blocks {blocks} do not divide {dims}")


def _card_blocks(dims: tuple, dtype: torch.dtype, asked: tuple) -> tuple:
    """The caller's blocks, with each one left at ``None`` taken from the
    first ranked compiled tiling whose ``(bm, bn)`` agree with those
    given."""
    if None not in asked:
        return asked
    for block in ranked_blocks(dims, dtype):
        if all(a is None or a == b for a, b in zip(asked[:2], block)):
            return tuple(b if a is None else a for a, b in zip(asked, block))
    raise ValueError(f"no compiled {K.route_of(dtype)} matmul tiling of "
                     f"{dims} has the blocks {asked}")


#: ``ranked_blocks``' memo: (dims, dtype, machine) -> the ranked tilings
_RANKED: dict[tuple, tuple] = {}


def ranked_blocks(dims: tuple, dtype: torch.dtype,
                  machine: GPUMachineModel = H100_SXM) -> tuple:
    """The compiled tilings of ``dtype``'s route that ``rank`` orders for
    the product ``dims = (m, n, k)`` on ``machine``, best first, ranked
    once per key.  The key holds the machine's ``repr``, every field of
    it."""
    key = (tuple(dims), dtype, repr(machine))
    if key not in _RANKED:
        from ...core.autotune import rank

        eb = torch.empty((), dtype=dtype).element_size()
        _RANKED[key] = tuple(r["block"] for r in rank(
            tuple(dims), machine, objective="matmul", elem_bytes=eb))
    return _RANKED[key]


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
    memory), from :func:`ranked_blocks`' memo.  The reference's on-disk
    cache of this pick is not ported."""
    return ranked_blocks((m, n, k), dtype, machine)[0]
