"""Wrapper of the flash-attention kernel (``csrc/attention.cu``
``rt_flash_attention``).

The counterpart of the reference's ``flash_attention_call``
(``repro/kernels/attention/kernel.py``) on fused heads: q ``(BH, Sq, d)``,
k and v ``(BH, Sk, d)`` with GQA already expanded, one CTA per (head,
q-block of ``bq`` rows) walking the KV tiles of ``bk`` rows in order.
``bq = 1`` (decode) runs a one-row branch of the kernel.  The kernel is
compiled for the tilings in :data:`TILINGS` at the head dims in
:data:`HEAD_DIMS`; any other raises, as does a tiling whose buffers
exceed the card's shared memory.  The wrapper takes CUDA tensors only;
CPU tensors take the plain version in ``ref.py``, chosen in ``ops.py``.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build
from ..pipeline import DTYPES, check_dense

#: (bq, bk) the kernel is compiled for, in the order ``rank`` breaks ties
#: in; each at every head dim of HEAD_DIMS (csrc/attention.cu
#: rt_flash_attention holds the same list)
TILINGS = ((64, 64), (64, 128), (128, 64), (128, 128), (1, 128), (1, 256))
HEAD_DIMS = (64, 128)
DEFAULT_BQ = 128
DEFAULT_BK = 128
#: floats of padding per row of P (csrc/attention.cu PAD)
_PAD = 4
#: threads of a CTA, and warps (csrc/attention.cu ATT_THREADS)
_THREADS = 256
_GRID_MAX = 65535

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_F = ctypes.c_float

FLASH_ATTENTION = _build.Kernel(
    "flash_attention", "attention", "rt_flash_attention",
    [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F, _I, _LL, _P],
    replaces="src/repro/kernels/attention/kernel.py:73")


def smem_bytes(bq: int, bk: int, d: int) -> int:
    """Shared memory of one CTA, in f32 whatever the input dtype.
    ``bq >= 2``: Q^T, K^T (later P, rows padded by 4 floats) and V of one
    tile.  ``bq = 1``: the tile's scores and the reduction buffers."""
    if bq == 1:
        return (bk + _THREADS + _THREADS // 32) * 4
    return (d * bq + max(d * bk, bq * (bk + _PAD)) + bk * d) * 4


def check_tiling(bq: int, bk: int, d: int, smem_limit: int) -> int:
    """The tiling's shared memory in bytes; raises ``ValueError`` on a head
    dim or tiling the kernel is not compiled for, or a footprint over
    ``smem_limit``."""
    if d not in HEAD_DIMS:
        raise ValueError(f"the attention kernel is compiled for head dims "
                         f"{HEAD_DIMS}, not {d}")
    smem = smem_bytes(bq, bk, d)
    if smem > smem_limit:
        raise ValueError(f"a {bq} x {bk} attention tile at d = {d} needs "
                         f"{smem} B of shared memory, over the {smem_limit} B "
                         f"a block may use")
    if (bq, bk) not in TILINGS:
        raise ValueError(f"the attention kernel is compiled for the (bq, bk) "
                         f"tilings {TILINGS}, not {(bq, bk)}")
    return smem


def flash_attention_fused(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool, bq: int, bk: int) -> torch.Tensor:
    """Launch attention over fused heads on CUDA tensors; returns a new
    ``(BH, Sq, d)`` tensor of q's dtype."""
    check_dense(q, k, v)
    if q.dim() != 3 or k.shape != v.shape or k.dim() != 3 or (
            q.shape[0], q.shape[2]) != (k.shape[0], k.shape[2]):
        raise ValueError(f"expected q (BH, Sq, d), k and v (BH, Sk, d), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    bh, sq, d = q.shape
    sk = k.shape[1]
    if causal and sq != sk:
        raise ValueError("causal masking assumes aligned q/k positions "
                         f"(sq == sk), got sq={sq}, sk={sk}")
    if sq % bq or sk % bk:
        raise ValueError(f"blocks {(bq, bk)} do not divide {(sq, sk)}")
    if sq // bq > _GRID_MAX:
        raise ValueError(f"{sq // bq} q-blocks exceed the launch grid")
    props = torch.cuda.get_device_properties(q.device)
    smem = check_tiling(bq, bk, d, props.shared_memory_per_block_optin)
    out = torch.empty_like(q)
    FLASH_ATTENTION.launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), bh, sq, sk,
        d, bq, bk, int(causal), d ** -0.5, DTYPES[q.dtype],
        0 if bq == 1 else smem, torch.cuda.current_stream(q.device).cuda_stream)
    return out
