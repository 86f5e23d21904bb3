"""The public flash attention, with the reference's signature and contract
(``repro/kernels/attention/ops.py``) less ``interpret``, and the bridges
to the model: :func:`attention_workload` builds the
``core.workload.AttentionWorkload`` of a tiling, :func:`tuned_blocks`
asks ``core.autotune.rank`` for the tiling to pass back into
:func:`flash_attention`.

q is ``(B, Sq, H, d)``, k and v ``(B, Sk, Hkv, d)``; ``causal`` with
``sq != sk`` raises; the output is in q's dtype.  Blocks the caller
passes are clamped to the sequence lengths and must then divide them.  A
CPU tensor takes the plain version in :mod:`.ref` on the reference's
operands (KV heads repeated to q's, ``repeat_interleave`` on dim 2, the
order of ``jnp.repeat``; heads fused), and a block left at ``None`` there
is the reference's default 512, clamped.  Any other tensor launches the
CUDA kernel, compiled for the tilings in ``kernel.TILINGS`` at the head
dims in ``kernel.HEAD_DIMS``: blocks left at ``None`` take the first
tiling of :func:`tuned_blocks`' ranking that agrees with the block given
(raising only when no compiled tiling divides the problem).  The kernel
never sees a repeated KV head: ``bq = 1`` (decode) hands it q, k and v as
they are, the cache in its own layout with no copy
(``kernel.flash_attention_split``); ``bq >= 64`` (prefill) fuses heads as
``(B, H, S, d)`` and ``(B, Hkv, S, d)`` (:func:`tile_operands`).  Head dims
16 and 32 run at 64 (``kernel.PADDED_HEAD_DIMS``): q, k and v are padded
with zeros, the scale stays ``d ** -0.5`` of the true d, and the padded
output columns are dropped.  A zero column adds ``0 * 0`` to every score
and feeds only the output columns that are dropped, so the result is the
unpadded one.  Any other head dim or tiling raises.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ...core.machine import H100_SXM, GPUMachineModel
from ...core.workload import AttentionWorkload
from . import kernel as K
from . import ref

#: the reference's default blocks (repro/kernels/attention/kernel.py
#: DEFAULT_BQ, DEFAULT_BK), sized for a TPU's VMEM
REFERENCE_BLOCKS = (512, 512)


def _fuse(t: torch.Tensor) -> torch.Tensor:
    """(B, S, H, d) -> contiguous (B*H, S, d)."""
    b, s, h, d = t.shape
    return t.permute(0, 2, 1, 3).reshape(b * h, s, d).contiguous()


def fused_inputs(q, k, v):
    """The plain version's operands of :func:`flash_attention`: KV heads
    repeated to q's, every tensor fused to ``(B*H, S, d)``."""
    h, hkv = q.shape[2], k.shape[2]
    if h % hkv:
        raise ValueError(f"{h} query heads are not a multiple of {hkv} KV heads")
    if hkv != h:
        k = k.repeat_interleave(h // hkv, dim=2)
        v = v.repeat_interleave(h // hkv, dim=2)
    return _fuse(q), _fuse(k), _fuse(v)


def tile_operands(q, k, v):
    """The tile route's operands of :func:`flash_attention`: each tensor
    ``(B, S, heads, d)`` made a contiguous ``(B, heads, S, d)``, KV at its
    own heads."""
    return tuple(t.permute(0, 2, 1, 3).contiguous() for t in (q, k, v))


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, bq: int | None = None,
                    bk: int | None = None) -> torch.Tensor:
    """Returns ``(B, Sq, H, d)`` (on the tile route a permuted view of
    the kernel's ``(B, H, Sq, d)`` output)."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    if causal and sq != sk:
        raise ValueError("causal masking assumes aligned q/k positions "
                         f"(sq == sk), got sq={sq}, sk={sk}")
    dims = (sq, sk)
    asked = tuple(None if x is None else min(x, s) for x, s in zip((bq, bk), dims))
    if q.device.type == "cpu":
        _check_divides(tuple(min(r, s) if a is None else a for a, r, s
                             in zip(asked, REFERENCE_BLOCKS, dims)), dims)
        out = ref.attention(*fused_inputs(q, k, v), causal=causal)
        return out.reshape(b, h, sq, d).permute(0, 2, 1, 3)
    _check_divides(asked, dims)
    bq, bk = _card_blocks(sq, sk, d, causal, asked)
    dk = K.PADDED_HEAD_DIMS.get(d, d)
    if dk != d:
        q, k, v = (F.pad(t, (0, dk - d)) for t in (q, k, v))
    if bq == 1:
        out = K.flash_attention_split(q, k, v, causal=causal, bk=bk,
                                      scale=d ** -0.5)
    else:
        out = K.flash_attention_tile(*tile_operands(q, k, v), causal=causal,
                                     bq=bq, bk=bk,
                                     scale=d ** -0.5).permute(0, 2, 1, 3)
    return out[..., :d] if dk != d else out


def _check_divides(blocks: tuple, dims: tuple) -> None:
    if any(x is not None and s % x for x, s in zip(blocks, dims)):
        raise ValueError(f"blocks {blocks} do not divide {dims}")


def _card_blocks(sq: int, sk: int, d: int, causal: bool, asked: tuple) -> tuple:
    """The caller's blocks, with one left at ``None`` taken from the first
    ranked compiled tiling that agrees with the one given."""
    if None not in asked:
        return asked
    from ...core.autotune import rank

    for r in rank((sq, sk, d), H100_SXM, objective="attention", causal=causal):
        if all(a is None or a == x for a, x in zip(asked, r["block"])):
            return r["block"]
    raise ValueError(f"no compiled attention tiling of {(sq, sk)} has the "
                     f"blocks {asked}")


def attention_workload(sq: int, sk: int, d: int, *, bq: int = K.DEFAULT_BQ,
                       bk: int = K.DEFAULT_BK, causal: bool = True,
                       elem_bytes: int = 4) -> AttentionWorkload:
    """The model of one head of :func:`flash_attention` at a tiling
    (clamped as the op clamps it); heads multiply the work."""
    return AttentionWorkload(sq=sq, skv=sk, d=d, bq=min(bq, sq),
                             bkv=min(bk, sk), causal=causal,
                             elem_bytes=elem_bytes)


def tuned_blocks(sq: int, sk: int, d: int, *, causal: bool = True,
                 machine: GPUMachineModel = H100_SXM) -> tuple[int, int]:
    """The ``(bq, bk)`` that ``rank`` puts first for f32 attention on
    ``machine`` (candidates: the compiled tilings that divide the sequence
    lengths, at the compiled head dim that runs ``d``, that fit the card's
    shared memory).  The reference's on-disk cache of this pick is not
    ported."""
    from ...core.autotune import rank

    return rank((sq, sk, d), machine, objective="attention",
                causal=causal)[0]["block"]
