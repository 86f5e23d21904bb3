"""The public flash attention, with the reference's signature and contract
(``repro/kernels/attention/ops.py``) less ``interpret``, and the bridges
to the model: :func:`attention_workload` builds the
``core.workload.AttentionWorkload`` of a tiling, :func:`tuned_blocks`
asks ``core.autotune.rank`` for the tiling to pass back into
:func:`flash_attention`.

q is ``(B, Sq, H, d)``, k and v ``(B, Sk, Hkv, d)``.  GQA repeats each KV
head ``H / Hkv`` times (``repeat_interleave`` on dim 2, the order of
``jnp.repeat``) before the fused ``(B*H, S, d)`` kernel; blocks are
clamped to the sequence lengths; ``causal`` with ``sq != sk`` raises.
The output is in q's dtype.  A CPU tensor takes the plain version in
:mod:`.ref`; any other launches the CUDA kernel, which is compiled for
the tilings in ``kernel.TILINGS`` at d in ``kernel.HEAD_DIMS`` and raises
on any other.  So the defaults are 128 x 128, a tiling the kernel has,
not the reference's 512 x 512, which is sized for a TPU's VMEM.
"""
from __future__ import annotations

import torch

from ...core.machine import H100_SXM, GPUMachineModel
from ...core.workload import AttentionWorkload
from . import kernel as K
from . import ref


def _fuse(t: torch.Tensor) -> torch.Tensor:
    """(B, S, H, d) -> contiguous (B*H, S, d)."""
    b, s, h, d = t.shape
    return t.permute(0, 2, 1, 3).reshape(b * h, s, d).contiguous()


def fused_inputs(q, k, v):
    """The kernel's operands of :func:`flash_attention`: KV heads repeated
    to q's, every tensor fused to ``(B*H, S, d)``."""
    h, hkv = q.shape[2], k.shape[2]
    if h % hkv:
        raise ValueError(f"{h} query heads are not a multiple of {hkv} KV heads")
    if hkv != h:
        k = k.repeat_interleave(h // hkv, dim=2)
        v = v.repeat_interleave(h // hkv, dim=2)
    return _fuse(q), _fuse(k), _fuse(v)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, bq: int = K.DEFAULT_BQ,
                    bk: int = K.DEFAULT_BK) -> torch.Tensor:
    """Returns ``(B, Sq, H, d)`` (a permuted view of the fused output)."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    if causal and sq != sk:
        raise ValueError("causal masking assumes aligned q/k positions "
                         f"(sq == sk), got sq={sq}, sk={sk}")
    bq, bk = min(bq, sq), min(bk, sk)
    if sq % bq or sk % bk:
        raise ValueError(f"blocks {(bq, bk)} do not divide {(sq, sk)}")
    qf, kf, vf = fused_inputs(q, k, v)
    if q.device.type == "cpu":
        out = ref.attention(qf, kf, vf, causal=causal)
    else:
        out = K.flash_attention_fused(qf, kf, vf, causal=causal, bq=bq, bk=bk)
    return out.reshape(b, h, sq, d).permute(0, 2, 1, 3)


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
    lengths, at a compiled head dim, that fit the card's shared memory).
    The reference's on-disk cache of this pick is not ported."""
    from ...core.autotune import rank

    return rank((sq, sk, d), machine, objective="attention",
                causal=causal)[0]["block"]
