"""The public flash attention, with the reference's signature and contract
(``repro/kernels/attention/ops.py``) less ``interpret``, and the bridges
to the model: :func:`attention_workload` builds the
``core.workload.AttentionWorkload`` of a tiling, :func:`tuned_blocks`
asks ``core.autotune.rank`` for the tiling to pass back into
:func:`flash_attention`.

q is ``(B, Sq, H, d)``, k and v ``(B, Sk, Hkv, d)``; ``causal`` with
``sq != sk`` raises; the output is in q's dtype.  The reference's rule
decides what is accepted, on both devices: blocks are clamped to the
sequence lengths and must then divide them, a block left at ``None``
being the reference's default 512, clamped.  A CPU tensor takes the
plain version in :mod:`.ref` on the reference's operands (KV heads
repeated to q's, ``repeat_interleave`` on dim 2, the order of
``jnp.repeat``; heads fused).  Any other tensor launches the CUDA kernel,
compiled for the tilings in ``kernel.TILINGS`` at the head dims in
``kernel.HEAD_DIMS``, at the tiling :func:`card_blocks` chooses from
:func:`tuned_blocks`' ranking: the blocks given where they are a compiled
tiling, else the first ranked tiling that agrees with most of the blocks
given (with none given, or none agreeing, the first ranked).  The result
does not depend on the tiling, within tolerance: the tile route masks the
ragged edge.  The kernel gets q, k and v as the caller holds them, read
through their strides, with no repeat and no copy: ``bq = 1`` (decode)
on the split route (``kernel.flash_attention_split``), ``bq > 1``
(prefill) on the tile route (``kernel.flash_attention_tile``).  Head
dims 16 and 32 run at 64 (``kernel.PADDED_HEAD_DIMS``): q, k and v are
padded with zeros, the scale stays ``d ** -0.5`` of the true d, and the
padded output columns are dropped.  A zero column adds ``0 * 0`` to every
score and feeds only the output columns that are dropped, so the result
is the unpadded one.  Any other head dim raises.  With grad mode on, an
operand that requires grad raises on both devices
(:func:`..autograd.refuse_grad`): the kernel has no backward.

The card path is the custom op ``torch.ops.repro_torch.flash_attention``
(``torch.library.custom_op``), so a trace sees it: on a fake tensor
(``FakeTensorMode``, the dry-run's ``core/hlo.py``) its fake version
returns the output's shape and launches nothing, and
``FlopCounterMode`` counts it by its registered formula (a counter made
after this module is imported: it copies the registry when made, and
``core/hlo.py`` ``flop_counter`` imports this module first),
``4 B H Sq Sk d``: what the plain version computes (two products over
every score, the masked ones too, at the true head dim), so a step
counts the same FLOPs on the card as on the CPU.  A real tensor runs the
kernel, with no fallback.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.flop_counter import register_flop_formula

from ...core.machine import H100_SXM, GPUMachineModel
from ...core.workload import AttentionWorkload
from ..autograd import refuse_grad
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


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, bq: int | None = None,
                    bk: int | None = None) -> torch.Tensor:
    """Returns ``(B, Sq, H, d)`` (on the CPU a permuted view of the plain
    version's ``(B, H, Sq, d)`` output)."""
    refuse_grad("flash_attention", q, k, v)
    b, sq, h, d = q.shape
    sk = k.shape[1]
    if causal and sq != sk:
        raise ValueError("causal masking assumes aligned q/k positions "
                         f"(sq == sk), got sq={sq}, sk={sk}")
    dims = (sq, sk)
    asked = tuple(None if x is None else min(x, s) for x, s in zip((bq, bk), dims))
    blocks = tuple(min(r, s) if a is None else a
                   for a, r, s in zip(asked, REFERENCE_BLOCKS, dims))
    if any(s % x for x, s in zip(blocks, dims)):
        raise ValueError(f"blocks {blocks} do not divide {dims}")
    if q.device.type == "cpu":
        out = ref.attention(*fused_inputs(q, k, v), causal=causal)
        return out.reshape(b, h, sq, d).permute(0, 2, 1, 3)
    bq, bk = card_blocks(asked, ranked_blocks(sq, sk, d, causal=causal))
    # a meta tensor (outside a fake mode) reaches the kernel wrappers,
    # which refuse it, as any other non-CUDA tensor
    card = _launch if q.device.type == "meta" else _flash_card
    return card(q, k, v, causal, bq, bk)


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            causal: bool, bq: int, bk: int) -> torch.Tensor:
    """The kernel at the tiling ``(bq, bk)``: the split route for one query
    row, else the tile route; head dims 16 and 32 padded to 64."""
    d = q.shape[-1]
    dk = K.PADDED_HEAD_DIMS.get(d, d)
    if dk != d:
        q, k, v = (F.pad(t, (0, dk - d)) for t in (q, k, v))
    if bq == 1:
        out = K.flash_attention_split(q, k, v, causal=causal, bk=bk,
                                      scale=d ** -0.5)
    else:
        out = K.flash_attention_tile(q, k, v, causal=causal, bq=bq, bk=bk,
                                     scale=d ** -0.5)
    return out[..., :d] if dk != d else out


_flash_card = torch.library.custom_op("repro_torch::flash_attention",
                                      _launch, mutates_args=())


@_flash_card.register_fake
def _(q, k, v, causal, bq, bk):
    return q.new_empty(q.shape)



@register_flop_formula(torch.ops.repro_torch.flash_attention)
def _flash_flops(q_shape, k_shape, v_shape, causal, bq, bk, *,
                 out_shape=None, **kwargs) -> int:
    """The plain version's products: ``q k^T`` and ``p v`` over every
    score, ``2 Sq Sk d`` each per head."""
    b, sq, h, d = q_shape
    return 4 * b * h * sq * k_shape[1] * d


#: ``ranked_blocks``' memo: (dims, causal, machine) -> the ranked tilings
_RANKED: dict[tuple, tuple] = {}


def ranked_blocks(sq: int, sk: int, d: int, *, causal: bool = True,
                  machine: GPUMachineModel = H100_SXM) -> tuple:
    """The compiled tilings ``rank`` orders for one head of ``(sq, sk, d)``
    on ``machine``, best first, ranked once per key: a model calls the op
    at one shape per layer and per step.  The key holds the machine's
    ``repr``, every field of it."""
    key = ((sq, sk, d), causal, repr(machine))
    if key not in _RANKED:
        from ...core.autotune import rank

        _RANKED[key] = tuple(r["block"] for r in rank(
            (sq, sk, d), machine, objective="attention", causal=causal))
    return _RANKED[key]


def card_blocks(asked: tuple, ranked: list[tuple]) -> tuple:
    """The tiling the card runs for the clamped blocks ``asked`` (``None``
    where not given), from the compiled tilings ``ranked`` best first: the
    first that agrees with the most given blocks, so the blocks themselves
    where they are a compiled tiling, and the first ranked where no tiling
    agrees with any."""
    return max(ranked, key=lambda t: sum(a == x for a, x in zip(asked, t)))


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
    ``machine`` (candidates: the compiled tilings at the compiled head dim
    that runs ``d`` that fit the card's shared memory, the one-row tilings
    only where they divide ``sk``), from :func:`ranked_blocks`' memo.  The
    reference's on-disk cache of this pick is not ported."""
    return ranked_blocks(sq, sk, d, causal=causal, machine=machine)[0]
