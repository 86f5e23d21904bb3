"""Wrappers of the flash-attention kernels (``csrc/attention.cu``).

The counterpart of the reference's ``flash_attention_call``
(``repro/kernels/attention/kernel.py``), in two routes of one kernel.
Both read q ``(B, Sq, H, d)`` and k, v ``(B, Sk, Hkv, d)`` as the op
receives them, through their strides (views the 16-byte copies can
address; :func:`check_views`), and neither repeats a KV head:

* ``"tile"`` (``bq > 1``, ``rt_flash_attention``): prefill.  One CTA per
  (batch, query head, q-block of ``bq`` rows) walks the KV tiles of ``bk``
  keys of its KV head in order, K and V streamed through a ``cp.async``
  ring of panels; ``ceil(Sq / bq)`` q-blocks and ``ceil(Sk / bk)`` tiles,
  the ragged edge masked (:func:`flash_attention_tile`).
* ``"split"`` (``bq = 1``, ``rt_flash_decode``): one query row at a time,
  split-KV.  One CTA per (batch, query row, KV head, split of whole
  ``bk`` tiles) serves the ``H / Hkv`` query heads of its KV head, and
  :data:`FLASH_COMBINE` (``rt_flash_combine``) merges the splits
  (:func:`flash_attention_split`).  The split count is not an argument:
  :func:`split_plan` derives it from the card's SMs and how many CTAs of
  the kernel one SM holds.

The kernel is compiled for the tilings in :data:`TILINGS` at the head
dims in :data:`HEAD_DIMS`; any other raises, as does a tile whose buffers
exceed the card's shared memory.  The wrappers take CUDA tensors only;
CPU tensors take the plain version in ``ref.py``, chosen in ``ops.py``.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from .. import _build
from ..pipeline import DTYPES

#: (bq, bk) the kernel is compiled for, in the order ``rank`` breaks ties
#: in; each at every head dim of HEAD_DIMS (csrc/attention.cu
#: rt_flash_attention holds the tile route's, rt_flash_decode takes any
#: bk that is a multiple of SPLIT_KEYS)
TILINGS = ((128, 64), (128, 128), (1, 128), (1, 256))
HEAD_DIMS = (64, 128)
#: head dims the op runs at a compiled one, zero-padded (ops.py)
PADDED_HEAD_DIMS = {16: 64, 32: 64}
DEFAULT_BQ = 128
DEFAULT_BK = 128
ROUTES = ("tile", "split")
#: the tile route (csrc/attention.cu): query rows a thread holds, and the
#: stages of its ring of K and V panels
TILE_ROWS = 8
TILE_STAGES = 3
#: the split route (csrc/attention.cu): threads of a CTA, keys of one ring
#: stage, stages, and the most query heads one KV head may serve
SPLIT_THREADS = 128
SPLIT_KEYS = 32
SPLIT_STAGES = 3
MAX_REP = 16
_GRID_MAX = 65535
_INT_MAX = 2**31 - 1

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_F = ctypes.c_float

FLASH_ATTENTION = _build.Kernel(
    "flash_attention", "attention",
    {"tile": "rt_flash_attention", "split": "rt_flash_decode"},
    {"tile": [_P] * 4 + [_I] * 8 + [_LL] * 12 + [_I, _F, _I, _LL, _P],
     "split": [_P] * 6 + [_I] * 9 + [_LL] * 9 + [_I, _F, _I, _LL, _P]},
    replaces="src/repro/kernels/attention/kernel.py:73", routes=ROUTES)
FLASH_COMBINE = _build.Kernel(
    "flash_combine", "attention", "rt_flash_combine",
    [_P] * 4 + [_LL, _I, _I, _I, _P],
    replaces="src/repro/kernels/attention/kernel.py:73")


def route_of(bq: int) -> str:
    return "split" if bq == 1 else "tile"


def split_smem_bytes(d: int, rep: int, elem_bytes: int) -> int:
    """Shared memory of one split-route CTA: a ring of SPLIT_STAGES
    stages of K and V, SPLIT_KEYS rows each padded by 16 bytes, in the
    input dtype; then in f32 the scaled q rows, P and the rescale factors
    of the ``rep`` query heads."""
    ring = SPLIT_STAGES * 2 * SPLIT_KEYS * (d * elem_bytes + 16)
    return ring + rep * (d + SPLIT_KEYS + 1) * 4


def tile_panels(bq: int, bk: int, d: int) -> tuple[int, int, int]:
    """The tile route's ring (csrc/attention.cu): ``(threads, kc, vc)``,
    a CTA's threads (16 for every TILE_ROWS query rows) and the shape of
    its panels of ``16 x threads`` elements, K ``bk x kc`` and V
    ``vc x d``, each at most the tile."""
    threads = bq // TILE_ROWS * 16
    return threads, min(16 * threads // bk, d), min(16 * threads // d, bk)


def smem_bytes(bq: int, bk: int, d: int) -> int:
    """Shared memory of one CTA.  ``bq >= 2``: the scaled Q and P of one
    tile and TILE_STAGES ring slots, each the larger panel (K rows padded
    by 4 floats), in f32 whatever the input dtype.  ``bq = 1``: the split
    route's largest launch (f32, MAX_REP query heads)."""
    if bq == 1:
        return split_smem_bytes(d, MAX_REP, 4)
    _, kc, vc = tile_panels(bq, bk, d)
    return (bq * d + bq * bk + TILE_STAGES * max(bk * (kc + 4), vc * d)) * 4


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


def _check_heads(h: int, hkv: int) -> int:
    if hkv <= 0 or h % hkv:
        raise ValueError(f"{h} query heads are not a multiple of {hkv} KV heads")
    return h // hkv


def check_views(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """Both routes' demands on their operands, short of the device: q
    ``(B, Sq, H, d)``, k and v ``(B, Sk, Hkv, d)`` of one dtype, each a view
    the kernel can address (the last dimension dense, 16-byte aligned base
    and strides, as its 16-byte copies need), the query heads a multiple of
    the KV heads."""
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape or (
            q.shape[0], q.shape[3]) != (k.shape[0], k.shape[3]):
        raise ValueError(f"expected q (B, Sq, H, d), k and v (B, Sk, Hkv, d), "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    for t in (q, k, v):
        if t.dtype not in DTYPES or t.dtype != q.dtype:
            raise ValueError(f"the CUDA kernels take operands of one dtype of "
                             f"{list(DTYPES)}, got {[u.dtype for u in (q, k, v)]}")
        vec = 16 // t.element_size()
        if t.stride(3) != 1 or any(s % vec for s in t.stride()[:3]) \
                or t.data_ptr() % 16:
            raise ValueError(f"expected views with a dense last dimension, "
                             f"16-byte aligned base and strides, got "
                             f"{tuple(t.shape)} with strides {t.stride()}")
    _check_heads(q.shape[2], k.shape[2])


def _check_causal(causal: bool, sq: int, sk: int) -> None:
    if causal and sq != sk:
        raise ValueError("causal masking assumes aligned q/k positions "
                         f"(sq == sk), got sq={sq}, sk={sk}")


def _check_cuda(*ts: torch.Tensor) -> None:
    for t in ts:
        if t.device.type != "cuda":
            raise ValueError(f"the CUDA kernels take CUDA tensors, got {t.device}")


def check_tile_operands(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool, bq: int, bk: int,
                        smem_limit: int) -> int:
    """Everything the tile route requires of its operands, short of the
    device: views as :func:`check_views` allows, a compiled ``(bq, bk)``
    tiling with ``bq > 1`` (any sequence lengths: the kernel masks the
    ragged edge), and a grid the card launches.  Returns the launch's
    shared memory."""
    check_views(q, k, v)
    (b, sq, h, d), sk = q.shape, k.shape[1]
    if bq == 1:
        raise ValueError("bq = 1 is the split route (flash_attention_split)")
    _check_causal(causal, sq, sk)
    if min(sq, sk) < 1:
        raise ValueError(f"empty sequences {(sq, sk)}")
    if -(-sq // bq) > _GRID_MAX or b * h > _INT_MAX:
        raise ValueError(f"{(b * h, -(-sq // bq))} tiles exceed the launch grid")
    return check_tiling(bq, bk, d, smem_limit)


def flash_attention_tile(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool, bq: int, bk: int,
                         scale: float) -> torch.Tensor:
    """The tile route on CUDA tensors, q ``(B, Sq, H, d)``, k and v
    ``(B, Sk, Hkv, d)`` (views as :func:`check_tile_operands` allows, read
    in place), the scores scaled by ``scale``; returns a new contiguous
    ``(B, Sq, H, d)`` tensor of q's dtype."""
    _check_cuda(q, k, v)
    props = torch.cuda.get_device_properties(q.device)
    smem = check_tile_operands(q, k, v, causal=causal, bq=bq, bk=bk,
                               smem_limit=props.shared_memory_per_block_optin)
    (b, sq, h, d), (sk, hkv) = q.shape, k.shape[1:3]
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    FLASH_ATTENTION.launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, h, hkv,
        sq, sk, d, bq, bk, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        *out.stride()[:3], int(causal), scale, DTYPES[q.dtype], smem,
        torch.cuda.current_stream(q.device).cuda_stream, route="tile")
    return out


def check_split_operands(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool, bk: int, smem_limit: int) -> int:
    """Everything the split route requires of its operands, short of the
    device: views as :func:`check_views` allows, at most MAX_REP query
    heads a KV head, a compiled ``(1, bk)`` tiling that divides Sk.
    Returns the launch's shared memory."""
    check_views(q, k, v)
    (b, sq, h, d), (sk, hkv) = q.shape, k.shape[1:3]
    rep = h // hkv
    if rep > MAX_REP:
        raise ValueError(f"{rep} query heads a KV head, over the {MAX_REP} "
                         f"the split route serves")
    _check_causal(causal, sq, sk)
    if sk % bk:
        raise ValueError(f"blocks {(1, bk)} do not divide {(sq, sk)}")
    check_tiling(1, bk, d, smem_limit)
    return split_smem_bytes(d, rep, q.element_size())


@dataclass(frozen=True)
class SplitPlan:
    """One split-route launch: ``n_split`` splits of ``split_keys`` keys
    (whole ``bk`` tiles; the last split may be shorter), ``ctas`` CTAs of
    which one SM holds ``ctas_per_sm``, and each CTA's shared memory."""

    n_split: int
    split_keys: int
    ctas: int
    ctas_per_sm: int
    smem_bytes: int


def split_plan(*, groups: int, sk: int, bk: int, sms: int, ctas_per_sm: int,
               smem_bytes: int) -> SplitPlan:
    """The split count of ``groups`` (batch x query rows x KV heads) walks
    over ``sk`` keys: as many splits as keep every CTA of the launch
    resident at once (``sms x ctas_per_sm``), so no SM waits on a second
    wave and each keeps its ring's bytes in flight; at least one, at most
    one per ``bk`` tile, then spread evenly over whole tiles."""
    tiles = sk // bk
    n = max(1, min(tiles, sms * ctas_per_sm // groups))
    per = -(-tiles // n)
    n = -(-tiles // per)
    return SplitPlan(n, per * bk, groups * n, ctas_per_sm, smem_bytes)


_OCCUPANCY: dict[tuple, int] = {}


def _ctas_per_sm(d: int, dtype: torch.dtype, rep: int, smem: int) -> int:
    """How many split-route CTAs one SM holds (the CUDA occupancy query on
    the compiled kernel: shared memory, registers and threads)."""
    key = (d, dtype, rep, smem)
    if key not in _OCCUPANCY:
        fn = _build.library("attention").rt_flash_decode_occupancy
        fn.argtypes = [_I, _I, _I, _LL, ctypes.POINTER(_I)]
        fn.restype = _I
        n = _I(0)
        rc = fn(d, DTYPES[dtype], rep, smem, ctypes.byref(n))
        if rc != 0 or n.value < 1:
            raise RuntimeError(f"rt_flash_decode_occupancy: error {rc}, "
                               f"{n.value} CTAs an SM")
        _OCCUPANCY[key] = n.value
    return _OCCUPANCY[key]


def split_partials(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   causal: bool, bk: int, scale: float
                   ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, SplitPlan]:
    """The split route's first pass on CUDA tensors (shapes as
    :func:`check_split_operands`): ``(m, l, acc, plan)`` with ``m``, ``l``
    ``(B*Sq*H, n_split)`` and ``acc`` ``(B*Sq*H, n_split, d)`` in f32, query
    rows in q's (b, s, h) order; a causal split wholly past its row has
    ``l = 0``."""
    _check_cuda(q, k, v)
    props = torch.cuda.get_device_properties(q.device)
    smem = check_split_operands(q, k, v, causal=causal, bk=bk,
                                smem_limit=props.shared_memory_per_block_optin)
    (b, sq, h, d), (sk, hkv) = q.shape, k.shape[1:3]
    plan = split_plan(groups=b * sq * hkv, sk=sk, bk=bk,
                      sms=props.multi_processor_count,
                      ctas_per_sm=_ctas_per_sm(d, q.dtype, h // hkv, smem),
                      smem_bytes=smem)
    if plan.ctas > _INT_MAX:
        raise ValueError(f"{plan.ctas} CTAs exceed the launch grid")
    rows = b * sq * h
    m = torch.empty((rows, plan.n_split), dtype=torch.float32, device=q.device)
    l = torch.empty_like(m)
    acc = torch.empty((rows, plan.n_split, d), dtype=torch.float32,
                      device=q.device)
    FLASH_ATTENTION.launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), m.data_ptr(), l.data_ptr(),
        acc.data_ptr(), b, sq, sk, h, hkv, d, bk, plan.n_split,
        plan.split_keys, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        int(causal), scale, DTYPES[q.dtype], smem,
        torch.cuda.current_stream(q.device).cuda_stream, route="split")
    return m, l, acc, plan


def combine(m: torch.Tensor, l: torch.Tensor, acc: torch.Tensor, *,
            shape: tuple, dtype: torch.dtype) -> torch.Tensor:
    """The split route's second pass: the partials of
    :func:`split_partials` merged in split order into a new tensor of
    ``shape`` (q's, ``(B, Sq, H, d)``) and ``dtype``."""
    rows, n_split, d = acc.shape
    if m.shape != (rows, n_split) or l.shape != m.shape or any(
            t.dtype != torch.float32 or not t.is_contiguous() or
            t.device.type != "cuda" for t in (m, l, acc)):
        raise ValueError("expected contiguous f32 CUDA partials m, l "
                         "(rows, n_split) and acc (rows, n_split, d)")
    if dtype not in DTYPES or rows * d != torch.Size(shape).numel():
        raise ValueError(f"cannot combine {tuple(acc.shape)} into {shape} {dtype}")
    out = torch.empty(shape, dtype=dtype, device=acc.device)
    FLASH_COMBINE.launch(m.data_ptr(), l.data_ptr(), acc.data_ptr(),
                         out.data_ptr(), rows, n_split, d, DTYPES[dtype],
                         torch.cuda.current_stream(acc.device).cuda_stream)
    return out


def flash_attention_split(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool, bk: int, scale: float
                          ) -> torch.Tensor:
    """The split route on CUDA tensors, q ``(B, Sq, H, d)``, k and v
    ``(B, Sk, Hkv, d)`` (views as :func:`check_split_operands` allows),
    the scores scaled by ``scale``; returns a new ``(B, Sq, H, d)`` tensor
    of q's dtype."""
    m, l, acc, _ = split_partials(q, k, v, causal=causal, bk=bk, scale=scale)
    return combine(m, l, acc, shape=tuple(q.shape), dtype=q.dtype)
