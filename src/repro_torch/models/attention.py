"""GQA attention: dense, chunked (the flash algorithm in plain PyTorch ops)
and the hand-written kernel, plus KV-cache decode (the reference's
``repro/models/attention.py``).

``impl`` selection:

* ``dense``   — materialises the (Sq, Sk) scores; fine for short sequences.
* ``chunked`` — online softmax over (q-block x KV-chunk) tiles in loops:
  the plain version of the flash algorithm, GQA unrepeated.
* ``flash``   — the port's flash-attention op
  (``kernels/attention/ops.py``): its CUDA kernel on a CUDA tensor, its
  plain version on a CPU tensor.

On a mesh (the serve steps of ``train/steps.py``, each leaf the rank's
block, ``dist.collectives.LocalBlock``) the projections are
tensor-parallel over ``model``: Q, K and V column-parallel on the rank's
heads, each local q head reading its own KV head (global q head //
``n_rep``; KV heads held whole are sliced, never repeated), the
attention on the local heads (the flash op too), and the output
projection row-parallel with one all-reduce.  The decode cache is the
rank's block.  With the cache sequence-sharded (the context's
``cache_seq_axis``: KV heads that do not divide ``model``) decode is the
reference's ``_flash_decode``: the rank whose sequence range holds the
length writes the new K and V (the length is a host int, so no
collective decides it), the masked scores over the local columns, and
the softmax completed by three all-reduces over the axis (max,
denominator, numerator), in plain ops as the reference's einsums (no
kernel).
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch
from torch.profiler import record_function

from .common import (ParamSpec, apply_rope, block, remat, rope_angles,
                     row_parallel, weight)

NEG_INF = -1e30


@dataclass(frozen=True)
class AttnConfig:
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    qkv_bias: bool = False
    rope_fraction: float = 1.0
    rope_theta: float = 10000.0
    causal: bool = True
    impl: str = "dense"          # dense | chunked | flash
    chunk_size: int = 1024


def attn_spec(cfg: AttnConfig) -> dict:
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    p = {
        "wq": ParamSpec((d, h, hd), ("embed", "heads", "head_dim")),
        "wk": ParamSpec((d, kv, hd), ("embed", "kv_heads", "head_dim")),
        "wv": ParamSpec((d, kv, hd), ("embed", "kv_heads", "head_dim")),
        "wo": ParamSpec((h, hd, d), ("heads", "head_dim", "embed")),
    }
    if cfg.qkv_bias:
        p["bq"] = ParamSpec((h, hd), ("heads", "head_dim"), init="zeros")
        p["bk"] = ParamSpec((kv, hd), ("kv_heads", "head_dim"), init="zeros")
        p["bv"] = ParamSpec((kv, hd), ("kv_heads", "head_dim"), init="zeros")
    return p


def _project(x, w):
    """``einsum("bsd,dhk->bshk", x, w)`` as one matmul."""
    return (x @ w.reshape(w.shape[0], -1)).unflatten(-1, w.shape[1:])


def _out_proj(out, wo):
    """``einsum("bshk,hkd->bsd", out, wo)`` as one matmul."""
    return out.reshape(*out.shape[:2], -1) @ wo.reshape(-1, wo.shape[-1])


def _kv_for(k, v, q_heads: tuple[int, int, bool],
            kv_heads: tuple[int, int, bool], n_rep: int):
    """The K and V heads the q heads ``q_heads`` read (each global q head
    its KV head, ``q // n_rep``), from ``k``, ``v`` holding the KV heads
    ``kv_heads``, and how many q heads share each: the held range sliced
    where the q heads map onto it evenly, else one KV head a q head."""
    qlo, qhi = q_heads[:2]
    klo, khi = kv_heads[:2]
    first, last = qlo // n_rep, (qhi - 1) // n_rep
    if first < klo or last >= khi:
        raise ValueError(f"q heads {(qlo, qhi)} read KV heads "
                         f"{(first, last + 1)}, the rank holds {(klo, khi)}")
    nq, nk = qhi - qlo, last + 1 - first
    if (first, last + 1) == (klo, khi) and nq == nk * n_rep:
        return k, v, n_rep
    if nq % nk == 0 and all((qlo + i) // n_rep - first == i // (nq // nk)
                            for i in range(nq)):
        return (k[:, :, first - klo:last + 1 - klo],
                v[:, :, first - klo:last + 1 - klo], nq // nk)
    idx = torch.tensor([(qlo + i) // n_rep - klo for i in range(nq)],
                       device=k.device)
    return k.index_select(2, idx), v.index_select(2, idx), 1


def _qkv(p, cfg: AttnConfig, x, positions):
    dt = x.dtype
    q = _project(x, weight(p["wq"], dt, keep=1))
    k = _project(x, weight(p["wk"], dt, keep=1))
    v = _project(x, weight(p["wv"], dt, keep=1))
    if cfg.qkv_bias:
        q = q + weight(p["bq"], dt, keep=0)
        k = k + weight(p["bk"], dt, keep=0)
        v = v + weight(p["bv"], dt, keep=0)
    if cfg.rope_fraction > 0:
        cos, sin, rot = rope_angles(positions, cfg.head_dim,
                                    theta=cfg.rope_theta,
                                    fraction=cfg.rope_fraction)
        # rope math in f32 (cos/sin), the result back in the compute dtype
        q = apply_rope(q, cos, sin, rot).to(dt)
        k = apply_rope(k, cos, sin, rot).to(dt)
    return q, k, v


def _repeat_kv(k, n_rep: int):
    """Each KV head repeated ``n_rep`` times in place (``jnp.repeat``'s
    order)."""
    return k if n_rep == 1 else k.repeat_interleave(n_rep, dim=2)


def _dense_attn(q, k, v, *, causal: bool, q_offset=0):
    b, sq, h, d = q.shape
    sk = k.shape[1]
    scale = 1.0 / math.sqrt(d)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        rows = q_offset + torch.arange(sq, device=q.device)[:, None]
        cols = torch.arange(sk, device=q.device)[None, :]
        s = s.masked_fill(rows < cols, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    return out.to(q.dtype)


def _kv_tile(m, l, acc, qb, kb, vb, rows, cols):
    """One (q-block x KV-chunk) tile of the online softmax: the running
    max ``m``, sum ``l`` and f32 accumulator ``acc`` of the q block
    ``qb`` (f32) updated by the keys ``kb`` and values ``vb`` (the compute
    dtype); ``cols`` is None without the causal mask."""
    s = torch.einsum("bqhrd,bkhd->bhrqk", qb, kb.float())
    if cols is not None:
        s = s.masked_fill(rows[:, None] < cols[None, :], NEG_INF)
    m_new = torch.maximum(m, s.amax(dim=-1))
    p = torch.exp(s - m_new[..., None])
    alpha = torch.exp(m - m_new)
    l = l * alpha + p.sum(dim=-1)
    acc = acc * alpha[..., None] + torch.einsum(
        "bhrqk,bkhd->bhrqd", p.to(vb.dtype).float(), vb.float())
    return m_new, l, acc


@record_function("chunked_attention")
def _chunked_attn(q, k, v, *, causal: bool, chunk: int):
    """Online softmax over (q-block x KV-chunk) tiles, in loops, GQA-aware
    (KV heads are never repeated: the q-group dim rides along in the
    einsums).  q, k and v stay in the compute dtype; f32 appears only in
    the score and accumulator tiles (products of the compute dtype,
    accumulated in f32, as the reference's ``preferred_element_type``),
    and the probabilities are rounded to v's dtype before ``p @ v``.

    Score tiles are (B, kvH, rep, cq, ck): O(chunk^2), never O(S^2).  A
    causal KV chunk wholly past its q block is skipped: the reference
    scores it at -1e30 everywhere, which adds exactly 0 to the sums and
    rescales them by exactly 1, so skipping it changes no bit.  Under
    autograd each tile is checkpointed (:func:`~.common.remat`), as the
    reference's ``jax.checkpoint(kv_chunk)``: the backward recomputes the
    score and probability tiles instead of keeping all of them, the whole
    (S, S) matrix in chunks.
    """
    b, sq, h, d = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    rep = h // kvh
    cq = min(chunk, sq)
    ck = min(chunk, sk)
    if sq % cq or sk % ck:
        raise ValueError(f"chunk {chunk} does not divide the lengths {(sq, sk)}")
    scale = 1.0 / math.sqrt(d)
    qs = (q * torch.tensor(scale, dtype=q.dtype)).reshape(b, sq, kvh, rep, d)
    blocks = []
    for q0 in range(0, sq, cq):
        qb = qs[:, q0:q0 + cq].float()                       # (b,cq,kvh,rep,d)
        rows = q0 + torch.arange(cq, device=q.device)
        m = torch.full((b, kvh, rep, cq), NEG_INF, device=q.device)
        l = torch.zeros((b, kvh, rep, cq), device=q.device)
        acc = torch.zeros((b, kvh, rep, cq, d), device=q.device)
        for k0 in range(0, sk, ck):
            if causal and k0 > q0 + cq - 1:
                break
            cols = k0 + torch.arange(ck, device=q.device) if causal else None
            m, l, acc = remat(_kv_tile, m, l, acc, qb, k[:, k0:k0 + ck],
                              v[:, k0:k0 + ck], rows, cols)
        out = acc / l.clamp_min(1e-30)[..., None]            # (b,kvh,rep,cq,d)
        blocks.append(out.permute(0, 3, 1, 2, 4))            # (b,cq,kvh,rep,d)
    return torch.cat(blocks, dim=1).reshape(b, sq, h, d).to(q.dtype)


def attention(p, cfg: AttnConfig, x, *, positions=None):
    """Full-sequence attention (train / prefill). x: (B, S, d).  Returns
    the output and this layer's (k, v): on a mesh the KV heads the rank's
    ``wk`` block gives (:func:`~.common.block` of its dim 1)."""
    b, s, _ = x.shape
    if positions is None:
        positions = torch.arange(s, device=x.device)[None].expand(b, s)
    q, k, v = _qkv(p, cfg, x, positions)
    heads = block(p["wq"], 1)
    kq, vq, n_rep = _kv_for(k, v, heads, block(p["wk"], 1),
                            cfg.n_heads // cfg.n_kv_heads)
    if cfg.impl == "flash":
        from ..kernels.attention.ops import flash_attention
        # one block of the whole sequence: the op's rule (blocks divide
        # the lengths) takes it at any S, where the reference's default
        # 512 refuses whisper's 1500 frames; the card runs the ranking's
        # first tiling either way, masking the ragged edge
        out = flash_attention(q, kq, vq, causal=cfg.causal, bq=s, bk=s)
    elif cfg.impl == "chunked":
        out = _chunked_attn(q, kq, vq, causal=cfg.causal, chunk=cfg.chunk_size)
    else:
        out = _dense_attn(q, _repeat_kv(kq, n_rep), _repeat_kv(vq, n_rep),
                          causal=cfg.causal)
    return row_parallel(out, heads, p["wo"], x.dtype), (k, v)


def _to_heads(t, have: tuple[int, int, bool], want: tuple[int, int, bool],
              mesh, dim: int = 2):
    """``t`` (B, S, heads, hd; the heads on ``dim``) holding the heads
    ``have``, as the heads ``want``: gathered over ``model`` where
    ``have`` is split and ``want`` reaches past it, then sliced."""
    if have[:2] == want[:2]:
        return t
    lo = have[0]
    if have[2] and not (have[0] <= want[0] and want[1] <= have[1]):
        from ..dist.collectives import all_gather

        t, lo = all_gather(t, mesh, "model", dim), 0
    return t.narrow(dim, want[0] - lo, want[1] - want[0])


def write_block(dst, kv, heads: tuple[int, int, bool]) -> None:
    """The part of a layer's prompt K or V (``kv`` (B_loc, S, heads, hd),
    holding the KV heads ``heads``) that the cache block ``dst``
    (``LocalBlock`` (B_loc, S_blk, kvH_blk, hd)) holds, written into it;
    ``dst`` a tensor (B, S_max, kvH, hd): the layer's whole cache."""
    if isinstance(dst, torch.Tensor):
        dst[:, :kv.shape[1]] = kv
        return
    kv = _to_heads(kv, heads, dst.block(2), dst.mesh)
    lo, hi, _ = dst.block(1)
    n = min(hi, kv.shape[1]) - lo
    if n > 0:
        dst.tensor[:, :n] = kv[:, lo:lo + n]


def _flash_decode(q, ck, cv, k_new, v_new, cache_len: int, offset: int, *,
                  mesh, axis: str, n_rep: int, scale: float):
    """The reference's sequence-parallel one-token decode on this rank's
    sequence block ``ck``, ``cv`` (B, S_loc, kvH, hd) of the cache, which
    starts at position ``offset``: the rank whose block holds
    ``cache_len`` writes the new K and V there, then the local scores
    over the global columns, masked past ``cache_len``, and the softmax
    completed over ``axis`` (:func:`_split_softmax`).  q holds every
    head; the cache is never repeated (the q group rides along) and only
    the score and probability tiles are f32, the probabilities rounded to
    the cache's dtype before ``p @ v``."""
    s_loc = ck.shape[1]
    idx = cache_len - offset
    if 0 <= idx < s_loc:
        ck[:, idx] = k_new[:, 0]
        cv[:, idx] = v_new[:, 0]
    b, _, h, d = q.shape
    kvh = ck.shape[2]
    qg = q.reshape(b, kvh, n_rep, d)
    s = torch.einsum("bkrd,bskd->bkrs", qg.float(), ck.float()) * scale
    cols = offset + torch.arange(s_loc, device=q.device)
    s = s.masked_fill(cols > cache_len, NEG_INF)
    out = _split_softmax(s, cv, "bkrs,bskd->bkrd", mesh, axis, cv.dtype)
    return out.reshape(b, 1, h, d).to(q.dtype)


def _split_softmax(s, v, pv: str, mesh, axis: str, p_dtype=None):
    """The softmax of the scores ``s`` (f32 (..., S_loc), masked: this
    rank's columns of rows split over ``axis``) applied to the rank's
    values ``v``, completed by three all-reduces over ``axis``: the rows'
    max, the denominator, and the numerator ``einsum(pv, p, v)`` in f32,
    the probabilities ``p`` rounded to ``p_dtype`` first where given.
    Returns the numerator over the denominator (f32, the rows' dims
    first, as ``pv`` lays them out)."""
    from ..dist.collectives import all_reduce

    m = all_reduce(s.amax(dim=-1), mesh, axis, "max")
    pr = torch.exp(s - m[..., None])
    denom = all_reduce(pr.sum(dim=-1), mesh, axis)
    if p_dtype is not None:
        pr = pr.to(p_dtype)
    num = all_reduce(torch.einsum(pv, pr.float(), v.float()), mesh, axis)
    return num / denom.clamp_min(1e-30)[..., None]


def decode_attention(p, cfg: AttnConfig, x, cache_k, cache_v, cache_len: int):
    """One-token decode against a KV cache.

    x: (B, 1, d); cache_k/v: (B, S_max, kvH, hd); cache_len: the current
    length, a host int (an index on the host costs no device sync).  The
    new K and V are written into the cache tensors in place, at
    ``cache_len``; the scores are masked to the ``cache_len + 1`` keys
    written so far.  GQA-aware, f32 only in the score and probability
    tiles: the probabilities stay f32 (as the reference's), only the cache
    is in the low dtype.  Returns (out (B,1,d), cache_k, cache_v).

    On a mesh the caches are the rank's blocks (``LocalBlock``): its rows,
    and its KV heads or, under the context's ``cache_seq_axis``, its
    sequence range (:func:`_flash_decode`).
    """
    b = x.shape[0]
    positions = torch.full((b, 1), cache_len, device=x.device)
    q, k_new, v_new = _qkv(p, cfg, x, positions)
    heads, kv_heads = block(p["wq"], 1), block(p["wk"], 1)
    n_rep = cfg.n_heads // cfg.n_kv_heads
    scale = 1.0 / math.sqrt(cfg.head_dim)
    if isinstance(cache_k, torch.Tensor):
        ck, cv, c_heads = cache_k, cache_v, (0, cache_k.shape[2], False)
    else:
        from ..dist.sharding import current_context

        ck, cv, c_heads = cache_k.tensor, cache_v.tensor, cache_k.block(2)
        mesh, axis = cache_k.mesh, current_context().cache_seq_axis
        k_new = _to_heads(k_new, kv_heads, c_heads, mesh)
        v_new = _to_heads(v_new, kv_heads, c_heads, mesh)
        if axis is not None:
            lo, _, split = cache_k.block(1, axis)
            if c_heads[1] - c_heads[0] != cfg.n_kv_heads or (
                    not split and dict(zip(mesh.mesh_dim_names,
                                           mesh.shape))[axis] > 1):
                raise ValueError(f"a decode over {axis!r} takes a cache "
                                 f"split over it by sequence, every KV head "
                                 f"whole; this rank holds "
                                 f"{cache_k.sharding.spec}")
            q = _to_heads(q, heads, (0, cfg.n_heads, False), mesh)
            out = _flash_decode(q, ck, cv, k_new, v_new, cache_len, lo,
                                mesh=mesh, axis=axis, n_rep=n_rep, scale=scale)
            return (row_parallel(out, (0, cfg.n_heads, False), p["wo"],
                                 x.dtype), cache_k, cache_v)
        if cache_k.block(1)[2]:
            raise ValueError("a cache split by sequence decodes under the "
                             "context's cache_seq_axis")
    ck[:, cache_len] = k_new[:, 0]
    cv[:, cache_len] = v_new[:, 0]
    kq, vq, rep = _kv_for(ck, cv, heads, c_heads, n_rep)
    s_max, kvh = kq.shape[1], kq.shape[2]
    _, _, h, d = q.shape
    qg = q.reshape(b, kvh, rep, d)
    s = torch.einsum("bkrd,bskd->bkrs", qg.float(), kq.float())
    s = s * scale
    valid = torch.arange(s_max, device=x.device) <= cache_len
    pr = torch.softmax(s.masked_fill(~valid, NEG_INF), dim=-1)
    out = torch.einsum("bkrs,bskd->bkrd", pr, vq.float())
    out = out.reshape(b, 1, h, d).to(x.dtype)
    return row_parallel(out, heads, p["wo"], x.dtype), cache_k, cache_v
