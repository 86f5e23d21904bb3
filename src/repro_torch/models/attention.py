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

The reference's sequence-parallel paths (``_seq_sharded_cache_update``,
``_flash_decode``) run under ``shard_map`` on a mesh and wait for ROADMAP
§1 item 5c; decode here is its single-device path.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch
from torch.profiler import record_function

from .common import ParamSpec, apply_rope, remat, rope_angles

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


def _qkv(p, cfg: AttnConfig, x, positions):
    dt = x.dtype
    q = _project(x, p["wq"].to(dt))
    k = _project(x, p["wk"].to(dt))
    v = _project(x, p["wv"].to(dt))
    if cfg.qkv_bias:
        q = q + p["bq"].to(dt)
        k = k + p["bk"].to(dt)
        v = v + p["bv"].to(dt)
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
    the output and this layer's (k, v)."""
    b, s, _ = x.shape
    if positions is None:
        positions = torch.arange(s, device=x.device)[None].expand(b, s)
    q, k, v = _qkv(p, cfg, x, positions)
    n_rep = cfg.n_heads // cfg.n_kv_heads
    if cfg.impl == "flash":
        from ..kernels.attention.ops import flash_attention
        # one block of the whole sequence: the op's rule (blocks divide
        # the lengths) takes it at any S, where the reference's default
        # 512 refuses whisper's 1500 frames; the card runs the ranking's
        # first tiling either way, masking the ragged edge
        out = flash_attention(q, k, v, causal=cfg.causal, bq=s, bk=s)
    elif cfg.impl == "chunked":
        out = _chunked_attn(q, k, v, causal=cfg.causal, chunk=cfg.chunk_size)
    else:
        out = _dense_attn(q, _repeat_kv(k, n_rep), _repeat_kv(v, n_rep),
                          causal=cfg.causal)
    return _out_proj(out, p["wo"].to(x.dtype)), (k, v)


def decode_attention(p, cfg: AttnConfig, x, cache_k, cache_v, cache_len: int):
    """One-token decode against a KV cache.

    x: (B, 1, d); cache_k/v: (B, S_max, kvH, hd); cache_len: the current
    length, a host int (an index on the host costs no device sync).  The
    new K and V are written into the cache tensors in place, at
    ``cache_len``; the scores are masked to the ``cache_len + 1`` keys
    written so far.  GQA-aware, f32 only in the score and probability
    tiles: the probabilities stay f32 (as the reference's), only the cache
    is in the low dtype.  Returns (out (B,1,d), cache_k, cache_v).
    """
    b = x.shape[0]
    positions = torch.full((b, 1), cache_len, device=x.device)
    q, k_new, v_new = _qkv(p, cfg, x, positions)
    cache_k[:, cache_len] = k_new[:, 0]
    cache_v[:, cache_len] = v_new[:, 0]
    s_max, kvh = cache_k.shape[1], cache_k.shape[2]
    _, _, h, d = q.shape
    qg = q.reshape(b, kvh, h // kvh, d)
    s = torch.einsum("bkrd,bskd->bkrs", qg.float(), cache_k.float())
    s = s * (1.0 / math.sqrt(cfg.head_dim))
    valid = torch.arange(s_max, device=x.device) <= cache_len
    pr = torch.softmax(s.masked_fill(~valid, NEG_INF), dim=-1)
    out = torch.einsum("bkrs,bskd->bkrd", pr, cache_v.float())
    out = out.reshape(b, 1, h, d).to(x.dtype)
    return _out_proj(out, p["wo"].to(x.dtype)), cache_k, cache_v
