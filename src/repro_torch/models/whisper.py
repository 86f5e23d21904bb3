"""Whisper-style encoder-decoder transformer backbone (arXiv:2212.04356;
the reference's ``repro/models/whisper.py``).

The conv/mel audio frontend is a stub, as in the reference: the batch
carries precomputed frame embeddings ``(B, S_frames, d)``, the output the
two-conv frontend would give.  Everything downstream is real: a
bidirectional pre-LN encoder with sinusoidal positions, a causal decoder
with learned positions and cross-attention, and a tied unembedding.

Layers are stacked on a leading "layers" axis (the reference scans them
with ``lax.scan``; here a loop over that axis).  ``remat`` other than
``"none"`` checkpoints each encoder and each decoder layer (the
reference's ``jax.checkpoint``): the backward keeps a layer's input and
recomputes the rest; ``"dots"`` keeps the matmul outputs too, as in
:mod:`.lm` (the reference checkpoints it as ``"full"``: the same grads).  :func:`prefill` encodes the frames once and
caches each layer's cross-attention K/V; :func:`decode_step` grows the
self-attention cache a token at a time, in place.  The cache is
``{"self_k", "self_v", "cross_k", "cross_v": (L, B, S, H, hd), "length":
int}`` with the length on the host.

On a mesh (the serve steps of ``train/steps.py``) every leaf comes as the
rank's block (``dist.collectives.LocalBlock``) and the layers compute on
their blocks, as :mod:`.lm`'s do: the encoder on the rank's rows of the
frames, the attention on the rank's heads (every head where they do not
divide ``model``), the MLP column- then row-parallel, the tied
vocabulary split in :func:`~.common.embed` and
:func:`~.common.unembed`.  :func:`prefill` writes the blocks of the
cache it is given; decode reads the self cache as :mod:`.attention`
does (split by sequence under the context's ``cache_seq_axis``) and the
cross cache by its own placement: split by heads, whole, or split by
sequence, whose softmax is completed by three all-reduces.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from .attention import (
    AttnConfig,
    _chunked_attn,
    _dense_attn,
    _kv_for,
    _project,
    _split_softmax,
    _to_heads,
    attention,
    attn_spec,
    decode_attention,
    write_block,
)
from .common import (
    ParamSpec,
    block,
    embed,
    gelu_mlp,
    gelu_mlp_spec,
    layernorm,
    layernorm_spec,
    masked_xent,
    remat,
    row_parallel,
    unembed,
    unstack,
    weight,
)
from .lm import _stack_spec, pad_vocab


@dataclass(frozen=True)
class WhisperConfig:
    name: str
    n_layers: int                  # encoder layers == decoder layers
    d_model: int
    n_heads: int
    d_ff: int
    vocab: int
    max_frames: int = 32768        # stub-frontend frame positions
    max_text: int = 32768
    attn_impl: str = "chunked"     # dense | chunked | flash
    attn_chunk: int = 1024
    norm_eps: float = 1e-5
    dtype: torch.dtype = torch.bfloat16
    remat: str = "none"            # none | full | dots (as lm's)
    vocab_pad_multiple: int = 2048
    z_loss: float = 0.0

    @property
    def head_dim_(self) -> int:
        return self.d_model // self.n_heads

    @property
    def vocab_padded(self) -> int:
        return pad_vocab(self.vocab, self.vocab_pad_multiple)

    def attn_cfg(self, *, causal: bool) -> AttnConfig:
        return AttnConfig(d_model=self.d_model, n_heads=self.n_heads,
                          n_kv_heads=self.n_heads, head_dim=self.head_dim_,
                          causal=causal, rope_fraction=0.0,
                          impl=self.attn_impl, chunk_size=self.attn_chunk)


# ---------------------------------------------------------------------------
# specs
# ---------------------------------------------------------------------------


def whisper_spec(cfg: WhisperConfig) -> dict:
    enc_layer = {
        "ln_attn": layernorm_spec(cfg.d_model),
        "attn": attn_spec(cfg.attn_cfg(causal=False)),
        "ln_ffn": layernorm_spec(cfg.d_model),
        "mlp": gelu_mlp_spec(cfg.d_model, cfg.d_ff),
    }
    dec_layer = {
        "ln_self": layernorm_spec(cfg.d_model),
        "self_attn": attn_spec(cfg.attn_cfg(causal=True)),
        "ln_cross": layernorm_spec(cfg.d_model),
        "cross_attn": attn_spec(cfg.attn_cfg(causal=False)),
        "ln_ffn": layernorm_spec(cfg.d_model),
        "mlp": gelu_mlp_spec(cfg.d_model, cfg.d_ff),
    }
    return {
        "enc": {
            "layers": _stack_spec(enc_layer, cfg.n_layers),
            "ln_f": layernorm_spec(cfg.d_model),
        },
        "dec": {
            # tied embedding/unembedding at 1/sqrt(d): the tied logits
            # start O(1)
            "embedding": ParamSpec((cfg.vocab_padded, cfg.d_model),
                                   ("vocab", "embed"),
                                   scale=cfg.d_model ** -0.5),
            "pos": ParamSpec((cfg.max_text, cfg.d_model), (None, "embed"),
                             scale=0.01),
            "layers": _stack_spec(dec_layer, cfg.n_layers),
            "ln_f": layernorm_spec(cfg.d_model),
        },
    }


def _sinusoid(s: int, d: int, device=None) -> torch.Tensor:
    """``(s, d)`` f32: sines then cosines of ``d // 2`` frequencies."""
    pos = torch.arange(s, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(d // 2, dtype=torch.float32, device=device)[None, :]
    ang = pos * torch.exp(-math.log(10000.0) * dim / max(d // 2 - 1, 1))
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


# ---------------------------------------------------------------------------
# encoder
# ---------------------------------------------------------------------------


def encode(params, cfg: WhisperConfig, frames):
    """frames: (B, S_f, d) stub frontend output -> encoder states.  The
    self-attention is bidirectional: under ``attn_impl="flash"`` the
    kernel's tile route runs with the causal skip off."""
    h = frames.to(cfg.dtype)
    h = h + _sinusoid(h.shape[1], cfg.d_model, h.device).to(cfg.dtype)[None]
    for p_l in unstack(params["enc"]["layers"], cfg.n_layers):
        h = remat(_enc_layer, h, p_l, cfg, mode=cfg.remat)
    return layernorm(params["enc"]["ln_f"], h, cfg.norm_eps)


def _enc_layer(h, p_l, cfg: WhisperConfig):
    a, _ = attention(p_l["attn"], cfg.attn_cfg(causal=False),
                     layernorm(p_l["ln_attn"], h, cfg.norm_eps))
    h = h + a
    return h + gelu_mlp(p_l["mlp"], layernorm(p_l["ln_ffn"], h, cfg.norm_eps))


# ---------------------------------------------------------------------------
# decoder
# ---------------------------------------------------------------------------


def _cross_attention(p, cfg: WhisperConfig, x, enc_k, enc_v):
    """x: (B, Sq, d) decoder states attending to the encoder's K/V.
    Chunked (online softmax) under ``attn_impl="chunked"`` when Sq > 1,
    else dense, under ``"flash"`` too, as in the reference: the kernel
    never takes the cross-attention.  On a mesh the q heads are the
    rank's; ``enc_k``, ``enc_v`` are the K/V of the heads the rank's
    ``wk`` gives (prefill) or the cross cache's blocks (decode:
    :func:`_cross_decode`)."""
    dt = x.dtype
    q = _project(x, weight(p["wq"], dt, keep=1))
    heads = block(p["wq"], 1)
    if not isinstance(enc_k, torch.Tensor):
        return _cross_decode(p, q, heads, enc_k, enc_v, dt)
    enc_k, enc_v, _ = _kv_for(enc_k, enc_v, heads, block(p["wk"], 1), 1)
    if cfg.attn_impl == "chunked" and q.shape[1] > 1:
        out = _chunked_attn(q, enc_k, enc_v, causal=False, chunk=cfg.attn_chunk)
    else:
        out = _dense_attn(q, enc_k, enc_v, causal=False)
    return row_parallel(out, heads, p["wo"], dt)


def _cross_decode(p, q, heads, ck, cv, dt):
    """One token's cross-attention on the cross cache's blocks ``ck``,
    ``cv`` (``LocalBlock`` (B, S_blk, H_blk, hd)): the q heads as the
    cache's heads, dense where the cache holds its frames whole; where
    they are split by sequence, the local scores and the softmax
    completed over the axis (:func:`~.attention._split_softmax`), the
    probabilities kept in f32 as the dense path keeps them."""
    c_heads = ck.block(2)
    q = _to_heads(q, heads, c_heads, ck.mesh)
    axis = ck.sharding.spec[1]
    if axis is None:
        out = _dense_attn(q, ck.tensor, cv.tensor, causal=False)
    else:
        scale = 1.0 / math.sqrt(q.shape[-1])
        s = torch.einsum("bqhd,bkhd->bhqk", q.float(), ck.tensor.float()) * scale
        out = _split_softmax(s, cv.tensor, "bhqk,bkhd->bhqd", ck.mesh,
                            axis).transpose(1, 2).to(dt)
    return row_parallel(out, c_heads, p["wo"], dt)


def _enc_kv(p_l, cfg: WhisperConfig, enc_out):
    """The cross-attention's K and V of the encoder states (on a mesh, of
    the heads the rank's ``wk`` block gives)."""
    dt = enc_out.dtype
    return (_project(enc_out, weight(p_l["cross_attn"]["wk"], dt, keep=1)),
            _project(enc_out, weight(p_l["cross_attn"]["wv"], dt, keep=1)))


def _dec_layer(p_l, cfg: WhisperConfig, h, enc_kv, *, self_cache=None,
               cache_len: int | None = None):
    """One decoder layer; returns the new residual stream and the layer's
    self-attention (k, v): the prompt's, or the cache written in place at
    ``cache_len``."""
    acfg = cfg.attn_cfg(causal=True)
    x = layernorm(p_l["ln_self"], h, cfg.norm_eps)
    if self_cache is None:
        a, new_cache = attention(p_l["self_attn"], acfg, x)
    else:
        a, ck, cv = decode_attention(p_l["self_attn"], acfg, x, *self_cache,
                                     cache_len)
        new_cache = (ck, cv)
    h = h + a
    x = layernorm(p_l["ln_cross"], h, cfg.norm_eps)
    h = h + _cross_attention(p_l["cross_attn"], cfg, x, *enc_kv)
    h = h + gelu_mlp(p_l["mlp"], layernorm(p_l["ln_ffn"], h, cfg.norm_eps))
    return h, new_cache


def _embed(params, cfg: WhisperConfig, tokens, start: int = 0):
    """Token embeddings plus the learned positions ``start ..`` (on a
    mesh the positions' rows looked up as :func:`~.common.embed` looks
    up tokens: the table may be split over ``model`` by its rows)."""
    s = tokens.shape[1]
    h = embed(params["dec"]["embedding"], tokens).to(cfg.dtype)
    pos = params["dec"]["pos"]
    if isinstance(pos, torch.Tensor):
        return h + pos[start:start + s].to(cfg.dtype)[None]
    at = torch.arange(start, start + s, device=h.device)
    return h + embed(pos, at).to(cfg.dtype)[None]


def decode_train(params, cfg: WhisperConfig, tokens, enc_out):
    """Teacher-forced decoder pass (training)."""
    h = _embed(params, cfg, tokens)
    for p_l in unstack(params["dec"]["layers"], cfg.n_layers):
        h = remat(_dec_train_layer, h, p_l, cfg, enc_out, mode=cfg.remat)
    return layernorm(params["dec"]["ln_f"], h, cfg.norm_eps)


def _dec_train_layer(h, p_l, cfg: WhisperConfig, enc_out):
    """One teacher-forced decoder layer, the encoder's K/V included (the
    reference's checkpointed body)."""
    return _dec_layer(p_l, cfg, h, _enc_kv(p_l, cfg, enc_out))[0]


def loss_fn(params, cfg: WhisperConfig, batch):
    """batch: frames (B,S_f,d), tokens (B,S_t), labels, mask."""
    enc_out = encode(params, cfg, batch["frames"])
    h = decode_train(params, cfg, batch["tokens"], enc_out)
    logits = _logits(params, cfg, h)
    loss = masked_xent(logits, batch["labels"], batch.get("mask"),
                       vocab=cfg.vocab, vocab_padded=cfg.vocab_padded,
                       z_loss=cfg.z_loss)
    return loss, {"loss": loss, "aux_loss": 0.0}


def _logits(params, cfg: WhisperConfig, h):
    """The tied unembedding: the decoder's embedding, transposed."""
    return unembed(params["dec"]["embedding"], h, tied=True)


# ---------------------------------------------------------------------------
# prefill / decode (inference)
# ---------------------------------------------------------------------------


def cache_spec(cfg: WhisperConfig, batch: int, max_len: int,
               n_frames: int | None = None) -> dict:
    h, hd = cfg.n_heads, cfg.head_dim_
    nf = n_frames or cfg.max_frames
    self_shape = (cfg.n_layers, batch, max_len, h, hd)
    cross_shape = (cfg.n_layers, batch, nf, h, hd)
    axes = ("layers", "batch", "seq", "kv_heads", "head_dim")
    return {
        "self_k": ParamSpec(self_shape, axes, init="zeros", dtype=cfg.dtype),
        "self_v": ParamSpec(self_shape, axes, init="zeros", dtype=cfg.dtype),
        "cross_k": ParamSpec(cross_shape, axes, init="zeros", dtype=cfg.dtype),
        "cross_v": ParamSpec(cross_shape, axes, init="zeros", dtype=cfg.dtype),
        "length": ParamSpec((), (), init="zeros", dtype=torch.int32),
    }


def prefill(params, cfg: WhisperConfig, batch, *, max_len: int | None = None,
            cache: dict | None = None):
    """Encode the frames, prefill the decoder on the prompt tokens; returns
    (last-token logits, cache).  The self-attention K/V go into a cache of
    ``max(max_len, S)`` positions, zero past the prompt (the reference's
    right padding); the cross K/V keep the frames' length.  ``cache`` (a
    mesh step's): the rank's zero blocks of the four K/V leaves, each
    written with the part it holds (its rows, heads and positions)."""
    frames, tokens = batch["frames"], batch["tokens"]
    b, s = tokens.shape
    enc_out = encode(params, cfg, frames)
    h = _embed(params, cfg, tokens)
    dev = h.device
    if cache is None:
        self_shape = (cfg.n_layers, b, max(s, max_len or 0), cfg.n_heads,
                      cfg.head_dim_)
        cross_shape = (cfg.n_layers, b, enc_out.shape[1], cfg.n_heads,
                       cfg.head_dim_)
        cache = {"self_k": torch.zeros(self_shape, dtype=cfg.dtype, device=dev),
                 "self_v": torch.zeros(self_shape, dtype=cfg.dtype, device=dev),
                 "cross_k": torch.empty(cross_shape, dtype=cfg.dtype, device=dev),
                 "cross_v": torch.empty(cross_shape, dtype=cfg.dtype, device=dev)}
    for i, p_l in enumerate(unstack(params["dec"]["layers"], cfg.n_layers)):
        enc_kv = _enc_kv(p_l, cfg, enc_out)
        h, kv = _dec_layer(p_l, cfg, h, enc_kv)
        for (name, attn), pair in ((("self", "self_attn"), kv),
                                   (("cross", "cross_attn"), enc_kv)):
            for t, leaf in zip(pair, (f"{name}_k", f"{name}_v")):
                write_block(cache[leaf][i], t, block(p_l[attn]["wk"], 1))
    h = layernorm(params["dec"]["ln_f"], h, cfg.norm_eps)
    logits = _logits(params, cfg, h[:, -1:, :])
    return logits, {**cache, "length": s}


def decode_step(params, cfg: WhisperConfig, cache, batch):
    """One-token decode with the cached self and cross K/V.  batch: tokens
    (B, 1); the self cache is written in place at ``length`` (a host int),
    and the returned cache holds the same tensors with ``length + 1``."""
    length = cache["length"]
    h = _embed(params, cfg, batch["tokens"], start=length)
    for i, p_l in enumerate(unstack(params["dec"]["layers"], cfg.n_layers)):
        h, _ = _dec_layer(p_l, cfg, h, (cache["cross_k"][i], cache["cross_v"][i]),
                          self_cache=(cache["self_k"][i], cache["self_v"][i]),
                          cache_len=length)
    h = layernorm(params["dec"]["ln_f"], h, cfg.norm_eps)
    return _logits(params, cfg, h), cache | {"length": length + 1}
