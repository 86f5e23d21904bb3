"""Zamba2 hybrid LM: a Mamba2 backbone with one *shared* attention+MLP
block applied at evenly spaced depths (arXiv:2411.15242; the reference's
``repro/models/zamba2.py``).

The shared block's weights are reused at every application; each
application has its own stacked RMSNorm gain and low-rank (LoRA) adapter
on the attention output, as in the reference.  The shared block fires
before Mamba layer i when ``i % shared_every == 0`` (the reference's
``lax.cond`` on a per-layer flag; here a Python ``if``), and a counter of
applications indexes the per-use parameters and the shared KV cache.

Decode carries one SSM state and one conv state per Mamba layer and one
KV cache per shared-block *application* (``n_shared`` of them, not
``n_layers``).  The cache is ``{"ssm", "conv", "k", "v", "length"}`` with
the length a host int; :func:`decode_step` writes every state in place.

On a mesh (the serve steps of ``train/steps.py``) every leaf and the
cache come as the rank's blocks (``dist.collectives.LocalBlock``): each
Mamba2 layer computes the rank's heads (:func:`.mamba2.mamba2_layer`),
the shared block its attention heads and SwiGLU columns as :mod:`.lm`'s
layers do, its per-application gain and LoRA read through
:func:`~.common.weight`.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from .attention import (AttnConfig, attention, attn_spec, decode_attention,
                        write_block)
from .common import (
    ParamSpec,
    block,
    embed,
    embedding_spec,
    masked_xent,
    remat,
    rmsnorm,
    rmsnorm_spec,
    swiglu,
    swiglu_spec,
    unembed,
    unembed_spec,
    unstack,
    weight,
)
from .lm import _stack_spec, pad_vocab
from .mamba2 import Mamba2Config, mamba2_layer, mamba2_spec


@dataclass(frozen=True)
class Zamba2Config:
    name: str
    n_layers: int                 # Mamba2 layers
    d_model: int
    n_heads: int                  # shared attention block heads
    n_kv_heads: int
    d_ff: int                     # shared block MLP
    vocab: int
    d_state: int = 64
    shared_every: int = 6         # shared block before layer i if i % shared_every == 0
    lora_rank: int = 64
    mamba_head_dim: int = 64
    mamba_chunk: int = 256
    attn_impl: str = "chunked"
    attn_chunk: int = 1024
    norm_eps: float = 1e-5
    dtype: torch.dtype = torch.bfloat16
    remat: str = "none"           # none | full | dots (as lm's)
    vocab_pad_multiple: int = 2048
    z_loss: float = 0.0

    @property
    def n_shared(self) -> int:
        return (self.n_layers + self.shared_every - 1) // self.shared_every

    @property
    def head_dim_(self) -> int:
        return self.d_model // self.n_heads

    @property
    def vocab_padded(self) -> int:
        return pad_vocab(self.vocab, self.vocab_pad_multiple)

    @property
    def mamba_cfg(self) -> Mamba2Config:
        return Mamba2Config(d_model=self.d_model, d_state=self.d_state,
                            head_dim=self.mamba_head_dim,
                            chunk=self.mamba_chunk)

    @property
    def attn_cfg(self) -> AttnConfig:
        return AttnConfig(d_model=self.d_model, n_heads=self.n_heads,
                          n_kv_heads=self.n_kv_heads, head_dim=self.head_dim_,
                          impl=self.attn_impl, chunk_size=self.attn_chunk)


# ---------------------------------------------------------------------------
# parameter specs
# ---------------------------------------------------------------------------


def zamba2_spec(cfg: Zamba2Config) -> dict:
    mamba_layer = {
        "ln": rmsnorm_spec(cfg.d_model),
        "mamba": mamba2_spec(cfg.mamba_cfg),
    }
    d, r, ns = cfg.d_model, cfg.lora_rank, cfg.n_shared
    return {
        "embedding": embedding_spec(cfg.vocab_padded, cfg.d_model),
        "layers": _stack_spec(mamba_layer, cfg.n_layers),
        "shared": {
            "ln_attn": rmsnorm_spec(d),
            "attn": attn_spec(cfg.attn_cfg),
            "ln_ffn": rmsnorm_spec(d),
            "mlp": swiglu_spec(d, cfg.d_ff),
            # per-application specialization (stacked over applications)
            "use_gain": ParamSpec((ns, d), (None, "embed"), init="ones"),
            "lora_a": ParamSpec((ns, d, r), (None, "embed", None),
                                scale=0.01),
            "lora_b": ParamSpec((ns, r, d), (None, None, "embed"),
                                init="zeros"),
        },
        "ln_f": rmsnorm_spec(cfg.d_model),
        "unembed": unembed_spec(cfg.d_model, cfg.vocab_padded),
    }


# ---------------------------------------------------------------------------
# forward (train / prefill path)
# ---------------------------------------------------------------------------


def _apply_shared(ps, cfg: Zamba2Config, h, app_idx: int, *, cache=None,
                  cache_len=None):
    """One application of the shared transformer block.  ``app_idx``
    selects the per-use gain and LoRA.  Returns (h, (k, v)): this
    application's K, V (train/prefill), or the cache tensors, written in
    place at ``cache_len`` (decode)."""
    dt = h.dtype
    x = rmsnorm(ps["ln_attn"], h, cfg.norm_eps) * weight(ps["use_gain"][app_idx], dt)
    if cache is None:
        a, kv = attention(ps["attn"], cfg.attn_cfg, x)
    else:
        a, ck, cv = decode_attention(ps["attn"], cfg.attn_cfg, x, *cache,
                                     cache_len)
        kv = (ck, cv)
    a = a + (x @ weight(ps["lora_a"][app_idx], dt)) @ weight(ps["lora_b"][app_idx], dt)
    h = h + a
    h = h + swiglu(ps["mlp"], rmsnorm(ps["ln_ffn"], h, cfg.norm_eps))
    return h, kv


def _fires(cfg: Zamba2Config, i: int) -> bool:
    """Whether the shared block runs before Mamba layer ``i``."""
    return i % cfg.shared_every == 0


def _layer(h, p_l, ps, cfg: Zamba2Config, app: int | None):
    """Mamba layer ``p_l``, after the shared block's application ``app``
    where it fires (None: it does not).  The reference checkpoints this
    body whole when ``remat`` is not ``"none"`` (``"dots"`` here keeps the
    matmul outputs too, as in :mod:`.lm`: the same grads)."""
    if app is not None:
        h, _ = _apply_shared(ps, cfg, h, app)
    return h + mamba2_layer(p_l["mamba"], cfg.mamba_cfg,
                            rmsnorm(p_l["ln"], h, cfg.norm_eps))


def hidden_states(params, cfg: Zamba2Config, tokens):
    """Embeddings through the hybrid stack; returns the final-normed
    states and the aux loss (0.0).  The reference's ``collect_kv``
    (stacked K/V at every layer) has no caller there and is left out."""
    h = embed(params["embedding"], tokens).to(cfg.dtype)
    ps = params["shared"]
    app = 0
    for i, p_l in enumerate(unstack(params["layers"], cfg.n_layers)):
        shared_app = app if _fires(cfg, i) else None
        h = remat(_layer, h, p_l, ps, cfg, shared_app, mode=cfg.remat)
        app += _fires(cfg, i)
    return rmsnorm(params["ln_f"], h, cfg.norm_eps), 0.0


def loss_fn(params, cfg: Zamba2Config, batch):
    h, aux = hidden_states(params, cfg, batch["tokens"])
    logits = unembed(params["unembed"], h)
    loss = masked_xent(logits, batch["labels"], batch.get("mask"),
                       vocab=cfg.vocab, vocab_padded=cfg.vocab_padded,
                       z_loss=cfg.z_loss)
    return loss, {"loss": loss, "aux_loss": aux}


# ---------------------------------------------------------------------------
# prefill / decode
# ---------------------------------------------------------------------------


def cache_spec(cfg: Zamba2Config, batch: int, max_len: int) -> dict:
    """Decode state: per-Mamba-layer SSM + conv states, per-application
    shared-attention KV (only n_shared caches, not n_layers)."""
    m = cfg.mamba_cfg
    kvh, hd = cfg.n_kv_heads, cfg.head_dim_
    kv_shape = (cfg.n_shared, batch, max_len, kvh, hd)
    kv_axes = (None, "batch", "seq", "kv_heads", "head_dim")
    return {
        "ssm": ParamSpec((cfg.n_layers, batch, m.n_heads, m.d_state,
                          m.head_dim),
                         ("layers", "batch", "heads", None, None),
                         init="zeros", dtype=torch.float32),
        "conv": ParamSpec((cfg.n_layers, batch, m.conv_kernel - 1, m.conv_dim),
                          ("layers", "batch", None, "mamba_inner"),
                          init="zeros", dtype=cfg.dtype),
        "k": ParamSpec(kv_shape, kv_axes, init="zeros", dtype=cfg.dtype),
        "v": ParamSpec(kv_shape, kv_axes, init="zeros", dtype=cfg.dtype),
        "length": ParamSpec((), (), init="zeros", dtype=torch.int32),
    }


def prefill(params, cfg: Zamba2Config, batch, *, max_len: int | None = None,
            cache: dict | None = None):
    """Process the prompt; return (last-token logits, decode cache).

    Each application's K/V is written into a cache of ``max(max_len, S)``
    positions, zero past the prompt (the reference's right padding); each
    Mamba layer's final SSM and conv states into theirs.  ``cache`` (a
    mesh step's): the rank's blocks of the four leaves, written in
    place."""
    tokens = batch["tokens"]
    b, s = tokens.shape
    h = embed(params["embedding"], tokens).to(cfg.dtype)
    ps = params["shared"]
    m = cfg.mamba_cfg
    if cache is None:
        kv_shape = (cfg.n_shared, b, max(s, max_len or 0), cfg.n_kv_heads,
                    cfg.head_dim_)
        cache = {
            "ssm": torch.zeros((cfg.n_layers, b, m.n_heads, m.d_state,
                                m.head_dim), dtype=torch.float32,
                               device=h.device),
            "conv": torch.zeros((cfg.n_layers, b, m.conv_kernel - 1,
                                 m.conv_dim), dtype=cfg.dtype, device=h.device),
            "k": torch.zeros(kv_shape, dtype=cfg.dtype, device=h.device),
            "v": torch.zeros(kv_shape, dtype=cfg.dtype, device=h.device)}
    app = 0
    for i, p_l in enumerate(unstack(params["layers"], cfg.n_layers)):
        if _fires(cfg, i):
            h, (k, v) = _apply_shared(ps, cfg, h, app)
            heads = block(ps["attn"]["wk"], 1)
            write_block(cache["k"][app], k, heads)
            write_block(cache["v"][app], v, heads)
            app += 1
        h = h + mamba2_layer(p_l["mamba"], m, rmsnorm(p_l["ln"], h, cfg.norm_eps),
                             ssm_state=cache["ssm"][i],
                             conv_state=cache["conv"][i])   # written in place
    h = rmsnorm(params["ln_f"], h, cfg.norm_eps)
    logits = unembed(params["unembed"], h[:, -1:, :])
    return logits, {**cache, "length": s}


def decode_step(params, cfg: Zamba2Config, cache, batch):
    """One-token decode.  batch: tokens (B, 1).  cache as :func:`prefill`
    returns it; its tensors are updated in place (each application's K/V
    at ``length``, each layer's SSM and conv states), and the returned
    cache holds them with ``length + 1``."""
    h = embed(params["embedding"], batch["tokens"]).to(cfg.dtype)
    ps = params["shared"]
    length = cache["length"]
    app = 0
    for i, p_l in enumerate(unstack(params["layers"], cfg.n_layers)):
        if _fires(cfg, i):
            h, _ = _apply_shared(ps, cfg, h, app,
                                 cache=(cache["k"][app], cache["v"][app]),
                                 cache_len=length)
            app += 1
        h = h + mamba2_layer(p_l["mamba"], cfg.mamba_cfg,
                             rmsnorm(p_l["ln"], h, cfg.norm_eps),
                             ssm_state=cache["ssm"][i],
                             conv_state=cache["conv"][i])   # written in place
    h = rmsnorm(params["ln_f"], h, cfg.norm_eps)
    logits = unembed(params["unembed"], h)
    return logits, {**cache, "length": length + 1}
