"""Decoder-only transformer LM (the reference's ``repro/models/lm.py``).

Covers internlm2-1.8b, qwen1.5-110b, minitron-4b and glm4-9b (dense, GQA,
optional QKV bias / partial RoPE), granite-moe / qwen3-moe (the MoE FFN of
:mod:`.moe`, its load-balance aux loss summed over the layers) and
pixtral-12b (a prefix of precomputed patch embeddings prepended to the
token stream: ``image_prefix`` / ``extra_embeds``).

Layers keep the reference's parameter layout: stacked on a leading
"layers" axis (``scan_layers=True``, which the reference scans with
``lax.scan``; here a loop over that axis), or one ``layer_{i}`` subtree
each.  ``remat`` chooses what the backward keeps of a layer, as the
reference's ``_remat``: ``"full"`` checkpoints each layer (only its input
is kept, the rest recomputed), ``"dots"`` keeps the layer's matmul
outputs and recomputes the rest, ``"none"`` keeps everything; with grad
off every setting is the same plain forward.  The KV cache is ``{"k",
"v": (L, B, S_max, kvH, hd), "length": int}`` with the length on the
host; :func:`decode_step` writes into the cache tensors in place.  On a
mesh (the serve steps of ``train/steps.py``) every leaf and the cache
come as the rank's blocks and the layers run unchanged on them, the
tensor-parallel work inside ``common``, ``attention`` and ``moe``.
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
    remat,
    rmsnorm,
    rmsnorm_spec,
    swiglu,
    swiglu_spec,
    tree_map,
    unembed,
    unembed_spec,
    unstack,
)
from .common import masked_xent as _masked_xent
from .moe import MoEConfig, moe_ffn, moe_spec


def pad_vocab(vocab: int, multiple: int = 2048) -> int:
    return ((vocab + multiple - 1) // multiple) * multiple


@dataclass(frozen=True)
class LMConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0                  # 0 -> d_model // n_heads
    qkv_bias: bool = False
    rope_fraction: float = 1.0
    rope_theta: float = 10000.0
    moe: MoEConfig | None = None
    attn_impl: str = "dense"           # dense | chunked | flash
    attn_chunk: int = 1024
    norm_eps: float = 1e-6
    dtype: torch.dtype = torch.bfloat16
    remat: str = "none"                # none | full | dots
    scan_layers: bool = True
    image_prefix: int = 0              # # of prefix embedding positions
    vocab_pad_multiple: int = 2048
    z_loss: float = 0.0

    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def vocab_padded(self) -> int:
        return pad_vocab(self.vocab, self.vocab_pad_multiple)

    @property
    def attn_cfg(self) -> AttnConfig:
        return AttnConfig(
            d_model=self.d_model, n_heads=self.n_heads,
            n_kv_heads=self.n_kv_heads, head_dim=self.head_dim_,
            qkv_bias=self.qkv_bias, rope_fraction=self.rope_fraction,
            rope_theta=self.rope_theta, impl=self.attn_impl,
            chunk_size=self.attn_chunk)


# ---------------------------------------------------------------------------
# parameter specs
# ---------------------------------------------------------------------------


def _layer_spec(cfg: LMConfig) -> dict:
    spec = {
        "ln_attn": rmsnorm_spec(cfg.d_model),
        "attn": attn_spec(cfg.attn_cfg),
        "ln_ffn": rmsnorm_spec(cfg.d_model),
    }
    if cfg.moe is not None:
        spec["moe"] = moe_spec(cfg.d_model, cfg.moe)
    else:
        spec["mlp"] = swiglu_spec(cfg.d_model, cfg.d_ff)
    return spec


def _stack_spec(spec, n: int):
    return tree_map(
        lambda s: ParamSpec((n, *s.shape), ("layers", *s.axes), init=s.init,
                            scale=s.scale, dtype=s.dtype), spec)


def lm_spec(cfg: LMConfig) -> dict:
    layer = _layer_spec(cfg)
    return {
        "embedding": embedding_spec(cfg.vocab_padded, cfg.d_model),
        "layers": _stack_spec(layer, cfg.n_layers) if cfg.scan_layers
        else {f"layer_{i}": layer for i in range(cfg.n_layers)},
        "ln_f": rmsnorm_spec(cfg.d_model),
        "unembed": unembed_spec(cfg.d_model, cfg.vocab_padded),
    }


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


def _layers(params, cfg: LMConfig) -> list:
    """Each layer's parameter tree, in order: views along the stacked
    leading axis, or the ``layer_{i}`` subtrees."""
    if not cfg.scan_layers:
        return [params["layers"][f"layer_{i}"] for i in range(cfg.n_layers)]
    return unstack(params["layers"], cfg.n_layers)


def _ffn(p_layer, cfg: LMConfig, h):
    """The layer's FFN and its aux loss (0.0 for the dense MLP).  The MoE
    reads the ambient mesh, as the reference's: its data axes, and FSDP
    over the axis that places the rank's expert blocks' ``embed`` dim
    (the profile's ``embed`` rule; none for whole tensors)."""
    if cfg.moe is not None:
        from ..dist.sharding import current_context

        ctx = current_context()
        wg = p_layer["moe"]["w_gate"]
        fsdp = None if isinstance(wg, torch.Tensor) else wg.sharding.spec[1]
        return moe_ffn(p_layer["moe"], cfg.moe, h, mesh=ctx.mesh,
                       data_axes=ctx.data_axes, fsdp_axis=fsdp)
    return swiglu(p_layer["mlp"], h), 0.0


def _layer(p_l, cfg: LMConfig, h):
    """One layer; returns the new residual stream, the layer's K, V and
    its aux loss."""
    a, kv = attention(p_l["attn"], cfg.attn_cfg,
                      rmsnorm(p_l["ln_attn"], h, cfg.norm_eps))
    h = h + a
    f, aux = _ffn(p_l, cfg, rmsnorm(p_l["ln_ffn"], h, cfg.norm_eps))
    return h + f, kv, aux


def _embed(params, cfg: LMConfig, tokens, extra_embeds):
    h = embed(params["embedding"], tokens).to(cfg.dtype)
    if extra_embeds is not None:
        h = torch.cat([extra_embeds.to(cfg.dtype), h], dim=1)
    return h


def hidden_states(params, cfg: LMConfig, tokens, *, extra_embeds=None):
    """Token (+ optional prefix) embeddings through all layers; returns
    the final-normed states and the aux loss summed over the layers (0.0
    for a dense config)."""
    h = _embed(params, cfg, tokens, extra_embeds)
    auxes = []
    for p_l in _layers(params, cfg):
        h, _, aux = remat(_layer, p_l, cfg, h, mode=cfg.remat)
        auxes.append(aux)
    aux = torch.stack(auxes).sum() if cfg.moe is not None else 0.0
    return rmsnorm(params["ln_f"], h, cfg.norm_eps), aux


def logits_fn(params, cfg: LMConfig, h):
    return unembed(params["unembed"], h)


def loss_fn(params, cfg: LMConfig, batch):
    """batch: tokens (B,S), labels (B,S), mask (B,S); ``patch_embeds``
    (B,P,d), where given, is prepended and labels cover the full
    (P + S_text) sequence."""
    h, aux = hidden_states(params, cfg, batch["tokens"],
                           extra_embeds=batch.get("patch_embeds"))
    logits = logits_fn(params, cfg, h)
    loss = masked_xent(logits, batch["labels"], batch.get("mask"), cfg)
    loss = loss + 0.01 * aux
    return loss, {"loss": loss, "aux_loss": aux}


def masked_xent(logits, labels, mask, cfg: LMConfig):
    return _masked_xent(logits, labels, mask, vocab=cfg.vocab,
                        vocab_padded=cfg.vocab_padded, z_loss=cfg.z_loss)


# ---------------------------------------------------------------------------
# prefill / decode (KV cache)
# ---------------------------------------------------------------------------


def cache_spec(cfg: LMConfig, batch: int, max_len: int) -> dict:
    kvh, hd = cfg.n_kv_heads, cfg.head_dim_
    shape = (cfg.n_layers, batch, max_len, kvh, hd)
    axes = ("layers", "batch", "seq", "kv_heads", "head_dim")
    return {
        "k": ParamSpec(shape, axes, init="zeros", dtype=cfg.dtype),
        "v": ParamSpec(shape, axes, init="zeros", dtype=cfg.dtype),
        "length": ParamSpec((), (), init="zeros", dtype=torch.int32),
    }


def prefill(params, cfg: LMConfig, batch, *, max_len: int | None = None,
            cache: dict | None = None):
    """Process the prompt, return (logits_last, cache).

    Uses the full-sequence path and writes each layer's K/V into a cache
    of ``max(max_len, S)`` positions, zero past the prompt (the
    reference's right padding).  Only the stacked layer layout is
    supported here, as in the reference.  ``cache`` (a mesh step's):
    the rank's zero blocks of ``k`` and ``v`` (``LocalBlock``s), each
    written with the part of the prompt's K/V it holds: its rows, its KV
    heads and its sequence range.
    """
    if not cfg.scan_layers:
        raise ValueError("prefill takes the stacked layer layout "
                         "(scan_layers=True), as the reference's does")
    h = _embed(params, cfg, batch["tokens"], batch.get("patch_embeds"))
    b, s = h.shape[:2]
    if cache is None:
        shape = (cfg.n_layers, b, max(s, max_len or 0), cfg.n_kv_heads,
                 cfg.head_dim_)
        ks = torch.zeros(shape, dtype=cfg.dtype, device=h.device)
        vs = torch.zeros_like(ks)
    else:
        ks, vs = cache["k"], cache["v"]
    for i, p_l in enumerate(_layers(params, cfg)):
        h, (k, v), _ = remat(_layer, p_l, cfg, h, mode=cfg.remat)
        heads = block(p_l["attn"]["wk"], 1)
        write_block(ks[i], k, heads)
        write_block(vs[i], v, heads)
    h = rmsnorm(params["ln_f"], h, cfg.norm_eps)
    logits = logits_fn(params, cfg, h[:, -1:, :])
    return logits, {"k": ks, "v": vs, "length": s}


def decode_step(params, cfg: LMConfig, cache, batch):
    """One-token decode.  batch: tokens (B,1).  cache as :func:`prefill`
    returns it; its tensors are updated in place at ``length``, and the
    returned cache holds them with ``length + 1``."""
    if not cfg.scan_layers:
        raise ValueError("decode_step takes the stacked layer layout "
                         "(scan_layers=True), as the reference's does")
    h = _embed(params, cfg, batch["tokens"], None)
    length = cache["length"]
    for i, p_l in enumerate(_layers(params, cfg)):
        a, _, _ = decode_attention(
            p_l["attn"], cfg.attn_cfg, rmsnorm(p_l["ln_attn"], h, cfg.norm_eps),
            cache["k"][i], cache["v"][i], length)
        h = h + a
        h = h + _ffn(p_l, cfg, rmsnorm(p_l["ln_ffn"], h, cfg.norm_eps))[0]
    h = rmsnorm(params["ln_f"], h, cfg.norm_eps)
    logits = logits_fn(params, cfg, h)
    return logits, {"k": cache["k"], "v": cache["v"], "length": length + 1}
