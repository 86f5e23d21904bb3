"""Mixture-of-Experts FFN with top-k routing (the reference's
``repro/models/moe.py``).

Three dispatch implementations, sharing the router and expert parameters:

* ``ref``       — dense all-experts (exact, no capacity drops): every
  expert on every token, so smoke tests and correctness only.
* ``scatter``   — global sort-based dispatch: a stable sort by expert id,
  a capacity-bounded scatter into an ``(E, cap, d)`` buffer, grouped
  expert matmuls, and the combine as a sum of the k weighted rows.
* ``shard_map`` — the reference's expert-parallel path, for one model
  shard: the assignments sorted by expert with an extra trash slot, and
  the k weighted rows added into zeros in expert-sorted order.  With one
  shard the reference's ``psum``/``pmean`` are identities and its FSDP
  gather is skipped; more model shards wait for tensor-parallel compute
  on the port's mesh (ROADMAP §1 item 5c) and raise.  The data-parallel
  train step (``train.steps.make_sharded_train_step``) runs it on each
  rank's rows: the dispatch per data shard, the aux loss averaged over
  the ranks, as the reference's ``shard_map``.

Routing is the reference's: the router in ``router_dtype`` (f32), top-k
with ties to the lower expert index, the k weights renormalised and cast
to the compute dtype, the Switch aux loss from each token's first choice.
``scatter`` and ``shard_map`` drop the assignments past each expert's
capacity, in the order of the stable sort.  No step synchronises with the
host, so a decode step that runs the MoE can be captured in a CUDA graph.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from .common import ParamSpec, _silu


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff: int
    capacity_factor: float = 1.25
    impl: str = "scatter"          # ref | scatter | shard_map
    router_dtype: torch.dtype = torch.float32


def moe_spec(d_model: int, cfg: MoEConfig) -> dict:
    e, f = cfg.n_experts, cfg.d_ff
    return {
        "router": ParamSpec((d_model, e), ("embed", "experts_r")),
        "w_gate": ParamSpec((e, d_model, f), ("experts", "embed", "mlp")),
        "w_up": ParamSpec((e, d_model, f), ("experts", "embed", "mlp")),
        "w_down": ParamSpec((e, f, d_model), ("experts", "mlp", "embed")),
    }


def _route(p, cfg: MoEConfig, xf):
    """xf: (N, d) -> (weights (N, k) in xf's dtype, ids (N, k), aux).

    ``lax.top_k`` breaks ties to the lower index; ``torch.topk`` promises
    no order, so the k largest are taken from a stable descending sort."""
    logits = xf.to(cfg.router_dtype) @ p["router"].to(cfg.router_dtype)
    probs = torch.softmax(logits, dim=-1)
    weights, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    weights, ids = weights[:, :cfg.top_k], ids[:, :cfg.top_k]
    weights = weights / weights.sum(dim=-1, keepdim=True)
    # Switch-style load-balance aux loss
    e = cfg.n_experts
    density = _counts(ids[:, 0], e).to(probs.dtype) / ids.shape[0]
    aux = e * torch.sum(density * probs.mean(dim=0))
    return weights.to(xf.dtype), ids, aux


def _counts(flat_ids, n: int):
    """How many entries of ``flat_ids`` name each of ``n`` ids (the
    reference's ``zeros(n).at[ids].add(1)``; ``bincount`` would read its
    size back to the host)."""
    return torch.zeros(n, dtype=torch.long, device=flat_ids.device).scatter_add_(
        0, flat_ids, torch.ones_like(flat_ids))


def _expert_ffn(w_gate, w_up, w_down, buf):
    """buf: (E, C, d) -> (E, C, d) through each expert's SwiGLU."""
    dt = buf.dtype
    g = torch.bmm(buf, w_gate.to(dt))
    u = torch.bmm(buf, w_up.to(dt))
    return torch.bmm(_silu(g) * u, w_down.to(dt))


def _capacity(n_tokens: int, cfg: MoEConfig) -> int:
    cap = int(math.ceil(n_tokens * cfg.top_k * cfg.capacity_factor
                        / cfg.n_experts))
    return max(8, ((cap + 127) // 128) * 128)


def _dispatch(flat_ids, n_ids: int):
    """The stable sort of the (N*k,) expert ids and each sorted entry's
    position within its expert: (sort_idx, sorted_ids, pos)."""
    sort_idx = torch.argsort(flat_ids, stable=True)
    sorted_ids = flat_ids[sort_idx]
    counts = _counts(flat_ids, n_ids)
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.arange(flat_ids.shape[0], device=flat_ids.device) \
        - starts[sorted_ids]
    return sort_idx, sorted_ids, pos


# ---------------------------------------------------------------------------
# ref: dense all-experts (exact; smoke/correctness only)
# ---------------------------------------------------------------------------


def moe_ffn_ref(p, cfg: MoEConfig, x):
    b, s, d = x.shape
    xf = x.reshape(-1, d)
    weights, ids, aux = _route(p, cfg, xf)
    out = torch.zeros_like(xf)
    for e in range(cfg.n_experts):
        w_e = torch.where(ids == e, weights, 0).sum(dim=-1)        # (N,)
        h = _expert_ffn(p["w_gate"][e:e + 1], p["w_up"][e:e + 1],
                        p["w_down"][e:e + 1], xf[None])
        out = out + h[0] * w_e[:, None]
    return out.reshape(b, s, d), aux


# ---------------------------------------------------------------------------
# scatter: global sort-based dispatch
# ---------------------------------------------------------------------------


def moe_ffn_scatter(p, cfg: MoEConfig, x):
    b, s, d = x.shape
    xf = x.reshape(-1, d)
    n = xf.shape[0]
    k, e = cfg.top_k, cfg.n_experts
    weights, ids, aux = _route(p, cfg, xf)

    cap = _capacity(n, cfg)
    sort_idx, sorted_ids, pos = _dispatch(ids.reshape(-1), e)
    token_of = sort_idx // k
    valid = pos < cap
    # a dropped row adds zeros to its expert's last slot: exact, so the
    # order of the adds does not matter
    slot = sorted_ids * cap + torch.where(valid, pos, cap - 1)
    gathered = xf[token_of] * valid[:, None].to(xf.dtype)
    buf = torch.zeros((e * cap, d), dtype=xf.dtype, device=xf.device)
    buf.index_add_(0, slot, gathered)
    h = _expert_ffn(p["w_gate"], p["w_up"], p["w_down"], buf.view(e, cap, d))

    rows = h.reshape(e * cap, d)[slot] * valid[:, None].to(xf.dtype)
    inv = torch.argsort(sort_idx)
    rows = rows[inv].reshape(n, k, d)
    out = torch.sum(rows * weights[..., None], dim=1)
    return out.reshape(b, s, d), aux


# ---------------------------------------------------------------------------
# shard_map: expert parallelism, one model shard
# ---------------------------------------------------------------------------


def moe_ffn_shard_map(p, cfg: MoEConfig, x, *, model_shards: int = 1):
    """The body of the reference's ``shard_map`` on one model shard
    (``lo = 0``, every expert local).  Each token's k weighted rows are
    added into zeros one after another in expert-sorted order, as the
    reference's ``.at[token_of].add`` adds them, and not by atomics, so
    the bf16 sums are deterministic on the card too."""
    if model_shards != 1:
        raise NotImplementedError(f"shard_map MoE over {model_shards} model "
                                  f"shards: tensor-parallel compute is not "
                                  f"ported yet (ROADMAP §1 item 5c)")
    b, s, d = x.shape
    xf = x.reshape(-1, d)
    n = xf.shape[0]
    k, e = cfg.top_k, cfg.n_experts
    weights, ids, aux = _route(p, cfg, xf)
    cap = _capacity(n, cfg)
    sort_idx, sorted_ids, pos = _dispatch(ids.reshape(-1), e)
    valid = pos < cap
    slot = torch.where(valid, sorted_ids * cap + pos, e * cap)
    buf = torch.zeros((e * cap + 1, d), dtype=xf.dtype, device=xf.device)
    buf.index_add_(0, slot, xf[sort_idx // k] * valid[:, None].to(xf.dtype))
    h = _expert_ffn(p["w_gate"], p["w_up"], p["w_down"],
                    buf[:-1].view(e, cap, d))
    rows = torch.cat([h.reshape(e * cap, d), h.new_zeros((1, d))])[slot]
    contrib = rows * weights.reshape(-1)[sort_idx][:, None]
    # token t's entries in sorted order, ascending: the scatter's order
    order = torch.argsort(sort_idx).view(n, k).sort(dim=1).values
    out = torch.zeros((n, d), dtype=xf.dtype, device=xf.device)
    for j in range(k):
        out = out + contrib[order[:, j]]
    return out.reshape(b, s, d), aux


def moe_ffn(p, cfg: MoEConfig, x, *, model_shards: int = 1):
    if cfg.impl == "ref":
        return moe_ffn_ref(p, cfg, x)
    if cfg.impl == "shard_map":
        return moe_ffn_shard_map(p, cfg, x, model_shards=model_shards)
    return moe_ffn_scatter(p, cfg, x)
