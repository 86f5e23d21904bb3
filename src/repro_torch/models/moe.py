"""Mixture-of-Experts FFN with top-k routing (the reference's
``repro/models/moe.py``).

Three dispatch implementations, sharing the router and expert parameters:

* ``ref``       — dense all-experts (exact, no capacity drops): every
  expert on every token, so smoke tests and correctness only.
* ``scatter``   — global sort-based dispatch: a stable sort by expert id,
  a capacity-bounded scatter into an ``(E, cap, d)`` buffer, grouped
  expert matmuls, and the combine as a sum of the k weighted rows.
* ``shard_map`` — the reference's expert-parallel path: each model shard
  computes its local experts ``lo .. lo + e_loc`` on its data shard's
  tokens (every other assignment to the trash id ``e_loc``), the
  assignments sorted by local expert, the capacity from the rank's
  tokens, the k weighted rows added into zeros in expert-sorted order,
  the partial outputs all-reduced over ``model`` and the aux loss
  averaged over the data axes and ``model``.  The expert weights come as
  the rank's blocks (``dist.collectives.LocalBlock``, from the train and
  serve steps on a mesh), their FSDP shards gathered over the
  ``fsdp_axis`` in the compute dtype; with whole tensors (no mesh) it is
  the one-shard body, ``lo = 0``, with no collective.  Under autograd the
  sums over ``model`` and the data axes carry the gradient (their
  adjoints); the routing's counts, sort and capacity are integers
  computed on the rank's tokens, with no exchange.

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

from .common import ParamSpec, _silu, block, weight


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
    logits = xf.to(cfg.router_dtype) @ weight(p["router"], cfg.router_dtype)
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
# shard_map: expert parallelism
# ---------------------------------------------------------------------------


def _local_experts(p, cfg: MoEConfig, xf, lo: int, e_loc: int):
    """The body of the reference's ``shard_map`` on one model shard: the
    experts ``lo .. lo + e_loc`` of ``p`` (tensors of those experts) on
    the tokens ``xf``; returns this shard's partial output
    (zeros for every row routed elsewhere) and the aux loss.  Each
    token's k weighted rows are added into zeros one after another in
    expert-sorted order, as the reference's ``.at[token_of].add`` adds
    them, and not by atomics, so the bf16 sums are deterministic on the
    card too (a row of another shard adds an exact zero)."""
    n, d = xf.shape
    k = cfg.top_k
    weights, ids, aux = _route(p, cfg, xf)
    local = (ids >= lo) & (ids < lo + e_loc)
    loc_ids = torch.where(local, ids - lo, e_loc)            # e_loc = trash
    cap = _capacity(n, cfg)
    sort_idx, sorted_ids, pos = _dispatch(loc_ids.reshape(-1), e_loc + 1)
    valid = (pos < cap) & (sorted_ids < e_loc)
    slot = torch.where(valid, sorted_ids * cap + pos, e_loc * cap)
    buf = torch.zeros((e_loc * cap + 1, d), dtype=xf.dtype, device=xf.device)
    buf.index_add_(0, slot, xf[sort_idx // k] * valid[:, None].to(xf.dtype))
    h = _expert_ffn(p["w_gate"], p["w_up"], p["w_down"],
                    buf[:-1].view(e_loc, cap, d))
    rows = torch.cat([h.reshape(e_loc * cap, d), h.new_zeros((1, d))])[slot]
    w_sorted = (weights * local.to(weights.dtype)).reshape(-1)[sort_idx]
    contrib = rows * w_sorted[:, None]
    # token t's entries in sorted order, ascending: the scatter's order
    order = torch.argsort(sort_idx).view(n, k).sort(dim=1).values
    out = torch.zeros((n, d), dtype=xf.dtype, device=xf.device)
    for j in range(k):
        out = out + contrib[order[:, j]]
    return out, aux


def moe_ffn_shard_map(p, cfg: MoEConfig, x, *, mesh=None,
                      data_axes=("data",), model_axis: str = "model",
                      fsdp_axis: str | None = None):
    """Expert-parallel MoE (the reference's ``moe_ffn_shard_map``): ``x``
    the rank's rows.  With the weights as whole tensors holding every
    expert, the one-shard body (no collective).  With the rank's blocks
    (``LocalBlock``, on ``mesh``): the experts of its ``model_axis`` block,
    each expert weight gathered over ``fsdp_axis`` (the only other axis
    that may shard it) in the compute dtype, the router whole; the
    partial outputs all-reduced over ``model_axis`` and the aux loss
    averaged over ``data_axes`` and ``model_axis``.  Expert weights of
    more than one model shard need a mesh, as the reference's."""
    b, s, d = x.shape
    xf = x.reshape(-1, d)
    e = cfg.n_experts
    wg = p["w_gate"]
    if isinstance(wg, torch.Tensor):
        if wg.shape[0] != e:
            raise ValueError(f"shard_map MoE over {e // wg.shape[0]} model "
                             f"shards needs a mesh and the rank's blocks "
                             f"(expert weights of {wg.shape[0]} of {e} "
                             f"experts)")
        out, aux = _local_experts(p, cfg, xf, 0, e)
        return out.reshape(b, s, d), aux
    if mesh is None:
        raise ValueError("shard_map MoE on the rank's blocks needs a mesh")
    from ..dist.collectives import all_reduce

    lo, hi, split = block(wg, 0, model_axis)
    if not split:
        raise ValueError(f"the experts of {wg.sharding.spec} are not split "
                         f"over {model_axis!r}")
    loc = {"router": p["router"]}
    for name in ("w_gate", "w_up", "w_down"):
        w = p[name]
        others = {a for ent in w.sharding.spec[1:]
                  for a in ((ent,) if isinstance(ent, str) else ent or ())}
        if others - {fsdp_axis}:
            raise ValueError(f"{name} {w.sharding.spec}: sharded over "
                             f"{sorted(others - {fsdp_axis})}, not the FSDP "
                             f"axis {fsdp_axis!r}")
        loc[name] = w.gathered(x.dtype, keep=0, axis=model_axis)
    out, aux = _local_experts(loc, cfg, xf, lo, hi - lo)
    out = all_reduce(out, mesh, model_axis)
    n = 1
    for a in (*data_axes, model_axis):
        aux = all_reduce(aux, mesh, a)
        n *= dict(zip(mesh.mesh_dim_names, mesh.shape))[a]
    return out.reshape(b, s, d), aux / n


def moe_ffn(p, cfg: MoEConfig, x, *, mesh=None, data_axes=("data",),
            model_axis: str = "model", fsdp_axis: str | None = None):
    if cfg.impl == "shard_map":
        return moe_ffn_shard_map(p, cfg, x, mesh=mesh, data_axes=data_axes,
                                 model_axis=model_axis, fsdp_axis=fsdp_axis)
    # the global dispatches take every expert: a rank's blocks gathered
    p = {k: weight(v) for k, v in p.items()}
    if cfg.impl == "ref":
        return moe_ffn_ref(p, cfg, x)
    return moe_ffn_scatter(p, cfg, x)
