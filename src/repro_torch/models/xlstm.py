"""xLSTM blocks: mLSTM (matrix memory, parallelizable) and sLSTM (scalar
memory, recurrent), per Beck et al. 2024 (arXiv:2405.04517; the
reference's ``repro/models/xlstm.py``).

mLSTM uses stabilized exponential gating with a matrix memory per head:

    m_t = max(logsig(f_t) + m_{t-1}, i_t)
    C_t = exp(logsig(f_t) + m_{t-1} - m_t) C_{t-1} + exp(i_t - m_t) v_t k_t^T
    n_t = exp(logsig(f_t) + m_{t-1} - m_t) n_{t-1} + exp(i_t - m_t) k_t
    h_t = (C_t q_t) / max(|n_t . q_t|, exp(-m_t))

:func:`_mlstm_core` is the recurrence, a loop over time (the decode
path); :func:`_mlstm_chunked` the chunkwise-parallel form, a loop over
chunks (the prefill path).  sLSTM keeps a scalar cell/normalizer pair per
unit with block-diagonal (per-head) recurrent weights and the same
stabilizer; it is strictly sequential, a loop over time.  Every gate and
state is f32; the projections run in the compute dtype.

Both blocks follow the paper's pre-LN residual layout; the xlstm-125m
config has d_ff = 0, so the feed-forward capacity lives inside the blocks
(mLSTM: x2 up-projection; sLSTM: 4/3 gated MLP after the cell).

On a mesh (the serve steps of ``train/steps.py``) each weight comes as
the rank's block (``dist.collectives.LocalBlock``) and is gathered whole
where it is used (:func:`~.common.weight`): the arch's ``dp_vocab``
profile splits no block dim, so every rank computes its rows with every
head.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from .common import ParamSpec, _gelu, _silu, remat, weight

#: the sLSTM's gates, in the reference's order
GATES = ("z", "i", "f", "o")
#: the stabilizer's start and the chunked form's padding (the reference's):
#: a padded step has i = -1e30 (no input) and f = 60 (logsig ~ 0: decay 1)
M_INIT = -1e30
PAD_I, PAD_F = -1e30, 60.0


@dataclass(frozen=True)
class XLSTMConfig:
    d_model: int
    n_heads: int
    expand_m: int = 2            # mLSTM up-projection factor
    ff_factor: float = 4.0 / 3.0  # sLSTM post-MLP factor
    chunk: int = 256             # mLSTM chunkwise-parallel chunk length
    mlstm_impl: str = "chunked"  # chunked | scan (reference)

    @property
    def d_inner(self) -> int:
        return self.expand_m * self.d_model

    @property
    def head_dim(self) -> int:
        return self.d_inner // self.n_heads

    @property
    def s_head_dim(self) -> int:
        return self.d_model // self.n_heads

    @property
    def d_ff_s(self) -> int:
        return int(self.d_model * self.ff_factor)


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------


def mlstm_spec(cfg: XLSTMConfig) -> dict:
    d, di, h = cfg.d_model, cfg.d_inner, cfg.n_heads
    return {
        "w_up": ParamSpec((d, di), ("embed", "mlp")),
        "w_z": ParamSpec((d, di), ("embed", "mlp")),
        "w_q": ParamSpec((di, di), ("mlp", "heads_qk")),
        "w_k": ParamSpec((di, di), ("mlp", "heads_qk")),
        "w_v": ParamSpec((di, di), ("mlp", "heads_qk")),
        "w_i": ParamSpec((di, h), ("mlp", "heads")),
        "w_f": ParamSpec((di, h), ("mlp", "heads")),
        "b_i": ParamSpec((h,), ("heads",), init="zeros"),
        "b_f": ParamSpec((h,), ("heads",), init="ones"),
        "w_down": ParamSpec((di, d), ("mlp", "embed")),
    }


def _mlstm_state(state, b: int, h: int, p: int, device):
    """The carried ``(C (B,H,P,P), n (B,H,P), m (B,H))``, or the empty one."""
    if state is not None:
        return state
    return (torch.zeros((b, h, p, p), device=device),
            torch.zeros((b, h, p), device=device),
            torch.full((b, h), M_INIT, device=device))


def _mlstm_core(q, k, v, i_raw, f_raw, *, state=None):
    """q/k/v: (B,S,H,P); i_raw/f_raw: (B,S,H).  Returns (h, state), the
    recurrence one step at a time.  state = (C (B,H,P,P), n (B,H,P),
    m (B,H))."""
    b, s, h, p = q.shape
    scale = 1.0 / math.sqrt(p)
    lf = F.logsigmoid(f_raw.float())                           # (B,S,H)
    ir = i_raw.float()
    c, n, m = _mlstm_state(state, b, h, p, q.device)
    qf, kf, vf = q.float(), k.float(), v.float()
    hs = []
    for t in range(s):
        it, ft, kt, vt = ir[:, t], lf[:, t], kf[:, t], vf[:, t]
        m_new = torch.maximum(ft + m, it)
        a = torch.exp(ft + m - m_new)[..., None]                # (B,H,1)
        bgate = torch.exp(it - m_new)[..., None]
        c = a[..., None] * c + bgate[..., None] * (vt[..., :, None]
                                                   * kt[..., None, :])
        n = a * n + bgate * kt
        qs = qf[:, t] * scale
        num = torch.einsum("bhvk,bhk->bhv", c, qs)
        den = torch.maximum(torch.einsum("bhk,bhk->bh", n, qs).abs(),
                            torch.exp(-m_new))[..., None]
        hs.append(num / den)
        m = m_new
    return torch.stack(hs, 1).to(q.dtype), (c, n, m)


def _mlstm_chunk(c, n, m, qk, kk, vk, ik, gk, tri):
    """One chunk of :func:`_mlstm_chunked`: the chunk's hidden states
    (B,L,H,P) from the carry ``(c, n, m)`` and the chunk's f32 q, k, v,
    input gates ``ik`` and log forget gates ``gk``, and the carry at the
    chunk's end."""
    f_cum = torch.cumsum(gk, 1)                               # F_t inclusive
    r = torch.cummax(ik - f_cum, 1).values                    # cummax(i - F)
    m_t = f_cum + torch.maximum(r, m[:, None])                # (B,L,H)
    # intra scores exp(F_t - F_j + i_j - m_t), j <= t: (B,L,L,H)
    log_s = (f_cum[:, :, None, :] - f_cum[:, None, :, :]
             + ik[:, None, :, :] - m_t[:, :, None, :])
    sc = torch.where(tri, torch.exp(log_s), 0.0)
    inter = torch.exp(f_cum + m[:, None] - m_t)               # (B,L,H)
    kq = torch.einsum("bjhp,bthp->btjh", kk, qk)              # k_j . q_t
    skq = sc * kq
    num = torch.einsum("btjh,bjhp->bthp", skq, vk) + inter[..., None] \
        * torch.einsum("bhvp,bthp->bthv", c, qk)
    den = skq.sum(2) + inter * torch.einsum("bhp,bthp->bth", n, qk)
    den = torch.maximum(den.abs(), torch.exp(-m_t))[..., None]
    # the carry at the chunk's end
    dec_last = torch.exp(f_cum[:, -1] + m - m_t[:, -1])        # (B,H)
    w_j = torch.exp(f_cum[:, -1:] - f_cum + ik - m_t[:, -1:])  # (B,L,H)
    c = dec_last[..., None, None] * c + torch.einsum(
        "bjhv,bjhk->bhvk", w_j[..., None] * vk, kk)
    n = dec_last[..., None] * n + torch.einsum("bjh,bjhp->bhp", w_j, kk)
    return num / den, c, n, m_t[:, -1]


def _mlstm_chunked(q, k, v, i_raw, f_raw, *, state=None, chunk: int = 256):
    """Chunkwise-parallel mLSTM: the semantics of :func:`_mlstm_core`
    (the same stabilized exponential gating) in ``ceil(S / L)`` steps of
    (L, L) intra-chunk scores, a loop over chunks (:func:`_mlstm_chunk`).

    With g_t = logsig(f_t), F_t = cumsum(g)_t and the carried stabilizer
    m_prev, the sequential m_t is ``max(F_t + cummax(i - F)_t, F_t +
    m_prev)``, and every term of C_t and n_t is a row of ``exp(F_t - F_j +
    i_j - m_t)`` scores.  Under autograd each chunk is checkpointed
    (:func:`~.common.remat`), as the reference's
    ``jax.checkpoint(chunk_step)``: the backward keeps the carries, not
    the (L, L, H) score tiles.
    """
    b, s_orig, h, p = q.shape
    scale = 1.0 / math.sqrt(p)
    l = min(chunk, s_orig)
    pad = (-s_orig) % l
    if pad:  # padded steps carry the state through unchanged
        q, k, v = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (q, k, v))
        i_raw = F.pad(i_raw, (0, 0, 0, pad), value=PAD_I)
        f_raw = F.pad(f_raw, (0, 0, 0, pad), value=PAD_F)
    s = s_orig + pad
    nc = s // l
    gc = F.logsigmoid(f_raw.float()).reshape(b, nc, l, h)
    ic = i_raw.float().reshape(b, nc, l, h)
    c, n, m = _mlstm_state(state, b, h, p, q.device)
    qc = (q.float() * scale).reshape(b, nc, l, h, p)
    kc = k.float().reshape(b, nc, l, h, p)
    vc = v.float().reshape(b, nc, l, h, p)
    ii = torch.arange(l, device=q.device)
    tri = (ii[:, None] >= ii[None, :])[None, :, :, None]      # (1,L,L,1)
    hs = []
    for j in range(nc):
        hj, c, n, m = remat(_mlstm_chunk, c, n, m, qc[:, j], kc[:, j],
                            vc[:, j], ic[:, j], gc[:, j], tri)
        hs.append(hj)
    out = torch.stack(hs, 1).reshape(b, s, h, p)[:, :s_orig]
    return out.to(q.dtype), (c, n, m)


def _mlstm_project(p, cfg: XLSTMConfig, u):
    """The block's projections of u (B,S,d): the output gate's z (B,S,di),
    and the core's q, k, v (B,S,H,P) and gate pre-activations i_raw,
    f_raw (B,S,H), in u's dtype."""
    b, s, _ = u.shape
    dt = u.dtype
    x = u @ weight(p["w_up"], dt)
    z = u @ weight(p["w_z"], dt)
    h, hd = cfg.n_heads, cfg.head_dim
    q = (x @ weight(p["w_q"], dt)).reshape(b, s, h, hd)
    k = (x @ weight(p["w_k"], dt)).reshape(b, s, h, hd)
    v = (x @ weight(p["w_v"], dt)).reshape(b, s, h, hd)
    i_raw = x @ weight(p["w_i"], dt) + weight(p["b_i"], dt)
    f_raw = x @ weight(p["w_f"], dt) + weight(p["b_f"], dt)
    return z, (q, k, v, i_raw, f_raw)


def mlstm_block(p, cfg: XLSTMConfig, u, *, state=None, return_state=False):
    b, s, _ = u.shape
    dt = u.dtype
    z, (q, k, v, i_raw, f_raw) = _mlstm_project(p, cfg, u)
    if cfg.mlstm_impl == "chunked" and s > 1:
        core, new_state = _mlstm_chunked(q, k, v, i_raw, f_raw, state=state,
                                         chunk=cfg.chunk)
    else:
        core, new_state = _mlstm_core(q, k, v, i_raw, f_raw, state=state)
    out = (core.reshape(b, s, cfg.d_inner) * _silu(z)) @ weight(p["w_down"], dt)
    if return_state:
        return out, new_state
    return out


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------


def slstm_spec(cfg: XLSTMConfig) -> dict:
    d, h, hd = cfg.d_model, cfg.n_heads, cfg.s_head_dim
    gates = {}
    for g in GATES:
        gates[f"w_{g}"] = ParamSpec((d, d), ("embed", "heads_qk"))
        gates[f"r_{g}"] = ParamSpec((h, hd, hd), ("heads", None, None),
                                    scale=0.5 / math.sqrt(hd))
        gates[f"b_{g}"] = ParamSpec((d,), ("embed",),
                                    init="ones" if g == "f" else "zeros")
    return {
        **gates,
        "ff_up": ParamSpec((d, cfg.d_ff_s), ("embed", "mlp")),
        "ff_gate": ParamSpec((d, cfg.d_ff_s), ("embed", "mlp")),
        "ff_down": ParamSpec((cfg.d_ff_s, d), ("mlp", "embed")),
    }


def _slstm_core(p, cfg: XLSTMConfig, x, *, state=None):
    """x: (B,S,d).  The recurrence one step at a time, with per-head
    recurrent weights (f32, as the reference casts them at use).  The four
    gates' input projections run at once before the loop, and each step's
    four recurrent products as one batched product.  state = (c, n, hid,
    m), each (B,H,hd); the empty state has n = 1."""
    b, s, d = x.shape
    h, hd = cfg.n_heads, cfg.s_head_dim
    dt = x.dtype
    pre = torch.stack([(x @ weight(p[f"w_{g}"], dt)
                        + weight(p[f"b_{g}"], dt)).float()
                       for g in GATES], 2).view(b, s, 4, h, hd)
    if state is None:
        c = torch.zeros((b, h, hd), device=x.device)
        n = torch.ones((b, h, hd), device=x.device)
        hid = torch.zeros((b, h, hd), device=x.device)
        m = torch.zeros((b, h, hd), device=x.device)
    else:
        c, n, hid, m = state
    rw = torch.cat([weight(p[f"r_{g}"], torch.float32) for g in GATES],
                   -1)                                        # (H,hd,4hd)
    hs = []
    for t in range(s):
        rec = torch.einsum("bhk,hkj->bhj", hid, rw).reshape(b, h, 4, hd)
        g = pre[:, t] + rec.transpose(1, 2)                    # (B,4,H,hd)
        zv = torch.tanh(g[:, 0])
        ov = torch.sigmoid(g[:, 3])
        ilog = g[:, 1]
        flog = F.logsigmoid(g[:, 2])
        m_new = torch.maximum(flog + m, ilog)
        iv = torch.exp(ilog - m_new)
        fv = torch.exp(flog + m - m_new)
        c = fv * c + iv * zv
        n = fv * n + iv
        hid = ov * c / torch.clamp_min(n, 1e-6)
        m = m_new
        hs.append(hid)
    out = torch.stack(hs, 1).reshape(b, s, d).to(dt)
    return out, (c, n, hid, m)


def slstm_block(p, cfg: XLSTMConfig, u, *, state=None, return_state=False):
    core, new_state = _slstm_core(p, cfg, u, state=state)
    # post gated MLP (factor 4/3)
    dt = u.dtype
    g = core @ weight(p["ff_gate"], dt)
    up = core @ weight(p["ff_up"], dt)
    out = (_gelu(g) * up) @ weight(p["ff_down"], dt)
    if return_state:
        return out, new_state
    return out
