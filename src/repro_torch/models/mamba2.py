"""Mamba2 (SSD — state-space duality) layer, chunked-parallel (the
reference's ``repro/models/mamba2.py``).

Implements the discrete selective SSM

    h_t = a_t * h_{t-1} + dt_t * B_t x_t        (per head, state size N)
    y_t = C_t . h_t + D * x_t

with a_t = exp(-dt_t * A_h), dt_t = softplus(dt_raw + bias), by the SSD
chunked algorithm: within-chunk attention-like scores with decay masks,
and the cross-chunk state recurrence (the reference's ``lax.scan`` over
chunks; here a loop).  Decode is the single-step recurrence.  The state
update and the decays run in f32; the depthwise causal conv frontend
(kernel 4) on (x, B, C) and the gated RMSNorm output stage round where
the reference rounds.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F

from .common import ParamSpec, _silu, remat, rmsnorm


@dataclass(frozen=True)
class Mamba2Config:
    d_model: int
    d_state: int = 64
    expand: int = 2
    head_dim: int = 64
    n_groups: int = 1
    conv_kernel: int = 4
    chunk: int = 256

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def n_heads(self) -> int:
        return self.d_inner // self.head_dim

    @property
    def conv_dim(self) -> int:
        return self.d_inner + 2 * self.n_groups * self.d_state


def mamba2_spec(cfg: Mamba2Config) -> dict:
    d, di, g, n, h = (cfg.d_model, cfg.d_inner, cfg.n_groups, cfg.d_state,
                      cfg.n_heads)
    proj_out = 2 * di + 2 * g * n + h          # z, x, B, C, dt
    return {
        "in_proj": ParamSpec((d, proj_out), ("embed", "mamba_inner")),
        "conv_w": ParamSpec((cfg.conv_kernel, cfg.conv_dim),
                            (None, "mamba_inner"), scale=0.1),
        "conv_b": ParamSpec((cfg.conv_dim,), ("mamba_inner",), init="zeros"),
        "a_log": ParamSpec((h,), ("heads",), init="zeros"),
        "dt_bias": ParamSpec((h,), ("heads",), init="zeros"),
        "d_skip": ParamSpec((h,), ("heads",), init="ones"),
        "norm": ParamSpec((di,), ("mamba_inner",), init="ones"),
        "out_proj": ParamSpec((di, d), ("mamba_inner", "embed")),
    }


def _split_proj(cfg: Mamba2Config, zxbcdt):
    di, g, n = cfg.d_inner, cfg.n_groups, cfg.d_state
    return zxbcdt.split([di, di, g * n, g * n, cfg.n_heads], dim=-1)


def _softplus(x):
    """``jax.nn.softplus``: ``logaddexp(x, 0)``, which is ``max(x, 0) +
    log1p(exp(-|x|))`` (``F.softplus`` switches to ``x`` above a
    threshold and rounds otherwise)."""
    return torch.clamp_min(x, 0) + torch.log1p(torch.exp(-x.abs()))


def _causal_conv(w, b, x, *, state=None):
    """Depthwise causal conv along time.  x: (B, S, C); w: (K, C).

    The k taps are added in order, each product and sum rounded in x's
    dtype.  With ``state`` (B, K-1, C) (decode) it is the left context;
    returns the output and the last K-1 inputs, the next state."""
    k = w.shape[0]
    if state is None:
        pad = x.new_zeros((x.shape[0], k - 1, x.shape[2]))
    else:
        pad = state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)
    s = x.shape[1]
    out = xp[:, :s] * w[0]
    for i in range(1, k):
        out = out + xp[:, i:i + s] * w[i]
    return _silu(out + b), xp[:, -(k - 1):]


def _ssd_chunk(h_prev, x, bmat, cmat, dtk, lak, mask, hpg: int):
    """One chunk of :func:`_ssd_chunked`: its outputs (B,l,H,P) in x's
    dtype from the carried state ``h_prev`` (B,H,N,P) f32, and the state
    at its end."""
    xk, bk, ck = x.float(), bmat.float(), cmat.float()   # (B,l,H,P), (B,l,G,N)
    cum = torch.cumsum(lak, dim=1)                       # (B,l,H) inclusive
    # intra-chunk: decay(i,j) = exp(cum_i - cum_j), j <= i
    diff = cum[:, :, None, :] - cum[:, None, :, :]       # (B,l,l,H)
    decay = torch.where(mask, torch.exp(diff), 0.0)
    # scores: C_i . B_j per group -> broadcast to heads
    cb = torch.einsum("bign,bjgn->bijg", ck, bk)         # (B,l,l,G)
    cb = cb.repeat_interleave(hpg, dim=3)                # (B,l,l,H)
    w_ij = cb * decay * dtk[:, None, :, :]               # dt_j weight
    y_intra = torch.einsum("bijh,bjhp->bihp", w_ij, xk)
    # inter-chunk: y_i += exp(cum_i) C_i . h_prev
    cfull = ck.repeat_interleave(hpg, dim=2)             # (B,l,H,N)
    y_inter = torch.einsum("bihn,bhnp->bihp", cfull, h_prev) \
        * torch.exp(cum)[..., None]
    # state update: h_new = exp(cum_L) h_prev
    #   + sum_j exp(cum_L - cum_j) dt_j B_j x_j
    wj = torch.exp(cum[:, -1:, :] - cum) * dtk           # (B,l,H)
    bfull = bk.repeat_interleave(hpg, dim=2)             # (B,l,H,N)
    h_new = torch.einsum("blhn,blhp->bhnp", wj[..., None] * bfull, xk)
    h_new = h_new + torch.exp(cum[:, -1])[..., None, None] * h_prev
    return (y_intra + y_inter).to(x.dtype), h_new


def _ssd_chunked(cfg: Mamba2Config, x, bmat, cmat, dt, a_log):
    """Chunked SSD.  x: (B,S,H,P); bmat/cmat: (B,S,G,N); dt: (B,S,H) f32.

    Returns (y (B,S,H,P) in x's dtype, h_final (B,H,N,P) f32).  Under
    autograd each chunk (:func:`_ssd_chunk`) is checkpointed
    (:func:`~.common.remat`), as the reference's
    ``jax.checkpoint(chunk_step)``: the backward keeps the states between
    chunks, not the (l, l, H) decay and score tiles."""
    bsz, s_orig, h, p = x.shape
    g, n = bmat.shape[2], bmat.shape[3]
    hpg = h // g                                    # heads per group
    l = min(cfg.chunk, s_orig)
    # pad to a chunk multiple: padded steps have dt=0 (=> decay 1, no input)
    pad = (-s_orig) % l
    if pad:
        x, bmat, cmat = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (x, bmat, cmat))
        dt = F.pad(dt, (0, 0, 0, pad))
    s = s_orig + pad

    a = torch.exp(a_log.float())                    # (H,) positive
    dtf = dt.float()
    la = -dtf * a                                   # log a_t  (B,S,H)
    ii = torch.arange(l, device=x.device)
    mask = (ii[:, None] >= ii[None, :])[None, :, :, None]

    h_prev = torch.zeros((bsz, h, n, p), dtype=torch.float32, device=x.device)
    ys = []
    for c0 in range(0, s, l):
        y, h_prev = remat(_ssd_chunk, h_prev, x[:, c0:c0 + l],
                          bmat[:, c0:c0 + l], cmat[:, c0:c0 + l],
                          dtf[:, c0:c0 + l], la[:, c0:c0 + l], mask, hpg)
        ys.append(y)
    return torch.cat(ys, dim=1)[:, :s_orig], h_prev


def mamba2_layer(p, cfg: Mamba2Config, u, *, ssm_state=None, conv_state=None,
                 return_state: bool = False):
    """Full Mamba2 block.  u: (B, S, d_model).

    Train/prefill: ``ssm_state``/``conv_state`` None.  Decode: S == 1 and
    both states given; returns (out, (ssm_state, conv_state)) with
    ``return_state``."""
    bsz, s, _ = u.shape
    dt_ = u.dtype
    zxbcdt = u @ p["in_proj"].to(dt_)
    z, x, bmat, cmat, dt = _split_proj(cfg, zxbcdt)
    xbc = torch.cat([x, bmat, cmat], dim=-1)
    xbc, new_conv = _causal_conv(p["conv_w"].to(dt_), p["conv_b"].to(dt_),
                                 xbc, state=conv_state)
    di, g, n = cfg.d_inner, cfg.n_groups, cfg.d_state
    x = xbc[..., :di].reshape(bsz, s, cfg.n_heads, cfg.head_dim)
    bmat = xbc[..., di:di + g * n].reshape(bsz, s, g, n)
    cmat = xbc[..., di + g * n:].reshape(bsz, s, g, n)
    dt = _softplus(dt.float() + p["dt_bias"].float())

    if ssm_state is None and s > 1:
        y, h_fin = _ssd_chunked(cfg, x, bmat, cmat, dt, p["a_log"])
    else:
        # single-step (decode) recurrence
        h_prev = (torch.zeros((bsz, cfg.n_heads, n, cfg.head_dim),
                              dtype=torch.float32, device=u.device)
                  if ssm_state is None else ssm_state)
        a = torch.exp(p["a_log"].float())
        at = torch.exp(-dt[:, 0] * a)                        # (B,H)
        hpg = cfg.n_heads // g
        bfull = bmat[:, 0].float().repeat_interleave(hpg, dim=1)
        cfull = cmat[:, 0].float().repeat_interleave(hpg, dim=1)
        contrib = (dt[:, 0, :, None] * bfull)[..., None] \
            * x[:, 0].float()[:, :, None, :]                 # (B,H,N,P)
        h_fin = at[..., None, None] * h_prev + contrib
        y = torch.einsum("bhn,bhnp->bhp", cfull, h_fin)[:, None].to(dt_)

    y = y + (p["d_skip"].float()[:, None] * x.float()).to(dt_)
    y = y.reshape(bsz, s, di)
    y = rmsnorm(p["norm"], y * _silu(z))
    out = y @ p["out_proj"].to(dt_)
    if return_state:
        return out, (h_fin, new_conv)
    return out
