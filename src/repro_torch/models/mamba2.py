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

On a mesh (:func:`mamba2_layer` on the rank's blocks, the serve steps
of ``train/steps.py``) a rank computes its own heads, the block of
``a_log``'s heads it holds: its heads' columns of ``z``, ``x`` and
``dt`` and the shared ``B``, ``C`` (one group), their conv, the SSD on
its heads, the gated RMSNorm with the sum of squares all-reduced over
``model``, and ``out_proj`` row-parallel.  ``in_proj``'s columns split
over ``model`` in contiguous blocks that straddle the segments ``z | x |
B | C | dt``, so the rank gathers what it needs: for a prompt the weight
(d x proj_out, the same bytes at any length), for a decode step (S == 1)
the product's columns (B x proj_out a token).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F

from .attention import _to_heads
from .common import (ParamSpec, _silu, block, remat, rmsnorm, row_parallel,
                     rows, weight)


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


def _step(h_prev, x, bmat, cmat, dt, a_log):
    """The single-step (decode) recurrence: y (B,1,H,P) in x's dtype and
    the new state (B,H,N,P) f32 from ``h_prev`` (None: zeros), x
    (B,1,H,P), bmat/cmat (B,1,G,N), dt (B,1,H) f32."""
    bsz, _, h, p = x.shape
    g, n = bmat.shape[2], bmat.shape[3]
    if h_prev is None:
        h_prev = torch.zeros((bsz, h, n, p), dtype=torch.float32,
                             device=x.device)
    a = torch.exp(a_log.float())
    at = torch.exp(-dt[:, 0] * a)                            # (B,H)
    hpg = h // g
    bfull = bmat[:, 0].float().repeat_interleave(hpg, dim=1)
    cfull = cmat[:, 0].float().repeat_interleave(hpg, dim=1)
    contrib = (dt[:, 0, :, None] * bfull)[..., None] \
        * x[:, 0].float()[:, :, None, :]                     # (B,H,N,P)
    h_fin = at[..., None, None] * h_prev + contrib
    y = torch.einsum("bhn,bhnp->bhp", cfull, h_fin)[:, None].to(x.dtype)
    return y, h_fin


def _mix(cfg: Mamba2Config, x, bmat, cmat, dt, a_log, d_skip, ssm_state):
    """The SSD (chunked for a prompt, the recurrence for a step) on the
    heads of x (B,S,H,P) and the skip: y (B,S,H*P) in x's dtype and the
    final state."""
    bsz, s, h, p = x.shape
    if ssm_state is None and s > 1:
        y, h_fin = _ssd_chunked(cfg, x, bmat, cmat, dt, a_log)
    else:
        y, h_fin = _step(ssm_state, x, bmat, cmat, dt, a_log)
    y = y + (d_skip.float()[:, None] * x.float()).to(x.dtype)
    return y.reshape(bsz, s, h * p), h_fin


def _merged(ranges) -> list[tuple[int, int]]:
    """``(start, stop)`` ranges in order, adjacent ones merged."""
    out: list[tuple[int, int]] = []
    for lo, hi in ranges:
        if out and out[-1][1] == lo:
            out[-1] = (out[-1][0], hi)
        else:
            out.append((lo, hi))
    return out


def _take(t, ranges, dim: int):
    """The ranges of ``t``'s dim ``dim``, concatenated in order (one view
    where they make one range)."""
    parts = [t.narrow(dim, lo, hi - lo) for lo, hi in _merged(ranges)]
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim)


def mamba2_layer(p, cfg: Mamba2Config, u, *, ssm_state=None, conv_state=None,
                 return_state: bool = False):
    """Full Mamba2 block.  u: (B, S, d_model).

    ``ssm_state`` (B, H, N, P) f32 and ``conv_state`` (B, K-1, conv_dim):
    None for a prompt or a first step, which start from zero states and
    return new ones; else the states' slots (a prefill's zero), read where
    S == 1 (a decode step) and written in place with the new states.
    Returns (out, (ssm_state, conv_state)) with ``return_state``.

    On a mesh ``p`` holds the rank's blocks (``dist.collectives.LocalBlock``),
    u the rank's rows, and the rank computes the heads of its ``a_log``
    block (module docstring); the slots are then this layer's cache
    blocks, ``(B_loc, H_blk, N, P)`` and ``(B_loc, K-1, conv_blk)``."""
    from ..dist.collectives import all_gather

    bsz, s, _ = u.shape
    dt_ = u.dtype
    heads = hlo, hhi, split = block(p["a_log"], 0)
    mesh = None if isinstance(p["a_log"], torch.Tensor) else p["a_log"].mesh
    pd, di, g, n = cfg.head_dim, cfg.d_inner, cfg.n_groups, cfg.d_state
    if split and g != 1:
        raise ValueError(f"Mamba2 heads split over model share one group of "
                         f"B and C; this config has {g}")
    gn, xs = g * n, (hlo * pd, hhi * pd)        # the rank's x (and z) columns
    hp = xs[1] - xs[0]
    conv_cols = [xs, (di, di + 2 * gn)]
    blocks = not isinstance(ssm_state, (torch.Tensor, type(None)))
    h_prev = c_prev = None
    if s == 1 and ssm_state is not None:
        h_prev, c_prev = ssm_state, conv_state
        if blocks:
            h_prev = _to_heads(h_prev.tensor, h_prev.block(1), heads, mesh,
                               dim=1)
            c_prev = _take(c_prev.gathered(keep=0, axis=c_prev.sharding.spec[0]),
                           conv_cols, -1)
    cols = [xs, (di + xs[0], di + xs[1]), (2 * di, 2 * di + 2 * gn),
            (2 * di + 2 * gn + hlo, 2 * di + 2 * gn + hhi)]
    if s == 1:                                  # the product's columns
        zxbcdt = u @ weight(p["in_proj"], dt_, keep=1)
        if block(p["in_proj"], 1)[2]:
            zxbcdt = all_gather(zxbcdt, mesh, "model", -1)
        zxbcdt = _take(zxbcdt, cols, -1)
    else:                                       # the weight's columns
        zxbcdt = u @ _take(weight(p["in_proj"], dt_), cols, 1)
    z, x, bmat, cmat, dt = zxbcdt.split([hp, hp, gn, gn, hhi - hlo], dim=-1)
    xbc, new_conv = _causal_conv(_take(weight(p["conv_w"], dt_), conv_cols, 1),
                                 _take(weight(p["conv_b"], dt_), conv_cols, 0),
                                 torch.cat([x, bmat, cmat], dim=-1),
                                 state=c_prev)
    x = xbc[..., :hp].reshape(bsz, s, hhi - hlo, pd)
    bmat = xbc[..., hp:hp + gn].reshape(bsz, s, g, n)
    cmat = xbc[..., hp + gn:].reshape(bsz, s, g, n)
    dt = _softplus(dt.float() + rows(p["dt_bias"], hlo, hhi).float())
    y, h_fin = _mix(cfg, x, bmat, cmat, dt, rows(p["a_log"], hlo, hhi),
                    rows(p["d_skip"], hlo, hhi), h_prev)
    y = rmsnorm(rows(p["norm"], *xs), y * _silu(z),
                split=(mesh, di) if split else None)
    out = row_parallel(y, (*xs, split), p["out_proj"], dt_)
    if blocks:
        # the conv cache's block straddles the heads: its x columns gathered
        x_all = new_conv[..., :hp]
        if split:
            x_all = all_gather(x_all, mesh, "model", -1)
        conv_state.tensor.copy_(torch.cat([x_all, new_conv[..., hp:]], dim=-1)[
            ..., conv_state.index[-1]])
        ssm_state.tensor.copy_(_to_heads(h_fin, heads, ssm_state.block(1),
                                         mesh, dim=1))
    elif ssm_state is not None:
        ssm_state.copy_(h_fin)
        conv_state.copy_(new_conv)
    if ssm_state is not None:
        h_fin, new_conv = ssm_state, conv_state
    if return_state:
        return out, (h_fin, new_conv)
    return out
