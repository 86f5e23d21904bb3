"""Plain PyTorch version of flash attention: the reference's oracle
(``repro/kernels/attention/ref.py``) exactly: scores in f32, scaled after
the product, a ``-inf`` mask of ``tril(k = sk - sq)`` when causal, and a
full softmax; the output in ``q``'s dtype.

Beside it, the split route's arithmetic in plain form
(:func:`split_partials`, :func:`combine`): the partials of each split of
the keys and their merge, as ``csrc/attention.cu`` computes them, so the
rule that keeps the combined maximum finite is pinned without a card."""
from __future__ import annotations

import torch

#: (rtol, atol) of a kernel's output against this version by input dtype:
#: the reference's attention tolerance (tests/test_kernels.py, 2e-3) in
#: f32; a bf16 output rounds to bf16, one step of which (2^-8 at 0.5) is
#: over 2e-3, so bf16 takes the reference's bf16 tolerance, 2e-2
TOLERANCE = {torch.float32: (2e-3, 2e-3), torch.bfloat16: (2e-2, 2e-2)}
#: the kernels' mask value (the reference kernel's NEG_INF)
NEG_INF = -1e30


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True) -> torch.Tensor:
    """q: (BH, Sq, d); k, v: (BH, Sk, d), GQA already expanded."""
    scale = q.shape[-1] ** -0.5
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * scale
    if causal:
        sq, sk = s.shape[-2], s.shape[-1]
        mask = torch.ones((sq, sk), dtype=torch.bool, device=s.device).tril(sk - sq)
        s = s.masked_fill(~mask, float("-inf"))
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = p / p.sum(dim=-1, keepdim=True)
    return torch.einsum("bqk,bkd->bqd", p, v.float()).to(q.dtype)


def split_partials(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   split_keys: int, causal: bool
                   ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The partials of splits of ``split_keys`` keys: q (BH, Sq, d); k, v
    (BH, Sk, d), GQA already expanded, causal with sq == sk.  Returns m, l
    (BH, Sq, n_split) and acc (BH, Sq, n_split, d) in f32: each split's
    running max, sum of ``exp(s - m)`` and unnormalised output, q scaled
    before the product and masked keys at -1e30 as the kernels do.  A
    causal split that starts past a row is skipped for that row, as the
    reference skips a tile wholly past its row: m = -1e30, l = 0, acc = 0.
    (Scored instead, its keys would all sit at the -1e30 it also takes as
    its max, each adding ``exp(0) = 1`` to l; the combine would still
    weigh it by ``exp(-1e30 - M) = 0``, M being finite because split 0
    holds key 0.)"""
    sq, sk = q.shape[1], k.shape[1]
    s = torch.einsum("bqd,bkd->bqk", q.float() * q.shape[-1] ** -0.5, k.float())
    rows = torch.arange(sq, device=q.device)
    if causal:
        cols = torch.arange(sk, device=q.device)
        s = s.masked_fill(cols[None, :] > rows[:, None], NEG_INF)
    ms, ls, accs = [], [], []
    for k0 in range(0, sk, split_keys):
        blk = s[..., k0:k0 + split_keys]
        m = blk.amax(-1)
        p = torch.exp(blk - m[..., None])
        l = p.sum(-1)
        acc = torch.einsum("bqk,bkd->bqd", p, v[:, k0:k0 + split_keys].float())
        if causal:
            empty = (rows < k0)[None, :]
            m = m.masked_fill(empty, NEG_INF)
            l = l.masked_fill(empty, 0.0)
            acc = acc.masked_fill(empty[..., None], 0.0)
        ms.append(m)
        ls.append(l)
        accs.append(acc)
    return torch.stack(ms, -1), torch.stack(ls, -1), torch.stack(accs, -2)


def combine(m: torch.Tensor, l: torch.Tensor, acc: torch.Tensor) -> torch.Tensor:
    """The splits merged (last dim of m and l, second last of acc):
    ``M = max m_s`` over the splits with ``l_s > 0``,
    ``L = sum l_s exp(m_s - M)``, ``O = sum acc_s exp(m_s - M) / max(L,
    1e-30)``; an empty split (``l_s = 0``) takes no part, whatever its m."""
    live = l > 0
    big = m.masked_fill(~live, float("-inf")).amax(-1, keepdim=True)
    w = torch.where(live, torch.exp(m - big), torch.zeros_like(m))
    den = (l * w).sum(-1).clamp_min(1e-30)
    return (acc * w[..., None]).sum(-2) / den[..., None]
