"""Plain PyTorch version of flash attention: the reference's oracle
(``repro/kernels/attention/ref.py``) exactly: scores in f32, scaled after
the product, a ``-inf`` mask of ``tril(k = sk - sq)`` when causal, and a
full softmax; the output in ``q``'s dtype."""
from __future__ import annotations

import torch

#: (rtol, atol) of a kernel's output against this version by input dtype:
#: the reference's attention tolerance (tests/test_kernels.py, 2e-3) in
#: f32; a bf16 output rounds to bf16, one step of which (2^-8 at 0.5) is
#: over 2e-3, so bf16 takes the reference's bf16 tolerance, 2e-2
TOLERANCE = {torch.float32: (2e-3, 2e-3), torch.bfloat16: (2e-2, 2e-2)}


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
