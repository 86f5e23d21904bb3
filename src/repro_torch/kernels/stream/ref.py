"""Plain PyTorch versions of the stream kernels (Table I loop bodies).

They compute what the reference's kernels compute, rounding where the
reference rounds:

* f32 ``striad`` and ``schoenauer`` round once, as a fused multiply-add
  (``torch.add(alpha=)`` and ``torch.addcmul``; ``b + s*c`` would round
  twice and differ in the last bit);
* bf16 and f16 round after every operation, with the scalar first cast to
  the array's dtype (the reference's ``_scal``);
* sums accumulate in f32 for bf16 and f16 inputs.

The ops in ``ops.py`` return these for CPU tensors; on the card they are
what the CUDA kernels are held against.
"""
from __future__ import annotations

import torch

_HALF = (torch.bfloat16, torch.float16)


def _acc(dtype: torch.dtype) -> torch.dtype:
    return torch.float32 if dtype in _HALF else dtype


def _scal(s: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(s, dtype=like.dtype, device=like.device)


def load(a):
    """s += A[i]"""
    return torch.sum(a, dtype=_acc(a.dtype))


def ddot(a, b):
    """s += A[i] * B[i]"""
    return torch.sum((a * b).to(_acc(a.dtype)))


def store(s, shape, dtype, *, device):
    """A[i] = s"""
    return torch.full(shape, s, dtype=dtype, device=device)


def update(s, a):
    """A[i] = s * A[i]"""
    return _scal(s, a) * a


def copy(b):
    """A[i] = B[i]"""
    return b.clone()


def striad(s, b, c):
    """A[i] = B[i] + s * C[i]"""
    if b.dtype in _HALF:
        return b + _scal(s, b) * c
    return torch.add(b, c, alpha=s)


def schoenauer(b, c, d):
    """A[i] = B[i] + C[i] * D[i]"""
    if b.dtype in _HALF:
        return b + c * d
    return torch.addcmul(b, c, d)


def striad_rmw(s, a, b, c):
    """A[i] = (A[i]*0 + B[i]) + s*C[i]: striad reading A first; the
    product with zero carries a NaN or inf of A into the result."""
    return striad(s, a * 0 + b, c)


def triad_update(s, t, b, c):
    """A[i] = t * (B[i] + s * C[i]): the fused chain computes exactly the
    two roundings of ``update(t, striad(s, b, c))``."""
    return update(t, striad(s, b, c))
