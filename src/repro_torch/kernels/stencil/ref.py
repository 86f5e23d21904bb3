"""Plain PyTorch versions of the Jacobi stencils.

The semantics of the reference's oracles (``repro/kernels/stencil/ref.py``):

* interior: ``out = c0*a + c1*(sum of the 2*dim nearest neighbours)``,
  with the neighbour sum associated per axis, outermost axis first:
  2D ``(n+s) + (w+e)``, 3D ``((d+u) + (n+s)) + (w+e)``;
* physical boundary (any index at 0 or the last position of its axis):
  ``out = a`` (Dirichlet copy).

Rounding is the reference oracle's: in f32 both products are rounded and
then added (two multiplies and one add, never a fused multiply-add such
as ``torch.add(alpha=)`` or ``addcmul``); in bf16 every operation rounds
to bf16, with the coefficients cast to bf16 first.  The CUDA kernels of
``csrc/stencil.cu`` compute the same roundings bit for bit.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def pad(a: torch.Tensor) -> torch.Tensor:
    """``a`` with one ring of zeros around it, as ``jnp.pad(a, 1)``."""
    return F.pad(a, (1, 1) * a.dim())


def edge_mask(shape, device) -> torch.Tensor:
    """True where any index is at 0 or the last position of its axis."""
    out = torch.zeros(shape, dtype=torch.bool, device=device)
    for ax, n in enumerate(shape):
        idx = torch.arange(n, device=device).view(
            [n if i == ax else 1 for i in range(len(shape))])
        out |= (idx == 0) | (idx == n - 1)
    return out


def _coef(c: float, a: torch.Tensor):
    """``c`` as the reference casts a Python scalar: to bf16 for a bf16
    array (a 0-dim tensor, so the product rounds to bf16), as it is for
    f32."""
    if a.dtype == torch.float32:
        return c
    return torch.tensor(c, dtype=a.dtype, device=a.device)


def _sweep(a: torch.Tensor, s: torch.Tensor, c0: float, c1: float):
    val = _coef(c0, a) * a + _coef(c1, a) * s
    return torch.where(edge_mask(a.shape, a.device), a, val)


def jacobi2d(a: torch.Tensor, c0: float = 0.0, c1: float = 0.25):
    """b[j,i] = c0*a[j,i] + c1*(a[j-1,i] + a[j+1,i] + a[j,i-1] + a[j,i+1])
    on the interior; b = a on the boundary."""
    p = pad(a)
    s = (p[:-2, 1:-1] + p[2:, 1:-1]) + (p[1:-1, :-2] + p[1:-1, 2:])
    return _sweep(a, s, c0, c1)


def jacobi3d(a: torch.Tensor, c0: float = 0.0, c1: float = 1.0 / 6.0):
    """b[k,j,i] = c0*a[k,j,i] + c1*(sum of the 6 nearest neighbours) on the
    interior; b = a on the boundary."""
    p = pad(a)
    s = (((p[:-2, 1:-1, 1:-1] + p[2:, 1:-1, 1:-1])
          + (p[1:-1, :-2, 1:-1] + p[1:-1, 2:, 1:-1]))
         + (p[1:-1, 1:-1, :-2] + p[1:-1, 1:-1, 2:]))
    return _sweep(a, s, c0, c1)
