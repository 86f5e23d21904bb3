"""The one comparison of a kernel's output with its plain version.

Every check of the port goes through :func:`compare`: the small-size
correctness phase on the card, the full-size ``validate()`` of the
benchmarks, and the CPU tests.  It is NaN-safe: an elementwise output
agrees only if ``torch.equal`` holds (False on any NaN), a sum only if it
is finite and within tolerance, and the reported error counts NaN as
infinite.  Outputs whose every element is a sum (matmul, attention) take
an explicit ``tol=(rtol, atol)`` instead.
"""
from __future__ import annotations

import math

import torch

_HALF = (torch.bfloat16, torch.float16)


def sum_tolerance(want: float, summed_from: torch.Tensor) -> float:
    """rtol 1e-4 + atol 1e-3*sqrt(n) (1e-2*sqrt(n) for bf16/f16 inputs):
    sums of n values of N(0, 1) cancel towards 0, so the absolute part
    scales with the sum's expected magnitude (the reference's own
    tolerance, tests/test_kernels.py and tests/test_pipeline.py)."""
    coef = 1e-2 if summed_from.dtype in _HALF else 1e-3
    return 1e-4 * abs(want) + coef * math.sqrt(summed_from.numel())


def compare(got: torch.Tensor, want: torch.Tensor, *,
            summed_from: torch.Tensor | None = None,
            tol: tuple[float, float] | None = None
            ) -> tuple[bool, float, float]:
    """``(ok, max_abs_err, tolerance)`` of ``got`` against ``want``.

    ``summed_from`` is the input of a sum (its size and dtype set the
    tolerance).  ``tol = (rtol, atol)`` holds every element to
    ``|got - want| <= atol + rtol * |want|`` with every element of ``got``
    finite (numpy's ``assert_allclose``, NaN-safe); the tolerance reported
    is the allowance at the largest ``|want|``.  With neither, the output
    is elementwise and must equal ``want`` bit for bit (tolerance 0).
    """
    if summed_from is not None and tol is not None:
        raise ValueError("pass summed_from or tol, not both")
    if got.shape != want.shape or got.dtype != want.dtype:
        raise ValueError(f"cannot compare {tuple(got.shape)} {got.dtype} "
                         f"with {tuple(want.shape)} {want.dtype}")
    inf = float("inf")
    diff = (got.float() - want.float()).abs().nan_to_num(nan=inf, posinf=inf)
    err = float(diff.max()) if diff.numel() else 0.0
    if tol is not None:
        rtol, atol = tol
        allowed = atol + rtol * want.float().abs()
        ok = bool(torch.isfinite(got).all()) and bool((diff <= allowed).all())
        return ok, err, float(allowed.max()) if allowed.numel() else atol
    if summed_from is None:
        return torch.equal(got, want), err, 0.0
    bound = sum_tolerance(float(want), summed_from)
    ok = bool(torch.isfinite(got).all()) and err <= bound
    return ok, err, bound
