"""The kernels have no backward.

No Pallas kernel of the reference defines a ``custom_vjp``, so
``jax.grad`` through one raises.  A CUDA kernel here writes its output
through ``data_ptr()``, so autograd would see a tensor with no history
and silently give its operands no gradient; the CPU path's plain version
would give one.  :func:`refuse_grad` makes both devices refuse instead.
"""
from __future__ import annotations

import torch


def refuse_grad(op: str, *operands: torch.Tensor) -> None:
    """Raise ``RuntimeError`` when grad mode is on and an operand of the
    kernel op ``op`` requires grad (on either device)."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in operands):
        raise RuntimeError(
            f"{op}: an operand requires grad, but the kernel has no backward "
            f"(the reference's Pallas kernel has none either); call it under "
            f"torch.no_grad(), or use the model's plain path to train")
