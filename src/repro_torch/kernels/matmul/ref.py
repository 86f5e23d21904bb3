"""Plain PyTorch version of the blocked matmul: the reference's oracle
(``repro/kernels/matmul/ref.py``, ``jnp.dot(..., preferred_element_type=
f32)``): the product of the f32-cast inputs, cast to the output dtype.

On the card ``torch.matmul`` of f32 tensors runs in full f32 unless TF32 is
allowed (``torch.backends.cuda.matmul.allow_tf32``, off by default); the
compute loop pins it off wherever it runs this on the card."""
from __future__ import annotations

import torch

#: (rtol, atol) of a kernel's output against this version by input dtype:
#: the reference's own (tests/test_kernels.py: matmul f32 1e-4 / 1e-3 at
#: K <= 1024, bf16 2e-2 / 2e-2)
TOLERANCE = {torch.float32: (1e-4, 1e-3), torch.bfloat16: (2e-2, 2e-2)}


def matmul(x: torch.Tensor, y: torch.Tensor, out_dtype: torch.dtype | None = None
           ) -> torch.Tensor:
    return torch.matmul(x.float(), y.float()).to(out_dtype or x.dtype)
