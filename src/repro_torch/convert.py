"""Carry the reference's state across to the port.

The state is the input streams (and the stencils' grids, the matmul
operands and the attention inputs q, k, v in the ``(B, S, H, d)`` layout:
arrays of any shape, taken alike), the Table I kernel specs, and the LM's
parameter trees, train states and decode caches (nested dicts of arrays,
mapped leaf by leaf), and data batches.
Arrays arrive as numpy arrays (bf16 ones as
``np.asarray`` of a JAX array gives them, with the ``ml_dtypes`` bfloat16
dtype, which ``torch.from_numpy`` does not take); specs as the dict
``dataclasses.asdict`` makes of a reference spec.
"""
from __future__ import annotations

import numpy as np
import torch

from .core.kernel_spec import StreamKernelSpec


def _tensor(a: np.ndarray) -> torch.Tensor:
    a = np.array(a)              # a writable, contiguous copy
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def streams_from_numpy(arrays, *, device, dtype: torch.dtype | None = None
                       ) -> list[torch.Tensor]:
    """Each numpy array as a tensor on ``device``, bit for bit, then cast
    to ``dtype`` where one is given."""
    out = []
    for a in arrays:
        t = _tensor(a).to(device)
        out.append(t if dtype is None else t.to(dtype))
    return out


def spec_from_dict(d: dict) -> StreamKernelSpec:
    """A port spec from ``dataclasses.asdict`` of a reference spec; raises
    ``TypeError`` on a field the port's spec does not have."""
    return StreamKernelSpec(**d)


def params_from_numpy(tree, *, device, dtype: torch.dtype | None = None):
    """A reference parameter tree (nested dicts of numpy arrays) as the
    port's, the same nesting, each leaf a tensor on ``device`` bit for
    bit, then cast to ``dtype`` where one is given."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device=device, dtype=dtype)
                for k, v in tree.items()}
    return streams_from_numpy([tree], device=device, dtype=dtype)[0]


def cache_from_numpy(cache: dict, *, device) -> dict:
    """A reference decode cache (arrays, or dicts of them, and a scalar
    ``length``: the LM's ``k``, ``v``; zamba2's ``ssm``, ``conv``, ``k``,
    ``v``; whisper's ``self_*`` and ``cross_*``; xLSTM's ``layer_{i}``
    state dicts) as the port's: every array bit for bit on ``device``, the
    length a host int."""
    return {k: int(v) if k == "length" else params_from_numpy(v, device=device)
            for k, v in cache.items()}


def state_from_numpy(state: dict, *, device) -> dict:
    """A reference train state (``{"params", "opt_state": {"mu", "nu",
    "count"}, "step"}``: f32 or bf16 moments, or int8 ones as ``{"q",
    "scale"}`` dicts, and int32 scalars) as the port's, every array bit
    for bit on ``device``."""
    return params_from_numpy(state, device=device)


def batch_from_numpy(batch: dict, *, device) -> dict:
    """A numpy batch (``make_batch``, the data pipeline) as tensors on
    ``device``, bit for bit."""
    return {k: _tensor(v).to(device) for k, v in batch.items()}
