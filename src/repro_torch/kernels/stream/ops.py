"""Public stream ops, with the reference's signatures and semantics
(``repro/kernels/stream/ops.py``).

Streams are flat (or already 2-D) arrays of a multiple of 128 elements,
laid out as ``(rows, 128)``.  ``num_stages=None`` runs the grid kernels
(one CTA per block); an int runs the multi-buffered pipeline with that
many ring slots per stream (contract in :mod:`..pipeline`).  A CPU tensor
takes the op's plain version in :mod:`.ref`; any other tensor launches
the CUDA kernel, which raises on what it does not take.  Reductions
return a 0-dim f32 tensor (f32 accumulator for bf16 inputs).

The pipeline's ring must fit the card's shared memory: at the default
64-row block, ``schoenauer`` at depth 3 needs 288 KiB and raises; pass a
smaller ``block_rows`` (the benchmark uses the largest block whose
depth-3 ring fits every op).
"""
from __future__ import annotations

import torch

from .. import pipeline as P
from . import kernel as K
from . import ref


def _as2d(x: torch.Tensor) -> torch.Tensor:
    """Reshape a flat stream to (rows, BLOCK_COLS)."""
    return x.reshape(x.numel() // K.BLOCK_COLS, K.BLOCK_COLS)


def _launch(op, scalars, ins, *, rows, dtype, device, num_stages,
            block_rows):
    kw = dict(rows=rows, dtype=dtype, device=device, block_rows=block_rows)
    if num_stages is None:
        return K.grid_map(op, scalars, ins, **kw)
    return P.map_pipeline(op, scalars, ins, num_stages=num_stages, **kw)


def _map(op, plain, scalars, streams, *, num_stages, block_rows):
    ins = tuple(_as2d(x) for x in streams)
    x = ins[0]
    if x.device.type == "cpu":
        out = plain(*scalars, *ins)
    else:
        out = _launch(op, scalars, ins, rows=x.shape[0], dtype=x.dtype,
                      device=x.device, num_stages=num_stages,
                      block_rows=block_rows)
    return out.reshape(streams[0].shape)


def _reduce(op, plain, streams, *, num_stages, block_rows):
    ins = tuple(_as2d(x) for x in streams)
    if ins[0].device.type == "cpu":
        return plain(*ins)
    if num_stages is None:
        out = K.grid_reduce(op, ins, block_rows=block_rows)
    else:
        out = P.reduce_pipeline(op, ins, num_stages=num_stages,
                                block_rows=block_rows)
    return out[0, 0]


def load(a, *, block_rows=K.BLOCK_ROWS, num_stages=None):
    return _reduce("load", ref.load, (a,), num_stages=num_stages,
                   block_rows=block_rows)


def ddot(a, b, *, block_rows=K.BLOCK_ROWS, num_stages=None):
    return _reduce("ddot", ref.ddot, (a, b), num_stages=num_stages,
                   block_rows=block_rows)


def store(s, shape, dtype, *, device="cuda", block_rows=K.BLOCK_ROWS,
          num_stages=None):
    device = torch.device(device)
    rows = (shape[0] * (shape[1] if len(shape) > 1 else 1)) // K.BLOCK_COLS
    if device.type == "cpu":
        out = ref.store(s, (rows, K.BLOCK_COLS), dtype, device=device)
    else:
        out = _launch("store", (s,), (), rows=rows, dtype=dtype,
                      device=device, num_stages=num_stages,
                      block_rows=block_rows)
    return out.reshape(shape)


def update(s, a, *, block_rows=K.BLOCK_ROWS, num_stages=None):
    return _map("update", ref.update, (s,), (a,), num_stages=num_stages,
                block_rows=block_rows)


def copy(b, *, block_rows=K.BLOCK_ROWS, num_stages=None):
    return _map("copy", ref.copy, (), (b,), num_stages=num_stages,
                block_rows=block_rows)


def striad(s, b, c, *, block_rows=K.BLOCK_ROWS, num_stages=None):
    return _map("striad", ref.striad, (s,), (b, c), num_stages=num_stages,
                block_rows=block_rows)


def schoenauer(b, c, d, *, block_rows=K.BLOCK_ROWS, num_stages=None):
    return _map("schoenauer", ref.schoenauer, (), (b, c, d),
                num_stages=num_stages, block_rows=block_rows)


def triad_update(s, t, b, c, *, block_rows=K.BLOCK_ROWS, num_stages=2):
    """Fused triad->update chain: ``A[i] = t * (B[i] + s*C[i])``.

    The triad result never round-trips through device memory: 3 streams
    instead of the 5 of ``update(t, striad(s, b, c))``.  ``num_stages=None``
    runs the same fused arithmetic on the grid kernel.
    """
    return _map("triad_update", ref.triad_update, (s, t), (b, c),
                num_stages=num_stages, block_rows=block_rows)


def triad_update_unfused(s, t, b, c, *, block_rows=K.BLOCK_ROWS,
                         num_stages=2):
    """Reference chain through device memory: two launches, 5 streams."""
    a = striad(s, b, c, block_rows=block_rows, num_stages=num_stages)
    return update(t, a, block_rows=block_rows, num_stages=num_stages)


def striad_rmw(s, a, b, c):
    """A[i] = B[i] + s*C[i], reading A first (write-allocate analogue):
    the reference's ``a * 0 + b + s * c``, one pass of the grid kernel
    over four streams on the card (the reference fuses it with
    ``jax.jit``).  There is no pipelined form."""
    return _map("striad_rmw", ref.striad_rmw, (s,), (a, b, c),
                num_stages=None, block_rows=K.BLOCK_ROWS)
