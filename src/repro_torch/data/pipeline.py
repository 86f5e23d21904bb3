"""Deterministic data pipeline (the reference's ``repro/data/pipeline.py``;
the datasets in numpy only, so every batch equals the reference's bit for
bit).

``SyntheticLMDataset`` generates language-modelling batches from a counter-
based PRNG (Philox keyed on ``(seed, step)``): stateless, so checkpoint-
restart needs no data-iterator state.

``TokenFileDataset`` is the real-data path: a flat binary token file
(np.uint16/np.int32 memmap) cut into fixed-length windows; window order is a
deterministic permutation of ``(seed, epoch)``.

:func:`make_global_array` and :func:`shard_batch` place a batch on a
``DeviceMesh``: each rank builds only its own block (JAX's block for its
mesh coordinate) and the global tensor is a DTensor over the ranks'
blocks.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import numpy as np
import torch

from ..dist.sharding import NamedSharding, mesh_device


@dataclass(frozen=True)
class DataConfig:
    global_batch: int
    seq_len: int
    vocab: int
    seed: int = 0
    #: synthetic corpus structure: tokens follow a Markov-ish mixture so the
    #: LM loss actually decreases during the example runs (pure uniform noise
    #: has no learnable signal).
    structure: float = 0.8


def _rng(seed: int, step: int) -> np.random.Generator:
    return np.random.Generator(np.random.Philox(key=[seed, step]))


class SyntheticLMDataset:
    """Deterministic synthetic LM batches: ``batch(step) -> dict``.

    Emitted arrays: tokens (B,S) int32, labels (B,S) int32 (next-token
    shifted), mask (B,S) float32.
    """

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        # fixed "grammar": each token deterministically prefers a successor;
        # generated once from the seed, shared by every batch.
        g = _rng(cfg.seed, 0xFFFF)
        self._succ = g.integers(0, cfg.vocab, size=(cfg.vocab,), dtype=np.int64)

    def batch(self, step: int) -> dict[str, np.ndarray]:
        cfg = self.cfg
        g = _rng(cfg.seed, step)
        b, s = cfg.global_batch, cfg.seq_len
        noise = g.integers(0, cfg.vocab, size=(b, s + 1), dtype=np.int64)
        use_rule = g.random((b, s + 1)) < cfg.structure
        toks = noise.copy()
        # pair grammar (vectorizable, genuinely learnable): odd positions
        # follow the successor of the *emitted* even token with probability
        # ``structure`` — a first-order dependency a model can pick up.
        n_pairs = (s + 1) // 2
        even = toks[:, 0:2 * n_pairs:2]
        toks[:, 1:2 * n_pairs:2] = np.where(
            use_rule[:, 1:2 * n_pairs:2], self._succ[even],
            noise[:, 1:2 * n_pairs:2])
        return {
            "tokens": toks[:, :-1].astype(np.int32),
            "labels": toks[:, 1:].astype(np.int32),
            "mask": np.ones((b, s), np.float32),
        }

    def batches(self, start_step: int = 0):
        step = start_step
        while True:
            yield self.batch(step)
            step += 1


class TokenFileDataset:
    """Fixed-window LM dataset over a flat binary token file (memmap)."""

    def __init__(self, path: str, cfg: DataConfig, dtype=np.uint16):
        self.cfg = cfg
        self._data = np.memmap(path, dtype=dtype, mode="r")
        self.n_windows = (len(self._data) - 1) // cfg.seq_len
        if self.n_windows < cfg.global_batch:
            raise ValueError(
                f"{path}: only {self.n_windows} windows of {cfg.seq_len} "
                f"tokens; need >= global_batch={cfg.global_batch}")

    def _perm(self, epoch: int) -> np.ndarray:
        return _rng(self.cfg.seed, epoch).permutation(self.n_windows)

    def batch(self, step: int) -> dict[str, np.ndarray]:
        cfg = self.cfg
        per_epoch = self.n_windows // cfg.global_batch
        epoch, idx = divmod(step, per_epoch)
        perm = self._perm(epoch)
        rows = perm[idx * cfg.global_batch:(idx + 1) * cfg.global_batch]
        s = cfg.seq_len
        out = np.stack([self._data[r * s:r * s + s + 1] for r in rows])
        out = out.astype(np.int32)
        return {
            "tokens": out[:, :-1],
            "labels": out[:, 1:],
            "mask": np.ones((cfg.global_batch, s), np.float32),
        }


# ---------------------------------------------------------------------------
# Sharded materialization
# ---------------------------------------------------------------------------


def make_global_array(host_fn: Callable[[tuple[slice, ...]], np.ndarray],
                      shape: tuple[int, ...], mesh, pspec: tuple,
                      dtype=None):
    """A global DTensor of ``shape`` on ``mesh`` sharded by ``pspec``,
    where this rank's block is ``host_fn(index)`` for its own index alone
    (``NamedSharding.index``: JAX's block for the rank's coordinate), cast
    to the numpy ``dtype`` where given; no rank touches another's
    block."""
    from torch.distributed.tensor import DTensor

    sharding = NamedSharding(mesh, tuple(pspec))
    placements = sharding.placements()
    arr = np.asarray(host_fn(sharding.index(mesh.get_coordinate(), shape)))
    if dtype is not None:
        arr = arr.astype(dtype)
    local = torch.from_numpy(np.ascontiguousarray(arr)).to(mesh_device(mesh))
    return DTensor.from_local(local, mesh, placements, run_check=False,
                              shape=torch.Size(shape),
                              stride=torch.empty(shape, device="meta").stride())


def _batch_entry(batch_axes):
    axes = tuple(batch_axes) if isinstance(batch_axes, (tuple, list)) \
        else (batch_axes,)
    return axes if len(axes) > 1 else axes[0]


def shard_batch(batch: dict[str, np.ndarray], mesh,
                batch_axes) -> dict[str, Any]:
    """Place a host batch onto the mesh, sharded over the batch axes."""
    out = {}
    for k, v in batch.items():
        spec = (_batch_entry(batch_axes), *([None] * (v.ndim - 1))) \
            if v.ndim else ()
        out[k] = make_global_array(lambda idx, v=v: v[idx], v.shape, mesh,
                                   spec, dtype=v.dtype)
    return out
