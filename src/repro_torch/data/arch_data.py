"""Arch-aware synthetic dataset (the reference's
``repro/data/arch_data.py``): fills every input the arch's batch spec
declares (tokens, labels and mask, and the stub modality embeddings:
pixtral's ``patch_embeds``, whisper's ``frames``), deterministically per
``(seed, step)``, as numpy arrays bit for bit the reference's.
"""
from __future__ import annotations

import numpy as np

from ..configs.base import ArchDef, ShapeSpec
from .pipeline import DataConfig, SyntheticLMDataset, _rng


class ArchSyntheticDataset:
    def __init__(self, arch: ArchDef, shape: ShapeSpec, seed: int = 0):
        self.arch = arch
        self.shape = shape
        self.seed = seed
        self.spec = arch.batch_spec(shape)
        text_len = self.spec["tokens"].shape[1]
        vocab = getattr(arch.cfg, "vocab", 1024)
        self._lm = SyntheticLMDataset(DataConfig(
            global_batch=shape.global_batch, seq_len=text_len,
            vocab=vocab, seed=seed))

    def batch(self, step: int) -> dict[str, np.ndarray]:
        lm = self._lm.batch(step)
        out: dict[str, np.ndarray] = {}
        g = _rng(self.seed ^ 0xA5C3, step)
        for k, spec in self.spec.items():
            if k == "tokens":
                out[k] = lm["tokens"]
            elif k in ("labels", "mask"):
                b, sl = spec.shape
                st = lm[k].shape[1]
                if sl == st:
                    out[k] = lm[k]
                else:                      # prefix positions (VLM): masked out
                    pad = np.zeros((b, sl - st), lm[k].dtype)
                    out[k] = np.concatenate([pad, lm[k]], axis=1)
            else:                          # stub modality embeddings
                out[k] = (g.standard_normal(spec.shape) * 0.02
                          ).astype(np.float32)
        return out
