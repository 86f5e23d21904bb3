"""Architecture definitions: the uniform API every ported arch implements
(the reference's ``repro/configs/base.py``).

An :class:`ArchDef` binds a model family's functions (spec / loss /
prefill / decode / cache-spec) to one concrete configuration, and knows
how to build its inputs for each assigned input shape as numpy arrays, or
as the dry-run's stand-ins (:meth:`ArchDef.abstract_batch`).

Input shapes (assigned, global):

=============  ========  ============
shape          seq_len   global_batch
=============  ========  ============
train_4k       4,096     256
prefill_32k    32,768    32
decode_32k     32,768    128 (1 token)
long_500k      524,288   1 (1 token)
=============  ========  ============

``long_500k`` requires sub-quadratic sequence mixing and is skipped (with
a recorded reason) for full-attention architectures.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, Callable

import numpy as np
import torch

from ..models.common import ParamSpec, abstract, count_params, tree_leaves


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str                      # train | prefill | decode

    @property
    def tokens_per_step(self) -> int:
        return self.seq_len * self.global_batch


SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}


@dataclass(frozen=True)
class ArchDef:
    """One selectable architecture (``--arch <name>``).  ``profile``,
    ``train_accum`` and ``moment_dtype`` carry the reference's sharding
    profile (``dist.get_profile``), gradient accumulation and Adam moment
    storage."""

    name: str
    family: str                    # dense | moe | hybrid | ssm | vlm | audio
    cfg: Any                       # model config dataclass
    spec_fn: Callable
    loss_fn: Callable
    prefill_fn: Callable
    decode_fn: Callable
    cache_spec_fn: Callable
    profile: str = "tp_dp"
    sub_quadratic: bool = False    # may run long_500k
    has_decoder: bool = True       # encoder-only archs skip decode shapes
    source: str = ""               # provenance note ([arXiv/hf; tier])
    #: extra per-shape batch entries: name -> fn(shape, cfg) -> ParamSpec
    #: or None (no entry at that shape)
    extra_inputs: dict = field(default_factory=dict)
    #: full override of batch_spec: fn(shape, cfg) -> dict[str, ParamSpec]
    #: (whisper's frames and prompt)
    batch_spec_fn: Callable | None = None
    train_accum: int = 1
    moment_dtype: str = "f32"      # f32 | bf16 | int8

    # -- parameters ----------------------------------------------------
    def param_spec(self):
        return self.spec_fn(self.cfg)

    @property
    def n_params(self) -> int:
        return count_params(self.param_spec())

    @property
    def n_active_params(self) -> int:
        """Active params per token (MoE: experts scaled by top_k/n_experts)."""
        spec = self.param_spec()
        moe = getattr(self.cfg, "moe", None)
        if moe is None:
            return count_params(spec)
        total = 0
        for s in tree_leaves(spec):
            n = int(math.prod(s.shape))
            if "experts" in s.axes:     # expert-parallel weights
                n = int(n * moe.top_k / moe.n_experts)
            total += n
        return total

    # -- model fns -----------------------------------------------------
    def loss(self, params, batch):
        return self.loss_fn(params, self.cfg, batch)

    def prefill(self, params, batch, *, max_len: int | None = None):
        return self.prefill_fn(params, self.cfg, batch, max_len=max_len)

    def decode(self, params, cache, batch):
        return self.decode_fn(params, self.cfg, cache, batch)

    def cache_spec(self, batch_size: int, max_len: int):
        return self.cache_spec_fn(self.cfg, batch_size, max_len)

    # -- shape policy ----------------------------------------------------
    def shape_supported(self, shape: ShapeSpec) -> tuple[bool, str]:
        if shape.kind == "decode" and not self.has_decoder:
            return False, "encoder-only: no decode step"
        if shape.name == "long_500k" and not self.sub_quadratic:
            return False, "full-attention arch: long_500k needs sub-quadratic mixing"
        return True, ""

    def cells(self) -> list[tuple[ShapeSpec, bool, str]]:
        return [(s, *self.shape_supported(s)) for s in SHAPES.values()]

    # -- inputs ----------------------------------------------------------
    def batch_spec(self, shape: ShapeSpec) -> dict:
        """ParamSpec tree of the step's *data* inputs (not params/cache)."""
        if self.batch_spec_fn is not None:
            return self.batch_spec_fn(shape, self.cfg)
        b = shape.global_batch
        text_s = self._text_len(shape)
        out = {"tokens": ParamSpec((b, text_s), ("batch", None), init="zeros",
                                   dtype=torch.int32)}
        if shape.kind == "train":
            label_s = text_s + getattr(self.cfg, "image_prefix", 0)
            out["labels"] = ParamSpec((b, label_s), ("batch", None),
                                      init="zeros", dtype=torch.int32)
            out["mask"] = ParamSpec((b, label_s), ("batch", None),
                                    init="ones", dtype=torch.float32)
        for k, fn in self.extra_inputs.items():
            spec = fn(shape, self.cfg)
            if spec is not None:
                out[k] = spec
        return out

    def _text_len(self, shape: ShapeSpec) -> int:
        """Token-stream length (prefix positions are reserved)."""
        if shape.kind == "decode":
            return 1
        return max(shape.seq_len - getattr(self.cfg, "image_prefix", 0), 1)

    def abstract_batch(self, shape: ShapeSpec, *, device) -> dict:
        """The step's data inputs as :func:`~..models.common.abstract`
        tensors on ``device`` (fake under the caller's
        ``FakeTensorMode``)."""
        return abstract(self.batch_spec(shape), device=device)

    def make_batch(self, shape: ShapeSpec, seed: int = 0) -> dict:
        """Concrete numpy batch for this shape, drawn as the reference
        draws it (``Philox(key=[seed, 7])``, the entries in its order), so
        both give the same arrays bit for bit: tokens and labels as
        integers, the mask as ones, float inputs (pixtral's patch
        embeddings, whisper's frames) as f32 normals times 0.02."""
        g = np.random.Generator(np.random.Philox(key=[seed, 7]))
        out = {}
        for k, spec in self.batch_spec(shape).items():
            if spec.dtype == torch.int32:
                out[k] = g.integers(0, self.cfg.vocab,
                                    size=spec.shape).astype(np.int32)
            elif spec.init == "ones":
                out[k] = np.ones(spec.shape, np.float32)
            else:
                out[k] = g.standard_normal(spec.shape).astype(np.float32) * 0.02
        return out

    # -- useful-work accounting ------------------------------------------
    def model_flops(self, shape: ShapeSpec) -> float:
        """MODEL_FLOPS = 6·N·D (train) / 2·N·D (inference fwd), N = active."""
        n = self.n_active_params
        if shape.kind == "train":
            return 6.0 * n * shape.tokens_per_step
        if shape.kind == "prefill":
            return 2.0 * n * shape.tokens_per_step
        return 2.0 * n * shape.global_batch          # decode: 1 token/seq
