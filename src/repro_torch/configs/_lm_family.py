"""Shared constructor for the dense, MoE and multimodal decoder-only LM
architectures."""
from __future__ import annotations

from ..models import lm
from .base import ArchDef


def lm_arch(name: str, cfg: lm.LMConfig, *, family: str = "dense",
            profile: str = "tp_dp", source: str = "",
            extra_inputs: dict | None = None, train_accum: int = 1,
            moment_dtype: str = "f32") -> ArchDef:
    return ArchDef(
        name=name,
        family=family,
        cfg=cfg,
        spec_fn=lm.lm_spec,
        loss_fn=lm.loss_fn,
        prefill_fn=lm.prefill,
        decode_fn=lm.decode_step,
        cache_spec_fn=lm.cache_spec,
        profile=profile,
        sub_quadratic=False,
        source=source,
        extra_inputs=extra_inputs or {},
        train_accum=train_accum,
        moment_dtype=moment_dtype,
    )
