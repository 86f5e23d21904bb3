"""Optimizer substrate (the reference's ``repro/optim``): AdamW with
schedules, global-norm clipping and f32, bf16 or int8 moments.

The state is declared by ``ParamSpec`` trees as the parameters are
(:func:`opt_state_spec`).  Eager PyTorch has no buffer donation, so the
update runs in place, leaf by leaf (:func:`adamw_step`): a step never
holds a second copy of the parameters or the moments.
"""
from .adamw import (
    AdamWConfig,
    adamw_init,
    adamw_step,
    adamw_update,
    apply_updates,
    global_norm,
    opt_state_spec,
)
from .schedule import Schedule, constant, cosine, linear_warmup_cosine

__all__ = [
    "AdamWConfig",
    "adamw_init",
    "adamw_step",
    "adamw_update",
    "apply_updates",
    "global_norm",
    "opt_state_spec",
    "Schedule",
    "constant",
    "cosine",
    "linear_warmup_cosine",
]
