"""Learning-rate schedules as step -> lr functions (the reference's
``repro/optim/schedule.py``).  Each takes the step as a tensor and returns
an f32 tensor on its device, rounding as the reference does (f32 after
every operation; ``torch.cos`` and ``jnp.cos`` may part by an ulp)."""
from __future__ import annotations

import math
from typing import Callable

import torch

Schedule = Callable[[torch.Tensor], torch.Tensor]


def constant(lr: float) -> Schedule:
    def fn(step):
        return torch.tensor(lr, dtype=torch.float32, device=step.device)
    return fn


def cosine(peak_lr: float, total_steps: int, *, final_fraction: float = 0.1
           ) -> Schedule:
    def fn(step):
        t = torch.clip(step.float() / max(total_steps, 1), 0.0, 1.0)
        cos = 0.5 * (1.0 + torch.cos(math.pi * t))
        return peak_lr * (final_fraction + (1 - final_fraction) * cos)
    return fn


def linear_warmup_cosine(peak_lr: float, warmup_steps: int, total_steps: int,
                         *, final_fraction: float = 0.1) -> Schedule:
    decay = cosine(peak_lr, max(total_steps - warmup_steps, 1),
                   final_fraction=final_fraction)

    def fn(step):
        warm = peak_lr * step.float() / max(warmup_steps, 1)
        return torch.where(step < warmup_steps, warm, decay(step - warmup_steps))
    return fn
