"""Architecture registry: one module per ported architecture (the
reference's ``repro/configs``).

``get_arch(name)`` returns the full-size :class:`~.base.ArchDef`;
``get_arch(name, smoke=True)`` the reduced same-family config the CPU
tests use.  The dense, MoE, multimodal and hybrid LMs are ported; asking
for one of the reference's other archs raises ``KeyError`` naming the
ROADMAP item that ports it.
"""
from __future__ import annotations

import importlib

from .base import SHAPES, ArchDef, ShapeSpec

_MODULES = {
    "zamba2-1.2b": "zamba2_1_2b",
    "internlm2-1.8b": "internlm2_1_8b",
    "qwen1.5-110b": "qwen1_5_110b",
    "minitron-4b": "minitron_4b",
    "glm4-9b": "glm4_9b",
    "granite-moe-1b-a400m": "granite_moe_1b",
    "qwen3-moe-235b-a22b": "qwen3_moe_235b",
    "pixtral-12b": "pixtral_12b",
}
#: the reference's archs not ported yet, and the ROADMAP §1 item that
#: ports them (the recurrent and audio families)
NOT_PORTED = {name: "ROADMAP §1 item 3" for name in (
    "xlstm-125m", "whisper-base")}

ARCH_NAMES = tuple(_MODULES)


def get_arch(name: str, *, smoke: bool = False) -> ArchDef:
    if name in NOT_PORTED:
        raise KeyError(f"arch {name!r} is not ported yet ({NOT_PORTED[name]}); "
                       f"ported: {sorted(_MODULES)}")
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; have {sorted(_MODULES)}")
    mod = importlib.import_module(f".{_MODULES[name]}", __package__)
    return mod.smoke() if smoke else mod.full()


def all_archs(*, smoke: bool = False) -> dict[str, ArchDef]:
    return {n: get_arch(n, smoke=smoke) for n in ARCH_NAMES}


__all__ = ["SHAPES", "ArchDef", "ShapeSpec", "ARCH_NAMES", "NOT_PORTED",
           "get_arch", "all_archs"]
