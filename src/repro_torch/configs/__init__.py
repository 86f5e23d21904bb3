"""Architecture registry: one module per ported architecture (the
reference's ``repro/configs``).

``get_arch(name)`` returns the full-size :class:`~.base.ArchDef`;
``get_arch(name, smoke=True)`` the reduced same-family config the CPU
tests use.  Every arch of the reference is ported: the dense, MoE,
multimodal and hybrid LMs, the recurrent xLSTM and the encoder-decoder
whisper.  An unknown name raises ``KeyError``.
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
    "xlstm-125m": "xlstm_125m",
    "pixtral-12b": "pixtral_12b",
    "whisper-base": "whisper_base",
}

ARCH_NAMES = tuple(_MODULES)


def get_arch(name: str, *, smoke: bool = False) -> ArchDef:
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; have {sorted(_MODULES)}")
    mod = importlib.import_module(f".{_MODULES[name]}", __package__)
    return mod.smoke() if smoke else mod.full()


def all_archs(*, smoke: bool = False) -> dict[str, ArchDef]:
    return {n: get_arch(n, smoke=smoke) for n in ARCH_NAMES}


__all__ = ["SHAPES", "ArchDef", "ShapeSpec", "ARCH_NAMES", "get_arch",
           "all_archs"]
