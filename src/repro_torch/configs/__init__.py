"""Assigned-architecture registry: ``get_config(name)`` / ``get_smoke(name)``.

Each module defines CONFIG (the exact assigned configuration) and SMOKE (a
reduced same-family variant for CPU tests).  ``ARCH_NAMES`` is the assigned
10-arch pool.  Names may be dashed (``gemma3-1b``) or dotted
(``zamba2-2.7b``).
"""
from __future__ import annotations

import importlib

from repro_torch.models.config import LMConfig

ARCH_NAMES = [
    "arctic_480b",
    "deepseek_v3_671b",
    "whisper_base",
    "internvl2_76b",
    "stablelm_3b",
    "gemma3_12b",
    "gemma3_1b",
    "mistral_large_123b",
    "zamba2_2p7b",
    "xlstm_350m",
]

def _module(name: str):
    name = name.replace("-", "_").replace(".", "p")
    if name not in ARCH_NAMES:
        raise KeyError(f"unknown arch {name!r}; known: {ARCH_NAMES}")
    return importlib.import_module(f"repro_torch.configs.{name}")


def get_config(name: str) -> LMConfig:
    return _module(name).CONFIG


def get_smoke(name: str) -> LMConfig:
    return _module(name).SMOKE

