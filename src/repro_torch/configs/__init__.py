"""Assigned-architecture registry: ``get_config(name)`` / ``get_smoke(name)``.

Each module defines CONFIG (the exact assigned configuration) and SMOKE (a
reduced same-family variant for CPU tests).  ``ARCH_NAMES`` is the assigned
10-arch pool.  Names may be dashed (``gemma3-1b``) or dotted
(``zamba2-2.7b``).  ``shape_applicable`` and ``all_cells`` are the JAX
package's skip rules and its 40 production cells (long_500k only for
sub-quadratic archs; decode only for archs with a decoder), with its
reasons word for word.
"""
from __future__ import annotations

import importlib

from repro_torch.models.config import SHAPES, LMConfig, ShapeCfg

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



def shape_applicable(cfg: LMConfig, shape: ShapeCfg) -> tuple[bool, str]:
    """(runs?, reason-if-skipped) for an (arch, shape) cell."""
    if shape.kind == "decode" and not cfg.has_decoder:
        return False, "encoder-only arch: no decode step"
    if shape.name == "long_500k" and not cfg.supports_long_context:
        return False, ("pure full-attention arch: long_500k needs "
                       "sub-quadratic attention (DESIGN.md Sec. 4)")
    return True, ""


def all_cells():
    """Yield (arch_name, shape_name, applicable, reason) for all 40 cells."""
    for a in ARCH_NAMES:
        cfg = get_config(a)
        for s in SHAPES.values():
            ok, why = shape_applicable(cfg, s)
            yield a, s.name, ok, why
