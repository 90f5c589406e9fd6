"""Composable layer blocks: pre-norm residual wrappers around the mixers.

The JAX package's ``models/blocks.py`` for the dense family: ``Ctx``,
``BlockDef`` and ``dense_block`` in train mode (causal self-attention
with an optional sliding window, no cross-attention).  Block protocol:

    init(gen, device)  -> params for ONE layer
    apply(p, x, ctx)   -> x, on activations [*lead, b, t, d]

Not ported yet: the moe, mla, mamba, mLSTM and sLSTM blocks, the
bidirectional encoder block and cross-attention (ROADMAP item 15), and
the decode caches (item 21).
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.models import attention as attn
from repro_torch.models import layers
from repro_torch.models.config import LMConfig


@dataclasses.dataclass
class Ctx:
    cfg: LMConfig
    positions: torch.Tensor | None = None    # [t] global positions


@dataclasses.dataclass
class BlockDef:
    name: str
    init: Callable                 # (gen, device) -> params of one layer
    apply: Callable                # (p, x, ctx) -> x


def dense_block(cfg: LMConfig, *, window: int = 0,
                theta: float | None = None, d_ff: int | None = None,
                name: str = "dense") -> BlockDef:
    """Attention + MLP, each behind an RMS norm and a residual add."""
    th = theta if theta is not None else cfg.rope_theta
    ff = d_ff if d_ff is not None else cfg.d_ff

    def init(gen, device):
        return {"n1": layers.init_rms(cfg.d_model, device),
                "n2": layers.init_rms(cfg.d_model, device),
                "attn": attn.init_gqa(gen, cfg, device),
                "mlp": layers.init_mlp(gen, cfg.d_model, ff, cfg.act,
                                       device)}

    def apply(p, x, ctx: Ctx):
        h = layers.rms_norm(p["n1"], x, cfg.norm_eps)
        x = x + attn.gqa_attn(p["attn"], h, ctx.positions, cfg, theta=th,
                              window=window)
        return x + layers.mlp(p["mlp"], layers.rms_norm(p["n2"], x,
                                                        cfg.norm_eps),
                              cfg.act)

    return BlockDef(name, init, apply)
