"""Composable layer blocks: pre-norm residual wrappers around the mixers.

The JAX package's ``models/blocks.py``: ``Ctx``, ``BlockDef``,
``dense_block`` (causal self-attention with an optional sliding window,
or whisper's bidirectional encoder attention; with cross-attention over
``Ctx.enc_out`` for whisper's decoder), and the xLSTM family's
``mlstm_block`` and ``slstm_block``.  Block protocol:

    init(gen, device)                     -> params for ONE layer
    apply(p, x, ctx)                      -> x, on activations
                                             [*lead, b, t, d] (train)
    apply(p, x, ctx, cache)               -> (x, new_cache) (serving:
                                             ctx.mode prefill or decode)
    cache_init(b, max_len)                -> the shapes of one layer's
                                             decode cache

Not ported yet: the moe, mla and mamba blocks (ROADMAP item 15; mamba
with the hybrid family) and the caches' sharding specs (item 17).
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.models import attention as attn
from repro_torch.models import layers, ssm
from repro_torch.models.config import LMConfig


@dataclasses.dataclass
class Ctx:
    cfg: LMConfig
    mode: str = "train"                      # train | prefill | decode
    positions: torch.Tensor | None = None    # [t] global positions
    pos: int = 0                             # the cache's write offset
    enc_out: torch.Tensor | None = None      # whisper's encoder output
                                             # [*lead, b, f, d]; None at
                                             # decode (the cache has it)


@dataclasses.dataclass
class BlockDef:
    name: str
    init: Callable                 # (gen, device) -> params of one layer
    apply: Callable                # (p, x, ctx[, cache]) -> x or
                                   # (x, new_cache)
    remat: bool = True             # recompute its activations in the
                                   # backward (see slstm_block)
    cache_init: Callable | None = None   # (b, max_len) -> shapes


def dense_block(cfg: LMConfig, *, window: int = 0,
                theta: float | None = None, causal: bool = True,
                cross: bool = False, d_ff: int | None = None,
                name: str = "dense") -> BlockDef:
    """Attention (causal, or bidirectional with ``causal=False``), then
    with ``cross`` attention over ``ctx.enc_out``, then the MLP; each
    behind an RMS norm and a residual add.  Its cache: ``{"self":
    gqa_cache_init}`` of length ``min(max_len, window)`` (``max_len``
    without a window), and for ``cross`` the encoder's keys and values
    ``"ek"``/``"ev"`` [b, frames, hkv, hd], computed at prefill from
    ``ctx.enc_out`` and read back at decode."""
    th = theta if theta is not None else cfg.rope_theta
    ff = d_ff if d_ff is not None else cfg.d_ff

    def init(gen, device):
        p = {"n1": layers.init_rms(cfg.d_model, device),
             "n2": layers.init_rms(cfg.d_model, device),
             "attn": attn.init_gqa(gen, cfg, device),
             "mlp": layers.init_mlp(gen, cfg.d_model, ff, cfg.act, device)}
        if cross:
            p["nx"] = layers.init_rms(cfg.d_model, device)
            p["xattn"] = attn.init_cross(gen, cfg, device)
        return p

    def apply(p, x, ctx: Ctx, cache=None):
        h = layers.rms_norm(p["n1"], x, cfg.norm_eps)
        new_cache = None if cache is None else {}
        if causal:
            a = attn.gqa_attn(p["attn"], h, ctx.positions, cfg, theta=th,
                              window=window,
                              cache=None if cache is None else cache["self"],
                              pos=ctx.pos, prefill=ctx.mode == "prefill")
            if cache is not None:
                a, new_cache["self"] = a
            x = x + a
        else:
            x = x + attn.bidir_attn(p["attn"], h, cfg)
        if cross:
            hx = layers.rms_norm(p["nx"], x, cfg.norm_eps)
            ekv = (attn.cross_kv(p["xattn"], ctx.enc_out, cfg)
                   if ctx.enc_out is not None
                   else {"k": cache["ek"], "v": cache["ev"]})
            x = x + attn.cross_attn(p["xattn"], hx, ekv, cfg)
            if cache is not None:
                new_cache["ek"] = ekv["k"].to(cache["ek"].dtype)
                new_cache["ev"] = ekv["v"].to(cache["ev"].dtype)
        x = x + layers.mlp(p["mlp"], layers.rms_norm(p["n2"], x,
                                                     cfg.norm_eps),
                           cfg.act)
        return x if cache is None else (x, new_cache)

    def cache_init(b, max_len):
        length = min(max_len, window) if window else max_len
        c = {"self": attn.gqa_cache_init(cfg, b, length)}
        if cross:
            c["ek"] = c["ev"] = (b, cfg.encoder_frames, cfg.n_kv_heads,
                                 cfg.hd)
        return c

    return BlockDef(name, init, apply, cache_init=cache_init)


def _mixer_block(cfg: LMConfig, name: str, init_mixer, mixer, state_init,
                 remat: bool = True) -> BlockDef:
    """A recurrent mixer behind an RMS norm and a residual add (its
    parameters under ``name``, beside the norm ``n1``); its cache is the
    mixer's recurrent state."""

    def init(gen, device):
        return {"n1": layers.init_rms(cfg.d_model, device),
                name: init_mixer(gen, cfg, device)}

    def apply(p, x, ctx: Ctx, cache=None):
        h = layers.rms_norm(p["n1"], x, cfg.norm_eps)
        if cache is None:
            return x + mixer(p[name], h, cfg)
        y, new_cache = mixer(p[name], h, cfg, state=cache)
        return x + y, new_cache

    def cache_init(b, max_len):
        return state_init(cfg, b)

    return BlockDef(name, init, apply, remat, cache_init)


def mlstm_block(cfg: LMConfig) -> BlockDef:
    return _mixer_block(cfg, "mlstm", ssm.init_mlstm, ssm.mlstm_block,
                        ssm.mlstm_state_init)


def slstm_block(cfg: LMConfig) -> BlockDef:
    """Not recomputed: its loop of small launches a position is what its
    step waits on (on the card the host issues them), and a recompute
    would run it twice; the activations it keeps are [b, H, hd] a
    position.  The values are the same either way."""
    return _mixer_block(cfg, "slstm", ssm.init_slstm, ssm.slstm_block,
                        ssm.slstm_state_init, remat=False)
