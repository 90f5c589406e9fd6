"""Composable layer blocks: pre-norm residual wrappers around the mixers.

The JAX package's ``models/blocks.py``: ``Ctx``, ``BlockDef``,
``dense_block`` (causal self-attention with an optional sliding window,
or whisper's bidirectional encoder attention; with cross-attention over
``Ctx.enc_out`` for whisper's decoder), the moe family's ``moe_block``
(GQA or MLA, then the MoE FFN) and ``mla_dense_block`` (deepseek-v3's
leading dense layers and its MTP block), the hybrid family's
``mamba_block`` and the xLSTM family's ``mlstm_block`` and
``slstm_block``.  Block protocol:

    init(gen, device)                     -> params for ONE layer
    apply(p, x, ctx)                      -> (x, aux), on activations
                                             [*lead, b, t, d] (train);
                                             aux [*lead] float32, the
                                             MoE load-balancing loss,
                                             zeros for other blocks
    apply(p, x, ctx, cache)               -> (x, new_cache) (serving:
                                             ctx.mode prefill or decode;
                                             the aux loss is not kept)
    cache_init(b, max_len)                -> the shapes of one layer's
                                             decode cache

``dense_block`` carries its leaves' sharding specs (``BlockDef.specs``,
the JAX block's) and runs tensor-parallel in train mode when
``Ctx.tp`` is set (``models.layers``, ``models.attention``); the other
blocks have no specs yet (ROADMAP item 17f).

Not ported yet: the caches' sharding specs (ROADMAP item 17d).
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.models import attention as attn
from repro_torch.models import layers
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm
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
    tp: object | None = None                 # the topology of a model
                                             # axis above 1 (train mode)


@dataclasses.dataclass
class BlockDef:
    name: str
    init: Callable                 # (gen, device) -> params of one layer
    apply: Callable                # (p, x, ctx[, cache]) -> (x, aux)
                                   # or (x, new_cache)
    remat: bool = True             # recompute its activations in the
                                   # backward (see slstm_block)
    cache_init: Callable | None = None   # (b, max_len) -> shapes
    specs: dict | None = None      # the leaves' model-axis specs


def no_aux(x: torch.Tensor) -> torch.Tensor:
    """The aux loss of a block without one: float32 zeros [*lead] of x
    [*lead, b, t, d]."""
    return torch.zeros(x.shape[:-3], dtype=torch.float32, device=x.device)


def dense_block(cfg: LMConfig, model_shards: int = 0, *, window: int = 0,
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
                              pos=ctx.pos, prefill=ctx.mode == "prefill",
                              tp=ctx.tp)
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
                           cfg.act, tp=ctx.tp)
        return (x, no_aux(x)) if cache is None else (x, new_cache)

    def cache_init(b, max_len):
        length = min(max_len, window) if window else max_len
        c = {"self": attn.gqa_cache_init(cfg, b, length)}
        if cross:
            c["ek"] = c["ev"] = (b, cfg.encoder_frames, cfg.n_kv_heads,
                                 cfg.hd)
        return c

    specs = {"n1": (None,), "n2": (None,),
             "attn": attn.gqa_specs(cfg, model_shards),
             "mlp": layers.mlp_specs(cfg.act)}
    if cross:
        specs["nx"] = (None,)
        specs["xattn"] = {k: attn.gqa_specs(cfg, model_shards)[k]
                          for k in ("wq", "wk", "wv", "wo")}
    return BlockDef(name, init, apply, cache_init=cache_init, specs=specs)


def moe_block(cfg: LMConfig, *, use_mla: bool = False,
              name: str = "moe") -> BlockDef:
    """GQA (no window, ``rope_theta``) or MLA, then the MoE FFN
    (``moe.moe_block``); each behind an RMS norm and a residual add.  Its
    train return carries the MoE's aux loss; its cache is the mixer's
    (``gqa_cache_init`` or ``mla_cache_init``, not nested)."""

    def init(gen, device):
        return {"n1": layers.init_rms(cfg.d_model, device),
                "n2": layers.init_rms(cfg.d_model, device),
                "attn": (attn.init_mla(gen, cfg, device) if use_mla
                         else attn.init_gqa(gen, cfg, device)),
                "moe": moe_mod.init_moe(gen, cfg, device)}

    def apply(p, x, ctx: Ctx, cache=None):
        h = layers.rms_norm(p["n1"], x, cfg.norm_eps)
        prefill = ctx.mode == "prefill"
        if use_mla:
            a = attn.mla_attn(p["attn"], h, ctx.positions, cfg, cache=cache,
                              pos=ctx.pos, prefill=prefill)
        else:
            a = attn.gqa_attn(p["attn"], h, ctx.positions, cfg,
                              theta=cfg.rope_theta, cache=cache, pos=ctx.pos,
                              prefill=prefill)
        if cache is not None:
            a, new_cache = a
        x = x + a
        y, aux = moe_mod.moe_block(p["moe"], layers.rms_norm(
            p["n2"], x, cfg.norm_eps), cfg)
        return (x + y, aux) if cache is None else (x + y, new_cache)

    def cache_init(b, max_len):
        return (attn.mla_cache_init(cfg, b, max_len) if use_mla
                else attn.gqa_cache_init(cfg, b, max_len))

    return BlockDef(name, init, apply, cache_init=cache_init)


def mla_dense_block(cfg: LMConfig, d_ff: int,
                    name: str = "dense") -> BlockDef:
    """MLA, then a dense MLP of width ``d_ff``: deepseek-v3's leading
    dense layers and its MTP block.  Its cache is ``mla_cache_init``."""

    def init(gen, device):
        return {"n1": layers.init_rms(cfg.d_model, device),
                "n2": layers.init_rms(cfg.d_model, device),
                "attn": attn.init_mla(gen, cfg, device),
                "mlp": layers.init_mlp(gen, cfg.d_model, d_ff, cfg.act,
                                       device)}

    def apply(p, x, ctx: Ctx, cache=None):
        h = layers.rms_norm(p["n1"], x, cfg.norm_eps)
        a = attn.mla_attn(p["attn"], h, ctx.positions, cfg, cache=cache,
                          pos=ctx.pos, prefill=ctx.mode == "prefill")
        if cache is not None:
            a, new_cache = a
        x = x + a
        x = x + layers.mlp(p["mlp"], layers.rms_norm(p["n2"], x,
                                                     cfg.norm_eps), cfg.act)
        return (x, no_aux(x)) if cache is None else (x, new_cache)

    def cache_init(b, max_len):
        return attn.mla_cache_init(cfg, b, max_len)

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
            x = x + mixer(p[name], h, cfg)
            return x, no_aux(x)
        y, new_cache = mixer(p[name], h, cfg, state=cache)
        return x + y, new_cache

    def cache_init(b, max_len):
        return state_init(cfg, b)

    return BlockDef(name, init, apply, remat, cache_init)


def mamba_block(cfg: LMConfig) -> BlockDef:
    return _mixer_block(cfg, "mamba", ssm.init_mamba2, ssm.mamba2_block,
                        ssm.mamba2_state_init)


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
