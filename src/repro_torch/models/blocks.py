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
    cache_specs(batch_ax, len_ax)         -> its spec tree (the JAX
                                             block's)

Every block carries its leaves' sharding specs (``BlockDef.specs``, the
JAX block's, at the ``model_shards`` it is built for): they lay out the
FSDP masters (``build.master_specs``).  Every block runs
tensor-parallel when ``Ctx.tp`` is set (``models.layers``,
``models.attention``, ``models.moe``, ``models.ssm``): whisper's
encoder and cross-attention too, the encoder's output whole on every
rank; in train mode and when serving, where a rank's cache is the block
its ``cache_specs`` give it -- the JAX block's spec tuples, the window
rule ``la = None if window else len_ax`` and the cross keys ``ek``/``ev``
by kv heads included.  ``Ctx.batch``, when serving over a process mesh,
is the topology whose pod and data ranks split the request rows: the
MoE routes by the whole call's groups across them
(``models.moe.moe_block``).  ``Ctx.seq``, when serving one request from
a cache split by length (``len_axis="data"``), is the topology whose
data ranks hold its blocks: a block whose ``cache_specs`` put
``len_ax`` on its length (an attention without a window, MLA) passes it
to its mixer; a window layer's cache and the recurrent states stay
whole.
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
                                             # axis above 1
    batch: object | None = None              # serving over a mesh: the
                                             # topology whose pod and
                                             # data ranks split the rows
    seq: object | None = None                # serving with the caches'
                                             # length split over the
                                             # data ranks: their topology


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
    cache_specs: Callable | None = None  # (batch_ax, len_ax) -> specs


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
                              tp=ctx.tp, seq=None if window else ctx.seq)
            if cache is not None:
                a, new_cache["self"] = a
            x = x + a
        else:
            x = x + attn.bidir_attn(p["attn"], h, cfg, tp=ctx.tp)
        if cross:
            hx = layers.rms_norm(p["nx"], x, cfg.norm_eps)
            ekv = (attn.cross_kv(p["xattn"], ctx.enc_out, cfg, tp=ctx.tp)
                   if ctx.enc_out is not None
                   else {"k": cache["ek"], "v": cache["ev"]})
            x = x + attn.cross_attn(p["xattn"], hx, ekv, cfg, tp=ctx.tp)
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

    def cache_specs(batch_ax, len_ax):
        la = None if window else len_ax
        c = {"self": attn.gqa_cache_specs(cfg, model_shards, batch_ax, la)}
        if cross:
            hks = attn._heads_spec(cfg.n_kv_heads, model_shards)
            c["ek"] = c["ev"] = (batch_ax, None, hks, None)
        return c

    specs = {"n1": (None,), "n2": (None,),
             "attn": attn.gqa_specs(cfg, model_shards),
             "mlp": layers.mlp_specs(cfg.act)}
    if cross:
        specs["nx"] = (None,)
        specs["xattn"] = {k: attn.gqa_specs(cfg, model_shards)[k]
                          for k in ("wq", "wk", "wv", "wo")}
    return BlockDef(name, init, apply, cache_init=cache_init, specs=specs,
                    cache_specs=cache_specs)


def moe_block(cfg: LMConfig, model_shards: int = 0, *,
              use_mla: bool = False, name: str = "moe") -> BlockDef:
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
                              pos=ctx.pos, prefill=prefill, tp=ctx.tp,
                              seq=ctx.seq)
        else:
            a = attn.gqa_attn(p["attn"], h, ctx.positions, cfg,
                              theta=cfg.rope_theta, cache=cache, pos=ctx.pos,
                              prefill=prefill, tp=ctx.tp, seq=ctx.seq)
        if cache is not None:
            a, new_cache = a
        x = x + a
        y, aux = moe_mod.moe_block(p["moe"], layers.rms_norm(
            p["n2"], x, cfg.norm_eps), cfg, tp=ctx.tp, batch=ctx.batch)
        return (x + y, aux) if cache is None else (x + y, new_cache)

    def cache_init(b, max_len):
        return (attn.mla_cache_init(cfg, b, max_len) if use_mla
                else attn.gqa_cache_init(cfg, b, max_len))

    def cache_specs(batch_ax, len_ax):
        return (attn.mla_cache_specs if use_mla else attn.gqa_cache_specs)(
            cfg, model_shards, batch_ax, len_ax)

    specs = {"n1": (None,), "n2": (None,),
             "attn": (attn.mla_specs(cfg, model_shards) if use_mla
                      else attn.gqa_specs(cfg, model_shards)),
             "moe": moe_mod.moe_specs(cfg, model_shards)}
    return BlockDef(name, init, apply, cache_init=cache_init, specs=specs,
                    cache_specs=cache_specs)


def mla_dense_block(cfg: LMConfig, d_ff: int, model_shards: int = 0,
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
                          pos=ctx.pos, prefill=ctx.mode == "prefill",
                          tp=ctx.tp, seq=ctx.seq)
        if cache is not None:
            a, new_cache = a
        x = x + a
        x = x + layers.mlp(p["mlp"], layers.rms_norm(p["n2"], x,
                                                     cfg.norm_eps), cfg.act,
                           tp=ctx.tp)
        return (x, no_aux(x)) if cache is None else (x, new_cache)

    def cache_init(b, max_len):
        return attn.mla_cache_init(cfg, b, max_len)

    def cache_specs(batch_ax, len_ax):
        return attn.mla_cache_specs(cfg, model_shards, batch_ax, len_ax)

    specs = {"n1": (None,), "n2": (None,),
             "attn": attn.mla_specs(cfg, model_shards),
             "mlp": layers.mlp_specs(cfg.act)}
    return BlockDef(name, init, apply, cache_init=cache_init, specs=specs,
                    cache_specs=cache_specs)


def _mixer_block(cfg: LMConfig, name: str, init_mixer, mixer, state_init,
                 specs: dict, state_specs, model_shards: int,
                 remat: bool = True) -> BlockDef:
    """A recurrent mixer behind an RMS norm and a residual add (its
    parameters under ``name``, beside the norm ``n1``); its cache is the
    mixer's recurrent state, laid out by ``state_specs(cfg,
    model_shards, batch_ax)`` (no length axis)."""

    def init(gen, device):
        return {"n1": layers.init_rms(cfg.d_model, device),
                name: init_mixer(gen, cfg, device)}

    def apply(p, x, ctx: Ctx, cache=None):
        h = layers.rms_norm(p["n1"], x, cfg.norm_eps)
        if cache is None:
            x = x + mixer(p[name], h, cfg, tp=ctx.tp)
            return x, no_aux(x)
        y, new_cache = mixer(p[name], h, cfg, state=cache, tp=ctx.tp)
        return x + y, new_cache

    def cache_init(b, max_len):
        return state_init(cfg, b)

    def cache_specs(batch_ax, len_ax):
        return state_specs(cfg, model_shards, batch_ax)

    return BlockDef(name, init, apply, remat, cache_init,
                    {"n1": (None,), name: specs}, cache_specs)


def mamba_block(cfg: LMConfig, model_shards: int = 0) -> BlockDef:
    return _mixer_block(cfg, "mamba", ssm.init_mamba2, ssm.mamba2_block,
                        ssm.mamba2_state_init,
                        ssm.mamba2_specs(cfg, model_shards),
                        ssm.mamba2_state_specs, model_shards)


def mlstm_block(cfg: LMConfig, model_shards: int = 0) -> BlockDef:
    return _mixer_block(cfg, "mlstm", ssm.init_mlstm, ssm.mlstm_block,
                        ssm.mlstm_state_init,
                        ssm.mlstm_specs(cfg, model_shards),
                        ssm.mlstm_state_specs, model_shards)


def slstm_block(cfg: LMConfig, model_shards: int = 0) -> BlockDef:
    """Not recomputed: its loop of small launches a position is what its
    step waits on (on the card the host issues them), and a recompute
    would run it twice.  What it keeps a position is seven float32
    [b, H, hd] tensors, 28·b·d bytes (the recurrent product's operand h;
    c and n; tanh(z) and sigmoid(o); max(n, 1) and c over it) and a few
    [b, H] gate scalars; ``wr`` is never copied to the rows.  The norm
    and the gated FFN keep their [b, t, ...] activations once, about
    8.3·b·t·d values in float32.  The values are the same either way."""
    return _mixer_block(cfg, "slstm", ssm.init_slstm, ssm.slstm_block,
                        ssm.slstm_state_init,
                        ssm.slstm_specs(cfg, model_shards),
                        ssm.slstm_state_specs, model_shards, remat=False)
