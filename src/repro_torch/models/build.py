"""Build ArchDefs, the train entry point and the serving entry points
from an LMConfig.

The JAX package's ``models/build.py`` for the dense, vlm, moe, ssm
(xlstm), hybrid (zamba2) and encdec/audio (whisper) families:

    built = build_model(cfg, topo)
    built.init_params(generator)  -> one replica's parameters
    built.bundle                  -> core.hier.ModelBundle
    built.make_cache(b, max_len)  -> decode cache
    built.prefill / built.decode_step

The bundle's loss takes ``[P, D, *leaf]`` parameter copies and
``{"tokens": [P, D, b, L]}`` (whisper: and ``"frames": [P, D, b, f,
frontend_dim]``; a vlm: and ``"patches": [P, D, b, n_patches,
d_model]``) and returns the ``[P, D]`` losses (any leading dims work,
none for one replica): the JAX ``make_loss_single``, which the JAX step
vmaps, with the vmap written out as batch dims.  Each replica's loss is
its next-token cross-entropy plus the blocks' aux losses (the MoE's
load balance), plus for deepseek-v3 ``mtp_loss_weight`` times the MTP
head's loss on the tokens two ahead.  A vlm's patches, cast to the
compute dtype, go before the tokens; positions run over both, and the
patch positions are cut off before the head.

The parameter tree is the JAX package's leaf for leaf -- ``embed.table``,
``stacks.<block>.<leaf>`` with the leading layer dim (zamba2's tied
``stacks.shared_attn.<leaf>`` without one), ``head.norm`` (and
``head.out`` when the embedding is not tied), whisper's
``enc_stacks.enc.<leaf>`` and ``adapter.w``, deepseek-v3's ``mtp``
(``proj``, ``n_x``, ``n_e``, ``block``) -- so a JAX tree converts with
``convert.params_from_numpy``.

Serving (``make_serve_fns``) runs one replica's parameters, ``lead``
0, on their device: ``prefill(params, {"tokens": [b, t]}, max_len)``
(whisper: and ``"frames"`` [b, frames, frontend_dim]; a vlm: and
``"patches"`` [b, n_patches, d_model], whose slots ``max_len`` must
hold) returns the last position's logits [b, 1, V] -- never the [b, t,
V] of all of them -- and the cache ``{"stacks": {block: [n_layers,
*slice]}, "pos": n_patches + t}``; ``decode_step(params, cache, tokens
[b, 1])`` returns the logits [b, 1, V] and the next cache.  ``pos`` is
a host int (no device sync a step).  The caches are bfloat16 whatever
the compute dtype, as the JAX package's prefill builds them (MLA's are
the latent ``ckv`` and rope key ``kr``).  Both run without autograd.
The MoE's capacity is reckoned from the tokens of the call, as in the
reference, so a decode step of a few tokens can drop routed pairs that
a long prefill keeps (ROADMAP queue 3).

An FSDP config (gemma3-12b, internvl2, arctic, deepseek-v3) trains
through ``bundle.loss_master`` (:func:`make_loss_master`): the masters
in, each layer lifted to its [P, D] copies inside the engine, the
per-edge directions out of autograd.  It serves resident, as the
replicated regime does, where its bf16 weights fit
``SERVE_RESIDENT_BUDGET`` (:func:`serve_layout`, the reference's rule).

zamba2's gradients are not finite where its SSD scan overflows, as the
reference's are (ROADMAP queue 3); the sign sends NaN to -1.

Over a model axis above 1 (``topo.model_shards``) the dense family
trains tensor-parallel: ``compute_specs`` gives each leaf's spec (the
JAX function's, leaf for leaf), the bundle carries them, and the loss
runs on a rank's blocks (``Ctx.tp``): the vocab-parallel embedding,
the blocks' split heads and MLP columns, the column-parallel tied
unembedding and the vocab-parallel cross-entropy (``models.layers``).

Not ported yet (each raises ``NotImplementedError``): the ``"gather"``
serve layout of the FSDP configs above the budget (item 17d:
``ServeGatherPlan``), ``cache_specs`` and serving over a model axis
(17d), and the other families' tensor-parallel forwards and specs
(item 17f).
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Callable

import torch

from repro_torch.core import comm, hier, pytree
from repro_torch.core.topology import Topology
from repro_torch.models import blocks as B
from repro_torch.models import engine, layers
from repro_torch.models.blocks import Ctx
from repro_torch.models.config import LMConfig
from repro_torch.models.engine import ArchDef, ReplicatedPlan, Segment

PyTree = Any


PORTED_FAMILIES = ("dense", "vlm", "moe", "ssm", "hybrid", "encdec",
                   "audio")
SERVE_RESIDENT_BUDGET = 12e9   # bf16 bytes on the card below which an
                               # FSDP config's weights serve resident


TP_FAMILIES = ("dense",)        # families with a tensor-parallel forward


def _refuse_tp(cfg: LMConfig, model_shards: int) -> None:
    if model_shards > 1 and cfg.family not in TP_FAMILIES:
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family} family over a model axis of "
            f"{model_shards} (its tensor-parallel forward and its *_specs) "
            "is ROADMAP item 17f; the dense family runs tensor-parallel")


def make_archdef(cfg: LMConfig, model_shards: int = 0) -> ArchDef:
    """The block schedule: dense stacks (a vlm's too), gemma3-style
    local:global periods (local blocks with the sliding window and
    ``rope_theta``, global ones with ``rope_theta_global``, a remainder
    of local blocks after the last period); the moe family's
    ``first_dense`` leading dense blocks (MLA ones with ``cfg.mla``, of
    width ``dense_ff``) and then its MoE stack, with deepseek-v3's MTP
    block; zamba2's periods of ``attn_every`` Mamba2 blocks and the one
    tied shared-attention block (a remainder of Mamba2 blocks after the
    last); xlstm's periods of ``m_per_s`` mLSTM blocks and one sLSTM
    block (a remainder of mLSTM blocks after the last); whisper's
    bidirectional encoder and causal decoder with cross-attention.
    ``model_shards`` sizes the dense blocks' specs (the heads split
    where they divide it); another family raises above 1 (item 17f)."""
    if cfg.family not in PORTED_FAMILIES:
        raise ValueError(f"unknown family {cfg.family!r} ({cfg.name})")
    _refuse_tp(cfg, model_shards)
    if cfg.family == "moe":
        use_mla = cfg.mla is not None
        blocks = {"moe": B.moe_block(cfg, use_mla=use_mla)}
        segments = []
        n_moe = cfg.n_layers
        if cfg.moe.first_dense:
            blocks["dense"] = (B.mla_dense_block(cfg, cfg.moe.dense_ff)
                               if use_mla
                               else B.dense_block(cfg, d_ff=cfg.moe.dense_ff))
            segments.append(Segment((("dense", 1),), cfg.moe.first_dense))
            n_moe -= cfg.moe.first_dense
        segments.append(Segment((("moe", 1),), n_moe))
        mtp = None
        if cfg.mtp:
            mtp = (B.mla_dense_block(cfg, cfg.moe.dense_ff, name="mtp")
                   if use_mla else B.dense_block(cfg, name="mtp"))
        return ArchDef(cfg, blocks, segments, mtp_block=mtp)
    if cfg.family == "hybrid":
        every = cfg.ssm.attn_every
        groups = cfg.n_layers // every
        rem = cfg.n_layers - groups * every
        blocks = {"mamba": B.mamba_block(cfg),
                  "shared_attn": B.dense_block(cfg, name="shared_attn")}
        segments = [Segment((("mamba", every), ("shared_attn", 1)), groups,
                            tied=frozenset({"shared_attn"}))]
        if rem:
            segments.append(Segment((("mamba", rem),), 1))
        return ArchDef(cfg, blocks, segments)
    if cfg.family == "ssm":
        m = cfg.xlstm.m_per_s
        groups = cfg.n_layers // (m + 1)
        rem = cfg.n_layers - groups * (m + 1)
        blocks = {"mlstm": B.mlstm_block(cfg), "slstm": B.slstm_block(cfg)}
        segments = [Segment((("mlstm", m), ("slstm", 1)), groups)]
        if rem:
            segments.append(Segment((("mlstm", rem),), 1))
        return ArchDef(cfg, blocks, segments)
    if cfg.family in ("encdec", "audio"):
        return ArchDef(
            cfg, {"dec": B.dense_block(cfg, cross=True, name="dec")},
            [Segment((("dec", 1),), cfg.n_layers)],
            enc_blocks={"enc": B.dense_block(cfg, causal=False,
                                             name="enc")},
            enc_segments=[Segment((("enc", 1),), cfg.encoder_layers)])
    if cfg.local_global:
        loc, glob = cfg.local_global
        period = loc + glob
        groups = cfg.n_layers // period
        rem = cfg.n_layers - groups * period
        blocks = {
            "local": B.dense_block(cfg, model_shards, window=cfg.window,
                                   theta=cfg.rope_theta, name="local"),
            "global": B.dense_block(cfg, model_shards,
                                    theta=cfg.rope_theta_global,
                                    name="global"),
        }
        segments = [Segment((("local", loc), ("global", glob)), groups)]
        if rem:
            segments.append(Segment((("local", rem),), 1))
        return ArchDef(cfg, blocks, segments)
    blocks = {"dense": B.dense_block(cfg, model_shards)}
    return ArchDef(cfg, blocks, [Segment((("dense", 1),), cfg.n_layers)])


def compute_specs(arch: ArchDef, model_shards: int = 0) -> PyTree:
    """Each parameter leaf's spec over the model axis (the JAX
    ``compute_specs``, leaf for leaf): the embedding vocab-sharded where
    the vocabulary divides the axis, each stack its block's specs behind
    a replicated layer dim, the head's norm (and an untied ``out``'s
    vocab columns).  The dense family's; another family raises above 1
    (item 17f) and has None below."""
    cfg = arch.cfg
    if any(bd.specs is None for bd in arch.blocks.values()):
        _refuse_tp(cfg, max(model_shards, 2))
    specs: dict = {"embed": layers.embed_specs(cfg.vocab, model_shards)}
    counts = engine.stack_counts(arch.segments)
    specs["stacks"] = {
        name: (pytree.tree_map(lambda sp: (None,) + tuple(sp),
                               arch.blocks[name].specs)
               if n else arch.blocks[name].specs)
        for name, n in counts.items()}
    head = {"norm": (None,)}
    if not cfg.tie_embed:
        head["out"] = (None, layers.MODEL if layers.vocab_sharded(
            cfg.vocab, model_shards) else None)
    specs["head"] = head
    return specs


def init_params(arch: ArchDef, generator: torch.Generator | None = None,
                device: str | torch.device | None = None) -> PyTree:
    """One replica's float32 parameters on the generator's device (or, with
    ``device="meta"`` and no generator, their shapes alone)."""
    cfg = arch.cfg
    dev = device if device is not None else generator.device
    params: dict = {"embed": layers.init_embed(generator, cfg.vocab,
                                               cfg.d_model, dev)}
    params["stacks"] = {
        name: engine._stack_init(arch.blocks[name], generator, n, dev)
        for name, n in engine.stack_counts(arch.segments).items()}
    if arch.enc_segments:
        params["enc_stacks"] = {
            name: engine._stack_init(arch.enc_blocks[name], generator, n,
                                     dev)
            for name, n in engine.stack_counts(arch.enc_segments).items()}
        params["adapter"] = {"w": layers.he_init(
            generator, (cfg.frontend_dim, cfg.d_model), dev)}
    head = {"norm": layers.init_rms(cfg.d_model, dev)}
    if not cfg.tie_embed:
        head["out"] = layers.he_init(generator, (cfg.d_model, cfg.vocab), dev)
    params["head"] = head
    if arch.mtp_block is not None:
        params["mtp"] = {
            "proj": layers.he_init(generator, (2 * cfg.d_model, cfg.d_model),
                                   dev),
            "n_x": layers.init_rms(cfg.d_model, dev),
            "n_e": layers.init_rms(cfg.d_model, dev),
            "block": arch.mtp_block.init(generator, dev)}
    return params


def _targets_and_mask(tokens: torch.Tensor):
    """Next-token LM targets with the final position masked out."""
    targets = torch.roll(tokens, -1, dims=-1)
    mask = torch.ones(tokens.shape, dtype=torch.float32,
                      device=tokens.device)
    mask[..., -1] = 0.0
    return targets, mask


def _logits(cfg: LMConfig, head, embed_p, x, tp=None):
    """The head's logits (with ``tp`` and a vocab-sharded table or
    ``out``, the rank's vocab block)."""
    x = layers.rms_norm(head["norm"], x, cfg.norm_eps)
    if cfg.tie_embed:
        return layers.unembed(embed_p["table"], x, tp)
    return layers.linear(comm.copy_to_model(tp, x), head["out"])


def _patches_first(cfg: LMConfig, x: torch.Tensor, batch):
    """A vlm's patches [*lead, b, n_patches, d], cast to x's dtype, before
    the token embeddings x [*lead, b, t, d]: (x, n_patches)."""
    if not cfg.n_patches:
        return x, 0
    patches = batch["patches"].to(x.dtype)
    return torch.cat([patches, x], dim=-2), patches.shape[-2]


def _losses(arch: ArchDef, head, embed_p, mtp, x, aux, tokens, mtp_apply,
            tp=None):
    """Each replica's loss: the cross-entropy of the head's logits on x
    [*lead, b, t, d] plus ``aux``, plus with an MTP block
    ``mtp_loss_weight`` times its cross-entropy on ``roll(tokens, -2)``
    (the last two positions masked): ``mtp_apply(p, h)`` runs the block
    on its input h, the projection of the normed x and the normed
    embeddings of ``roll(tokens, -1)``."""
    cfg = arch.cfg
    targets, mask = _targets_and_mask(tokens)
    losses = layers.softmax_xent(_logits(cfg, head, embed_p, x, tp),
                                 targets, mask, tp) + aux
    if arch.mtp_block is None:
        return losses
    e2 = layers.embed(embed_p, torch.roll(tokens, -1, dims=-1),
                      cfg.embed_scale)
    h = layers.linear(torch.cat(
        [layers.rms_norm(mtp["n_x"], x, cfg.norm_eps),
         layers.rms_norm(mtp["n_e"], e2, cfg.norm_eps)], dim=-1),
        mtp["proj"].to(x.dtype))
    h = mtp_apply(mtp["block"], h)
    mask2 = torch.ones(tokens.shape, dtype=torch.float32,
                       device=tokens.device)
    mask2[..., -2:] = 0.0
    return losses + cfg.mtp_loss_weight * layers.softmax_xent(
        _logits(cfg, head, embed_p, h), torch.roll(tokens, -2, dims=-1),
        mask2)


def make_loss(arch: ArchDef, remat: bool = True,
              topo: Topology | None = None) -> Callable:
    """loss(params, batch) -> the loss of every replica (the module
    docstring's): params with leading replica dims ``[*lead, *leaf]``
    and ``{"tokens": [*lead, b, L]}`` give ``[*lead]``.  An
    encoder-decoder first encodes ``batch["frames"]`` [*lead, b, f,
    frontend_dim] (cast to the embedding's dtype, through the adapter and
    the encoder segments); a vlm puts ``batch["patches"]`` first.  Over
    a model axis above 1 (``topo``) params are a rank's blocks (the
    dense family's tensor-parallel forward); every model rank returns
    the same losses."""
    cfg = arch.cfg
    plan = ReplicatedPlan(cfg, remat)
    tp = topo if topo is not None and topo.model_shards > 1 else None
    if tp is not None:
        _refuse_tp(cfg, tp.model_shards)
    tp_vocab = tp if tp is not None and layers.vocab_sharded(
        cfg.vocab, tp.model_shards) else None

    def loss(params, batch):
        tokens = batch["tokens"]
        lead = tokens.dim() - 2
        x = layers.embed(params["embed"], tokens, cfg.embed_scale, tp_vocab)
        enc_out, enc_aux = None, 0.0
        if arch.enc_segments:
            frames = batch["frames"].to(x.dtype)
            ex = layers.linear(frames, params["adapter"]["w"].to(x.dtype))
            ectx = Ctx(cfg, positions=torch.arange(frames.shape[-2],
                                                   device=frames.device))
            enc_out, enc_aux = engine.run_segments(
                plan, arch, arch.enc_segments, params["enc_stacks"], ex,
                ectx, lead=lead)
        x, n_patch = _patches_first(cfg, x, batch)
        ctx = Ctx(cfg, positions=torch.arange(x.shape[-2],
                                              device=tokens.device),
                  enc_out=enc_out, tp=tp)
        x, aux = engine.run_segments(plan, arch, arch.segments,
                                     params["stacks"], x, ctx, lead=lead)
        x = x[..., n_patch:, :]
        return _losses(arch, params["head"], params["embed"],
                       params.get("mtp"), x, aux + enc_aux, tokens,
                       lambda p, h: plan.block(arch.mtp_block, p, h, ctx)[0],
                       tp_vocab)

    return loss


def make_loss_master(arch: ArchDef) -> Callable:
    """The FSDP regime's loss (the JAX package's ``make_loss_master``):

    loss_master(params, delta, batch, lift) -> (sum of the losses, the
        [P, D] losses)

    params: the [P, *leaf] masters (stacks [P, n_layers, *leaf]; a tied
    block's, zamba2's shared attention, [P, *leaf]), delta the same tree
    of corrections, ``{"tokens": [P, D, b, L]}`` (a vlm:
    and ``"patches"``); ``lift(tree, delta_tree)`` lifts a tree to its
    [P, D] copies (its backward votes).  The embedding is lifted once,
    first, and used wherever it is (the tokens, the tied unembedding,
    MTP's rolled tokens), so its cotangents sum before the sign; a tied
    block likewise, once before the layers (``engine.run_segments``);
    each other layer is lifted inside its block (``engine.FsdpPlan``),
    then the
    head (the logits and MTP's) and the ``mtp`` subtree, each once.  The
    losses are the replicated loss's, the layers' aux [P, D] included."""
    cfg = arch.cfg
    if arch.enc_segments:
        raise NotImplementedError(
            f"{cfg.name}: an encoder-decoder trains in the replicated "
            "regime (as in the JAX package)")

    def loss_master(params, delta, batch, lift):
        plan = engine.FsdpPlan(cfg, lift)
        tokens = batch["tokens"]                       # [P, D, b, L]
        emb = lift(params["embed"], delta["embed"])
        x = layers.embed(emb, tokens, cfg.embed_scale)
        x, n_patch = _patches_first(cfg, x, batch)
        ctx = Ctx(cfg, positions=torch.arange(x.shape[-2],
                                              device=tokens.device))
        x, aux = engine.run_segments(plan, arch, arch.segments,
                                     params["stacks"], x, ctx, lead=1,
                                     dstacks=delta["stacks"])
        x = x[..., n_patch:, :]
        head = lift(params["head"], delta["head"])
        mtp = (lift(params["mtp"], delta["mtp"])
               if arch.mtp_block is not None else None)
        losses = _losses(arch, head, emb, mtp, x, aux, tokens,
                         lambda p, h: arch.mtp_block.apply(p, h, ctx)[0])
        return losses.sum(), losses

    return loss_master


def occurrence_counts(segments) -> dict[str, int]:
    """How often each block runs: a tied block once an occurrence."""
    occ: dict[str, int] = {}
    for seg in segments:
        for bname, cnt in seg.layout:
            occ[bname] = occ.get(bname, 0) + cnt * seg.repeats
    return occ


def make_cache(arch: ArchDef, b: int, max_len: int,
               device: str | torch.device | None = None) -> dict:
    """bfloat16 zeros of each block's ``cache_init`` slice shapes,
    stacked over its occurrences (a tied block has a slice for each),
    and ``pos`` 0.  Every leaf is zero, the sLSTM's ``n`` too, where
    training starts it at ones: the JAX package's ``make_cache`` does
    the same (ROADMAP queue 3)."""
    stacks = {}
    for name, n in occurrence_counts(arch.segments).items():
        bd = arch.blocks[name]
        if bd.cache_init is None:
            continue
        stacks[name] = pytree.tree_map(
            lambda shape: torch.zeros((n,) + shape, dtype=torch.bfloat16,
                                      device=device),
            bd.cache_init(b, max_len))
    return {"stacks": stacks, "pos": 0}


def cache_specs(arch: ArchDef):
    raise NotImplementedError(
        "cache_specs (the caches' sharding, with the gather serve "
        "layout): ROADMAP item 17d")


class ServeGatherPlan(ReplicatedPlan):
    """The serving plan for FSDP-stored parameters (a per-layer
    all-gather): ROADMAP item 17d."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "ServeGatherPlan (serving FSDP-stored parameters): ROADMAP "
            "item 17d")


def serve_layout(cfg: LMConfig, n_params: int) -> str:
    """The reference's rule: ``"resident"`` (the weights served as they
    are) for the replicated regime and for an FSDP config whose bf16
    weights, ``2 * n_params`` bytes on the one card, fit
    ``SERVE_RESIDENT_BUDGET``; ``"gather"`` (FSDP-stored weights gathered
    a layer at a time, ROADMAP item 17d) otherwise."""
    if cfg.param_mode != "fsdp":
        return "resident"
    return "resident" if 2.0 * n_params <= SERVE_RESIDENT_BUDGET else "gather"


def make_serve_fns(arch: ArchDef, layout: str = "resident"):
    """(prefill, decode_step) as the module docstring gives them; the
    ``"gather"`` layout raises (ROADMAP item 17d)."""
    cfg = arch.cfg
    plan = ReplicatedPlan(cfg, remat=False)

    def check_layout():
        if layout == "tp":
            raise NotImplementedError(
                f"serving {cfg.name} over a model axis above 1 (the "
                "caches' specs and the sharded serve layouts): ROADMAP "
                "item 17d")
        if layout != "resident":
            raise NotImplementedError(
                f"serving {cfg.name} in the {layout!r} layout (FSDP-stored "
                "weights gathered a layer at a time, the gather serve "
                "layout): ROADMAP item 17d")

    def prefill(params, batch, max_len: int):
        """The whole prompt: (the last position's logits [b, 1, V], the
        cache).  whisper's encoder runs in train mode first; a vlm's
        patches go before the tokens."""
        check_layout()
        tokens = batch["tokens"]
        b = tokens.shape[0]
        with torch.no_grad():
            x = layers.embed(params["embed"], tokens, cfg.embed_scale)
            enc_out = None
            if arch.enc_segments:
                frames = batch["frames"].to(x.dtype)
                ex = layers.linear(frames,
                                   params["adapter"]["w"].to(x.dtype))
                ectx = Ctx(cfg, "train", positions=torch.arange(
                    frames.shape[-2], device=frames.device))
                enc_out, _ = engine.run_segments(
                    plan, arch, arch.enc_segments, params["enc_stacks"],
                    ex, ectx)
            x, _ = _patches_first(cfg, x, batch)
            t = x.shape[-2]
            cache = make_cache(arch, b, max_len, tokens.device)
            ctx = Ctx(cfg, "prefill",
                      positions=torch.arange(t, device=tokens.device),
                      pos=0, enc_out=enc_out)
            x, stacks = engine.run_segments(
                plan, arch, arch.segments, params["stacks"], x, ctx,
                caches=cache["stacks"])
            logits = _logits(cfg, params["head"], params["embed"],
                             x[..., -1:, :])
        return logits, {"stacks": stacks, "pos": t}

    def decode_step(params, cache, tokens):
        """One step: tokens [b, 1] at ``cache["pos"]`` -> (logits [b, 1,
        V], the next cache)."""
        check_layout()
        pos, t = cache["pos"], tokens.shape[-1]
        with torch.no_grad():
            x = layers.embed(params["embed"], tokens, cfg.embed_scale)
            ctx = Ctx(cfg, "decode", positions=pos + torch.arange(
                t, device=tokens.device), pos=pos)
            x, stacks = engine.run_segments(
                plan, arch, arch.segments, params["stacks"], x, ctx,
                caches=cache["stacks"])
            logits = _logits(cfg, params["head"], params["embed"], x)
        return logits, {"stacks": stacks, "pos": pos + t}

    return prefill, decode_step


@dataclasses.dataclass
class BuiltModel:
    cfg: LMConfig
    arch: ArchDef
    topo: Topology
    bundle: hier.ModelBundle
    init_params: Callable          # (torch.Generator) -> one replica's params
    abstract_params: Callable      # () -> the same tree on the meta device
    prefill: Callable              # (params, batch, max_len) -> logits, cache
    decode_step: Callable          # (params, cache, tokens) -> logits, cache
    make_cache: Callable           # (b, max_len, device) -> cache
    serve_layout: str = "resident"  # or "gather" (item 17d)


def build_model(cfg: LMConfig, topo: Topology) -> BuiltModel:
    """The model's entry points; an FSDP config (``param_mode="fsdp"``)
    gets ``loss=None`` and a ``loss_master`` (:func:`make_loss_master`).
    The bundle carries the dense family's specs at ``topo``'s model axis
    (the replicated regime's masters are laid out as computed, as in the
    JAX ``build_master_specs``); over a model axis above 1 the loss is
    tensor-parallel and serving raises (item 17d)."""
    m = topo.model_shards
    arch = make_archdef(cfg, m)
    layout = serve_layout(cfg, param_count(init_params(arch, None, "meta")))
    prefill, decode_step = make_serve_fns(arch, layout if m == 1 else "tp")
    fsdp = cfg.param_mode == "fsdp"
    specs = compute_specs(arch, m) if cfg.family in TP_FAMILIES else None
    return BuiltModel(
        cfg=cfg, arch=arch, topo=topo,
        bundle=hier.ModelBundle(
            loss=None if fsdp else make_loss(arch, topo=topo),
            loss_master=make_loss_master(arch) if fsdp else None,
            param_mode=cfg.param_mode, specs=specs),
        init_params=lambda generator: init_params(arch, generator),
        abstract_params=lambda: init_params(arch, None, "meta"),
        prefill=prefill, decode_step=decode_step,
        make_cache=functools.partial(make_cache, arch), serve_layout=layout)


def param_count(params: PyTree) -> int:
    return sum(math.prod(a.shape) for a in pytree.tree_flatten(params)[0])
