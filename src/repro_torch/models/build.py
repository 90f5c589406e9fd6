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

Over a model axis above 1 (``topo.model_shards``) every family trains
tensor-parallel, in each regime it runs (an encoder-decoder in the
replicated one only): ``compute_specs`` gives each leaf's spec (the
JAX function's, leaf for leaf), the bundle carries them, and the loss
runs on a rank's blocks (``Ctx.tp``): the vocab-parallel embedding,
the blocks' split heads (GQA's, MLA's, the recurrent mixers'), inner
dims, MLP columns and experts, the column-parallel unembedding and the
vocab-parallel cross-entropy (``models.layers``, ``models.attention``,
``models.moe``, ``models.ssm``) -- deepseek-v3's MTP head's
rolled-token embedding, logits and cross-entropy included.  A vlm's
patches cross the model group as they are, and so do whisper's frames
through the replicated adapter: every rank holds them whole, and the
encoder's output too.  A vocabulary that does not divide the axis
(whisper's 51865) keeps the embedding, head and cross-entropy whole.

Serving over a process mesh (``topo`` with a mesh; the ``"resident"``
layout, the weights in the compute layout) is the JAX package's one
logical serve laid out by its specs: each rank serves its rows of the
request batch -- the batch split over the pod and data ranks,
``SERVE_BATCH_AXES`` -- with its blocks of the parameters (``Ctx.tp``:
the heads, inner dims and experts over the model group, as training
splits them), and its cache is its block of the global one
(:func:`cache_specs`, :func:`make_cache` with ``b`` the global batch;
:func:`cache_bytes` reckons it).  The MoE routes by the whole call's
groups across the batch ranks (``models.moe``); the head's vocab blocks
are gathered over the model group, so a rank returns the whole [b_loc,
1, V] logits of its rows; whisper's encoder and a vlm's patches run as
in training.

The ``"gather"`` serve layout (:class:`ServeGatherPlan`, the FSDP
configs past the budget, or any FSDP config whose caller asks for it):
the parameters stay as the FSDP regime stores them, each rank its data
shard of every leaf (:func:`master_specs`), and each layer's shards --
the embedding's and the head's too -- are gathered over the data group
into the rank's compute block at every call, just before they are used,
and dropped after (``comm.gather_shards``, counted ``gather_serve``); a
tied block's once a call.  Without a mesh the gather is the identity.

One request (``rows="replicated"``): the batch of 1 is the same on
every pod and data rank, as the JAX package lays out ``b == 1`` (its
``ba = None``): each rank's cache holds the whole batch dim and the MoE
routes the call's own tokens.  With ``len_axis="data"`` (long_500k's
layout, one request) each data rank holds a block of the length of
every cache whose spec names ``"data"`` there, and the attention
combines the ranks' partial softmaxes (``models.attention``).
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Callable

import torch

from repro_torch.core import comm, device_axis, hier, pytree
from repro_torch.core.topology import Topology
from repro_torch.models import blocks as B
from repro_torch.models import engine, layers
from repro_torch.models import moe as moe_mod
from repro_torch.models.blocks import Ctx
from repro_torch.models.config import LMConfig
from repro_torch.models.engine import ArchDef, ReplicatedPlan, Segment

PyTree = Any


PORTED_FAMILIES = ("dense", "vlm", "moe", "ssm", "hybrid", "encdec",
                   "audio")
SERVE_RESIDENT_BUDGET = 12e9   # bf16 bytes on the card below which an
                               # FSDP config's weights serve resident


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
    ``model_shards`` sizes the blocks' specs (the heads, inner dims and
    experts split where they divide it)."""
    if cfg.family not in PORTED_FAMILIES:
        raise ValueError(f"unknown family {cfg.family!r} ({cfg.name})")
    if cfg.family == "moe":
        use_mla = cfg.mla is not None
        blocks = {"moe": B.moe_block(cfg, model_shards, use_mla=use_mla)}
        segments = []
        n_moe = cfg.n_layers
        if cfg.moe.first_dense:
            blocks["dense"] = (
                B.mla_dense_block(cfg, cfg.moe.dense_ff, model_shards)
                if use_mla else B.dense_block(cfg, model_shards,
                                              d_ff=cfg.moe.dense_ff))
            segments.append(Segment((("dense", 1),), cfg.moe.first_dense))
            n_moe -= cfg.moe.first_dense
        segments.append(Segment((("moe", 1),), n_moe))
        mtp = None
        if cfg.mtp:
            mtp = (B.mla_dense_block(cfg, cfg.moe.dense_ff, model_shards,
                                     name="mtp")
                   if use_mla else B.dense_block(cfg, model_shards,
                                                 name="mtp"))
        return ArchDef(cfg, blocks, segments, mtp_block=mtp)
    if cfg.family == "hybrid":
        every = cfg.ssm.attn_every
        groups = cfg.n_layers // every
        rem = cfg.n_layers - groups * every
        blocks = {"mamba": B.mamba_block(cfg, model_shards),
                  "shared_attn": B.dense_block(cfg, model_shards,
                                               name="shared_attn")}
        segments = [Segment((("mamba", every), ("shared_attn", 1)), groups,
                            tied=frozenset({"shared_attn"}))]
        if rem:
            segments.append(Segment((("mamba", rem),), 1))
        return ArchDef(cfg, blocks, segments)
    if cfg.family == "ssm":
        m = cfg.xlstm.m_per_s
        groups = cfg.n_layers // (m + 1)
        rem = cfg.n_layers - groups * (m + 1)
        blocks = {"mlstm": B.mlstm_block(cfg, model_shards),
                  "slstm": B.slstm_block(cfg, model_shards)}
        segments = [Segment((("mlstm", m), ("slstm", 1)), groups)]
        if rem:
            segments.append(Segment((("mlstm", rem),), 1))
        return ArchDef(cfg, blocks, segments)
    if cfg.family in ("encdec", "audio"):
        return ArchDef(
            cfg, {"dec": B.dense_block(cfg, model_shards, cross=True,
                                       name="dec")},
            [Segment((("dec", 1),), cfg.n_layers)],
            enc_blocks={"enc": B.dense_block(cfg, model_shards,
                                             causal=False, name="enc")},
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
    a replicated layer dim, whisper's encoder stacks and adapter, the
    head's norm (and an untied ``out``'s vocab columns), deepseek-v3's
    ``mtp``, for every family at any model axis."""
    cfg = arch.cfg
    prepend = functools.partial(pytree.tree_map,
                                lambda sp: (None,) + tuple(sp))
    specs: dict = {"embed": layers.embed_specs(cfg.vocab, model_shards)}
    counts = engine.stack_counts(arch.segments)
    specs["stacks"] = {
        name: prepend(arch.blocks[name].specs) if n
        else arch.blocks[name].specs for name, n in counts.items()}
    if arch.enc_segments:
        specs["enc_stacks"] = {
            name: prepend(arch.enc_blocks[name].specs)
            for name in engine.stack_counts(arch.enc_segments)}
        specs["adapter"] = {"w": (None, None)}
    head = {"norm": (None,)}
    if not cfg.tie_embed:
        head["out"] = (None, layers.MODEL if layers.vocab_sharded(
            cfg.vocab, model_shards) else None)
    specs["head"] = head
    if arch.mtp_block is not None:
        specs["mtp"] = {"proj": (None, None), "n_x": (None,),
                        "n_e": (None,), "block": arch.mtp_block.specs}
    return specs


def fsdpify_leaf(spec: tuple, shape: tuple, d_shards: int,
                 m_shards: int) -> tuple:
    """The JAX ``fsdpify_leaf``: ``"data"`` on the first dim the compute
    spec leaves unsplit whose extent D divides (and is at least D), else
    ``("model", "data")`` on a model-split dim that D * M divides, else
    the spec as it is (padded with None to the leaf's rank)."""
    entries = list(spec) + [None] * (len(shape) - len(spec))
    for i, n in enumerate(shape):
        if entries[i] is None and n % max(d_shards, 1) == 0 \
                and n >= d_shards:
            entries[i] = device_axis.DATA
            return tuple(entries)
    for i, n in enumerate(shape):
        if entries[i] == layers.MODEL and n % (d_shards * m_shards) == 0:
            entries[i] = (layers.MODEL, device_axis.DATA)
            return tuple(entries)
    return tuple(entries)


def master_specs(arch: ArchDef, cspecs: PyTree, shapes: PyTree,
                 d_shards: int, m_shards: int, fsdp: bool) -> PyTree:
    """Each master leaf's spec (the JAX ``build_master_specs``' full
    specs): the compute specs in the replicated regime; under FSDP each
    leaf's spec through :func:`fsdpify_leaf` at the GLOBAL D (so the
    layout is JAX's whatever the process grid), a stack's derived from
    one layer's shape behind its replicated layer dim.  ``shapes``: the
    parameter tree (meta tensors will do)."""
    if not fsdp:
        return cspecs

    def fsdpify(spec_tree, shape_tree, lead=0):
        return pytree.tree_map(
            lambda sp, x: (None,) * lead + fsdpify_leaf(
                sp[lead:], tuple(x.shape[lead:]), d_shards, m_shards),
            spec_tree, shape_tree)

    full = {name: fsdpify(cspecs[name], shapes[name])
            for name in ("embed", "head", "adapter", "mtp") if name in cspecs}
    counts = engine.stack_counts(arch.segments)
    full["stacks"] = {name: fsdpify(cspecs["stacks"][name],
                                    shapes["stacks"][name], 1 if n else 0)
                      for name, n in counts.items()}
    if "enc_stacks" in cspecs:
        full["enc_stacks"] = {name: fsdpify(spec, shapes["enc_stacks"][name],
                                            1)
                              for name, spec in cspecs["enc_stacks"].items()}
    return full


def layer_specs(arch: ArchDef, mspecs: PyTree) -> dict:
    """The per-block, per-LAYER master specs that ``engine.FsdpPlan``
    hands the lift (the JAX ``build_master_specs``' second result): a
    stack's specs without their layer dim, a tied block's as they are."""
    counts = engine.stack_counts(arch.segments)
    return {name: (pytree.tree_map(lambda sp: tuple(sp[1:]),
                                   mspecs["stacks"][name]) if n
                   else mspecs["stacks"][name])
            for name, n in counts.items()}


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
    embeddings of ``roll(tokens, -1)``.  ``tp``: a vocab-sharded model
    axis (both heads' lookups, logits and cross-entropies vocab-
    parallel); the replicated ``proj`` gets its whole gradient, since the
    MTP block marks its own input."""
    cfg = arch.cfg
    targets, mask = _targets_and_mask(tokens)
    losses = layers.softmax_xent(_logits(cfg, head, embed_p, x, tp),
                                 targets, mask, tp) + aux
    if arch.mtp_block is None:
        return losses
    e2 = layers.embed(embed_p, torch.roll(tokens, -1, dims=-1),
                      cfg.embed_scale, tp)
    h = layers.linear(torch.cat(
        [layers.rms_norm(mtp["n_x"], x, cfg.norm_eps),
         layers.rms_norm(mtp["n_e"], e2, cfg.norm_eps)], dim=-1),
        mtp["proj"].to(x.dtype))
    h = mtp_apply(mtp["block"], h)
    mask2 = torch.ones(tokens.shape, dtype=torch.float32,
                       device=tokens.device)
    mask2[..., -2:] = 0.0
    return losses + cfg.mtp_loss_weight * layers.softmax_xent(
        _logits(cfg, head, embed_p, h, tp), torch.roll(tokens, -2, dims=-1),
        mask2, tp)


def make_loss(arch: ArchDef, remat: bool = True,
              topo: Topology | None = None) -> Callable:
    """loss(params, batch) -> the loss of every replica (the module
    docstring's): params with leading replica dims ``[*lead, *leaf]``
    and ``{"tokens": [*lead, b, L]}`` give ``[*lead]``.  An
    encoder-decoder first encodes ``batch["frames"]`` [*lead, b, f,
    frontend_dim] (cast to the embedding's dtype, through the adapter and
    the encoder segments); a vlm puts ``batch["patches"]`` first.  Over
    a model axis above 1 (``topo``) params are a rank's blocks (the
    tensor-parallel forward); every model rank returns the same
    losses."""
    cfg = arch.cfg
    plan = ReplicatedPlan(cfg, remat)
    tp = topo if topo is not None and topo.model_shards > 1 else None
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
                                                   device=frames.device),
                       tp=tp)
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


def make_loss_master(arch: ArchDef, topo: Topology | None = None,
                     mspecs: PyTree | None = None) -> Callable:
    """The FSDP regime's loss (the JAX package's ``make_loss_master``):

    loss_master(params, delta, batch, lift) -> (sum of the losses, the
        [P, D] losses)

    params: the [P, *leaf] masters (stacks [P, n_layers, *leaf]; a tied
    block's, zamba2's shared attention, [P, *leaf]), delta the same tree
    of corrections, ``{"tokens": [P, D, b, L]}`` (a vlm:
    and ``"patches"``); ``lift(tree, delta_tree, specs)`` lifts a tree
    to its [P, D] copies (its backward votes; ``specs``: the tree's
    master specs, :func:`master_specs`, which say where a rank of a
    process mesh holds a shard).  The embedding is lifted once, first,
    and used wherever it is (the tokens, the tied unembedding, MTP's
    rolled tokens), so its cotangents sum before the sign; a tied block
    likewise, once before the layers (``engine.run_segments``); each
    other layer is lifted inside its block (``engine.FsdpPlan``), then
    the head (the logits and MTP's) and the ``mtp`` subtree, each once.
    The losses are the replicated loss's, the layers' aux [P, D]
    included.  Over a model axis above 1 (``topo``) the lifted copies
    are the rank's model blocks and the forward runs tensor-parallel,
    as :func:`make_loss`'s."""
    cfg = arch.cfg
    if arch.enc_segments:
        raise NotImplementedError(
            f"{cfg.name}: an encoder-decoder trains in the replicated "
            "regime (as in the JAX package)")
    tp = topo if topo is not None and topo.model_shards > 1 else None
    tp_vocab = tp if tp is not None and layers.vocab_sharded(
        cfg.vocab, tp.model_shards) else None
    ms = mspecs or {}
    per_layer = layer_specs(arch, ms) if ms else {}

    def loss_master(params, delta, batch, lift):
        plan = engine.FsdpPlan(cfg, lift, per_layer)
        tokens = batch["tokens"]                       # [P, D, b, L]
        emb = lift(params["embed"], delta["embed"], ms.get("embed"))
        x = layers.embed(emb, tokens, cfg.embed_scale, tp_vocab)
        x, n_patch = _patches_first(cfg, x, batch)
        ctx = Ctx(cfg, positions=torch.arange(x.shape[-2],
                                              device=tokens.device), tp=tp)
        x, aux = engine.run_segments(plan, arch, arch.segments,
                                     params["stacks"], x, ctx, lead=1,
                                     dstacks=delta["stacks"])
        x = x[..., n_patch:, :]
        head = lift(params["head"], delta["head"], ms.get("head"))
        mtp = (lift(params["mtp"], delta["mtp"], ms.get("mtp"))
               if arch.mtp_block is not None else None)
        losses = _losses(arch, head, emb, mtp, x, aux, tokens,
                         lambda p, h: arch.mtp_block.apply(p, h, ctx)[0],
                         tp_vocab)
        return losses.sum(), losses

    return loss_master


def occurrence_counts(segments) -> dict[str, int]:
    """How often each block runs: a tied block once an occurrence."""
    occ: dict[str, int] = {}
    for seg in segments:
        for bname, cnt in seg.layout:
            occ[bname] = occ.get(bname, 0) + cnt * seg.repeats
    return occ


SERVE_BATCH_AXES = ("pod", "data")   # the request rows over a mesh: the
                                     # JAX ``batch_axes``, pod-major


def axis_sizes(topo: Topology | None) -> dict:
    """Each mesh axis' size (every one 1 without a mesh)."""
    m = None if topo is None else topo.mesh
    if m is None:
        return {"pod": 1, "data": 1, "model": 1}
    return {"pod": m.pods, "data": m.data, "model": m.model}


def block_shape(shape: tuple, spec: tuple, sizes: dict) -> tuple:
    """A leaf's block on one rank: each dim divided by the sizes of the
    axes its spec entry names (None, an axis, or a tuple of axes); a dim
    they do not divide raises ``ValueError``."""
    out = []
    for i, n in enumerate(shape):
        entry = spec[i] if i < len(spec) else None
        names = entry if isinstance(entry, tuple) else (entry,)
        div = math.prod(sizes[a] for a in names if a is not None)
        if n % div:
            raise ValueError(f"dim {i} of {tuple(shape)} ({n}) does not "
                             f"split over {entry} ({div} ranks)")
        out.append(n // div)
    return tuple(out)


LEN_AXES = (None, "data")    # a cache's length whole, or split over
                             # the data ranks (long_500k's layout)


def _cache_leaves(arch: ArchDef, b: int, max_len: int,
                  topo: Topology | None, len_axis=None) -> dict:
    """Each block's cache slice shapes at this rank: {block: tree of
    (n_occurrences, *block shape)}."""
    if len_axis not in LEN_AXES:
        raise ValueError(f"len_axis must be one of {LEN_AXES}, not "
                         f"{len_axis!r}")
    if len_axis is not None and b != 1:
        raise ValueError(f"a cache split by length holds one request, not "
                         f"{b} (the batch would split over the same axis)")
    sizes = axis_sizes(topo)
    # a single request is whole on every batch rank (JAX's ``ba = None``)
    specs = cache_specs(arch, SERVE_BATCH_AXES if b > 1 else None,
                        len_axis)["stacks"]
    out = {}
    for name, n in occurrence_counts(arch.segments).items():
        bd = arch.blocks[name]
        if bd.cache_init is None:
            continue
        out[name] = pytree.tree_map(
            lambda shape, sp: (n,) + block_shape(shape, sp[1:], sizes),
            bd.cache_init(b, max_len), specs[name])
    return out


def make_cache(arch: ArchDef, b: int, max_len: int,
               device: str | torch.device | None = None,
               topo: Topology | None = None, len_axis=None) -> dict:
    """bfloat16 zeros of each block's ``cache_init`` slice shapes,
    stacked over its occurrences (a tied block has a slice for each),
    and ``pos`` 0.  Every leaf is zero, the sLSTM's n too, where
    training starts it at ones: the JAX package's ``make_cache`` does
    the same (ROADMAP queue 3).  Over a mesh (``topo``) ``b`` is the
    global batch and the cache is this rank's block of it
    (:func:`cache_specs` over ``SERVE_BATCH_AXES``): its batch rows (all
    of a single request), and its heads or inner-dim slice where a
    spec names the model axis.  ``len_axis="data"`` (one request,
    long_500k's layout): data rank r holds positions ``[r*L/data,
    (r+1)*L/data)`` of each leaf whose spec names ``"data"`` on its
    length (the global layers' k and v, zamba2's shared attention's,
    MLA's ckv and kr); window caches and recurrent states stay whole; a
    length the data ranks do not divide raises ``ValueError``."""
    stacks = {name: pytree.tree_map(
        lambda shape: torch.zeros(shape, dtype=torch.bfloat16,
                                  device=device), tree)
        for name, tree in _cache_leaves(arch, b, max_len, topo,
                                        len_axis).items()}
    return {"stacks": stacks, "pos": 0}


STATE_LEAVES = frozenset({"ssm", "C", "n", "m", "c", "h"})   # float32 once
                                                        # served


def cache_bytes(arch: ArchDef, b: int, max_len: int,
                topo: Topology | None = None,
                compute_dtype: torch.dtype | None = None,
                len_axis=None) -> int:
    """The bytes of a rank's cache, reckoned from the specs: as
    :func:`make_cache` allocates it (bfloat16) without a
    ``compute_dtype``; with one, as prefill and decode return it --
    the recurrent states (``STATE_LEAVES``) float32, the conv states in
    the compute dtype, the attention caches bfloat16.  ``len_axis``: as
    :func:`make_cache` splits the length."""
    def nbytes(key, shape):
        if compute_dtype is None:
            size = 2
        elif key in STATE_LEAVES:
            size = 4
        elif key == "conv":
            size = torch.empty((), dtype=compute_dtype).element_size()
        else:
            size = 2
        return size * math.prod(shape)

    def walk(tree):
        return sum(walk(v) if isinstance(v, dict) else nbytes(k, v)
                   for k, v in tree.items())
    return walk(_cache_leaves(arch, b, max_len, topo, len_axis))


def cache_specs(arch: ArchDef, batch_ax, len_axis=None) -> dict:
    """The cache's spec tree (the JAX ``cache_specs``, tuple for tuple):
    each block's ``cache_specs(batch_ax, len_axis)`` behind a ``None``
    for its occurrences, and ``pos`` replicated, ``()``."""
    stacks = {}
    for name in occurrence_counts(arch.segments):
        bd = arch.blocks[name]
        if bd.cache_specs is None:
            continue
        stacks[name] = pytree.tree_map(lambda sp: (None,) + tuple(sp),
                                       bd.cache_specs(batch_ax, len_axis))
    return {"stacks": stacks, "pos": ()}


def gather_serve(topo: Topology | None, tree: PyTree,
                 specs: PyTree) -> PyTree:
    """A tree of FSDP shards (``specs``: its master specs) -> the rank's
    compute blocks: each leaf whose spec names ``"data"`` gathered over
    the data group along that dim (``comm.gather_shards``, counted
    ``gather_serve``), the rest as they are.  The FSDP layout has no
    padded shard (the regime refuses a model axis that would leave one),
    so the gathered block is the compute block as it is; without a
    data group above one rank, the tree itself."""
    if device_axis.data_ranks(topo) == 1:
        return tree
    return pytree.tree_map(
        lambda x, sp: x if device_axis.data_dim(sp) is None
        else comm.gather_shards(topo, x, device_axis.data_dim(sp),
                                op="gather_serve"), tree, specs)


class ServeGatherPlan(ReplicatedPlan):
    """The serving plan for FSDP-stored parameters (the JAX plan, which
    constrains each layer's shards to its block's compute specs): each
    layer's leaves arrive as the rank's shards and are gathered over the
    data group into the block's compute block (:func:`gather_serve`)
    just before the block runs; ``layer_specs`` are the per-layer master
    specs (:func:`layer_specs`).  ``engine.run_segments`` asks for a
    tied block's once a call."""

    def __init__(self, cfg: LMConfig, topo: Topology | None,
                 layer_specs: dict):
        super().__init__(cfg, remat=False)
        self.topo = topo
        self.layer_specs = layer_specs

    def layer(self, name: str, lp):
        return gather_serve(self.topo, lp, self.layer_specs[name])


def serve_layout(cfg: LMConfig, topo: Topology, n_params: int) -> str:
    """The reference's rule: ``"resident"`` (the weights served in the
    compute layout) for the replicated regime and for an FSDP config
    whose bf16 weights on a card, ``2 * n_params`` bytes over the model
    axis' shards, fit ``SERVE_RESIDENT_BUDGET``; ``"gather"``
    (FSDP-stored weights gathered a layer at a time,
    :class:`ServeGatherPlan`) otherwise."""
    if cfg.param_mode != "fsdp":
        return "resident"
    per_card = 2.0 * n_params / max(topo.model_shards, 1)
    return "resident" if per_card <= SERVE_RESIDENT_BUDGET else "gather"


def serve_master_specs(arch: ArchDef, devices: int, model: int) -> PyTree:
    """The FSDP master specs the gather layout serves from: the
    regime's layout at the global D ``devices`` and model axis
    ``model``."""
    return master_specs(arch, compute_specs(arch, model),
                        init_params(arch, None, "meta"), devices, model,
                        True)


SERVE_ROWS = ("split", "replicated")


def make_serve_fns(arch: ArchDef, topo: Topology | None = None,
                   layout: str = "resident", rows: str = "split",
                   len_axis=None):
    """(prefill, decode_step) as the module docstring gives them.

    ``layout``: ``"resident"`` (the parameters in the compute layout) or
    ``"gather"`` (an FSDP config's parameters as the rank's FSDP shards,
    gathered a layer at a time, :class:`ServeGatherPlan`; a replicated
    config's masters are its compute blocks, so it serves them as
    resident).  Over a mesh (``topo``) each rank serves with its blocks
    of the parameters; ``rows="split"``: its rows of the batch (the
    module docstring), ``"replicated"``: one request, the same on every
    batch rank.  ``len_axis="data"`` (with ``"replicated"``): the
    caches' length split over the data ranks (:func:`make_cache`)."""
    cfg = arch.cfg
    if layout not in ("resident", "gather"):
        raise ValueError(f"layout must be 'resident' or 'gather', not "
                         f"{layout!r}")
    if rows not in SERVE_ROWS:
        raise ValueError(f"rows must be one of {SERVE_ROWS}, not {rows!r}")
    if len_axis is not None and rows != "replicated":
        raise ValueError("a cache split by length serves one request, "
                         "replicated over the batch ranks "
                         "(rows='replicated')")
    tp = topo if topo is not None and topo.model_shards > 1 else None
    tp_vocab = tp if tp is not None and layers.vocab_sharded(
        cfg.vocab, tp.model_shards) else None
    mesh_topo = topo if topo is not None and topo.mesh is not None else None
    batch_topo = mesh_topo if rows == "split" else None
    n_batch = moe_mod.batch_ranks(batch_topo)[0]
    seq = (mesh_topo if len_axis is not None
           and device_axis.data_ranks(mesh_topo) > 1 else None)
    if cfg.param_mode == "fsdp" and layout == "gather":
        mspecs = serve_master_specs(
            arch, topo.devices_per_pod if topo is not None else 1,
            topo.model_shards if topo is not None else 1)
        per_layer = layer_specs(arch, mspecs)
        for name, spec in mspecs.get("enc_stacks", {}).items():
            per_layer[name] = pytree.tree_map(lambda sp: tuple(sp[1:]), spec)
        plan = ServeGatherPlan(cfg, mesh_topo, per_layer)

        def whole(params, name):
            return gather_serve(mesh_topo, params[name], mspecs[name])
    else:
        plan = ReplicatedPlan(cfg, remat=False)

        def whole(params, name):
            return params[name]

    def logits_of(head, embed_p, x):
        """The head's logits [b, 1, V] of x [b, 1, d], the vocab blocks
        gathered over the model group."""
        return comm.gather_model(tp_vocab, _logits(
            cfg, head, embed_p, x, tp_vocab), -1)

    def global_rows(tokens) -> int:
        b = tokens.shape[0]
        if rows == "replicated" and b != 1:
            raise ValueError(f"rows='replicated' serves one request, not {b}")
        return b * n_batch

    def prefill(params, batch, max_len: int):
        """The whole prompt: (the last position's logits [b, 1, V], the
        cache).  whisper's encoder runs in train mode first; a vlm's
        patches go before the tokens."""
        tokens = batch["tokens"]
        b_all = global_rows(tokens)
        with torch.no_grad():
            embed_p = whole(params, "embed")
            x = layers.embed(embed_p, tokens, cfg.embed_scale, tp_vocab)
            enc_out = None
            if arch.enc_segments:
                frames = batch["frames"].to(x.dtype)
                ex = layers.linear(frames,
                                   whole(params, "adapter")["w"].to(x.dtype))
                ectx = Ctx(cfg, "train", positions=torch.arange(
                    frames.shape[-2], device=frames.device), tp=tp)
                enc_out, _ = engine.run_segments(
                    plan, arch, arch.enc_segments, params["enc_stacks"],
                    ex, ectx)
            x, _ = _patches_first(cfg, x, batch)
            t = x.shape[-2]
            cache = make_cache(arch, b_all, max_len, tokens.device,
                               mesh_topo, len_axis)
            ctx = Ctx(cfg, "prefill",
                      positions=torch.arange(t, device=tokens.device),
                      pos=0, enc_out=enc_out, tp=tp, batch=batch_topo,
                      seq=seq)
            x, stacks = engine.run_segments(
                plan, arch, arch.segments, params["stacks"], x, ctx,
                caches=cache["stacks"])
            logits = logits_of(whole(params, "head"), embed_p,
                               x[..., -1:, :])
        return logits, {"stacks": stacks, "pos": t}

    def decode_step(params, cache, tokens):
        """One step: tokens [b, 1] at ``cache["pos"]`` -> (logits [b, 1,
        V], the next cache)."""
        global_rows(tokens)
        pos, t = cache["pos"], tokens.shape[-1]
        with torch.no_grad():
            embed_p = whole(params, "embed")
            x = layers.embed(embed_p, tokens, cfg.embed_scale, tp_vocab)
            ctx = Ctx(cfg, "decode", positions=pos + torch.arange(
                t, device=tokens.device), pos=pos, tp=tp, batch=batch_topo,
                seq=seq)
            x, stacks = engine.run_segments(
                plan, arch, arch.segments, params["stacks"], x, ctx,
                caches=cache["stacks"])
            logits = logits_of(whole(params, "head"), embed_p, x)
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
    make_cache: Callable           # (b, max_len, device) -> the rank's cache
    cache_specs: Callable          # (batch_ax, len_axis=None) -> specs
    serve_layout: str = "resident"  # or "gather" (ServeGatherPlan)


def build_model(cfg: LMConfig, topo: Topology,
                layout: str | None = None) -> BuiltModel:
    """The model's entry points; an FSDP config (``param_mode="fsdp"``)
    gets ``loss=None`` and a ``loss_master`` (:func:`make_loss_master`).
    The bundle carries the compute specs at ``topo``'s model axis and
    the master specs
    (:func:`master_specs` at ``topo``'s global D: the replicated
    regime's masters are laid out as computed, an FSDP config's
    data-sharded as in the JAX ``build_master_specs``); over a model
    axis above 1 the loss and serving are tensor-parallel.  Serving is
    in ``layout``, by default the reference's rule (:func:`serve_layout`);
    a caller may ask for ``"gather"`` below the budget, as the JAX
    ``make_serve_fns`` serves by default."""
    m = topo.model_shards
    arch = make_archdef(cfg, m)
    abstract = init_params(arch, None, "meta")
    if layout is None:
        layout = serve_layout(cfg, topo, param_count(abstract))
    prefill, decode_step = make_serve_fns(arch, topo, layout)
    fsdp = cfg.param_mode == "fsdp"
    cspecs = compute_specs(arch, m)
    mspecs = master_specs(arch, cspecs, abstract, topo.devices_per_pod, m,
                          fsdp)
    return BuiltModel(
        cfg=cfg, arch=arch, topo=topo,
        bundle=hier.ModelBundle(
            loss=None if fsdp else make_loss(arch, topo=topo),
            loss_master=(make_loss_master(arch, topo, mspecs) if fsdp
                         else None),
            param_mode=cfg.param_mode,
            specs=cspecs,
            master_specs=mspecs),
        init_params=lambda generator: init_params(arch, generator),
        abstract_params=lambda: init_params(arch, None, "meta"),
        prefill=prefill, decode_step=decode_step,
        make_cache=functools.partial(make_cache, arch, topo=topo),
        cache_specs=functools.partial(cache_specs, arch),
        serve_layout=layout)


def param_count(params: PyTree) -> int:
    return sum(math.prod(a.shape) for a in pytree.tree_flatten(params)[0])
