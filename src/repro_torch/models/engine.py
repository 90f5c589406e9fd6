"""Model engine: the layer schedule of a forward, in train mode or over
the decode caches.

The JAX package's ``models/engine.py`` for the replicated regime.  Layer
schedules are lists of Segments; a Segment runs ``repeats`` times over
its ``layout`` (gemma3: 5 local + 1 global a repeat).  Parameters are
stacked per block name with a leading layer dim (after the replica
dims), and the segments take the layers of each stack in order -- the
JAX package's ``lax.scan`` written as Python loops in the same order.
An encoder-decoder (whisper) has its own ``enc_blocks`` and
``enc_segments``, run by the same code over ``enc_stacks``.  Serving
hands ``run_segments`` the caches, stacked per block name as the
parameters are; each layer takes the slice its cursor gives, and the
new slices are restacked in layer order.  In train mode every block
returns its aux loss ([*lead] float32: the MoE's load balance, zeros
elsewhere) and ``run_segments`` sums them per replica in layer order,
as the JAX scan carries them.

The FSDP regime (``FsdpPlan``): the segments run over the [P, n_layers,
*leaf] masters, each layer lifted to its [P, D] copies inside its block
(``core.device_axis``), the lift's backward voting.

``ArchDef.mtp_block`` is deepseek-v3's MTP block, run by the loss
(``models.build``) after the segments.

Tied blocks (zamba2's shared attention, a Segment's ``tied`` names)
keep ONE parameter set, unstacked ([*lead, *leaf]), applied at every
occurrence: replicated, autograd sums the occurrences' gradients into
the [P, D] copies before the flatten and the sign; under FSDP the tree
is lifted once, before the layer loop and outside the recompute (the
JAX ``lift_once``), and each occurrence applies the lifted copies
directly, so the lift's backward votes once, on the summed cotangent --
the paper's per-coordinate semantics.  A tied block's cache has a slice
per occurrence, on its own cursor.

Not ported yet: the serving plan that gathers FSDP shards (ROADMAP item
17).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.core import pytree
from repro_torch.models.blocks import BlockDef, Ctx
from repro_torch.models.config import LMConfig

PyTree = Any


@dataclasses.dataclass(frozen=True)
class Segment:
    layout: tuple[tuple[str, int], ...]      # (block_name, count per repeat)
    repeats: int
    tied: frozenset = frozenset()            # block names with shared params


@dataclasses.dataclass
class ArchDef:
    cfg: LMConfig
    blocks: dict[str, BlockDef]
    segments: list[Segment]
    enc_blocks: dict[str, BlockDef] | None = None
    enc_segments: list[Segment] | None = None
    mtp_block: BlockDef | None = None


def stack_counts(segments: list[Segment]) -> dict[str, int]:
    counts: dict[str, int] = {}
    for seg in segments:
        for bname, cnt in seg.layout:
            if bname in seg.tied:
                counts.setdefault(bname, 0)
            else:
                counts[bname] = counts.get(bname, 0) + cnt * seg.repeats
    return counts


def _stack_init(bd: BlockDef, gen, n: int, device) -> PyTree:
    """n layers' parameters stacked on a leading layer dim (one set,
    unstacked, for n == 0: a tied block)."""
    if n == 0:
        return bd.init(gen, device)
    layers_ = [bd.init(gen, device) for _ in range(n)]
    return pytree.tree_map(lambda *xs: torch.stack(xs), *layers_)


class ReplicatedPlan:
    """Block application on plain parameters; with ``remat`` each block
    whose ``BlockDef.remat`` is set runs under ``torch.utils.checkpoint``
    (its activations recomputed in the backward pass, as
    ``jax.checkpoint`` does for every block)."""

    def __init__(self, cfg: LMConfig, remat: bool):
        self.remat = remat and cfg.remat

    def block(self, bd: BlockDef, lp, x, ctx: Ctx, cache=None):
        if cache is not None:
            return bd.apply(lp, x, ctx, cache)
        if self.remat and bd.remat and torch.is_grad_enabled():
            return checkpoint(lambda p_, x_: bd.apply(p_, x_, ctx), lp, x,
                              use_reentrant=False)
        return bd.apply(lp, x, ctx)


class FsdpPlan:
    """The FSDP regime's block application: each layer's master slice
    [P, *leaf] is lifted to its [P, D, *leaf] copies by ``lift(lp,
    ld)`` (``core.device_axis.fsdp_lift_tree``: the backward votes)
    inside the block, and with ``cfg.remat`` the lift and the block run
    under ``torch.utils.checkpoint``, so the copies and activations are
    recomputed in the backward pass while the vote runs once.  Train
    mode only: the block's (x, aux), aux [P, D]."""

    def __init__(self, cfg: LMConfig, lift):
        self.lift = lift
        self.remat = cfg.remat

    def block(self, bd: BlockDef, lp, x, ctx: Ctx, ld):
        def run(lp_, ld_, x_):
            return bd.apply(self.lift(lp_, ld_), x_, ctx)

        if self.remat and bd.remat and torch.is_grad_enabled():
            return checkpoint(run, lp, ld, x, use_reentrant=False)
        return run(lp, ld, x)


def _per_layer(tree, lead: int) -> list:
    """A stacked tree [*lead, n, *leaf] -> its n layers' trees."""
    leaves, td = pytree.tree_flatten(tree)
    return [pytree.tree_unflatten(td, list(ls))
            for ls in zip(*(a.unbind(lead) for a in leaves))]


def run_segments(plan, arch: ArchDef, segments, stacks,
                 x: torch.Tensor, ctx: Ctx, lead: int = 0, caches=None,
                 dstacks=None):
    """Apply all segments to x [*lead, b, t, d].  ``stacks`` holds each
    block's parameters [*lead, n_layers, *leaf] (``lead`` replica dims;
    a tied block's [*lead, *leaf], one set); the layers of a stack are
    used in order across the segments.  The segments' block names are
    the decoder's or the encoder's.  With ``caches`` (each block's
    [n_occurrences, *slice], serving, ``lead`` 0) each occurrence takes
    its slice and the result is (x, the new caches stacked the same
    way).

    FSDP (``plan`` an :class:`FsdpPlan`): ``stacks`` are the masters [P,
    n_layers, *leaf] and ``dstacks`` their corrections, ``lead`` 1 (the
    JAX ``slice_stack``); each is unbound once, so autograd stacks the
    layers' directions once (a per-layer ``select`` would build a
    full-size zero tensor for every layer), and each layer hands its
    slices to ``plan.block``.  A tied block's tree is never unbound: it
    is lifted once and applied at each occurrence as it is, without the
    recompute (the JAX ``lift_once`` and its direct apply)."""
    blocks = {**arch.blocks, **(arch.enc_blocks or {})}
    tied = {name for seg in segments for name in seg.tied}
    fsdp = dstacks is not None
    per_layer = {name: _per_layer(tree, lead) for name, tree in stacks.items()
                 if name not in tied}
    dper = ({name: _per_layer(tree, lead) for name, tree in dstacks.items()
             if name not in tied} if fsdp else None)
    shared = {name: plan.lift(stacks[name], dstacks[name]) if fsdp
              else stacks[name] for name in tied}
    cursors = dict.fromkeys(stacks, 0)        # occurrences of each block
    old = ({name: _per_layer(tree, 0) for name, tree in caches.items()}
           if caches is not None else None)
    new = {name: [] for name in old} if old is not None else None
    aux = (torch.zeros(x.shape[:-3], dtype=torch.float32, device=x.device)
           if old is None else None)
    for seg in segments:
        for _ in range(seg.repeats):
            for bname, cnt in seg.layout:
                bd = blocks[bname]
                for _ in range(cnt):
                    at = cursors[bname]
                    if bname in shared and fsdp:
                        x, a = bd.apply(shared[bname], x, ctx)
                    elif fsdp:
                        x, a = plan.block(bd, per_layer[bname][at], x, ctx,
                                          ld=dper[bname][at])
                    else:
                        lp = (shared[bname] if bname in shared
                              else per_layer[bname][at])
                        if old is None:
                            x, a = plan.block(bd, lp, x, ctx)
                        else:
                            x, nc = plan.block(bd, lp, x, ctx,
                                               old[bname][at])
                            new[bname].append(nc)
                    if old is None:
                        aux = aux + a
                    cursors[bname] += 1
    if new is None:
        return x, aux
    return x, {name: pytree.tree_map(lambda *ls: torch.stack(ls), *layers_)
               for name, layers_ in new.items()}
