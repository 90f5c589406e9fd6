"""Model engine: the layer schedule of a train forward.

The JAX package's ``models/engine.py`` for the replicated regime.  Layer
schedules are lists of Segments; a Segment runs ``repeats`` times over
its ``layout`` (gemma3: 5 local + 1 global a repeat).  Parameters are
stacked per block name with a leading layer dim (after the replica
dims), and the segments take the layers of each stack in order -- the
JAX package's ``lax.scan`` written as Python loops in the same order.
An encoder-decoder (whisper) has its own ``enc_blocks`` and
``enc_segments``, run by the same code over ``enc_stacks``.

Not ported yet: tied blocks (zamba2's shared attention, with the hybrid
family, ROADMAP item 15), the MTP block (deepseek-v3, with the moe
family, item 15), the decode caches (item 21), and ``FsdpPlan`` (item
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

    def block(self, bd: BlockDef, lp, x, ctx: Ctx):
        if self.remat and bd.remat and torch.is_grad_enabled():
            return checkpoint(lambda p_, x_: bd.apply(p_, x_, ctx), lp, x,
                              use_reentrant=False)
        return bd.apply(lp, x, ctx)


def run_segments(plan: ReplicatedPlan, arch: ArchDef, segments, stacks,
                 x: torch.Tensor, ctx: Ctx, lead: int = 0) -> torch.Tensor:
    """Apply all segments to x [*lead, b, t, d].  ``stacks`` holds each
    block's parameters [*lead, n_layers, *leaf] (``lead`` replica dims);
    the layers of a stack are used in order across the segments.  The
    segments' block names are the decoder's or the encoder's."""
    blocks = {**arch.blocks, **(arch.enc_blocks or {})}
    per_layer = {}
    for name, tree in stacks.items():
        leaves, td = pytree.tree_flatten(tree)
        per_layer[name] = [pytree.tree_unflatten(td, list(ls))
                           for ls in zip(*(a.unbind(lead) for a in leaves))]
    cursors = dict.fromkeys(per_layer, 0)
    for seg in segments:
        if seg.tied:
            raise NotImplementedError(
                "tied blocks (zamba2's shared attention): ROADMAP item 15")
        for _ in range(seg.repeats):
            for bname, cnt in seg.layout:
                for _ in range(cnt):
                    lp = per_layer[bname][cursors[bname]]
                    cursors[bname] += 1
                    x = plan.block(blocks[bname], lp, x, ctx)
    return x
