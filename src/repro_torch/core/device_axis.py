"""The FSDP regime's per-layer lift: master [P, *leaf] -> copies [P, D, *leaf].

The JAX package's ``core/device_axis.py`` (``LiftCfg``, ``fsdp_lift``,
``fsdp_lift_tree``) on one card.  The lift is a ``torch.autograd.Function``
whose forward makes the D device copies of one layer's master leaf in the
compute dtype, and whose **backward runs the paper's compression** for
that leaf: ``sgn(g + rho*delta)`` of every device's cotangent, the
majority vote over the D devices under the voter mask (or, for
``wmean``, the share-weighted full-precision mean), cast to the master's
dtype.  So the "gradient" autograd returns for a master is the per-edge
direction, and a whole-model ``[P, D, n]`` gradient never forms: each
leaf's cotangent lives from its layer's backward to its vote.

The forward copies are materialised (contiguous, cast first): the
model's ops would copy a stride-0 view anyway (``F.embedding`` reshapes
the table, a batched product folds the replica dims), and contiguous
copies keep every product the replicated regime's own, so the two
regimes give the same bits.  Under the engine's remat the forward runs
again in the recompute; the backward -- the vote -- runs once.

Transports: ``fused`` votes through the kernels (one ``sign_pack`` and
one ``vote_update`` vote-only launch on the leaf's ``[P, D, numel]``
view, ``votes.fused_sign_vote_leaf``); ``ag_packed`` and ``ar_int8``
keep the replicated tree path's per-leaf arithmetic
(``votes.majority_vote_dev``).  All three are bitwise the same.  (The
JAX lift sends ``fused`` to ``ag_packed``, so the reference's
arithmetic is the same either way.)  On CPU tensors the kernels' plain
versions run; a CUDA tensor launches them or raises.

Large leaves (gemma3's tied table) go through the correction and the
mean in coordinate chunks (``votes.per_chunk``): the arithmetic of every
coordinate is the unchunked one, without its full-size temporaries.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.core import pytree, signs, votes

PyTree = Any
F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class LiftCfg:
    """Static configuration of the lift (the JAX ``LiftCfg``; the device
    count is the topology's D)."""
    devices: int
    transport: str = "ag_packed"     # ag_packed | ar_int8 | fused | wmean
    rho: float = 0.2
    compute_dtype: torch.dtype = torch.bfloat16


def lift_direction(cfg: LiftCfg, g: torch.Tensor, delta: torch.Tensor,
                   maskf: torch.Tensor, devwf: torch.Tensor) -> torch.Tensor:
    """The lift's backward arithmetic on one leaf's cotangent g [P, D,
    *leaf]: the [P, *leaf] direction (before the cast to the master's
    dtype).  ``wmean``: ``votes.weighted_mean_dev`` of g in float32 (the
    cast folded into each device's product).  Otherwise ``sgn(g +
    rho*delta)`` voted over D under ``maskf > 0.5``."""
    p, d = g.shape[:2]
    if cfg.transport == "wmean":
        g3 = g.reshape(p, d, -1)
        out = torch.empty((p, g3.shape[-1]), dtype=F32, device=g.device)
        votes.per_chunk(lambda gg: votes.weighted_mean_dev(gg.to(F32),
                                                           devwf), out, g3)
        return out.reshape((p,) + tuple(g.shape[2:]))
    mask = maskf > 0.5
    if cfg.transport == "fused":
        return votes.fused_sign_vote_leaf(g, delta if cfg.rho else None,
                                          cfg.rho, mask)
    u = votes.corrected_leaf(g, delta, cfg.rho) if cfg.rho else g
    return votes.majority_vote_dev(signs.sgn(u), mask, cfg.transport)


class _Lift(torch.autograd.Function):
    """w [P, *leaf] -> [P, D, *leaf] copies in the compute dtype; the
    backward is :func:`lift_direction`, counted in ``fsdp_lift.votes``."""

    @staticmethod
    def forward(ctx, w, delta, maskf, devwf, cfg: LiftCfg):
        ctx.cfg, ctx.wdtype = cfg, w.dtype
        ctx.save_for_backward(delta, maskf, devwf)
        out = torch.empty((w.shape[0], cfg.devices) + tuple(w.shape[1:]),
                          dtype=cfg.compute_dtype, device=w.device)
        return out.copy_(w.unsqueeze(1))       # cast and broadcast, fresh

    @staticmethod
    def backward(ctx, g):
        delta, maskf, devwf = ctx.saved_tensors
        fsdp_lift.votes += 1
        direction = lift_direction(ctx.cfg, g, delta, maskf, devwf)
        return direction.to(ctx.wdtype), None, None, None, None


def fsdp_lift(cfg: LiftCfg, w: torch.Tensor, delta: torch.Tensor, *,
              maskf: torch.Tensor, devwf: torch.Tensor) -> torch.Tensor:
    """Lift one master leaf [P, *leaf] to its [P, D, *leaf] device copies.

    delta: the leaf's [P, *leaf] correction (read only with ``rho``);
    maskf: [P, D] float voter mask (1.0 = the vote counts); devwf: [P, D]
    float shares |D_qk|/D_q (``wmean`` only).  The gradient autograd
    returns for ``w`` is the per-edge direction [P, *leaf] in w's dtype."""
    return _Lift.apply(w, delta, maskf, devwf, cfg)


def fsdp_lift_tree(cfg: LiftCfg, tree: PyTree, delta_tree: PyTree, *,
                   maskf: torch.Tensor, devwf: torch.Tensor) -> PyTree:
    """:func:`fsdp_lift` on every leaf of a tree (one layer's, the
    embedding's, the head's, or a tied block's unstacked tree -- zamba2's
    shared attention -- lifted once, so its backward votes once on the
    cotangent summed over the block's occurrences)."""
    return pytree.tree_map(
        lambda w, dl: fsdp_lift(cfg, w, dl, maskf=maskf, devwf=devwf),
        tree, delta_tree)


# backward calls of the lift: one per leaf and layer a pass, remat or not
fsdp_lift.votes = 0
