"""A model whose gradients are given: the loss ``sum_leaf <G, params>``.

Each step's batch carries the gradients G themselves, one per client,
as leaves ``{"g": {name: [P, D, K, *leaf]}}``: the batch dim b is the K
clients' one row each, so the carve hands voter ``d*K + c`` (and the
streamed slice hands client c) exactly ``G[:, d, c]``, and autograd
returns it bit for bit (the gradient of ``sum(G * w)`` is ``G * 1``).
The step's transport, votes, masks, anchor and cloud means then run on
known directions, independent of any framework's matmul order.

Used by ``tests/test_torch_hier.py`` (bitwise against the JAX step fed
the same G) and by ``chip_smoke.py`` (the stream / merged / tree triple
on the card).  Imports torch and numpy only.

Over a model axis (:func:`make_tp_bundle`) a rank's parameters are its
blocks of the leaves the specs split: the gradient is G's block, and
the loss's value is the one-process value to the bit -- each leaf's
blocks gathered over the model group and summed as one process sums
them (the value does not enter the gradient).
"""
from __future__ import annotations

import torch

from repro_torch.core import comm, flatbuf, hier, shardflat


def loss(params_dev, batch) -> torch.Tensor:
    """[P, V] losses ``sum_leaf <G_leaf, w_leaf>`` of [P, V, *leaf]
    parameter copies against ``batch["g"]`` leaves [P, V, 1, *leaf]."""
    total = None
    for name, w in sorted(params_dev.items()):
        g = batch["g"][name][:, :, 0].to(w.dtype)
        term = (g * w).reshape(w.shape[0], w.shape[1], -1).sum(-1)
        total = term if total is None else total + term
    return total


def make_bundle() -> hier.ModelBundle:
    return hier.ModelBundle(loss=loss)


def make_tp_bundle(topo, shapes: dict, specs: dict) -> hier.ModelBundle:
    """:func:`loss` on a rank's blocks over ``topo``'s model axis, the
    leaves ``shapes`` (global) split by ``specs`` (the same bundle, with
    its specs, as :func:`make_bundle` without a model axis)."""
    layout = shardflat.param_layout(topo, specs, {
        n: torch.empty(s, device="meta") for n, s in shapes.items()})
    if layout.shards == 1:
        return hier.ModelBundle(loss=loss, specs=specs)
    slots = dict(zip(sorted(shapes), layout.slots))
    m = topo.model_rank

    def whole(slot, w):
        """The leaf from every rank's logical block (the value only)."""
        ax = 2 + slot.shard_dim
        blk = slot.shape[slot.shard_dim]
        pad = list(w.shape)
        pad[ax] = blk - w.shape[ax]
        full = comm.gather_model(topo, torch.cat(
            [w.detach(), w.new_zeros(pad)], dim=ax), ax)
        return full.narrow(ax, 0, blk * layout.shards - slot.shard_pad)

    def tp_loss(params_dev, batch):
        value = part = None
        for name, w in sorted(params_dev.items()):
            slot = slots[name]
            g = batch["g"][name][:, :, 0].to(w.dtype)
            if slot.shard_dim is None:
                g_loc, w_all = g, w.detach()
            else:
                g_loc = flatbuf.slot_block(slot, g, m, layout.shards, 2
                                           ).narrow(2 + slot.shard_dim, 0,
                                                    w.shape[2 + slot.shard_dim])
                w_all = whole(slot, w)
            term = (g * w_all).reshape(w.shape[0], w.shape[1], -1).sum(-1)
            local = (g_loc * w).reshape(w.shape[0], w.shape[1], -1).sum(-1)
            value = term if value is None else value + term
            part = local if part is None else part + local
        return value + (part - part.detach())

    return hier.ModelBundle(loss=tp_loss, specs=specs)


def make_grads(shapes: dict, pods: int, devices: int, clients: int,
               steps: int, generator: torch.Generator,
               device="cpu") -> list:
    """``steps`` batches of standard-normal f32 gradients, one per
    (pod, device, client) and leaf, from ``generator``."""
    return [{"g": {name: torch.randn((pods, devices, clients) + tuple(s),
                                     generator=generator, device=device)
                   for name, s in sorted(shapes.items())}}
            for _ in range(steps)]
