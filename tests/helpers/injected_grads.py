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
"""
from __future__ import annotations

import torch

from repro_torch.core import hier


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


def make_grads(shapes: dict, pods: int, devices: int, clients: int,
               steps: int, generator: torch.Generator,
               device="cpu") -> list:
    """``steps`` batches of standard-normal f32 gradients, one per
    (pod, device, client) and leaf, from ``generator``."""
    return [{"g": {name: torch.randn((pods, devices, clients) + tuple(s),
                                     generator=generator, device=device)
                   for name, s in sorted(shapes.items())}}
            for _ in range(steps)]
