"""The paper's EMNIST-Digits model: a one-hidden-layer fully-connected
net (Sec. V-A), 784 -> 64 -> 10, 50,890 parameters.

The same formula as the JAX package's ``models/mlp.py``
(``tanh(x @ w1 + b1) @ w2 + b2``, logsumexp cross-entropy) and the same
parameter names and shapes, so a JAX parameter tree converts leaf for
leaf (``repro_torch.convert``).  The functions take a parameter dict
with any leading batch dims: ``[P, D, *leaf]`` parameters with
``[P, D, b, 784]`` inputs give ``[P, D]`` losses -- JAX's ``vmap``
written out as batch dims.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from repro_torch.core.hier import ModelBundle


def init_mlp(generator: torch.Generator, dim: int = 784, hidden: int = 64,
             classes: int = 10) -> dict[str, torch.Tensor]:
    """Random parameters on the generator's device: normal weights scaled
    by 1/sqrt(fan_in), zero biases."""
    kw = dict(generator=generator, device=generator.device)
    return {
        "w1": torch.randn(dim, hidden, **kw) / math.sqrt(dim),
        "b1": torch.zeros(hidden, device=generator.device),
        "w2": torch.randn(hidden, classes, **kw) / math.sqrt(hidden),
        "b2": torch.zeros(classes, device=generator.device),
    }


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` in the promoted dtype, as ``jnp.matmul`` promotes (f32
    inputs against bf16 parameters compute in f32)."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return a.to(dt) @ b.to(dt)


def logits_fn(params, x: torch.Tensor) -> torch.Tensor:
    h = torch.tanh(_mm(x, params["w1"]) + params["b1"].unsqueeze(-2))
    return _mm(h, params["w2"]) + params["b2"].unsqueeze(-2)


def loss_fn(params, batch) -> torch.Tensor:
    """Mean cross-entropy over the last batch dim (per leading index)."""
    lg = logits_fn(params, batch["x"])
    lse = torch.logsumexp(lg, dim=-1)
    gold = torch.take_along_dim(lg, batch["y"].long()[..., None],
                                dim=-1)[..., 0]
    return torch.mean(lse - gold, dim=-1)


@torch.no_grad()
def accuracy(params, batch) -> torch.Tensor:
    lg = logits_fn(params, batch["x"])
    return torch.mean((torch.argmax(lg, -1) == batch["y"]).to(torch.float32))


def param_count(params) -> int:
    return sum(int(p.numel()) for p in params.values())


class MLP(nn.Module):
    """The model as an ``nn.Module``; ``params()`` is the dict the
    functions above and the train step take."""

    def __init__(self, params: dict[str, torch.Tensor]):
        super().__init__()
        self.w1 = nn.Parameter(params["w1"])
        self.b1 = nn.Parameter(params["b1"])
        self.w2 = nn.Parameter(params["w2"])
        self.b2 = nn.Parameter(params["b2"])

    def params(self) -> dict[str, torch.Tensor]:
        return {"w1": self.w1, "b1": self.b1, "w2": self.w2, "b2": self.b2}

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return logits_fn(self.params(), x)


def make_bundle() -> ModelBundle:
    """The hierarchy's view of the model: [P, D] losses of [P, D] copies."""
    return ModelBundle(loss=loss_fn)
