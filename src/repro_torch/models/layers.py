"""Basic neural blocks of the LM zoo, in PyTorch.

The JAX package's ``models/layers.py`` (its ``*_specs`` sharding helpers
are not ported: the port runs the replicated regime on one card).  Every
function takes tensors with any leading replica dims: a parameter leaf
is ``[*lead, *leaf]`` and an activation ``[*lead, b, t, d]`` -- the
``[P, D]`` device copies of the hierarchical step (``core.hier``), the
JAX ``vmap`` written out as batch dims, or none for one replica.  The
arithmetic follows the JAX package's: ``rms_norm`` and ``rope`` in
float32, gelu's tanh approximation (``jax.nn.gelu``'s default), python
scalars cast to the operand's dtype before they multiply (JAX's weak
types), the cross-entropy in float32.

Initialisers take a ``torch.Generator`` on the target device (or none on
the ``meta`` device, for shapes alone); they draw other numbers than
``jax.random``, so the tests hand both packages the JAX package's
parameters (``convert.params_from_numpy``).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

F32 = torch.float32


def normal(gen: torch.Generator | None, shape, device) -> torch.Tensor:
    """Standard normal float32 draws of ``shape`` from ``gen`` (none on
    the meta device)."""
    if torch.device(device).type == "meta":
        return torch.empty(shape, dtype=F32, device="meta")
    return torch.randn(shape, generator=gen, dtype=F32, device=device)


def he_init(gen, shape, device, fan_in=None) -> torch.Tensor:
    fan_in = fan_in or shape[0]
    return normal(gen, shape, device) * (1.0 / math.sqrt(fan_in))


def init_rms(d: int, device) -> torch.Tensor:
    return torch.zeros((d,), dtype=F32, device=device)  # stored as (g - 1)


def bcast(p: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """A ``[*lead, f]`` parameter against an ``[*lead, ..., f]``
    activation: singleton dims between the replica dims and f."""
    return p.reshape(p.shape[:-1] + (1,) * (x.dim() - p.dim())
                     + p.shape[-1:])


def scalar(x: torch.Tensor, value: float) -> torch.Tensor:
    """A python scalar as a 0-dim tensor of x's dtype on x's device, as a
    weak-typed JAX scalar enters x's arithmetic."""
    return torch.tensor(value, dtype=x.dtype, device=x.device)


def rms_norm(g: torch.Tensor, x: torch.Tensor, eps: float = 1e-6):
    """x scaled by rsqrt(mean(x^2) + eps) and by ``1 + g``, in float32,
    back in x's dtype (g stored as g - 1, gemma-style)."""
    x32 = x.to(F32)
    y = x32 * torch.rsqrt(torch.mean(x32 * x32, dim=-1, keepdim=True) + eps)
    return (y * (1.0 + bcast(g, x).to(F32))).to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float):
    """Rotary embedding of x [..., t, h, hd] (hd even) at positions [t]
    (int), in float32, back in x's dtype."""
    hd = x.shape[-1]
    half = hd // 2
    freq = torch.pow(torch.tensor(theta, dtype=F32, device=x.device),
                     -torch.arange(0, half, dtype=F32, device=x.device)
                     / half)
    ang = positions.to(F32)[:, None, None] * freq            # [t, 1, half]
    sin, cos = torch.sin(ang), torch.cos(ang)
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def linear(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x [*lead, b, t, d] @ w [*lead, d, f] -> [*lead, b, t, f]: one
    batched product over the replicas, b and t merged into its rows."""
    b, t = x.shape[-3:-1]
    y = x.reshape(x.shape[:-3] + (b * t, x.shape[-1])) @ w
    return y.reshape(x.shape[:-3] + (b, t, w.shape[-1]))


def init_mlp(gen, d: int, ff: int, act: str, device) -> dict:
    p = {"up": he_init(gen, (d, ff), device),
         "down": he_init(gen, (ff, d), device, ff)}
    if act == "swiglu":
        p["gate"] = he_init(gen, (d, ff), device)
    return p


def mlp(p: dict, x: torch.Tensor, act: str = "swiglu") -> torch.Tensor:
    if act == "swiglu":
        h = F.silu(linear(x, p["gate"])) * linear(x, p["up"])
    else:
        h = F.gelu(linear(x, p["up"]), approximate="tanh")
    return linear(h, p["down"])


def init_embed(gen, vocab: int, d: int, device) -> dict:
    return {"table": normal(gen, (vocab, d), device) * 0.02}


def embed(p: dict, tokens: torch.Tensor, scale: bool = False):
    """Rows of the table [*lead, V, d] at tokens [*lead, b, t] -> [*lead,
    b, t, d]: each replica gathers from its own table (one
    ``F.embedding`` over the replicas' tables stacked, whose gradient
    sums the rows in a fixed order on the card)."""
    table = p["table"]
    lead = table.shape[:-2]
    vocab, d = table.shape[-2:]
    n_rep = math.prod(lead)
    offs = (torch.arange(n_rep, device=tokens.device) * vocab).reshape(
        lead + (1,) * (tokens.dim() - len(lead)))
    x = F.embedding(tokens + offs, table.reshape(n_rep * vocab, d))
    if scale:
        x = x * scalar(x, math.sqrt(d))
    return x


def unembed(table: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """x [*lead, b, t, d] -> logits [*lead, b, t, V] against the tied
    table [*lead, V, d]."""
    return linear(x, table.transpose(-1, -2))


def softmax_xent(logits: torch.Tensor, targets: torch.Tensor,
                 mask: torch.Tensor | None = None) -> torch.Tensor:
    """Mean next-token cross-entropy of each replica: logits [*lead, b, t,
    V], targets and mask [*lead, b, t] -> [*lead], in float32.

    The gold logit is gathered (``torch.gather``), where the JAX package
    sums a one-hot product: the same value for finite logits (one term,
    the rest zeros), without an [b, t, V] float32 one-hot a replica."""
    logits = logits.to(F32)
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, targets[..., None].long())[..., 0]
    nll = lse - gold
    if mask is not None:
        denom = torch.clamp_min(torch.sum(mask, dim=(-2, -1)), 1.0)
        return torch.sum(nll * mask, dim=(-2, -1)) / denom
    return torch.mean(nll, dim=(-2, -1))
