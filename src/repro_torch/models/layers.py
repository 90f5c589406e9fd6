"""Basic neural blocks of the LM zoo, in PyTorch.

The JAX package's ``models/layers.py``, with its ``*_specs`` sharding
helpers (a spec is a tuple over the leaf's dims of None or ``"model"``,
or None for a replicated leaf).  Every
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

Tensor parallelism (``tp``: the topology of a model axis above 1, as
``models.build`` passes it; None runs the one-replica arithmetic): a
rank holds its blocks of the leaves the specs split and the functions
here run Megatron's pattern on them -- ``embed`` looks up its vocab
rows (other tokens masked to zero) and sums over the model group;
``mlp`` takes ``up``/``gate`` column-parallel and ``down`` row-parallel
and sums; ``unembed`` is column-parallel over the vocab and
``softmax_xent`` vocab-parallel (the max, the sum of exponentials and
the gold logit each reduced over the model group).  ``comm.copy_to_model``
marks each whole activation a rank reads through its own blocks, so its
gradient is summed back over the group.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.core import comm

F32 = torch.float32
MODEL = "model"


def mlp_specs(act: str = "swiglu") -> dict:
    s = {"up": (None, MODEL), "down": (MODEL, None)}
    if act == "swiglu":
        s["gate"] = (None, MODEL)
    return s


def embed_specs(vocab: int = 0, model_shards: int = 0) -> dict:
    """Vocab-sharded when the vocabulary divides the model axis,
    replicated otherwise (whisper's 51865)."""
    return {"table": (MODEL if vocab_sharded(vocab, model_shards) else None,
                      None)}


def vocab_sharded(vocab: int, model_shards: int) -> bool:
    return bool(model_shards and vocab and vocab % model_shards == 0)


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


def mlp(p: dict, x: torch.Tensor, act: str = "swiglu",
        tp=None) -> torch.Tensor:
    """The MLP; with ``tp`` the rank's ff columns of ``up``/``gate`` and
    rows of ``down``, the product summed over the model group."""
    x = comm.copy_to_model(tp, x)
    if act == "swiglu":
        h = F.silu(linear(x, p["gate"])) * linear(x, p["up"])
    else:
        h = F.gelu(linear(x, p["up"]), approximate="tanh")
    return comm.sum_model(tp, linear(h, p["down"]))


def init_embed(gen, vocab: int, d: int, device) -> dict:
    return {"table": normal(gen, (vocab, d), device) * 0.02}


def _vocab_block(tokens: torch.Tensor, vocab_loc: int, tp):
    """tokens -> (their rows in this rank's vocab block, whether they
    fall in it)."""
    local = tokens - tp.model_rank * vocab_loc
    inside = (local >= 0) & (local < vocab_loc)
    return torch.where(inside, local, torch.zeros_like(local)), inside


def embed(p: dict, tokens: torch.Tensor, scale: bool = False, tp=None):
    """Rows of the table [*lead, V, d] at tokens [*lead, b, t] -> [*lead,
    b, t, d]: each replica gathers from its own table (one
    ``F.embedding`` over the replicas' tables stacked, whose gradient
    sums the rows in a fixed order on the card).  With ``tp`` and the
    table's vocab rows split, a rank looks up the tokens of its block,
    zeros the others and the ranks' rows are summed (one nonzero term a
    token: exact)."""
    table = p["table"]
    lead = table.shape[:-2]
    vocab, d = table.shape[-2:]
    inside = None
    if tp is not None:
        tokens, inside = _vocab_block(tokens, vocab, tp)
    n_rep = math.prod(lead)
    offs = (torch.arange(n_rep, device=tokens.device) * vocab).reshape(
        lead + (1,) * (tokens.dim() - len(lead)))
    x = F.embedding(tokens + offs, table.reshape(n_rep * vocab, d))
    if inside is not None:
        x = comm.sum_model(tp, torch.where(inside[..., None], x,
                                           torch.zeros_like(x)))
    if scale:
        x = x * scalar(x, math.sqrt(d))
    return x


def unembed(table: torch.Tensor, x: torch.Tensor, tp=None) -> torch.Tensor:
    """x [*lead, b, t, d] -> logits [*lead, b, t, V] against the tied
    table [*lead, V, d] (with ``tp``, the logits of the rank's vocab
    block)."""
    return linear(comm.copy_to_model(tp, x), table.transpose(-1, -2))


def softmax_xent(logits: torch.Tensor, targets: torch.Tensor,
                 mask: torch.Tensor | None = None, tp=None) -> torch.Tensor:
    """Mean next-token cross-entropy of each replica: logits [*lead, b, t,
    V], targets and mask [*lead, b, t] -> [*lead], in float32.

    The gold logit is gathered (``torch.gather``), where the JAX package
    sums a one-hot product: the same value for finite logits (one term,
    the rest zeros), without an [b, t, V] float32 one-hot a replica.
    With ``tp`` the logits are the rank's vocab block: the log-sum-exp
    takes the model group's max and its summed exponentials, and the
    gold logit is summed from the rank that holds it."""
    logits = logits.to(F32)
    if tp is None:
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, targets[..., None].long())[..., 0]
    else:
        # vocab-parallel: logits are this rank's vocab block
        top = comm.max_model(tp, logits.detach().amax(dim=-1))
        lse = top + torch.log(comm.sum_model(tp, torch.sum(
            torch.exp(logits - top[..., None]), dim=-1)))
        local, inside = _vocab_block(targets.long(), logits.shape[-1], tp)
        gold = torch.gather(logits, -1, local[..., None])[..., 0]
        gold = comm.sum_model(tp, torch.where(inside, gold,
                                              torch.zeros_like(gold)))
    nll = lse - gold
    if mask is not None:
        denom = torch.clamp_min(torch.sum(mask, dim=(-2, -1)), 1.0)
        return torch.sum(nll * mask, dim=(-2, -1)) / denom
    return torch.mean(nll, dim=(-2, -1))
