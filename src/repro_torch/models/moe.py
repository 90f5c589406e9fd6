"""Mixture-of-Experts block: GShard-style capacity routing, two dispatch
forms.

The JAX package's ``models/moe.py`` (its ``moe_specs``, the expert
sharding, are not ported: item 17d).  Activations are ``[*lead, b, t, d]``
and parameters ``[*lead, *leaf]``, as in ``layers``; each replica's
``n = b*t`` tokens split into ``g = max(1, n // group_tokens)`` groups of
their own (the replica dims are never folded into the groups), and the
load-balancing loss is one value a replica, ``[*lead]``.

Routing (:func:`_route`) computes the router's logits in the compute
dtype, then float32; the softmax; the top-k of each token by a stable
descending sort, so that equal probabilities keep the lower expert first
(``jax.lax.top_k``'s order; ``torch.topk`` promises none); each
(token, choice) pair's place in its expert's queue by a float32 cumsum
over the group's ``S*k`` pairs in choice order; and drops the pairs past
``cap = max(1, int(S * top_k / n_experts * capacity_factor))``.  The
dispatch and combine tensors ``[*lead, g, S, E, C]`` are float32 one-hots
(the combine holds the renormalised gate at the kept slot), built
elementwise: a token's k choices name k different experts, so each
(token, expert) pair holds at most one kept choice, and the reference's
sums over the choices are exact.

Dispatch ``"einsum"`` moves the tokens into the [E, C] slots by a
product with the one-hot (in the compute dtype, exact: one nonzero a
slot); ``"gather"`` takes the same rows by index -- through
``F.embedding``, whose backward on the card sums rows in a fixed order,
where ``torch.gather``'s backward is a nondeterministic ``scatter_add``
-- with an appended zero row for the empty slots.  Both give the same
slots bit for bit; the experts' SwiGLU and the combine product follow
in the compute dtype.  Shared experts (deepseek) and the dense residual
MLP (arctic) add their SwiGLU outputs.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models import layers

F32 = torch.float32


def init_moe(gen, cfg, device) -> dict:
    e, d = cfg.moe, cfg.d_model
    p = {
        "router": layers.he_init(gen, (d, e.n_experts), device),
        "w_gate": layers.he_init(gen, (e.n_experts, d, e.d_expert), device),
        "w_up": layers.he_init(gen, (e.n_experts, d, e.d_expert), device),
        "w_down": layers.he_init(gen, (e.n_experts, e.d_expert, d), device,
                                 e.d_expert),
    }
    if e.n_shared:
        p["shared"] = layers.init_mlp(gen, d, e.n_shared * e.d_expert,
                                      "swiglu", device)
    if e.dense_residual_ff:
        p["dense"] = layers.init_mlp(gen, d, e.dense_residual_ff, "swiglu",
                                     device)
    return p


def capacity(group: int, e) -> int:
    """Slots an expert has in a group of ``group`` tokens (the
    reference's expression, in its order of operations)."""
    return max(1, int(group * e.top_k / e.n_experts * e.capacity_factor))


def _route(p, xg: torch.Tensor, e):
    """xg [*lead, G, S, d] -> (combine, dispatch [*lead, G, S, E, C]
    float32, the aux loss [*lead], C)."""
    s_len = xg.shape[-2]
    cap = capacity(s_len, e)
    logits = layers.linear(xg, p["router"]).to(F32)            # [*, G, S, E]
    probs = torch.softmax(logits, dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals, gate_idx = vals[..., :e.top_k], idx[..., :e.top_k]
    gate_vals = gate_vals / torch.clamp_min(
        torch.sum(gate_vals, dim=-1, keepdim=True), 1e-9)
    sel = F.one_hot(gate_idx, e.n_experts).to(F32)             # [*, G,S,k,E]
    flat = sel.reshape(sel.shape[:-3] + (s_len * e.top_k, e.n_experts))
    pos_in_e = torch.cumsum(flat, dim=-2).reshape(sel.shape) - 1.0
    keep = sel * (pos_in_e < cap)
    # at most one kept choice a (token, expert): sums over k are exact
    kept = keep.sum(dim=-2)                                    # [*, G,S,E]
    pos = (pos_in_e * keep).sum(dim=-2)
    slot = F.one_hot(pos.long(), cap).to(F32)                  # [*,G,S,E,C]
    disp = kept[..., None] * slot
    comb = (keep * gate_vals[..., None]).sum(dim=-2)[..., None] * slot
    f_e = torch.mean(sel.sum(dim=-2), dim=(-3, -2))            # [*, E]
    p_e = torch.mean(probs, dim=(-3, -2))
    aux = e.n_experts * torch.sum(f_e * p_e, dim=-1) * e.aux_loss_coef
    return comb, disp, aux, cap


def _gather_slots(xg: torch.Tensor, disp: torch.Tensor) -> torch.Tensor:
    """The token in each [E, C] slot of each group (zeros where the slot
    is empty): xg [*, G, S, d], disp [*, G, S, E, C] -> [*, G, E, C, d],
    rows taken by ``F.embedding`` over the groups' rows stacked."""
    s_len, d = xg.shape[-2:]
    slot_tok = torch.einsum("...sec,s->...ec", disp,
                            torch.arange(s_len, dtype=F32, device=xg.device))
    occupied = torch.sum(disp, dim=-3) > 0
    idx = torch.where(occupied, slot_tok.long(), s_len)        # [*, G, E, C]
    pad = torch.cat([xg, xg.new_zeros(xg.shape[:-2] + (1, d))], dim=-2)
    n_groups = math.prod(pad.shape[:-2])
    offs = (torch.arange(n_groups, device=xg.device) * (s_len + 1)).reshape(
        pad.shape[:-2] + (1, 1))
    return F.embedding(idx + offs, pad.reshape(n_groups * (s_len + 1), d))


def moe_block(p, x: torch.Tensor, cfg):
    """x [*lead, b, t, d] -> (y [*lead, b, t, d], the aux loss [*lead])."""
    e = cfg.moe
    b, t, d = x.shape[-3:]
    n = b * t
    g = max(1, n // e.group_tokens)
    xg = x.reshape(x.shape[:-3] + (g, n // g, d))
    comb, disp, aux, _ = _route(p, xg, e)
    if e.dispatch == "einsum":
        xe = torch.einsum("...gsd,...gsec->...gecd", xg, disp.to(x.dtype))
    else:
        xe = _gather_slots(xg, disp)
    h = (F.silu(torch.einsum("...gecd,...edf->...gecf", xe, p["w_gate"]))
         * torch.einsum("...gecd,...edf->...gecf", xe, p["w_up"]))
    ye = torch.einsum("...gecf,...efd->...gecd", h, p["w_down"])
    y = torch.einsum("...gecd,...gsec->...gsd", ye, comb.to(x.dtype))
    y = y.reshape(x.shape)
    if e.n_shared:
        y = y + layers.mlp(p["shared"], x)
    if e.dense_residual_ff:
        y = y + layers.mlp(p["dense"], x)
    return y, aux
