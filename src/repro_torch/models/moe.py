"""Mixture-of-Experts block: GShard-style capacity routing, two dispatch
forms.

The JAX package's ``models/moe.py``, its expert sharding
(``moe_specs``) included.  Activations are ``[*lead, b, t, d]``
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

Expert parallelism (``moe_block``'s ``tp``: a model axis above 1 that
divides the expert count): the tokens are the same on every model rank,
so no all-to-all moves them -- JAX's GSPMD inserts one only because it
shards the tokens.  Every rank routes all of them with the replicated
router (the same combine, dispatch and aux loss on each), takes the
[E/M, C] slots of its own experts ``[r*E/M, (r+1)*E/M)`` in either
dispatch form, runs its experts and its share of the combine, and the
share, with the shared experts' and the dense MLP's column-parallel
shares, is summed over the model group once.  The tokens entering the
rank's experts and MLPs are marked ``comm.copy_to_model``, and so is
the combine before the rank takes its experts' slice, so that the
router's gate gradient is summed over the group; the router and its
logits are not marked: the aux loss is whole on every rank, and so is
its gradient.  Experts that do not divide the axis (spec None) run
whole on every rank, unsummed.

Serving over a process mesh (``moe_block``'s ``batch``): the request
rows are split over the pod and data ranks, but the groups are the
whole call's, as in the reference's one logical program -- ``g =
max(1, N // group_tokens)`` groups of ``S = N / g`` of the call's ``N``
tokens in batch order, the capacity from ``S``.  A rank whose tokens
are whole groups routes them alone, with no exchange.  Where a group
straddles batch ranks (a decode step: deepseek-v3's 128 requests are
one group), every batch rank's top-k expert ids ``[n, k]`` cross one
all-gather over the data group and one over the pod group
(``comm.gather_batch``, batch order: pod-major, then data), the
queue positions are :func:`_route`'s cumsum over the whole groups the
rank's tokens touch, and the rank routes its own rows at their places
in those groups (zeros elsewhere).  Routing each rank's rows alone
would shrink ``S``, and with it the capacity and the drops, silently.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.core import comm
from repro_torch.models import layers

F32 = torch.float32


def moe_specs(cfg, model_shards: int) -> dict:
    """The MoE FFN's leaf specs (the JAX ``moe_specs``): the experts
    split over the model axis where their count divides it."""
    e = cfg.moe
    es = (layers.MODEL if (model_shards and e.n_experts % model_shards == 0)
          else None)
    s = {"router": (None, None), "w_gate": (es, None, None),
         "w_up": (es, None, None), "w_down": (es, None, None)}
    if e.n_shared:
        s["shared"] = layers.mlp_specs("swiglu")
    if e.dense_residual_ff:
        s["dense"] = layers.mlp_specs("swiglu")
    return s


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


def _gates(p, xg: torch.Tensor, e):
    """The router on xg [*lead, G, S, d]: (probs [*, G, S, E], the
    renormalised top-k gates [*, G, S, k], their experts [*, G, S, k],
    and those as one-hots sel [*, G, S, k, E] float32)."""
    logits = layers.linear(xg, p["router"]).to(F32)            # [*, G, S, E]
    probs = torch.softmax(logits, dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals, gate_idx = vals[..., :e.top_k], idx[..., :e.top_k]
    gate_vals = gate_vals / torch.clamp_min(
        torch.sum(gate_vals, dim=-1, keepdim=True), 1e-9)
    return (probs, gate_vals, gate_idx,
            F.one_hot(gate_idx, e.n_experts).to(F32))


def _queue(sel, e):
    """Each (token, choice) pair's place in its expert's queue, from sel
    [*, G, S, k, E]: a float32 cumsum over the group's S*k pairs in
    choice order."""
    flat = sel.reshape(sel.shape[:-3] + (-1, e.n_experts))
    return torch.cumsum(flat, dim=-2).reshape(sel.shape) - 1.0


def _slots(sel, gate_vals, pos_in_e, cap: int):
    """(combine, dispatch [*, G, S, E, cap] float32): the pairs whose
    queue position ``pos_in_e`` is below ``cap`` kept, each at slot
    ``pos_in_e``."""
    keep = sel * (pos_in_e < cap)
    # at most one kept choice a (token, expert): sums over k are exact
    kept = keep.sum(dim=-2)                                    # [*, G,S,E]
    pos = (pos_in_e * keep).sum(dim=-2)
    slot = F.one_hot(pos.long(), cap).to(F32)                  # [*,G,S,E,C]
    disp = kept[..., None] * slot
    comb = (keep * gate_vals[..., None]).sum(dim=-2)[..., None] * slot
    return comb, disp


def _aux(sel, probs, e) -> torch.Tensor:
    f_e = torch.mean(sel.sum(dim=-2), dim=(-3, -2))            # [*, E]
    p_e = torch.mean(probs, dim=(-3, -2))
    return e.n_experts * torch.sum(f_e * p_e, dim=-1) * e.aux_loss_coef


def _route(p, xg: torch.Tensor, e):
    """xg [*lead, G, S, d] -> (combine, dispatch [*lead, G, S, E, C]
    float32, the aux loss [*lead], C)."""
    cap = capacity(xg.shape[-2], e)
    probs, gate_vals, _, sel = _gates(p, xg, e)                # [*, G,S,k,E]
    comb, disp = _slots(sel, gate_vals, _queue(sel, e), cap)
    return comb, disp, _aux(sel, probs, e), cap


def batch_ranks(batch) -> tuple[int, int]:
    """(the number of batch ranks, this rank's place among them) of a
    serving topology: its pod and data ranks, pod-major (the JAX
    ``batch_axes``' order); (1, 0) without a mesh."""
    m = None if batch is None else batch.mesh
    if m is None:
        return 1, 0
    return m.pods * m.data, m.pod_rank * m.data + m.data_rank


def _spread(v: torch.Tensor, at: int, rows: int) -> torch.Tensor:
    """v [n, ...] at rows ``[at, at + n)`` of ``rows`` rows, zeros
    elsewhere."""
    return F.pad(v, (0, 0) * (v.dim() - 1) + (at, rows - at - v.shape[0]))


def _route_across(p, x: torch.Tensor, e, batch, s_len: int, at: int,
                  w: int):
    """The rank's n tokens x [n, d] -- global tokens ``[r*n, (r+1)*n)``
    of the call, r its batch rank, ``at`` rows into the first of the
    ``w`` groups of ``s_len`` tokens they touch -- routed by those
    groups: every batch rank's top-k experts gathered
    (``comm.gather_batch``), the queue positions the whole groups'
    (:func:`_queue`), the rank's pairs kept at their rows.  Returns
    (combine, dispatch [w, s_len, E, cap], the rank's aux loss)."""
    n = x.shape[0]
    _, r = batch_ranks(batch)
    probs, gate_vals, idx, sel = _gates(p, x[None], e)         # [1, n, ...]
    first = r * n - at                          # the groups' first token
    every = comm.gather_batch(batch, idx[0].to(torch.int32)).flatten(0, 1)
    ids = every[first:first + w * s_len].long()
    pos_in_e = _queue(F.one_hot(ids, e.n_experts).to(F32).reshape(
        w, s_len, e.top_k, e.n_experts), e)
    grouped = [_spread(v[0], at, w * s_len).reshape((w, s_len) + v.shape[2:])
               for v in (sel, gate_vals)]
    comb, disp = _slots(*grouped, pos_in_e, capacity(s_len, e))
    return comb, disp, _aux(sel, probs, e)


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


def moe_block(p, x: torch.Tensor, cfg, tp=None, batch=None):
    """x [*lead, b, t, d] -> (y [*lead, b, t, d], the aux loss [*lead]);
    with ``tp`` p holds the rank's blocks (the module docstring).
    ``batch`` (serving over a mesh, no lead dims): the topology whose
    pod and data ranks split the call's rows; the groups are the whole
    call's (the module docstring), and the aux loss, which serving does
    not keep, is the rank's rows'."""
    e = cfg.moe
    b, t, d = x.shape[-3:]
    n = b * t
    nb, r = batch_ranks(batch)
    g = max(1, n * nb // e.group_tokens)
    if (n * nb) % g:
        raise ValueError(f"{n * nb} tokens do not split into {g} groups")
    s_len = n * nb // g
    at = r * n % s_len            # the rank's first row in its first group
    w = -(-(at + n) // s_len)     # the groups its tokens touch
    alone = not at and n % s_len == 0     # they are whole groups

    def group(v):                 # [*lead, b, t, d] -> [*lead, w, S, d]
        if alone:
            return v.reshape(v.shape[:-3] + (w, s_len, d))
        return _spread(v.reshape(n, d), at, w * s_len).reshape(w, s_len, d)

    xg = group(x)
    if alone:
        comb, disp, aux, _ = _route(p, xg, e)
    else:
        comb, disp, aux = _route_across(p, x.reshape(n, d), e, batch, s_len,
                                        at, w)
    xm = comm.copy_to_model(tp, x)
    split = tp is not None and e.n_experts % tp.model_shards == 0
    if split:          # the rank's experts' slots
        e_loc = p["w_gate"].shape[-3]
        lo = tp.model_rank * e_loc
        xd = group(xm)
        disp = disp[..., lo:lo + e_loc, :]
        comb = comm.copy_to_model(tp, comb)[..., lo:lo + e_loc, :]
    else:
        xd = xg
    if e.dispatch == "einsum":
        xe = torch.einsum("...gsd,...gsec->...gecd", xd, disp.to(x.dtype))
    else:
        xe = _gather_slots(xd, disp)
    h = (F.silu(torch.einsum("...gecd,...edf->...gecf", xe, p["w_gate"]))
         * torch.einsum("...gecd,...edf->...gecf", xe, p["w_up"]))
    ye = torch.einsum("...gecf,...efd->...gecd", h, p["w_down"])
    y = torch.einsum("...gecd,...gsec->...gsd", ye, comb.to(x.dtype))
    y = (y if alone else y.reshape(-1, d)[at:at + n]).reshape(x.shape)
    # the experts' share and the MLPs' shares, summed over the model
    # group once; experts whole on every rank are added after the sum
    whole = tp is not None and not split
    part = None if whole else y
    for name, on in (("shared", e.n_shared), ("dense", e.dense_residual_ff)):
        if on:
            share = layers.mlp_part(p[name], xm)
            part = share if part is None else part + share
    if part is None:
        return y, aux
    part = comm.sum_model(tp, part)
    return (y + part if whole else part), aux
