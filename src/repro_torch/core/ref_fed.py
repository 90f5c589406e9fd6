"""Reference (oracle) implementation of the paper's algorithms.

The JAX package's ``core/ref_fed.py`` in PyTorch: a faithful,
loop-over-clusters transcription of Algorithm 1 (HierSignSGD) and
Algorithm 2 (DC-HierSignSGD), plus the two baselines the paper compares
against (HierSGD and the Hier-Local-QSGD-style ternary-quantized
variant), plus the two related-work drift corrections that share DC's
pre-sign slot: SCAFFOLD-style per-client control variates
(scaffold_hier_signsgd) and MTGC's multi-timescale edge/cloud correction
(mtgc_hier_signsgd, arXiv:2409.18448) -- see ``global_round`` for the
exact update rules.

It is the ground truth for ``repro_torch.core.hier``'s fused step: one
client and one edge at a time, in Python loops, with none of the step's
machinery -- no flat buffers, no packed transport, no kernel.  It carries
the full virtual-client semantics of ``core.clients`` (per-round
participation masks, integer |D_qk| vote weights with empty-quorum
abstention, participating-share reweighting of the anchor and mean
aggregations: K virtual clients per slice are simply K more entries per
edge), the chaos schedule's per-step masks (``device_mask_steps``) and
closing cloud weights (``edge_weights_agg``), and the cloud sync
schedule.

Arithmetic.  Each operation rounds as the JAX oracle's eager operations
do on XLA's CPU backend: one operation at a time (a product is rounded
before the sum it enters, never fused), a Python scalar rounded to the
tensor's dtype first, and subnormal operands and results taken as the
zero of their sign.  The weighted sums fold in client order from the
first product (``_tree_weighted_sum``), as the step's means fold
(``votes.weighted_mean_dev`` and ``pod_weighted_average``); ``sgn`` is
``x > -FLT_MIN`` and ties vote +1 (``core.signs``).  So with the same
gradients it is the JAX oracle bit for bit, on any device.

Gradients come from a user-supplied ``grad_fn(params, device_batch, rng)
-> grads`` on parameter trees (nested dicts of tensors, ``core.pytree``),
``rng`` a ``torch.Generator`` or None, passed through as given.  The
QSGD baseline's uniforms come from a callable of the train step's form
(``core.hier.Uniforms``: ``uniforms(step, leaf_index, (P, V, *leaf),
voters)``), asked for one voter at a time, so the oracle and the step
can quantize with the same numbers.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Sequence

import torch

from repro_torch.core import pytree, schedule, signs

PyTree = Any
GradFn = Callable[[PyTree, Any, "torch.Generator | None"], PyTree]
Uniforms = Callable[[int, int, tuple, range], torch.Tensor]

SIGN_METHODS = ("hier_signsgd", "dc_hier_signsgd", "scaffold_hier_signsgd",
                "mtgc_hier_signsgd")
CLIENT_CORRECTION_METHODS = ("scaffold_hier_signsgd", "mtgc_hier_signsgd")

tmap = pytree.tree_map


@dataclasses.dataclass
class HierConfig:
    """Hyper-parameters shared by all hierarchical methods (paper Table I)."""
    mu: float = 5e-3            # step-size (mu)
    t_e: int = 15               # local steps per global round (T_E)
    rho: float = 0.2            # correction strength (DC / scaffold / mtgc)
    method: str = "dc_hier_signsgd"  # hier_sgd | hier_local_qsgd |
                                # hier_signsgd | dc_hier_signsgd |
                                # scaffold_hier_signsgd | mtgc_hier_signsgd
    mu_sgd: float = 1.0         # step-size for the full-precision baselines
    decay: bool = False         # mu_t = mu0/sqrt(t+1) (paper's CIFAR setting)
    cloud_period: int = 2       # mtgc only: rounds between eta refreshes
    cloud_overlap: Any = "sync"  # cloud sync schedule: "sync" | "overlap",
                                # or an explicit ``schedule.CloudSchedule``

    def cloud_schedule(self) -> schedule.CloudSchedule:
        if isinstance(self.cloud_overlap, schedule.CloudSchedule):
            return self.cloud_overlap
        return schedule.CloudSchedule.from_mode(self.cloud_overlap)


@dataclasses.dataclass
class FedState:
    """Cloud + per-edge state across global rounds.

    corr_cl / corr_edge are the scaffold/mtgc correction states
    (lazy-initialized to zeros on the first ``global_round`` once the
    per-edge client counts are known from the batch structure):
    scaffold keeps c_local per client in corr_cl[q][k] and one
    c_global copy per edge in corr_edge[q]; mtgc keeps gamma_qk in
    corr_cl[q][k] and eta_q in corr_edge[q]."""
    w: PyTree                         # global model w^(t)
    delta: list[PyTree]               # per-edge correction c^(t-1) - c_q^(t-1)
    round: int = 0
    corr_cl: list[list[PyTree]] | None = None
    corr_edge: list[PyTree] | None = None
    w_inflight: PyTree | None = None  # cloud_overlap="overlap" only: the
                                      # aggregate issued at this round's
                                      # opening boundary, committed one
                                      # boundary later (lazy-initialized
                                      # on the first round to the opening
                                      # weights' sum of Q copies of w)


def loss_grad_fn(loss: Callable[[PyTree, Any], torch.Tensor],
                 copies: tuple[int, int] = (1, 1)) -> GradFn:
    """A ``grad_fn`` from a ``ModelBundle.loss`` (``loss(params_dev,
    batch) -> [P, D]`` on ``[P, D, *leaf]`` copies): one client's
    gradient, taken with the step's own loss and autograd on a
    ``copies`` block of copies of its parameters, its batch given the
    same leading dims, read at copy [0, 0].  (1, 1) takes one copy; the
    step's (P, D) gives every library call the shape it has in the
    step, so where a library picks its kernel by the shape (cuBLAS on
    the card) the gradient is bitwise the step's per-voter gradient.
    ``rng`` is not read."""
    lead = tuple(copies)

    def grad_fn(params, batch, rng=None):
        leaves, td = pytree.tree_flatten(params)
        blocks = [leaf.detach().expand(lead + tuple(leaf.shape)).clone()
                  .requires_grad_(True) for leaf in leaves]
        b = tmap(lambda x: torch.as_tensor(x).expand(
            lead + tuple(x.shape)).clone(), batch)
        with torch.enable_grad():
            out = loss(pytree.tree_unflatten(td, blocks), b)
            grads = torch.autograd.grad(out.sum(), blocks)
        return pytree.tree_unflatten(td, [g[0, 0] for g in grads])
    return grad_fn


def init_state(w0: PyTree, num_edges: int) -> FedState:
    zeros = lambda: tmap(torch.zeros_like, w0)                 # noqa: E731
    return FedState(w=w0, delta=[zeros() for _ in range(num_edges)], round=0)


# -- one eager operation at a time, as XLA's CPU backend rounds it ----------

def _scalar(a, x: torch.Tensor) -> torch.Tensor:
    """A Python scalar (or 0-dim tensor) in x's dtype and device: JAX's
    rule for a weakly typed scalar meeting an array."""
    if isinstance(a, torch.Tensor):
        return a.to(dtype=x.dtype, device=x.device)
    return torch.tensor(float(a), dtype=x.dtype, device=x.device)


def _mul(a, x: torch.Tensor) -> torch.Tensor:
    """``a * x``, subnormal operands and result flushed."""
    return signs.ftz(signs.ftz(_scalar(a, x)) * signs.ftz(x))


def _add(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return signs.ftz(signs.ftz(x) + signs.ftz(y))


def _sub(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return signs.ftz(signs.ftz(x) - signs.ftz(y))


def _tree_axpy(a, x: PyTree, y: PyTree) -> PyTree:
    return tmap(lambda u, v: _add(_mul(a, u), v), x, y)


def _tree_weighted_sum(weights: Sequence[float],
                       trees: Sequence[PyTree]) -> PyTree:
    """``sum_i weights[i] * trees[i]`` folded in order from the first
    product (the JAX oracle's fold, and the step's means')."""
    acc = tmap(lambda x: _mul(weights[0], x), trees[0])
    for wgt, t in zip(weights[1:], trees[1:]):
        acc = tmap(lambda a, x, wgt=wgt: _add(a, _mul(wgt, x)), acc, t)
    return acc


def regroup_client_data(nested: Sequence[Sequence[Any]], assignment,
                        n_edges: int) -> list[list[Any]]:
    """Per-client data assignment: regroup nested per-client oracle
    inputs (``nested[q][k]`` -- batch lists, anchor batches, vote
    weights, aggregation shares, anything indexed client-first-by-edge)
    under a server-side edge assignment.

    ``assignment[s]`` is the ORIGINAL flat client index (edge-major,
    client k of edge q is ``q*K + k``) that occupies flat slot ``s``
    after regrouping -- the output of ``data.cluster.assignment_order``,
    and the same permutation ``core.clients.regroup_clients`` applies to
    the step's carved row blocks."""
    flat = [c for edge in nested for c in edge]
    idx = [int(i) for i in assignment]
    if sorted(idx) != list(range(len(flat))):
        raise ValueError(
            f"assignment must permute all {len(flat)} clients: {idx}")
    if len(flat) % n_edges:
        raise ValueError(
            f"{len(flat)} clients do not fill {n_edges} equal edges")
    cap = len(flat) // n_edges
    return [[flat[idx[q * cap + j]] for j in range(cap)]
            for q in range(n_edges)]


def _participating_shares(weights: Sequence[float],
                          mask: Sequence[bool] | None) -> list[float]:
    """Per-edge aggregation shares renormalized to the participating
    clients: w_k m_k / sum_j w_j m_j (python-float arithmetic; all
    zeros when the whole edge is masked out, so the aggregate is the
    zero tree)."""
    m = ([1.0] * len(weights) if mask is None
         else [1.0 if b else 0.0 for b in mask])
    raw = [float(w) * mm for w, mm in zip(weights, m)]
    tot = sum(raw)
    return [r / tot if tot > 0 else 0.0 for r in raw]


def _quantize(g: PyTree, uniforms: Uniforms, step: int, edges: int, q: int,
              k: int) -> PyTree:
    """Client k of edge q: each leaf ternary-quantized with its own l2
    norm (``signs.ternary_quantize``) and the uniforms the step would
    give voter k of edge q at ``step``."""
    leaves, td = pytree.tree_flatten(g)
    out = []
    for i, leaf in enumerate(leaves):
        u = torch.as_tensor(uniforms(step, i, (edges, 1) + tuple(leaf.shape),
                                     range(k, k + 1)))
        out.append(signs.ternary_quantize(
            leaf, u[q, 0].to(device=leaf.device, dtype=torch.float32)))
    return pytree.tree_unflatten(td, out)


def global_round(
    state: FedState,
    cfg: HierConfig,
    grad_fn: GradFn,
    batches: Sequence[Sequence[Any]],       # [q][k] -> T_E device batches
    anchor_batches: Sequence[Sequence[Any]],  # [q][k] -> one batch
    edge_weights: Sequence[float],          # D_q / N
    device_weights: Sequence[Sequence[float]],  # |D_qk| / D_q
    rng: torch.Generator | None = None,
    device_mask: Sequence[Sequence[bool]] | None = None,
    vote_weights: Sequence[Sequence[int]] | None = None,
    reweight_participation: bool = False,
    device_mask_steps: Sequence[Sequence[Sequence[bool]]] | None = None,
    edge_weights_agg: Sequence[float] | None = None,
    uniforms: Uniforms | None = None,
) -> FedState:
    """Run one global round t (T_E local steps + cloud aggregation).

    Transcribes Algorithm 2 exactly; Algorithm 1 is the rho=0 / no-anchor
    special case; baselines replace the sign/vote with full-precision or
    ternary-quantized averaging.

    Virtual-client semantics (mirroring ``core.hier``'s active
    ``ClientConfig``): a "device" k here is any client under edge q --
    virtual clients are simply more entries in ``batches[q]``.

    rng: handed to every ``grad_fn`` call as it is.
    device_mask: per-client participation of THIS round ({0,1}).
    vote_weights: optional integer data shares |D_qk| weighting the
        majority vote (weighted popcount, combined with the mask; an
        edge whose whole quorum abstains votes 0, leaving v_q unchanged
        for the round -- ties still resolve sgn(0)=+1).  ``None`` keeps
        the unit-weight vote.
    reweight_participation: renormalize ``device_weights`` to the
        participating clients for the anchor pass and the
        full-precision edge means (``device_weights`` may then be
        UNNORMALIZED raw shares).  False: the mask gates the vote only.
    device_mask_steps: optional per-local-step masks (length ``t_e``;
        chaos-schedule semantics: local step tau uses
        ``device_mask_steps[tau]``, as the step reads fresh membership
        arrays every step, while the participation draw is per round).
        ``device_mask`` stays the ROUND mask -- it gates the anchor
        shares and the correction-state refresh, like the step's round
        prologue (= the tau-0 mask under churn).
    edge_weights_agg: optional cloud-aggregation weights for THIS
        round's closing ``w_next`` (default ``edge_weights``).  The step
        aggregates round t in the prologue of step (t+1)*T_E, i.e. with
        the NEXT round's edge weights -- under churn the two differ.
    uniforms: hier_local_qsgd's uniforms, as ``make_hier_step(...,
        uniforms=)`` takes them: asked as ``uniforms(step, leaf, (P, 1,
        *leaf), range(k, k + 1))`` for client k of every edge at local
        step ``step = round * t_e + tau``; the oracle reads edge q's row.
    """
    q_edges = len(batches)
    mu = cfg.mu if cfg.method in SIGN_METHODS else cfg.mu_sgd
    if cfg.decay:
        mu = signs.ftz(torch.tensor(mu, dtype=torch.float32)
                       / torch.sqrt(torch.tensor(state.round + 1.0,
                                                 dtype=torch.float32)))
    if cfg.method == "hier_local_qsgd" and uniforms is None:
        raise ValueError("hier_local_qsgd needs the uniforms callable "
                         "(the step's, ``core.hier.Uniforms``)")

    # ---- cloud sync schedule (core.schedule): under "overlap" the round
    # runs from the COMMITTED (one-boundary-stale) aggregate -- which is
    # exactly ``state.w`` here, committed by the previous call -- while
    # ``state.w_inflight`` holds the aggregate issued at this round's
    # opening boundary, to be committed at the close.  Lazy first-round
    # init: the edges all hold w0 at the opening boundary, so the issued
    # aggregate is the opening weights' sum of Q copies of w.
    sched = cfg.cloud_schedule()
    w_inflight = state.w_inflight
    if sched.staged and w_inflight is None:
        w_inflight = _tree_weighted_sum(
            [float(x) for x in edge_weights], [state.w] * q_edges)

    def edge_shares(q, mask=None):
        if not reweight_participation:
            return device_weights[q]
        if mask is None:
            mask = device_mask
        return _participating_shares(
            device_weights[q], None if mask is None else mask[q])

    new_delta = list(state.delta)
    edge_models: list[PyTree] = []
    anchors_cq: list[PyTree] = []

    # ---- anchor gradients at w^(t) (DC only):
    # c_q^(t) = sum_k w_qk grad f_qk(w)
    if cfg.method == "dc_hier_signsgd":
        for q in range(q_edges):
            g_devs = [grad_fn(state.w, anchor_batches[q][k], rng)
                      for k in range(len(anchor_batches[q]))]
            anchors_cq.append(_tree_weighted_sum(edge_shares(q), g_devs))
        c_glob = _tree_weighted_sum(edge_weights, anchors_cq)

    # ---- scaffold / mtgc correction refresh at w^(t) (fresh semantics:
    # the refreshed state is used by THIS round's local steps, as the
    # step's round prologue refreshes it)
    corr_cl, corr_edge = state.corr_cl, state.corr_edge
    if cfg.method in CLIENT_CORRECTION_METHODS:
        zeros = lambda: tmap(torch.zeros_like, state.w)        # noqa: E731
        if corr_cl is None:
            corr_cl = [[zeros() for _ in anchor_batches[q]]
                       for q in range(q_edges)]
        if corr_edge is None:
            corr_edge = [zeros() for _ in range(q_edges)]

        def participates(q, k):
            """The step's EF carry-forward gate (vote weight > 0): only
            meaningful on the reweighting (virtual-client) path; the
            legacy path updates unconditionally."""
            if not reweight_participation:
                return True
            ok = device_mask is None or bool(device_mask[q][k])
            if vote_weights is not None:
                ok = ok and vote_weights[q][k] > 0
            return ok

        anchors = [[grad_fn(state.w, anchor_batches[q][k], rng)
                    for k in range(len(anchor_batches[q]))]
                   for q in range(q_edges)]

        if cfg.method == "scaffold_hier_signsgd":
            # c_global absorbs the share-weighted drift sum_qk (a - c_local)
            # (abstainers enter with zero participating share), THEN the
            # participating clients refresh c_local <- a_qk -- option-I
            # control variates; telescopes under full participation.
            upd = [_tree_weighted_sum(
                       edge_shares(q),
                       [tmap(_sub, anchors[q][k], corr_cl[q][k])
                        for k in range(len(anchors[q]))])
                   for q in range(q_edges)]
            drift = _tree_weighted_sum(edge_weights, upd)
            corr_edge = [tmap(_add, corr_edge[q], drift)
                         for q in range(q_edges)]
            corr_cl = [[anchors[q][k] if participates(q, k)
                        else corr_cl[q][k]
                        for k in range(len(anchors[q]))]
                       for q in range(q_edges)]
        else:  # mtgc: gamma every round, eta every cloud_period rounds;
            # an edge whose whole quorum abstains keeps BOTH its terms
            # (c still sums the abstained edges' zero c_q, like DC)
            c_qs = [_tree_weighted_sum(edge_shares(q), anchors[q])
                    for q in range(q_edges)]
            c = _tree_weighted_sum(edge_weights, c_qs)
            if state.round % cfg.cloud_period == 0:
                corr_edge = [
                    tmap(_sub, c, c_qs[q])
                    if any(participates(q, k)
                           for k in range(len(anchors[q])))
                    else corr_edge[q]
                    for q in range(q_edges)]
            corr_cl = [[tmap(_sub, c_qs[q], anchors[q][k])
                        if participates(q, k) else corr_cl[q][k]
                        for k in range(len(anchors[q]))]
                       for q in range(q_edges)]

    # ---- T_E local steps per edge (paper: in parallel over q)
    for q in range(q_edges):
        v = state.w
        delta_q = state.delta[q]
        for tau in range(cfg.t_e):
            # churn semantics: the membership mask of local step tau
            # (the step reads fresh membership arrays every step; the
            # round mask is the tau-0 / prologue view)
            mask_tau = (device_mask if device_mask_steps is None
                        else device_mask_steps[tau])
            g_devs = [grad_fn(v, batches[q][k][tau], rng)
                      for k in range(len(batches[q]))]

            if cfg.method in SIGN_METHODS:
                # device-side (corrected) sign -> 1-bit uplink -> majority
                # vote; scaffold/mtgc put their per-client correction in
                # the same pre-sign slot as DC's shared delta
                rho = cfg.rho
                if cfg.method == "dc_hier_signsgd":
                    sign_devs = [tmap(
                        lambda g, d: signs.sgn(_add(g, _mul(rho, d))),
                        g, delta_q) for g in g_devs]
                elif cfg.method == "scaffold_hier_signsgd":
                    sign_devs = [tmap(
                        lambda g, e, cv: signs.sgn(
                            _add(g, _mul(rho, _sub(e, cv)))),
                        g_devs[k], corr_edge[q], corr_cl[q][k])
                        for k in range(len(g_devs))]
                elif cfg.method == "mtgc_hier_signsgd":
                    sign_devs = [tmap(
                        lambda g, cv, e: signs.sgn(
                            _add(g, _mul(rho, _add(cv, e)))),
                        g_devs[k], corr_cl[q][k], corr_edge[q])
                        for k in range(len(g_devs))]
                else:
                    sign_devs = [tmap(signs.sgn, g) for g in g_devs]
                mask_q = None
                if mask_tau is not None:
                    mask_q = torch.tensor([int(bool(b)) for b in mask_tau[q]],
                                          dtype=torch.int32)
                if vote_weights is not None:
                    vw = torch.tensor([int(x) for x in vote_weights[q]],
                                      dtype=torch.int32)
                    mask_q = vw if mask_q is None else vw * mask_q
                vote = tmap(
                    lambda *s: signs.majority_vote(torch.stack(s), mask_q,
                                                   axis=0),
                    *sign_devs)
                v = tmap(lambda p, s: _sub(p, _mul(mu, s.to(p.dtype))), v,
                         vote)
            elif cfg.method == "hier_sgd":
                g_edge = _tree_weighted_sum(edge_shares(q, mask_tau), g_devs)
                v = _tree_axpy(-mu, g_edge, v)
            elif cfg.method == "hier_local_qsgd":
                step = state.round * cfg.t_e + tau
                q_devs = [_quantize(g, uniforms, step, q_edges, q, k)
                          for k, g in enumerate(g_devs)]
                g_edge = _tree_weighted_sum(edge_shares(q, mask_tau), q_devs)
                v = _tree_axpy(-mu, g_edge, v)
            else:
                raise ValueError(cfg.method)
        edge_models.append(v)
        if cfg.method == "dc_hier_signsgd":
            new_delta[q] = tmap(_sub, c_glob, anchors_cq[q])

    # ---- cloud aggregation: w^(t+1) = sum_q (D_q/N) v_q^(t, T_E)
    # (under membership churn the closing weights are the NEXT round's
    # edge weights -- the step's prologue view; see ``edge_weights_agg``).
    # The schedule decides what lands: sync commits the freshly issued
    # aggregate; overlap commits the one issued at this round's OPENING
    # boundary (``w_inflight``, its weights pinned to issue time) and
    # stages the fresh one.
    issued = _tree_weighted_sum(
        edge_weights if edge_weights_agg is None else edge_weights_agg,
        edge_models)
    w_next, w_inflight = sched.commit(issued, w_inflight)
    return FedState(w=w_next, delta=new_delta, round=state.round + 1,
                    corr_cl=corr_cl, corr_edge=corr_edge,
                    w_inflight=w_inflight)
