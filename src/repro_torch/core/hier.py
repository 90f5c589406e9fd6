"""HierSignSGD / DC-HierSignSGD train step on one card (the paper's core).

The replicated regime of the JAX package's ``core/hier.py``.  Each
``train_step`` call is one local step tau.  At a round boundary
(``step % t_e == 0``) a prologue first runs

  1. the cloud aggregation ``v_q <- sum_q (D_q/N) v_q`` (Alg. 1/2's
     end-of-round step, folded into the next step's prologue), and
  2. (DC only) the anchor pass: ``c_q = sum_k (|D_qk|/D_q) grad f_qk(w)``,
     ``c = sum_q (D_q/N) c_q``, ``delta_q = c - c_q``.  With
     ``anchor_staleness=1`` (the paper's pipelined variant) the fresh
     delta is staged and the previous round's is used; ``0`` uses it at
     once.

Then the local step: per-device gradients -> ``+ rho*delta`` (DC) ->
sign -> majority vote over the D devices of each edge ->
``v_q <- v_q - mu * vote``.

P (edges) and D (devices) are the leading dims of every tensor on one
card: per-device gradients come from autograd over ``[P, D, *leaf]``
copies of the edge models (``vmap`` written out as batch dims).

Transports (``core.votes``): ``ag_packed``, ``ar_int8`` and ``fused``,
bitwise identical.  State layouts: ``tree`` keeps the master as a dict of
``[P, *leaf]`` tensors; ``flat`` keeps it AS a ``core.flatbuf`` buffer,
and with ``fused`` the whole update is one ``sign_pack`` and one
``vote_update`` launch that writes the master buffer **in place** (the
state passed in is updated; clone it first to keep it).  Both layouts
give bitwise identical trajectories.

Virtual clients (``AlgoConfig.clients``, ``core.clients``): with an
active config each device hosts K clients.  A per-round participation
mask (pinned to ``(seed, step // t_e)``) times ``dev_mask`` and the
integer |D_qk| weights give the int32 vote weights of the weighted
popcount, and the anchor mean reweights to the participating shares.
``mode="merged"`` carves the device batch into the voter axis
``[P, D*K, b/K, ...]`` and votes as above; ``mode="stream"`` loops over
the K clients inside the step, one client's gradient live at a time,
folding each one's signs into an integer tally (on the fused transport
one ``tally_acc`` launch per client) and thresholding after the loop --
bitwise the merged trajectory.

Ported: methods ``hier_signsgd`` and ``dc_hier_signsgd``, ``decay``,
``anchor_staleness`` 0 and 1, virtual clients (merged and stream), the
sync cloud schedule (the cloud mean is applied at the boundary that
issues it).  Everything else raises ``NotImplementedError`` naming its
ROADMAP item.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple

import torch

from repro_torch.core import clients as vclients
from repro_torch.core import flatbuf, pytree, signs, votes
from repro_torch.core.topology import Topology

PyTree = Any

SIGN_METHODS = ("hier_signsgd", "dc_hier_signsgd", "scaffold_hier_signsgd",
                "mtgc_hier_signsgd")
CLIENT_CORRECTION_METHODS = ("scaffold_hier_signsgd", "mtgc_hier_signsgd")
ALL_METHODS = SIGN_METHODS + ("hier_sgd", "hier_local_qsgd")
CLOUD_OVERLAP_MODES = ("sync", "overlap")


@dataclasses.dataclass(frozen=True)
class AlgoConfig:
    """The JAX package's ``AlgoConfig``, field for field."""
    method: str = "dc_hier_signsgd"
    mu: float = 1e-3                  # sign-step size
    mu_sgd: float = 0.1               # full-precision baseline step size
    t_e: int = 15                     # local steps per global round
    rho: float = 0.2                  # correction strength (DC)
    transport: str = "ag_packed"      # ag_packed | ar_int8 | fused
    state_layout: str = "tree"        # tree | flat
    anchor_staleness: int = 1         # 1 = paper's pipelined delta, 0 = fresh
    cloud_period: int = 2             # MTGC slow timescale
    cloud_overlap: str = "sync"       # cloud sync schedule
    clients: vclients.ClientConfig = vclients.ClientConfig()
    error_feedback: bool = False
    momentum: float = 0.0
    compute_dtype: torch.dtype = torch.bfloat16
    master_dtype: torch.dtype = torch.float32
    delta_dtype: torch.dtype = torch.bfloat16
    decay: bool = False               # mu_t = mu / sqrt(round + 1)

    def __post_init__(self):
        if self.method not in ALL_METHODS:
            raise ValueError(
                f"unknown method {self.method!r} (choose from "
                f"{', '.join(ALL_METHODS)})")
        if self.transport not in votes.SIGN_TRANSPORTS:
            raise ValueError(f"unknown transport {self.transport!r}")
        if self.state_layout not in ("tree", "flat"):
            raise ValueError(f"unknown state_layout {self.state_layout!r}")
        if self.cloud_period < 1:
            raise ValueError(
                f"cloud_period must be >= 1, got {self.cloud_period}")
        if self.cloud_overlap not in CLOUD_OVERLAP_MODES:
            raise ValueError(
                f"unknown cloud_overlap {self.cloud_overlap!r} (choose "
                f"from {', '.join(CLOUD_OVERLAP_MODES)})")

    @property
    def is_dc(self) -> bool:
        return self.method == "dc_hier_signsgd"


class TrainState(NamedTuple):
    """Training state.  Under ``state_layout="flat"`` params / delta /
    delta_next are ``flatbuf.FlatState`` buffers [P, n_pad]; the deltas
    are None where the config does not read them.  The JAX state's slots
    for unported options (staged aggregate, error feedback, momentum,
    client corrections) come with the slices that fill them."""
    step: int                         # global step counter t * T_E + tau
    params: PyTree                    # [P, ...] per-edge models v_q
    delta: PyTree | None              # [P, ...] active correction c - c_q
    delta_next: PyTree | None         # staged delta (anchor_staleness=1)
    rng: torch.Generator              # for the stochastic baselines (item
                                      # 8); the ported methods draw nothing


@dataclasses.dataclass(frozen=True)
class ModelBundle:
    """What a model provides to train under the hierarchy.

    loss(params_dev, batch) -> [P, D] -- the mean loss of every (edge,
        device) replica: params_dev is a tree of [P, D, *leaf] copies and
        batch a tree of [P, D, b, ...] arrays; the gradient of the sum
        with respect to params_dev is the paper's per-device gradients.
    """
    loss: Callable[[PyTree, Any], torch.Tensor]
    param_mode: str = "replicated"    # the FSDP regime is not ported


def _refuse_unported(algo: AlgoConfig, bundle: ModelBundle) -> None:
    if bundle.param_mode != "replicated":
        raise NotImplementedError(
            f"param_mode={bundle.param_mode!r}: only the replicated regime "
            "is ported (FSDP: ROADMAP queue 1 item 17)")
    if algo.method in ("hier_sgd", "hier_local_qsgd"):
        raise NotImplementedError(
            f"method {algo.method!r} is not ported yet: ROADMAP queue 1 "
            "item 8")
    if algo.method in CLIENT_CORRECTION_METHODS:
        raise NotImplementedError(
            f"method {algo.method!r} is not ported yet: ROADMAP queue 1 "
            "item 9")
    if algo.error_feedback or algo.momentum > 0.0:
        raise NotImplementedError(
            "error feedback and sign momentum are not ported yet: ROADMAP "
            "queue 1 item 8")
    if algo.cloud_overlap != "sync":
        raise NotImplementedError(
            "cloud_overlap='overlap' is not ported yet: ROADMAP queue 1 "
            "item 12")


def make_hier_step(topo: Topology, algo: AlgoConfig, bundle: ModelBundle):
    """Build (init_fn, train_step).

    train_step(state, batch, edge_weights, dev_weights, dev_mask)
        -> (state, metrics)

    batch: {'train': tree of [P, D, b, ...], 'anchor': optional same};
    edge_weights: [P] = D_q/N; dev_weights: [P, D] = |D_qk|/D_q (with
    active clients, the per-device factor of the participating shares);
    dev_mask: [P, D] float in {0, 1}, the vote quorum, or with active
    clients optionally [P, D, K] per client.  Inputs are moved to
    ``topo.device``.  The returned state may share (and, with the fused
    flat update, has overwritten) the input state's buffers.
    """
    _refuse_unported(algo, bundle)
    p, d = topo.pods, topo.devices_per_pod
    t_e = algo.t_e
    flat = algo.state_layout == "flat"
    fold_dc = algo.transport == "fused" and algo.is_dc
    dev = topo.device
    cc = algo.clients
    virtual = cc.active
    k = cc.count
    stream = virtual and cc.mode == "stream"
    d_virtual = d * k                 # the merged voter axis
    # merged means re-associate to the streamed fold order (K clients,
    # then D devices) so both modes share one trajectory
    k_merge = k if virtual else None
    vote_bound = cc.weight_bound(p, d) if virtual else None
    w_int = (torch.as_tensor(cc.weight_array(p, d), device=dev)
             if virtual else None)                          # [P, D, K] int32
    part_cache: dict[int, torch.Tensor] = {}

    def participation(rnd_index: int) -> torch.Tensor:
        """The round's [P, D, K] mask, drawn on the host once per round."""
        if rnd_index not in part_cache:
            part_cache.clear()
            part_cache[rnd_index] = torch.as_tensor(
                vclients.participation_mask(cc, p, d, rnd_index),
                device=dev)
        return part_cache[rnd_index]

    def per_device_grads(params_tree, batch, devices=d_virtual):
        """[P, V, *leaf] gradients of every voter's loss at its copy of
        its edge's model (V = D*K merged voters, or the D devices of one
        streamed client), in the compute dtype, plus the [P, V] losses.
        The copies are fresh contiguous tensors, so the gradient is the
        same whether the model came from a tree or from flat views."""
        leaves, td = pytree.tree_flatten(params_tree)
        copies = [
            leaf.detach().unsqueeze(1)
            .expand((p, devices) + tuple(leaf.shape[1:]))
            .to(algo.compute_dtype).contiguous().requires_grad_(True)
            for leaf in leaves]
        with torch.enable_grad():
            losses = bundle.loss(pytree.tree_unflatten(td, copies), batch)
            grads = torch.autograd.grad(losses.sum(), copies)
        return pytree.tree_unflatten(td, list(grads)), losses.detach()

    def pod_avg(params, edge_w):
        if flat:
            return params.replace(
                votes.pod_weighted_average(params.buf, edge_w))
        return pytree.tree_map(
            lambda v: votes.pod_weighted_average(v, edge_w), params)

    def anchor_fold_stream(params_tree, batch, shares3, to_acc):
        """The streamed anchor: a zeros-initialised fold over the K
        clients of each device's share-weighted gradient, one client's
        gradient live at a time -- the order ``weighted_mean_dev(...,
        clients=K)`` adds the merged voter axis in."""
        acc = None
        for c in range(k):
            g_c, _ = per_device_grads(
                params_tree, vclients.client_slice(batch, k, c),
                devices=d)
            g_c = to_acc(g_c)
            sh = shares3[:, :, c]
            term = pytree.tree_map(
                lambda g: g * sh.reshape(sh.shape + (1,) * (g.dim() - 2)),
                g_c)
            if acc is None:
                acc = pytree.tree_map(torch.zeros_like, term)
            acc = pytree.tree_map(torch.add, acc, term)
        return pytree.tree_map(votes.fold_devices, acc)

    def compute_delta(params, batch, edge_w, dev_w):
        """The anchor pass at the freshly aggregated edge models; dev_w is
        [P, D] (no clients), [P, D*K] (merged) or [P, D, K] (stream)."""
        dd = algo.delta_dtype
        if flat:
            layout = params.layout
            if stream:
                c_q = anchor_fold_stream(
                    params.tree(), batch, dev_w,
                    lambda g: flatbuf.flatten_tree(layout, g, 2,
                                                   torch.float32))
            else:
                g_dev, _ = per_device_grads(params.tree(), batch)
                g_buf = flatbuf.flatten_tree(layout, g_dev, 2, torch.float32)
                c_q = votes.weighted_mean_dev(g_buf, dev_w, clients=k_merge)
            c = votes.pod_weighted_average(c_q, edge_w)
            return flatbuf.FlatState((c - c_q).to(dd),
                                     flatbuf.with_dtype(layout, dd))
        if stream:
            c_q = anchor_fold_stream(
                params, batch, dev_w,
                lambda g: pytree.tree_map(lambda x: x.to(torch.float32), g))
        else:
            g_dev, _ = per_device_grads(params, batch)
            c_q = pytree.tree_map(
                lambda g: votes.weighted_mean_dev(g.to(torch.float32), dev_w,
                                                  clients=k_merge), g_dev)
        c = pytree.tree_map(
            lambda v: votes.pod_weighted_average(v, edge_w), c_q)
        return pytree.tree_map(lambda a, b: (a - b).to(dd), c, c_q)

    def corrected(u_dev, delta_tree):
        """u + rho*delta in each leaf's dtype (the non-folded DC path)."""
        return pytree.tree_map(
            lambda u, dl: u + flatbuf.scaled(dl[:, None].to(u.dtype),
                                             algo.rho),
            u_dev, delta_tree)

    def vote_tree(s_dev, vote_w):
        return pytree.tree_map(
            lambda s: votes.majority_vote_dev(s, vote_w, algo.transport,
                                              weight_bound=vote_bound),
            s_dev)

    def local_step_tree(params, delta, batch, vote_w, mu):
        u_dev, losses = per_device_grads(params, batch)
        if algo.is_dc and not fold_dc:
            u_dev = corrected(u_dev, delta)
        if algo.transport == "fused":
            direction = votes.fused_sign_vote(
                u_dev, delta if fold_dc else None,
                algo.rho if fold_dc else 0.0, vote_w)
        else:
            direction = vote_tree(pytree.tree_map(signs.sgn, u_dev), vote_w)
        new = pytree.tree_map(lambda v, s: signs.descend(v, mu, s), params,
                              direction)
        return new, losses

    def local_step_flat(params, delta, batch, vote_w, mu):
        layout = params.layout
        u_dev, losses = per_device_grads(params.tree(), batch)
        if algo.is_dc and not fold_dc:
            u_dev = corrected(u_dev, delta.tree(cast=False))
        if algo.transport == "fused":
            # ONE sign_pack + ONE vote_update launch; mu folds into the
            # kernel when it does not change with the step
            new_buf = votes.fused_sign_vote_update(
                layout, u_dev, delta.buf if fold_dc else None,
                algo.rho if fold_dc else 0.0, vote_w, params.buf, mu,
                mu_static=None if algo.decay else algo.mu)
            return params.replace(new_buf), losses
        direction = vote_tree(pytree.tree_map(signs.sgn, u_dev), vote_w)
        dir_buf = flatbuf.flatten_tree(layout, direction, 1, params.buf.dtype)
        return params.replace(signs.descend(params.buf, mu, dir_buf)), losses

    def local_step_stream(params, delta, batch, vote_w3, mu):
        """mode='stream': loop over the K clients with one client's
        gradient live at a time; each client's signs fold, weighted, into
        a persistent integer tally (a flat [P, D, n_pad] buffer and one
        ``tally_acc`` launch per client on the fused transport, per-leaf
        tallies otherwise), thresholded after the loop.  vote_w3 is the
        [P, D, K] int32 vote weight."""
        params_tree = params.tree() if flat else params
        acc_dt = votes.tally_dtype(vote_bound)
        delta_tree = None
        if algo.is_dc and not fold_dc:
            delta_tree = delta.tree(cast=False) if flat else delta
        if algo.transport == "fused":
            if flat:
                vlayout = params.layout
            else:     # only the per-device shapes matter to the layout
                vlayout = flatbuf.make_layout(pytree.tree_map(
                    lambda v: torch.empty((p, d) + tuple(v.shape[1:]),
                                          device="meta"), params_tree),
                    batch_dims=2)
            tally = torch.zeros((p, d, vlayout.n_pad), dtype=acc_dt,
                                device=dev)
        else:
            tally = pytree.tree_map(
                lambda v: torch.zeros((p, d) + tuple(v.shape[1:]),
                                      dtype=acc_dt, device=dev), params_tree)
        losses = []
        for c in range(k):
            u_c, loss_c = per_device_grads(
                params_tree, vclients.client_slice(batch, k, c),
                devices=d)
            losses.append(loss_c)
            w_c = vote_w3[:, :, c]
            if delta_tree is not None:
                u_c = corrected(u_c, delta_tree)
            if algo.transport == "fused":
                tally = votes.fused_sign_tally_accumulate(
                    vlayout, u_c,
                    delta if (fold_dc and not flat) else None,
                    delta.buf if (fold_dc and flat) else None,
                    algo.rho if fold_dc else 0.0, w_c, tally)
            else:
                tally = pytree.tree_map(
                    lambda t, s: votes.tally_add_signs(t, s, w_c), tally,
                    pytree.tree_map(signs.sgn, u_c))
        losses = torch.stack(losses, dim=2).reshape(p, d * k)
        n_eff = torch.sum(vote_w3, dim=(1, 2), dtype=torch.int32)
        if algo.transport == "fused":
            if flat:
                return params.replace(votes.fused_tally_finish(
                    vlayout, tally, n_eff, params.buf, mu)), losses
            direction = votes.fused_tally_finish(vlayout, tally, n_eff,
                                                 None, None)
        else:
            direction = pytree.tree_map(
                lambda t: votes.tally_vote_dev(t, n_eff), tally)
        if flat:
            dir_buf = flatbuf.flatten_tree(params.layout, direction, 1,
                                           params.buf.dtype)
            return (params.replace(signs.descend(params.buf, mu, dir_buf)),
                    losses)
        return pytree.tree_map(lambda v, s: signs.descend(v, mu, s), params,
                               direction), losses

    def on_device(tree):
        return pytree.tree_map(lambda x: torch.as_tensor(x, device=dev), tree)

    def train_step(state: TrainState, batch, edge_weights, dev_weights,
                   dev_mask):
        edge_weights, dev_weights, dev_mask = (
            torch.as_tensor(x, device=dev)
            for x in (edge_weights, dev_weights, dev_mask))
        maskf = dev_mask.to(torch.float32)
        rnd_index = state.step // t_e
        vote_w3 = None
        if not virtual:
            if maskf.dim() != 2:
                raise ValueError(
                    "a client-granular [P, D, K] dev_mask requires an "
                    "active AlgoConfig.clients; without virtual clients "
                    "the step takes the [P, D] device mask")
            vote_w = maskf > 0.5
            shares = dev_weights
            carve = lambda b: b                                # noqa: E731
        else:
            if maskf.dim() == 3 and maskf.shape[2] != k:
                raise ValueError(
                    f"dev_mask client dim {maskf.shape[2]} != K={k}")
            maskf3 = maskf if maskf.dim() == 3 else maskf[:, :, None]
            part = participation(rnd_index) * maskf3           # [P, D, K]
            # int32 vote weights: |D_qk| never round through a float
            vote_w3 = w_int * part.to(torch.int32)
            vote_w = vote_w3.reshape(p, d_virtual)
            shares = vclients.participating_shares(
                dev_weights.to(torch.float32), w_int.to(torch.float32), part)
            if stream:
                shares = shares.reshape(p, d, k)
                carve = lambda b: b                            # noqa: E731
            else:
                carve = lambda b: vclients.carve_batch(b, k)   # noqa: E731
        train_batch = carve(on_device(batch["train"]))
        anchor_batch = carve(on_device(batch.get("anchor", batch["train"])))
        params, delta, delta_next = state.params, state.delta, state.delta_next
        if state.step % t_e == 0:
            # the prologue: the cloud mean (sync), then the anchor
            params = pod_avg(params, edge_weights)
            if algo.is_dc:
                fresh = compute_delta(params, anchor_batch, edge_weights,
                                      shares)
                if algo.anchor_staleness == 1:
                    delta, delta_next = delta_next, fresh
                else:
                    delta = fresh
        # flushed once here (signs.descend takes it so): on the host, and
        # with decay once more on the card
        mu = signs.ftz(torch.tensor(algo.mu, dtype=algo.master_dtype)).to(dev)
        if algo.decay:
            mu = signs.ftz(mu / torch.sqrt(torch.tensor(
                float(rnd_index), dtype=algo.master_dtype, device=dev) + 1.0))
        if stream:
            params, losses = local_step_stream(params, delta, train_batch,
                                               vote_w3, mu)
        else:
            step_fn = local_step_flat if flat else local_step_tree
            params, losses = step_fn(params, delta, train_batch, vote_w, mu)
        new_state = state._replace(step=state.step + 1, params=params,
                                   delta=delta, delta_next=delta_next)
        losses = losses.to(torch.float32)
        metrics = {"loss": losses.mean(), "loss_per_pod": losses.mean(1),
                   "mu": mu}
        return new_state, metrics

    def init_fn(params_single: PyTree, seed: int = 0) -> TrainState:
        """params_single: one replica's parameters (no leading dims),
        copied to P edge models in the master dtype on ``topo.device``."""
        params_tree = pytree.tree_map(
            lambda x: torch.as_tensor(x, device=dev).unsqueeze(0)
            .expand((p,) + tuple(x.shape)).to(algo.master_dtype)
            .contiguous(), params_single)
        if flat:
            layout = flatbuf.make_layout(params_tree, batch_dims=1)
            params = flatbuf.FlatState(
                flatbuf.flatten_tree(layout, params_tree, 1), layout)

            def zeros_m(dt):
                return flatbuf.FlatState(
                    torch.zeros((p, layout.n_pad), dtype=dt, device=dev),
                    flatbuf.with_dtype(layout, dt))
        else:
            params = params_tree

            def zeros_m(dt):
                return pytree.tree_map(
                    lambda v: torch.zeros_like(v, dtype=dt), params_tree)
        dd = algo.delta_dtype
        delta = zeros_m(dd) if algo.is_dc else None
        delta_next = (zeros_m(dd) if algo.is_dc and algo.anchor_staleness == 1
                      else None)
        rng = torch.Generator(device=dev)
        rng.manual_seed(seed)
        return TrainState(step=0, params=params, delta=delta,
                          delta_next=delta_next, rng=rng)

    return init_fn, train_step


def edge_params(state: TrainState) -> PyTree:
    """The [P, *leaf] edge models of a state as a tree, in either layout
    (flat views alias the buffer)."""
    if isinstance(state.params, flatbuf.FlatState):
        return state.params.tree()
    return state.params
