"""The hierarchical train steps on one card (the paper's core).

The replicated regime of the JAX package's ``core/hier.py``: all six
methods -- ``hier_signsgd``, ``dc_hier_signsgd``, the pre-sign client
corrections ``scaffold_hier_signsgd`` and ``mtgc_hier_signsgd``, and the
full-precision baselines ``hier_sgd`` and ``hier_local_qsgd`` -- with
error feedback, sign momentum, ``decay``, ``anchor_staleness`` 0 and 1,
virtual clients (merged and stream) and the cloud sync schedule
(``core.schedule``: ``sync`` or ``overlap``).

Each ``train_step`` call is one local step tau.  At a round boundary
(``step % t_e == 0``) a prologue first runs

  1. the cloud tier: the aggregate ``sum_q (D_q/N) v_q`` is issued and,
     by the schedule, committed at once (``sync``) or one boundary later
     (``overlap``: the edges run from the aggregate staged in
     ``TrainState.agg_next`` at the previous boundary);
  2. the anchors at the committed model: DC's ``delta_q = c - c_q``
     (staged one round with ``anchor_staleness=1``), SCAFFOLD's control
     variates or MTGC's edge and cloud terms (``compute_corrections``).

Then the local step.  Sign methods: per-device gradients -> momentum ->
``+ e`` (EF) -> ``+ rho*delta`` (DC) or ``+ rho*q`` (SCAFFOLD/MTGC) ->
sign (EF keeps the residual) -> majority vote over the D devices of each
edge -> ``v_q <- v_q - mu * vote``.  Mean methods: per-device gradients
(ternary-quantized for QSGD) -> share-weighted mean -> ``v_q <- v_q -
mu_sgd * mean``.

P (edges) and D (devices) are the leading dims of every tensor on one
card: per-device gradients come from autograd over ``[P, D, *leaf]``
copies of the edge models (``vmap`` written out as batch dims).

Over a process mesh (``Topology.mesh``, ``launch.mesh``) each rank holds
the block ``[P_loc, D_loc]`` of edges and devices: its state is its
edges' models (``[P_loc, ...]``; the ranks of a pod row hold the same
copies) and its voters' slots (``[P_loc, D_loc*K, ...]``, see
:func:`state_blocks`), its batch its block of the global batch.  The
membership arrays stay global; the step takes each rank's block of
them, and the vote masks are its edges' whole ``[P_loc, D*K]`` rows.
Every reduction over D or P crosses ranks in ``core.votes`` (the words
gathered and voted, the integer tallies summed, the float terms
gathered and folded in the one-process order), the QSGD uniforms are
drawn for the global block and sliced, and ``metrics["loss"]`` is the
mean of the gathered ``[P, D*K]`` losses -- so a mesh run is the
one-process run's, bitwise, given the same per-device gradients.  The
FSDP regime under a mesh is ROADMAP item 17c (``NotImplementedError``).

With a model axis above 1 (``topo.model_shards``) and a bundle with
``specs``, the parameters are laid out by the sharded flat
layout (``core.shardflat``, the JAX ``hier.py``'s sharded init): each
rank holds model shard ``model_rank`` of every leaf the specs split --
its bucket ``[P_loc, bucket_pad]`` in the flat layout, or its blocks at
the padded block size in the tree layout (an uneven last block's zero
tail is don't-care) -- and every other leaf whole.  The bundle's loss
runs tensor-parallel on the rank's blocks, cut to their logical rows
(``shardflat.logical``), and returns each block's gradient and the
whole gradient of every copy.  Every step above is coordinatewise on
the rank's blocks, so the words still cross the data group only; the
two sums that span a leaf -- QSGD's norm and EF's ``mean|u|`` -- are
formed over the rank's logical coordinates and summed over the model
group (``comm.sum_model``), and a shard's QSGD uniforms
are its slice of the whole leaf's draw.

Transports (``core.votes``): ``ag_packed``, ``ar_int8`` and ``fused``,
bitwise identical.  State layouts: ``tree`` keeps the master (and every
other slot) as dicts of ``[P, *leaf]`` / ``[P, D*K, *leaf]`` tensors;
``flat`` keeps them AS ``core.flatbuf`` buffers, and with ``fused`` the
sign methods' update is one ``sign_pack`` and one ``vote_update`` launch
that writes the master buffer **in place** (the state passed in is
updated; clone it first to keep it).  Both layouts give bitwise
identical trajectories.  The fused transport folds DC's one shared delta
into its kernels; SCAFFOLD/MTGC's per-client corrections are added
before it, and error feedback, which needs the explicit per-leaf signs,
takes the per-leaf route up to the vote (then ``vote_update``'s
vote-only form on ``fused``).

Virtual clients (``AlgoConfig.clients``, ``core.clients``): with an
active config each device hosts K clients.  A per-round participation
mask (pinned to ``(seed, step // t_e)``) times ``dev_mask`` and the
integer |D_qk| weights give the int32 vote weights of the weighted
popcount; the anchor and mean aggregations reweight to the participating
shares, and only clients with a live vote refresh their EF residual and
correction terms.  ``mode="merged"`` carves the device batch into the
voter axis ``[P, D*K, b/K, ...]``; ``mode="stream"`` loops over the K
clients inside the step, one client's gradient live at a time, folding
each one's signs into an integer tally (on the fused transport one
``tally_acc`` launch per client; per leaf under EF) or its weighted
gradient into an f32 accumulator (mean methods) -- bitwise the merged
trajectory.

The QSGD uniforms: every client c has its own stream per leaf and
step, a generator on the step's device seeded with :func:`key_seed` of
(the state generator's seed, step, leaf, c) that fills the ``[P, D,
*leaf]`` block of its voters, or they come from the ``uniforms``
callable given to :func:`make_hier_step`.  A leaf's draws are made just
before its quantization: the K blocks stacked to ``[P, D*K, *leaf]``
merged, client c's block inside the streamed loop (so stream mode holds
one client's draws of one leaf at a time, and both modes draw the same
numbers, K draws a leaf).
Each leaf is quantized as ``P*D*K`` rows with their own l2 norms,
``ternary_quant`` launches on CUDA (``kernels.ops.ternary_quant_rows``:
one, or more where the rows hold 2^31 coordinates or more).

The FSDP regime (``ModelBundle.param_mode="fsdp"``, the JAX package's
``fsdp_lift`` path): the bundle's ``loss_master`` takes the ``[P,
*leaf]`` masters and lifts each layer to its ``[P, D, *leaf]`` copies
inside its forward (``core.device_axis``); the lift's backward is the
compression -- ``sgn(g + rho*delta)`` and the vote over D (``wmean`` for
the mean methods and DC's anchor pass) -- so autograd returns each
master's per-edge direction and no whole-model ``[P, D, n]`` gradient
forms.  The update is the tree layout's ``v - mu * direction``, written
**into the state's master in place**, as is the round's cloud mean, and
DC's fresh anchor goes into the buffer of the delta it replaces (the
regime exists for models whose state the card holds once, not twice).
The state is the tree layout's with ``delta`` for every method (threaded
through the lift; read with DC's ``rho``) and no ``ef``/``mom``.  As in
the reference, the FSDP regime takes neither the flat layout, virtual
clients, SCAFFOLD/MTGC nor the overlapped cloud (``ValueError``); its
two quirks are the reference's own (ROADMAP section 3):
``hier_local_qsgd`` takes the ``wmean`` of the raw gradients, and
``error_feedback`` / ``momentum`` are dropped.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, NamedTuple

import torch

from repro_torch.core import clients as vclients
from repro_torch.core import (comm, device_axis, flatbuf, pytree, schedule,
                              shardflat, signs, votes)
from repro_torch.core.keys import key_seed
from repro_torch.core.topology import Topology
from repro_torch.kernels import ops as kops

PyTree = Any
F32 = torch.float32

SIGN_METHODS = ("hier_signsgd", "dc_hier_signsgd", "scaffold_hier_signsgd",
                "mtgc_hier_signsgd")
CLIENT_CORRECTION_METHODS = ("scaffold_hier_signsgd", "mtgc_hier_signsgd")
ALL_METHODS = SIGN_METHODS + ("hier_sgd", "hier_local_qsgd")
CLOUD_OVERLAP_MODES = schedule.CLOUD_OVERLAP_MODES


@dataclasses.dataclass(frozen=True)
class AlgoConfig:
    """The JAX package's ``AlgoConfig``, field for field."""
    method: str = "dc_hier_signsgd"
    mu: float = 1e-3                  # sign-step size
    mu_sgd: float = 0.1               # full-precision baseline step size
    t_e: int = 15                     # local steps per global round
    rho: float = 0.2                  # correction strength (DC/SCAFFOLD/MTGC)
    transport: str = "ag_packed"      # ag_packed | ar_int8 | fused
    state_layout: str = "tree"        # tree | flat
    anchor_staleness: int = 1         # 1 = paper's pipelined delta, 0 = fresh
    cloud_period: int = 2             # MTGC: rounds between eta refreshes
    cloud_overlap: str = "sync"       # cloud sync schedule: sync | overlap
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
    def is_sign(self) -> bool:
        return self.method in SIGN_METHODS

    @property
    def is_dc(self) -> bool:
        return self.method == "dc_hier_signsgd"

    @property
    def is_scaffold(self) -> bool:
        return self.method == "scaffold_hier_signsgd"

    @property
    def is_mtgc(self) -> bool:
        return self.method == "mtgc_hier_signsgd"

    @property
    def has_client_correction(self) -> bool:
        """Per-client correction state in the pre-sign slot (corr_cl +
        corr_edge): SCAFFOLD's control variates or MTGC's terms."""
        return self.method in CLIENT_CORRECTION_METHODS

    @property
    def is_overlap(self) -> bool:
        return self.cloud_overlap == "overlap"

    @property
    def cloud_schedule(self) -> schedule.CloudSchedule:
        """The cloud sync schedule (issue/commit latency) of this config."""
        return schedule.CloudSchedule.from_mode(self.cloud_overlap)


class TrainState(NamedTuple):
    """Training state, in the JAX ``TrainState``'s field order.  Under
    ``state_layout="flat"`` every slot but step and rng is a
    ``flatbuf.FlatState``: ``[P, n_pad]`` for the master-shaped slots and
    ``[P, D*K, n_pad]`` (``batch_dims=2``) for the per-voter ones.  Each
    optional slot is None where the config does not read it."""
    step: int                         # global step counter t * T_E + tau
    params: PyTree                    # [P, ...] per-edge models v_q
    agg_next: PyTree | None           # [P, ...] staged in-flight cloud
                                      # aggregate (cloud_overlap="overlap")
    delta: PyTree | None              # [P, ...] active correction c - c_q
    delta_next: PyTree | None         # staged delta (anchor_staleness=1)
    ef: PyTree | None                 # [P, D*K, ...] error-feedback residual
    mom: PyTree | None                # [P, D*K, ...] sign-momentum buffer
    corr_cl: PyTree | None            # [P, D*K, ...] per-client correction:
                                      # SCAFFOLD c_local / MTGC gamma_qk
    corr_edge: PyTree | None          # [P, ...] per-edge correction term:
                                      # SCAFFOLD c_global / MTGC eta_q
    rng: torch.Generator              # its initial_seed() keys the QSGD
                                      # uniforms (key_seed)


@dataclasses.dataclass(frozen=True)
class ModelBundle:
    """What a model provides to train under the hierarchy.

    loss(params_dev, batch) -> [P, D] -- the mean loss of every (edge,
        device) replica: params_dev is a tree of [P, D, *leaf] copies and
        batch a tree of [P, D, b, ...] arrays; the gradient of the sum
        with respect to params_dev is the paper's per-device gradients.
    loss_master(params, delta, batch, lift) -> (sum, [P, D] losses) --
        the FSDP regime only: params and delta are the [P, *leaf] masters
        and corrections, and the model applies ``lift(tree, delta_tree)``
        (``core.device_axis.fsdp_lift_tree``) to each layer's slices
        inside its forward.
    """
    loss: Callable[[PyTree, Any], torch.Tensor] | None
    loss_master: Callable | None = None
    param_mode: str = "replicated"    # replicated | fsdp
    specs: PyTree | None = None   # leaf specs over the model axis
                                  # (None: nothing shards)


# (step, leaf_index, shape [P, V, *leaf], voters) -> float32 uniforms in
# [0, 1): ``voters`` is the range of V voters on the merged D*K axis whose
# draws are asked for (all of them, or one streamed client's D)
Uniforms = Callable[[int, int, tuple, range], torch.Tensor]


def _check_fsdp(algo: AlgoConfig) -> None:
    """The reference's refusals of the FSDP regime (``ValueError``, each
    naming the replicated regime)."""
    if algo.state_layout == "flat":
        raise ValueError(
            "state_layout='flat' requires the replicated regime (the FSDP "
            "lift votes per layer, so the whole-model buffer never forms)")
    if algo.clients.active:
        raise ValueError(
            "virtual clients (clients count/participation/weights) require "
            "the replicated regime: the FSDP lift votes per layer with "
            "physical-device masks")
    if algo.has_client_correction:
        raise ValueError(
            f"{algo.method} requires the replicated regime: its per-client "
            "correction state (corr_cl) rides the explicit voter axis, "
            "which the FSDP lift never materializes")
    if algo.is_overlap:
        raise ValueError(
            "cloud_overlap='overlap' requires the replicated regime: the "
            "staged in-flight aggregate (agg_next) is a whole-model master "
            "snapshot, which the FSDP lift's per-layer vote never "
            "materializes")


def make_hier_step(topo: Topology, algo: AlgoConfig, bundle: ModelBundle,
                   uniforms: Uniforms | None = None):
    """Build (init_fn, train_step).

    train_step(state, batch, edge_weights, dev_weights, dev_mask)
        -> (state, metrics)

    batch: {'train': tree of [P, D, b, ...], 'anchor': optional same};
    edge_weights: [P] = D_q/N; dev_weights: [P, D] = |D_qk|/D_q (with
    active clients, the per-device factor of the participating shares);
    dev_mask: [P, D] float in {0, 1}, the vote quorum, or with active
    clients optionally [P, D, K] per client.  Inputs are moved to
    ``topo.device``.  The returned state may share (and, with the fused
    flat update or under FSDP, has overwritten) the input state's
    buffers.

    uniforms: where ``hier_local_qsgd`` takes its uniforms, called per
    leaf and step as ``uniforms(step, leaf_index, (P, V, *leaf),
    voters)``, ``voters`` the range of the V voters asked for on the
    merged D*K axis: all D*K merged, ``range(c, D*K, K)`` for streamed
    client c; it must give the same numbers to a voter whatever range
    asks.  None draws each client's ``[P, D, *leaf]`` block from its own
    seeded stream (:func:`key_seed` of the state generator's seed, step,
    leaf and client).  The draws are the same in both layouts and both
    client modes.
    """
    fsdp = bundle.param_mode == "fsdp"
    if fsdp:
        if topo.mesh is not None:
            raise NotImplementedError(
                "the FSDP regime over a process mesh (the per-layer lift's "
                "all-gather and its vote's reduce-scatter across ranks, at "
                f"any model axis; this one's is {topo.model_shards}) is "
                "ROADMAP item 17c")
        _check_fsdp(algo)
    # the rank's block (the whole without a mesh) and the global P x D
    p, d = topo.local_pods, topo.local_devices
    pg, dg = topo.pods, topo.devices_per_pod
    rows = topo.pod_rows
    t_e = algo.t_e
    flat = algo.state_layout == "flat"
    # DC's correction, or under FSDP every method's: the lift threads
    # delta through the loss (read only with DC's rho)
    needs_delta = fsdp or algo.is_dc
    dev = topo.device
    ef_on = algo.error_feedback
    mom_on = algo.momentum > 0.0
    # the fused transport's kernel route for the sign methods; EF needs
    # the explicit per-leaf signs, so it runs the per-leaf route up to
    # the vote.  Only DC's one shared delta folds into the kernels.
    fuse = algo.is_sign and algo.transport == "fused" and not ef_on
    fold_dc = fuse and algo.is_dc
    cloud_sched = algo.cloud_schedule
    cc = algo.clients
    virtual = cc.active
    k = cc.count
    stream = virtual and cc.mode == "stream"
    d_virtual = d * k                 # the rank's merged voter axis
    dg_virtual = dg * k               # an edge's whole merged voter axis
    vcols = topo.voter_cols(k)        # the rank's voters on it
    # merged means re-associate to the streamed fold order (K clients,
    # then D devices) so both modes share one trajectory
    k_merge = k if virtual else None
    vote_bound = cc.weight_bound(pg, dg) if virtual else None
    w_int = (torch.as_tensor(cc.weight_array(pg, dg), device=dev)
             if virtual else None)                          # [P, D, K] int32
    part_cache: dict[int, torch.Tensor] = {}
    tmap = pytree.tree_map
    # the sharded layout of the [P, *leaf] master, set by init_fn (a
    # one-bucket layout where nothing shards)
    sharding: dict[str, flatbuf.FlatLayout] = {}

    def shard_layout() -> flatbuf.FlatLayout | None:
        """The master's sharded layout, or None where nothing shards."""
        if topo.model_shards == 1 or bundle.specs is None:
            return None
        if "layout" not in sharding:
            raise RuntimeError("a model-sharded step needs its state from "
                               "init_fn (which lays the master out)")
        lay = sharding["layout"]
        return lay if lay.shards > 1 else None

    def sharded_slots(tree) -> list:
        """Each leaf's slot where it is model-sharded, else None."""
        lay = shard_layout()
        if lay is None:
            return [None] * len(pytree.tree_flatten(tree)[0])
        return [s if s.shard_dim is not None else None for s in lay.slots]

    def leaf_sums(x, slot):
        """[P, V, *leaf] -> [P*V] sums of each row over the leaf's logical
        coordinates, in ``signs.row_sums``' order; for a sharded leaf the
        rank's logical rows, then the sum over the model group."""
        rows = x.shape[0] * x.shape[1]
        if slot is None:
            return signs.row_sums(x.reshape(rows, -1))
        x = x.narrow(2 + slot.shard_dim, 0, slot.local_extent(
            topo.model_shards, topo.model_rank))
        return comm.sum_model(topo, signs.row_sums(x.reshape(rows, -1)))

    def participation(rnd_index: int) -> torch.Tensor:
        """The round's global [P, D, K] mask, drawn on the host once per
        round."""
        if rnd_index not in part_cache:
            part_cache.clear()
            part_cache[rnd_index] = torch.as_tensor(
                vclients.participation_mask(cc, pg, dg, rnd_index),
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
        lay = shard_layout()
        with torch.enable_grad():
            tree = pytree.tree_unflatten(td, copies)
            if lay is not None:     # the blocks' logical rows (views)
                tree = shardflat.logical(topo, lay, tree, 2)
            losses = bundle.loss(tree, batch)
            grads = torch.autograd.grad(losses.sum(), copies)
        return pytree.tree_unflatten(td, list(grads)), losses.detach()

    def pod_mean(tree, edge_w):
        """The cloud mean of a tree or of a bare buffer."""
        return tmap(lambda v: votes.pod_weighted_average(v, edge_w, topo),
                    tree)

    def mean_dev(x, shares):
        """The share-weighted mean over an edge's voters of the rank's
        [P_loc, V_loc, *leaf] terms (shares: the edges' [P_loc, V] rows)."""
        return votes.weighted_mean_dev(x, shares, clients=k_merge, topo=topo)

    def fold_dev(acc):
        return votes.fold_devices(acc, topo)

    def pod_avg(params, edge_w):
        if flat:
            return params.replace(pod_mean(params.buf, edge_w))
        if fsdp:          # into the masters, in place (see the docstring)
            return tmap(lambda v: chunked(
                lambda x: votes.pod_weighted_average(x, edge_w), v, v),
                params)
        return pod_mean(params, edge_w)

    def wmul(x, sh):
        """[P, V, *leaf] x [P, V] shares, a subnormal product flushed (as
        the means flush theirs: ``votes.weighted_mean_dev``)."""
        return signs.ftz_(x * sh.reshape(sh.shape + (1,) * (x.dim() - 2)))

    def fold_sum(acc, term):
        """The streamed zeros-initialised fold, one term at a time (the
        order and flush ``weighted_mean_dev(clients=K)`` adds the merged
        axis with), into ``acc`` in place."""
        if acc is None:
            acc = tmap(torch.zeros_like, term)
        return tmap(lambda a, t: signs.ftz_(a.add_(t)), acc, term)

    def merge_clients(per_client):
        """K trees of [P, D, *leaf] -> one of [P, D*K, *leaf] (voter
        d*K + c is client c of device d)."""
        return tmap(lambda *xs: torch.stack(xs, dim=2).reshape(
            (p, d_virtual) + tuple(xs[0].shape[2:])), *per_client)

    def take(tree3, c):
        return tmap(lambda x: x[:, :, c], tree3)

    def views3(slot):
        """A per-voter slot as [P, D, K, *leaf] views (stream mode)."""
        t = slot.tree(cast=False) if flat else slot
        return tmap(lambda x: x.reshape((p, d, k) + tuple(x.shape[2:])), t)

    def as_flat(like, tree):
        """A per-voter [P, D*K, *leaf] f32 tree into ``like``'s slot."""
        if not flat:
            return tree
        return like.replace(flatbuf.flatten_tree(like.layout, tree, 2, F32))

    # -- the shared per-leaf pieces of the local step, used verbatim by
    # every layout and mode, so their bitwise contract lives in one place

    draw_gen = torch.Generator(device=dev)      # reseeded for every client

    def leaf_uniforms(state, i, leaf_shape, voters: range, slot=None):
        """Leaf i's uniforms for ``voters`` of an edge's whole merged
        axis: drawn for every edge, [P, len(voters), *leaf] float32, and
        the rank's block of them returned (over a mesh, the draws of
        the one-process run, sliced; a model-sharded leaf's ``slot``
        gives its whole logical shape, and the rank keeps its block)."""
        if slot is not None:
            u = leaf_uniforms(state, i, slot.global_shape(topo.model_shards),
                              voters)
            return flatbuf.slot_block(slot, u, topo.model_rank,
                                      topo.model_shards, 2)
        shape = (pg, len(voters)) + tuple(leaf_shape)
        one = len(voters) == dg       # one client: range(c, D*K, K)
        cols = topo.voter_cols(1 if one else k)
        if uniforms is not None:
            u = torch.as_tensor(uniforms(state.step, i, shape, voters)).to(
                device=dev, dtype=F32)
            if tuple(u.shape) != shape:
                raise ValueError(f"uniforms for leaf {i}: shape "
                                 f"{tuple(u.shape)}, want {shape}")
            return u[rows, cols]
        seed = state.rng.initial_seed()

        def client_block(c):
            draw_gen.manual_seed(key_seed(seed, state.step, i, c))
            return torch.empty((pg, dg) + tuple(leaf_shape), dtype=F32,
                               device=dev).uniform_(0.0, 1.0,
                                                    generator=draw_gen)

        if one:
            return client_block(voters.start)[rows, cols]
        u = torch.empty((pg, dg, k) + tuple(leaf_shape), dtype=F32,
                        device=dev)
        for c in range(k):            # voter d*K + c is client c's
            u[:, :, c] = client_block(c)
        return u.reshape(shape)[rows, cols]

    def quantize_dev(state, g_dev, voters: range):
        """Per device and leaf unbiased ternary quantization: each leaf
        [P, V, *leaf] is P*V rows of numel(leaf), each with its own l2
        norm (``ternary_quant`` on CUDA) -> f32.  A leaf's uniforms are
        drawn just before its launch and dropped after it."""
        leaves, td = pytree.tree_flatten(g_dev)
        slots = sharded_slots(g_dev)
        out = []
        for i, (g, slot) in enumerate(zip(leaves, slots)):
            n_rows = g.shape[0] * g.shape[1]
            u = leaf_uniforms(state, i, g.shape[2:], voters, slot)
            norms = (None if slot is None else torch.sqrt(leaf_sums(
                signs.ftz_(g.to(F32).square()), slot)))
            out.append(kops.ternary_quant_rows(
                g.reshape(n_rows, -1), u.reshape(n_rows, -1), norms
            ).reshape(g.shape))
            del u
        return pytree.tree_unflatten(td, out)

    def mean_terms(state, g_dev):
        """What the mean methods average: f32 gradients, or their
        quantization (hier_local_qsgd)."""
        if algo.method == "hier_local_qsgd":
            return quantize_dev(state, g_dev, range(dg_virtual))
        return tmap(lambda g: g.to(F32), g_dev)

    def mom_update(m, g):
        """Sign momentum ``beta*m + (1-beta)*g`` in m's dtype (f32), each
        product rounded before the add."""
        return (flatbuf.scaled(m, algo.momentum)
                + flatbuf.scaled(g.to(m.dtype), 1.0 - algo.momentum))

    def ef_add(u_dev, e_dev):
        return tmap(lambda u, e: u.to(F32) + e, u_dev, e_dev)

    def ef_residual(u_dev, s_dev, part=None):
        """``e' = u - mean|u| * sgn(u)``, the scale per device and leaf
        (a fixed-order row sum, so it does not depend on the voter
        count).  A client masked out of the round (``part`` 0, virtual
        path only) sent nothing and carries ``e' = u``."""
        slots = iter(sharded_slots(u_dev))

        def upd(u, s):
            slot = next(slots)
            numel = (u[0, 0].numel() if slot is None
                     else slot.global_size(topo.model_shards))
            scale = leaf_sums(u.abs(), slot) / float(max(numel, 1))
            sent = scale.reshape(u.shape[:2] + (1,) * (u.dim() - 2)) \
                * s.to(u.dtype)
            if part is not None:
                sent = sent * part.reshape(
                    part.shape + (1,) * (u.dim() - 2)).to(u.dtype)
            return (u - sent).to(F32)
        return tmap(upd, u_dev, s_dev)

    def corrected(u_dev, delta_tree):
        """u + rho*delta in each leaf's dtype (the non-folded DC path);
        delta is the edge's [P, *leaf] correction, shared by its voters."""
        return tmap(lambda u, dl: u + flatbuf.scaled(dl[:, None].to(u.dtype),
                                                     algo.rho),
                    u_dev, delta_tree)

    def add_client_correction(u_dev, q_dev):
        """u + rho*q with q the [P, V, *leaf] per-client correction, in
        each leaf's dtype; never folded into a kernel (whose fold is one
        shared delta)."""
        return tmap(lambda u, q: u + flatbuf.scaled(q.to(u.dtype), algo.rho),
                    u_dev, q_dev)

    def client_correction(cl, ce):
        """The per-client pre-sign correction in delta_dtype: SCAFFOLD
        ``q = c_global - c_local``, MTGC ``q = gamma + eta``; cl [P, V,
        *leaf] per voter, ce [P, *leaf] per edge."""
        if algo.is_scaffold:
            return tmap(lambda e, c: e[:, None] - c, ce, cl)
        return tmap(lambda c, e: c + e[:, None], cl, ce)

    def vote_tree(s_dev, vote_w):
        return tmap(lambda s: votes.majority_vote_dev(
            s, vote_w, algo.transport, weight_bound=vote_bound, topo=topo),
            s_dev)

    def vote_direction(s_dev, vote_w):
        """The vote of pre-signed ±1 trees: the kernels' vote-only route
        on ``fused``, per leaf otherwise."""
        if algo.transport == "fused":
            return votes.fused_sign_vote(s_dev, None, 0.0, vote_w, topo)
        return vote_tree(s_dev, vote_w)

    # -- the FSDP regime: autograd returns the per-edge directions --------

    def pod_direction_fsdp(params, delta, batch, maskf, devwf, transport,
                           rho):
        """The directions of the [P, *leaf] masters, each the vote (or
        ``wmean``) its lift's backward computed, as a list in the tree's
        flatten order, and the [P, D] losses.  A master no lift reaches
        gets zeros, as JAX's gradient does."""
        cfg = device_axis.LiftCfg(devices=d, transport=transport, rho=rho,
                                  compute_dtype=algo.compute_dtype)
        lift = functools.partial(device_axis.fsdp_lift_tree, cfg,
                                 maskf=maskf, devwf=devwf)
        leaves, td = pytree.tree_flatten(params)
        masters = [v.detach().requires_grad_(True) for v in leaves]
        with torch.enable_grad():
            total, losses = bundle.loss_master(
                pytree.tree_unflatten(td, masters), delta, batch, lift)
            dirs = torch.autograd.grad(total, masters, allow_unused=True)
        dirs = [torch.zeros_like(m) if g is None else g
                for m, g in zip(masters, dirs)]
        return dirs, losses.detach()

    def chunked(fn, out, *xs):
        """``out <- fn(*xs)`` for [P, *leaf] tensors and an ``fn`` that
        works coordinate by coordinate, chunk by chunk of the leaf's
        coordinates (``votes.per_chunk``): ``fn``'s bits, with
        temporaries of one chunk.  ``out`` may be one of ``xs``."""
        flat2 = lambda x: x.reshape(x.shape[0], -1)      # noqa: E731
        votes.per_chunk(fn, flat2(out), *map(flat2, xs))
        return out

    def local_step_fsdp(state, params, delta, batch, shares, maskf, mu):
        """FSDP: sign methods vote on ``algo.transport`` (DC with its
        rho), mean methods take ``wmean`` (QSGD too: the reference's
        quirk); then ``v - mu * direction`` into the master in place,
        leaf by leaf, each direction dropped once it is applied."""
        transport = algo.transport if algo.is_sign else "wmean"
        rho = algo.rho if algo.is_dc else 0.0
        dirs, losses = pod_direction_fsdp(params, delta, batch, maskf,
                                          shares.to(F32), transport, rho)
        upd = signs.descend if algo.is_sign else signs.descend_mean
        for i, v in enumerate(pytree.tree_flatten(params)[0]):
            s, dirs[i] = dirs[i], None
            chunked(lambda vv, ss: upd(vv, mu, ss), v, v, s)
        return params, state.ef, state.mom, losses

    # -- the round prologue's anchors -------------------------------------

    def anchor_fold_stream(params_tree, batch, shares3, to_acc):
        """The streamed anchor: a zeros-initialised fold over the K
        clients of each device's share-weighted gradient, one client's
        gradient live at a time."""
        acc = None
        for c in range(k):
            g_c, _ = per_device_grads(
                params_tree, vclients.client_slice(batch, k, c), devices=d)
            acc = fold_sum(acc, tmap(lambda g: wmul(g, shares3[:, :, c]),
                                     to_acc(g_c)))
        return tmap(fold_dev, acc)

    def compute_delta(params, batch, edge_w, dev_w, delta=None, maskf=None):
        """DC's anchor pass at the committed edge models; dev_w is the
        edges' [P, D] (no clients) or [P, D*K] (merged) rows, or the
        rank's [P, D, K] block (stream).
        FSDP: the lift's ``wmean`` with rho 0 (``delta``'s values are not
        read), then ``c - c_q`` leaf by leaf, written into ``delta``'s
        buffers -- the delta the round's swap drops -- so no third delta
        is held beside the caller's state."""
        dd = algo.delta_dtype
        if fsdp:
            c_q, _ = pod_direction_fsdp(params, delta, batch, maskf,
                                        dev_w.to(F32), "wmean", 0.0)
            for i, out in enumerate(pytree.tree_flatten(delta)[0]):
                cq, c_q[i] = c_q[i], None
                chunked(lambda x: (votes.pod_weighted_average(x, edge_w)
                                   - x).to(dd), out, cq)
            return delta
        if flat:
            layout = params.layout
            if stream:
                c_q = anchor_fold_stream(
                    params.tree(), batch, dev_w,
                    lambda g: flatbuf.flatten_tree(layout, g, 2, F32))
            else:
                g_dev, _ = per_device_grads(params.tree(), batch)
                g_buf = flatbuf.flatten_tree(layout, g_dev, 2, F32)
                del g_dev
                c_q = mean_dev(g_buf, dev_w)
                del g_buf
            c = votes.pod_weighted_average(c_q, edge_w, topo)
            return flatbuf.FlatState((c - c_q).to(dd),
                                     flatbuf.with_dtype(layout, dd))
        if stream:
            c_q = anchor_fold_stream(params, batch, dev_w,
                                     lambda g: tmap(lambda x: x.to(F32), g))
        else:
            g_dev, _ = per_device_grads(params, batch)
            c_q = tmap(lambda g: mean_dev(g.to(F32), dev_w), g_dev)
        c = pod_mean(c_q, edge_w)
        return tmap(lambda a, b: (a - b).to(dd), c, c_q)

    def compute_corrections(params, corr_cl, corr_edge, batch, edge_w,
                            dev_w, part, live, rnd_index):
        """The round-boundary refresh of SCAFFOLD's / MTGC's correction
        state at the committed edge models, from the anchor gradients
        a_qk in f32, stored back in ``delta_dtype``.

        SCAFFOLD: the shared variate absorbs the share-weighted drift,
          c_global <- c_global + sum_q ew_q sum_k sh_qk (a_qk - c_local_qk),
        then a participating client sets c_local_qk <- a_qk.
        MTGC: gamma_qk <- c_q - a_qk every round (c_q = sum_k sh_qk a_qk),
        eta_q <- c - c_q every ``cloud_period`` rounds (c = sum_q ew_q
        c_q); an edge whose whole quorum abstains keeps both terms.

        ``part`` gates the per-client refresh: the rank's [P, D*K]
        (merged) or [P, D, K] (stream) live votes; None (no virtual
        clients) updates every client.  ``live``: [P] whether an edge has
        a live vote (None = every edge)."""
        do_cloud = rnd_index % algo.cloud_period == 0
        if stream:
            return corrections_stream(params, corr_cl, corr_edge, batch,
                                      edge_w, dev_w, part, live, do_cloud)
        dd = algo.delta_dtype
        g_dev, _ = per_device_grads(params.tree() if flat else params,
                                    batch)
        if flat:
            a32 = flatbuf.flatten_tree(params.layout, g_dev, 2, F32)
            cl_old, ce_old = corr_cl.buf, corr_edge.buf
        else:
            a32 = tmap(lambda g: g.to(F32), g_dev)
            cl_old, ce_old = corr_cl, corr_edge

        def gate(fresh, old):
            if part is None:
                return fresh
            return tmap(lambda f, o: torch.where(
                part.reshape(part.shape + (1,) * (f.dim() - 2)), f, o),
                fresh, old)

        def wmean(t):
            return tmap(lambda x: mean_dev(x, dev_w), t)

        if algo.is_scaffold:
            drift = pod_mean(wmean(tmap(lambda a, c: a - c.to(F32), a32,
                                        cl_old)), edge_w)
            ce_new = tmap(lambda e, dr: (e.to(F32) + dr).to(dd), ce_old,
                          drift)
            cl_new = gate(tmap(lambda a: a.to(dd), a32), cl_old)
        else:
            c_q = wmean(a32)
            ce_new = mtgc_edge_term(c_q, ce_old, edge_w, do_cloud, live)
            cl_new = gate(tmap(lambda cq, a: (cq[:, None] - a).to(dd), c_q,
                               a32), cl_old)
        if flat:
            return corr_cl.replace(cl_new), corr_edge.replace(ce_new)
        return cl_new, ce_new

    def mtgc_edge_term(c_q, ce_old, edge_w, do_cloud, live):
        """MTGC's eta_q = c - c_q, refreshed on cloud rounds for edges
        with a live vote (``live`` [P] bool, None = every edge)."""
        if not do_cloud:
            return ce_old
        dd = algo.delta_dtype
        eta = tmap(lambda u, v: (u - v).to(dd), pod_mean(c_q, edge_w), c_q)
        if live is None:
            return eta
        return tmap(lambda f, o: torch.where(
            live.reshape((p,) + (1,) * (f.dim() - 1)), f, o), eta, ce_old)

    def corrections_stream(params, corr_cl, corr_edge, batch, edge_w,
                           shares3, part, live, do_cloud):
        """The streamed refresh: the share-weighted anchor sums fold over
        the clients in the merged re-association, one client's gradient
        live at a time; MTGC needs c_q before gamma, so it takes the
        (deterministic) anchor gradients again in a second pass instead
        of keeping K of them."""
        dd = algo.delta_dtype
        layout = params.layout if flat else None
        pt = params.tree() if flat else params

        def grads_c(c):
            g_c, _ = per_device_grads(
                pt, vclients.client_slice(batch, k, c), devices=d)
            if flat:
                return flatbuf.flatten_tree(layout, g_c, 2, F32)
            return tmap(lambda g: g.to(F32), g_c)

        def gate_c(c, fresh, old):
            if part is None:
                return fresh
            g = part[:, :, c]
            return tmap(lambda f, o: torch.where(
                g.reshape(g.shape + (1,) * (f.dim() - 2)), f, o), fresh, old)

        cl3 = (corr_cl.buf.reshape(p, d, k, layout.n_pad) if flat
               else tmap(lambda x: x.reshape((p, d, k) + tuple(x.shape[2:])),
                         corr_cl))
        ce_old = corr_edge.buf if flat else corr_edge
        new_cl = []
        if algo.is_scaffold:
            acc = None
            for c in range(k):
                a_c, cl_c = grads_c(c), take(cl3, c)
                acc = fold_sum(acc, tmap(
                    lambda a, cv: wmul(a - cv.to(F32), shares3[:, :, c]),
                    a_c, cl_c))
                new_cl.append(gate_c(c, tmap(lambda a: a.to(dd), a_c),
                                     cl_c))
            drift = pod_mean(tmap(fold_dev, acc), edge_w)
            ce_new = tmap(lambda e, dr: (e.to(F32) + dr).to(dd), ce_old,
                          drift)
        else:
            acc = None
            for c in range(k):
                acc = fold_sum(acc, tmap(
                    lambda a: wmul(a, shares3[:, :, c]), grads_c(c)))
            c_q = tmap(fold_dev, acc)
            ce_new = mtgc_edge_term(c_q, ce_old, edge_w, do_cloud, live)
            for c in range(k):
                fresh = tmap(lambda cq, a: (cq[:, None] - a).to(dd), c_q,
                             grads_c(c))
                new_cl.append(gate_c(c, fresh, take(cl3, c)))
        cl_t = merge_clients(new_cl)
        if flat:
            return corr_cl.replace(cl_t), corr_edge.replace(ce_new)
        return cl_t, ce_new

    # -- the local steps ----------------------------------------------------

    def local_step_tree(state, params, delta, corr_cl, corr_edge, batch,
                        shares, vote_w, mu):
        """Merged voters, tree layout -> (params, ef, mom, losses)."""
        g_dev, losses = per_device_grads(params, batch)
        ef, mom = state.ef, state.mom
        if not algo.is_sign:
            direction = tmap(lambda g: mean_dev(g, shares),
                             mean_terms(state, g_dev))
            return (tmap(lambda v, s: signs.descend_mean(v, mu, s), params,
                         direction), ef, mom, losses)
        u_dev = g_dev
        if mom_on:
            mom = tmap(mom_update, state.mom, g_dev)
            u_dev = mom
        if ef_on:
            u_dev = ef_add(u_dev, state.ef)
        if algo.is_dc and not fold_dc:
            u_dev = corrected(u_dev, delta)
        if algo.has_client_correction:
            u_dev = add_client_correction(
                u_dev, client_correction(corr_cl, corr_edge))
        if fuse:
            direction = votes.fused_sign_vote(
                u_dev, delta if fold_dc else None,
                algo.rho if fold_dc else 0.0, vote_w, topo)
        else:
            s_dev = tmap(signs.sgn, u_dev)
            if ef_on:
                ef = ef_residual(u_dev, s_dev,
                                 part=(vote_w[:, vcols] > 0) if virtual
                                 else None)
            direction = vote_direction(s_dev, vote_w)
        return (tmap(lambda v, s: signs.descend(v, mu, s), params,
                     direction), ef, mom, losses)

    def local_step_flat(state, params, delta, corr_cl, corr_edge, batch,
                        shares, vote_w, mu):
        """Merged voters, flat layout: whole-buffer means, momentum and
        updates; the per-leaf pieces (quantizer, EF scale, corrections)
        on the buffers' leaf views, so every coordinate sees the tree
        path's arithmetic."""
        layout = params.layout
        g_dev, losses = per_device_grads(params.tree(), batch)
        ef, mom = state.ef, state.mom
        if not algo.is_sign:
            t_buf = flatbuf.flatten_tree(layout, mean_terms(state, g_dev), 2,
                                         F32)
            dir_buf = mean_dev(t_buf, shares)
            return (params.replace(signs.descend_mean(params.buf, mu,
                                                      dir_buf)),
                    ef, mom, losses)
        u_dev = g_dev
        if mom_on:
            g_buf = flatbuf.flatten_tree(layout, g_dev, 2, F32)
            mom = state.mom.replace(mom_update(state.mom.buf, g_buf))
            u_dev = mom.tree(cast=False)
        if ef_on:
            u_dev = ef_add(u_dev, state.ef.tree(cast=False))
        if algo.is_dc and not fold_dc:
            u_dev = corrected(u_dev, delta.tree(cast=False))
        if algo.has_client_correction:
            u_dev = add_client_correction(u_dev, client_correction(
                corr_cl.tree(cast=False), corr_edge.tree(cast=False)))
        if fuse:
            # ONE sign_pack + ONE vote_update launch; mu folds into the
            # kernel when it does not change with the step
            new_buf = votes.fused_sign_vote_update(
                layout, u_dev, delta.buf if fold_dc else None,
                algo.rho if fold_dc else 0.0, vote_w, params.buf, mu,
                mu_static=None if algo.decay else algo.mu, topo=topo)
            return params.replace(new_buf), ef, mom, losses
        s_dev = tmap(signs.sgn, u_dev)
        if ef_on:
            ef = as_flat(state.ef, ef_residual(
                u_dev, s_dev, part=(vote_w[:, vcols] > 0) if virtual
                else None))
        dir_buf = flatbuf.flatten_tree(layout, vote_direction(s_dev, vote_w),
                                       1, params.buf.dtype)
        return (params.replace(signs.descend(params.buf, mu, dir_buf)), ef,
                mom, losses)

    def local_step_stream(state, params, delta, corr_cl, corr_edge, batch,
                          shares3, vote_w3, mu):
        """mode='stream': loop over the K clients with one client's
        gradient live at a time.  Sign methods fold each client's signs,
        weighted, into a persistent integer tally (a flat [P, D, n_pad]
        buffer and one ``tally_acc`` launch per client on the fused
        route, per-leaf tallies otherwise), thresholded after the loop;
        mean methods fold its share-weighted (quantized) gradient into an
        f32 accumulator.  Momentum, EF residuals and client corrections
        are sliced per client.  shares3 [P, D, K] f32 and vote_w3 [P, D,
        K] int32 arrive unmerged (the rank's block of shares, its edges'
        whole rows of weights)."""
        params_tree = params.tree() if flat else params
        losses, new_ef, new_mom = [], [], []
        acc = tally = None
        if fuse:
            if flat:
                vlayout = params.layout
            else:     # only the per-device shapes matter to the layout
                vlayout = flatbuf.make_layout(tmap(
                    lambda v: torch.empty((p, d) + tuple(v.shape[1:]),
                                          device="meta"), params_tree),
                    batch_dims=2)
            tally = torch.zeros((p, d, vlayout.n_pad),
                                dtype=votes.tally_dtype(vote_bound),
                                device=dev)
        elif algo.is_sign:
            tally = tmap(lambda v: torch.zeros(
                (p, d) + tuple(v.shape[1:]),
                dtype=votes.tally_dtype(vote_bound), device=dev), params_tree)
        delta_tree = None
        if algo.is_dc and not fold_dc:
            delta_tree = delta.tree(cast=False) if flat else delta
        ce_tree = cl3 = ef3 = mom3 = None
        if algo.has_client_correction:
            ce_tree = corr_edge.tree(cast=False) if flat else corr_edge
            cl3 = views3(corr_cl)
        if algo.is_sign and ef_on:
            ef3 = views3(state.ef)
        if algo.is_sign and mom_on:
            mom3 = views3(state.mom)
        for c in range(k):
            g_c, loss_c = per_device_grads(
                params_tree, vclients.client_slice(batch, k, c), devices=d)
            losses.append(loss_c)
            w_c = vote_w3[:, topo.voter_cols(), c]
            if not algo.is_sign:
                if algo.method == "hier_local_qsgd":   # merged's draws
                    g_c = quantize_dev(state, g_c, range(c, dg_virtual, k))
                if flat:
                    g_c = flatbuf.flatten_tree(params.layout, g_c, 2, F32)
                else:
                    g_c = tmap(lambda g: g.to(F32), g_c)
                # the client's terms die here: the next client's
                # gradients are taken with only the accumulator alive
                acc = fold_sum(acc, tmap(lambda g: wmul(g, shares3[:, :, c]),
                                         g_c))
                del g_c
                continue
            u_c = g_c
            if mom3 is not None:
                u_c = tmap(mom_update, take(mom3, c), g_c)
                new_mom.append(u_c)
            if ef3 is not None:
                u_c = ef_add(u_c, take(ef3, c))
            if delta_tree is not None:
                u_c = corrected(u_c, delta_tree)
            if ce_tree is not None:
                u_c = add_client_correction(
                    u_c, client_correction(take(cl3, c), ce_tree))
            if fuse:
                tally = votes.fused_sign_tally_accumulate(
                    vlayout, u_c,
                    delta if (fold_dc and not flat) else None,
                    delta.buf if (fold_dc and flat) else None,
                    algo.rho if fold_dc else 0.0, w_c, tally)
                continue
            s_c = tmap(signs.sgn, u_c)
            if ef3 is not None:
                new_ef.append(ef_residual(u_c, s_c, part=w_c > 0))
            tally = tmap(lambda t, s: votes.tally_add_signs(t, s, w_c), tally,
                         s_c)
        losses = torch.stack(losses, dim=2).reshape(p, d_virtual)
        ef = (as_flat(state.ef, merge_clients(new_ef)) if new_ef
              else state.ef)
        mom = (as_flat(state.mom, merge_clients(new_mom)) if new_mom
               else state.mom)
        if not algo.is_sign:
            if flat:
                return (params.replace(signs.descend_mean(
                    params.buf, mu, fold_dev(acc))), ef, mom, losses)
            return (tmap(lambda v, a: signs.descend_mean(
                v, mu, fold_dev(a)), params, acc), ef, mom, losses)
        n_eff = torch.sum(vote_w3, dim=(1, 2), dtype=torch.int32)
        if fuse:
            if flat:
                return (params.replace(votes.fused_tally_finish(
                    vlayout, tally, n_eff, params.buf, mu, topo)), ef, mom,
                    losses)
            direction = votes.fused_tally_finish(vlayout, tally, n_eff,
                                                 None, None, topo)
        else:
            direction = tmap(lambda t: votes.tally_vote_dev(t, n_eff, topo),
                             tally)
        if flat:
            dir_buf = flatbuf.flatten_tree(params.layout, direction, 1,
                                           params.buf.dtype)
            return (params.replace(signs.descend(params.buf, mu, dir_buf)),
                    ef, mom, losses)
        return (tmap(lambda v, s: signs.descend(v, mu, s), params,
                     direction), ef, mom, losses)

    def on_device(tree):
        return tmap(lambda x: torch.as_tensor(x, device=dev), tree)

    def train_step(state: TrainState, batch, edge_weights, dev_weights,
                   dev_mask):
        edge_weights, dev_weights, dev_mask = (
            torch.as_tensor(x, device=dev)
            for x in (edge_weights, dev_weights, dev_mask))
        maskf = dev_mask.to(F32)
        rnd_index = state.step // t_e
        vote_w3 = corr_part = live = None
        if not virtual:
            if maskf.dim() != 2:
                raise ValueError(
                    "a client-granular [P, D, K] dev_mask requires an "
                    "active AlgoConfig.clients; without virtual clients "
                    "the step takes the [P, D] device mask")
            vote_w = maskf[rows] > 0.5
            shares = dev_weights[rows]
            carve = lambda b: b                                # noqa: E731
        else:
            if maskf.dim() == 3 and maskf.shape[2] != k:
                raise ValueError(
                    f"dev_mask client dim {maskf.shape[2]} != K={k}")
            maskf3 = maskf if maskf.dim() == 3 else maskf[:, :, None]
            part = participation(rnd_index) * maskf3           # [P, D, K]
            # int32 vote weights: |D_qk| never round through a float;
            # the rank's edges' whole rows of them and of the shares
            vote_w3 = (w_int * part.to(torch.int32))[rows]
            vote_w = vote_w3.reshape(p, dg_virtual)
            shares = vclients.participating_shares(
                dev_weights.to(F32), w_int.to(F32), part)[rows]
            if stream:
                # the streamed fold runs on the rank's own devices
                shares = shares.reshape(p, dg, k)[:, topo.voter_cols()]
                carve = lambda b: b                            # noqa: E731
            else:
                carve = lambda b: vclients.carve_batch(b, k)   # noqa: E731
            # only clients with a live vote refresh their correction
            # terms (the EF carry-forward contract)
            corr_part = (vote_w3[:, topo.voter_cols()] if stream
                         else vote_w[:, vcols]) > 0
            live = (vote_w > 0).any(dim=1)
        train_batch = carve(on_device(batch["train"]))
        anchor_batch = carve(on_device(batch.get("anchor", batch["train"])))
        params, agg_next = state.params, state.agg_next
        delta, delta_next = state.delta, state.delta_next
        corr_cl, corr_edge = state.corr_cl, state.corr_edge
        if state.step % t_e == 0:
            # the prologue: issue the cloud mean, commit by the schedule,
            # then refresh the anchors at the committed model
            issued = pod_avg(params, edge_weights)
            params, agg_next = cloud_sched.commit(issued, agg_next)
            if algo.is_dc:
                fresh = compute_delta(params, anchor_batch, edge_weights,
                                      shares, delta, maskf)
                if algo.anchor_staleness == 1:
                    delta, delta_next = delta_next, fresh
                else:
                    delta = fresh
            if algo.has_client_correction:
                corr_cl, corr_edge = compute_corrections(
                    params, corr_cl, corr_edge, anchor_batch, edge_weights,
                    shares, corr_part, live, rnd_index)
        # flushed once here (signs.descend takes it so): on the host, and
        # with decay once more on the card
        mu = signs.ftz(torch.tensor(algo.mu if algo.is_sign else algo.mu_sgd,
                                    dtype=algo.master_dtype)).to(dev)
        if algo.decay:
            mu = signs.ftz(mu / torch.sqrt(torch.tensor(
                float(rnd_index), dtype=algo.master_dtype, device=dev) + 1.0))
        if fsdp:
            params, ef, mom, losses = local_step_fsdp(
                state, params, delta, train_batch, shares, maskf, mu)
        else:
            if stream:
                step_fn, wv = local_step_stream, vote_w3
            else:
                step_fn = local_step_flat if flat else local_step_tree
                wv = vote_w
            params, ef, mom, losses = step_fn(state, params, delta, corr_cl,
                                              corr_edge, train_batch, shares,
                                              wv, mu)
        new_state = TrainState(
            step=state.step + 1, params=params, agg_next=agg_next,
            delta=delta, delta_next=delta_next, ef=ef, mom=mom,
            corr_cl=corr_cl, corr_edge=corr_edge, rng=state.rng)
        # every rank's mean is the one-process mean of all [P, D*K] losses
        losses = comm.gather_pods(topo, comm.gather_devices(
            topo, losses.to(F32)))
        metrics = {"loss": losses.mean(), "loss_per_pod": losses.mean(1),
                   "mu": mu}
        return new_state, metrics

    def init_fn(params_single: PyTree, seed: int = 0) -> TrainState:
        """params_single: one replica's parameters (no leading dims),
        copied to P edge models (the rank's P_loc over a mesh) in the
        master dtype on ``topo.device``; the slots are filled as the
        reference's ``init_fn`` fills them."""
        params_tree = tmap(
            lambda x: torch.as_tensor(x, device=dev).unsqueeze(0)
            .expand((p,) + tuple(x.shape)).to(algo.master_dtype)
            .contiguous(), params_single)
        layout = None
        if topo.model_shards > 1 and bundle.specs is not None:
            # the rank keeps its blocks of the sharded layout
            sharding["layout"] = shardflat.param_layout(
                topo, bundle.specs, params_tree, batch_dims=1)
            params_tree = shardflat.local_block(topo, sharding["layout"],
                                                params_tree, 1)
            layout = sharding["layout"].bucket()
        if flat:
            layout = layout or flatbuf.make_layout(params_tree, batch_dims=1)
            params = flatbuf.FlatState(
                flatbuf.flatten_tree(layout, params_tree, 1), layout)

            def zeros(dt, voters):
                lead = (p,) if voters is None else (p, voters)
                return flatbuf.FlatState(
                    torch.zeros(lead + (layout.n_pad,), dtype=dt,
                                device=dev),
                    flatbuf.with_dtype(layout, dt), batch_dims=len(lead))

            def copy_params():
                return params.replace(params.buf.clone())
        else:
            params = params_tree

            def zeros(dt, voters):
                if voters is None:
                    return tmap(lambda v: torch.zeros_like(v, dtype=dt),
                                params_tree)
                return tmap(lambda v: torch.zeros(
                    (p, voters) + tuple(v.shape[1:]), dtype=dt, device=dev),
                    params_tree)

            def copy_params():
                return tmap(torch.clone, params_tree)
        dd = algo.delta_dtype
        has_cc = algo.has_client_correction
        rng = torch.Generator(device=dev)
        rng.manual_seed(seed)
        # the staged in-flight aggregate starts as a copy of the
        # replicated w0, so the step-0 prologue commits exactly w0
        return TrainState(
            step=0, params=params,
            agg_next=copy_params() if cloud_sched.staged else None,
            delta=zeros(dd, None) if needs_delta else None,
            delta_next=(zeros(dd, None)
                        if algo.is_dc and algo.anchor_staleness == 1
                        else None),
            # FSDP keeps no per-voter slots: the reference drops EF and
            # momentum there (ROADMAP section 3)
            ef=zeros(F32, d_virtual) if ef_on and not fsdp else None,
            mom=zeros(F32, d_virtual) if mom_on and not fsdp else None,
            corr_cl=zeros(dd, d_virtual) if has_cc else None,
            corr_edge=zeros(dd, None) if has_cc else None,
            rng=rng)

    return init_fn, train_step


def make_global_round(topo: Topology, algo: AlgoConfig, bundle: ModelBundle,
                      uniforms: Uniforms | None = None):
    """Build (init_fn, global_round): one round as the JAX package's
    ``make_global_round`` runs it -- the prologue plus T_E local steps --
    here a plain loop of ``train_step`` calls, so it is bitwise the T_E
    steps run one by one.

    global_round(state, batches, edge_weights, dev_weights, dev_mask)
        -> (state, {"loss": the mean of the T_E steps' losses})

    batches: tree of [T_E, P, D, b, ...]; step tau trains on row tau and
    the round's anchor is row 0 (the step's default, as in the JAX
    ``lax.scan``).  The membership arrays hold for the whole round."""
    init_fn, train_step = make_hier_step(topo, algo, bundle, uniforms)

    def global_round(state: TrainState, batches, edge_weights, dev_weights,
                     dev_mask):
        losses = []
        for tau in range(algo.t_e):
            batch_t = pytree.tree_map(lambda x: x[tau], batches)
            state, metrics = train_step(state, {"train": batch_t},
                                        edge_weights, dev_weights, dev_mask)
            losses.append(metrics["loss"])
        return state, {"loss": torch.stack(losses).mean()}

    return init_fn, global_round


def edge_params(state: TrainState, topo: Topology | None = None,
                layout: flatbuf.FlatLayout | None = None) -> PyTree:
    """The [P, *leaf] edge models of a state as a tree, in either layout
    (flat views alias the buffer).  With a mesh topology, every rank's
    [P_loc, *leaf] edges gathered over its pod group: all P; with a
    model axis, each sharded leaf's blocks gathered over the model group
    too and cut to its logical extent.  ``layout`` is the master's
    sharded layout (``shardflat.param_layout``), needed for a tree
    state's sharded leaves (a flat state's bucket carries it)."""
    flat = isinstance(state.params, flatbuf.FlatState)
    tree = state.params.tree() if flat else state.params
    if topo is None or topo.mesh is None:
        return tree
    if topo.model_shards > 1:
        lay = layout if layout is not None else (
            state.params.layout.sharded(topo.model_shards) if flat else None)
        if lay is None:
            raise ValueError("edge_params of a model-sharded tree state "
                             "needs the master's sharded layout")
        tree = shardflat.gather(topo, lay, tree, batch_dims=1)
    return pytree.tree_map(lambda x: comm.gather_pods(topo, x), tree)


PER_VOTER = ("ef", "mom", "corr_cl")     # [P, D*K, ...] slots; the rest
                                         # of the tensor slots are [P, ...]


def state_blocks(topo: Topology, clients: int = 1,
                 layout: flatbuf.FlatLayout | None = None) -> TrainState:
    """The counterpart of the JAX ``state_shardings``: for each tensor
    slot of a ``TrainState`` the index of the block this rank holds in
    the global slot -- ``(pod rows,)`` for the per-edge slots, ``(pod
    rows, voter cols)`` on the merged ``D*K`` axis for the per-voter
    ones (ef, mom, corr_cl; ``clients`` = K) -- in either layout (a flat
    slot's buffer is indexed the same way).  With a sharded ``layout``
    (the master's, ``layout.shards`` model ranks) each index ends in
    the rank's bucket, ``[m * bucket_pad, (m+1) * bucket_pad)``, of a
    flat slot's global multi-bucket buffer; a tree slot's sharded leaf
    takes its block by ``flatbuf.slot_block``.  ``step`` and ``rng`` are
    None: every rank holds them whole."""
    edge = (topo.pod_rows,)
    voter = (topo.pod_rows, topo.voter_cols(clients))
    if layout is not None and layout.shards > 1:
        bp = layout.bucket_pad
        coords = (Ellipsis, slice(topo.model_rank * bp,
                                  (topo.model_rank + 1) * bp))
        edge, voter = edge + coords, voter + coords
    return TrainState(step=None, rng=None, **{
        name: voter if name in PER_VOTER else edge
        for name in TrainState._fields if name not in ("step", "rng")})
