"""Majority-vote transports over the device tier, on one card.

The local arithmetic of the JAX package's ``core/votes.py``.  Inputs are
per-device quantities ``[P, D, *leaf]`` (P edges, D devices); outputs
are per-edge votes ``[P, *leaf]``.  On one card the "transport" is a
choice of arithmetic, and all three sign transports are bitwise
identical (ties -> +1):

``ag_packed``  each device's signs packed to 1 bit/coordinate, then a
    popcount vote over the packed rows (the paper's uplink payload).
``ar_int8``    an integer tally of the signs (int8 while the weight sum
    fits, int16/int32 beyond), then its sign.
``fused``      the whole tree as ONE flat buffer (``core.flatbuf``):
    the DC correction folded in pre-sign, ONE ``sign_pack`` launch over
    all P*D rows and ONE ``vote_update`` launch over all pods
    (``kernels.ops``; the CUDA kernels on the card, their plain versions
    on the CPU).  With the flat state layout the vote never forms: the
    kernel updates the master buffer in place.

Over a process mesh (``core.topology``) every function that reduces over
D or P takes the topology: a rank holds the block ``[P_loc, D_loc,
*leaf]``, its masks are its edges' whole ``[P_loc, D]`` rows of the
global mask (the tally dtype and the empty quorum follow the edge's
global weights), and the reduction crosses ranks through ``core.comm``:
the packed words are gathered over the data group and voted on
``[P_loc, D, ...]`` (``ag_packed``, ``fused``), the integer tally is
summed over it (``ar_int8``, the streamed tallies), and the float means
gather their per-device (or per-edge) terms and fold them in the
one-process order -- so every result is the one-process run's, bitwise.
Without a mesh (``topo`` None or one process) nothing crosses.  With a
model axis (``core.shardflat``) a rank calls these on its own bucket:
its local blocks and the bucket layout (``layout.bucket()``), so every
sign, vote, tally and mean stays coordinatewise on the rank's shard,
the words and tallies cross the data group (the ranks of its pod and
model shard) only, and nothing here crosses the model group.

The FSDP lift votes one leaf at a time (``fused_sign_vote_leaf``: the
same two kernels on the leaf's [P, D, numel] rows) and takes its large
leaves by coordinate chunks (``per_chunk``, ``corrected_leaf``).

Masks are [P, D] {0,1} voter masks or nonnegative integer vote weights
(weighted popcount; an edge whose quorum has weight 0 votes 0); with
merged virtual clients the voter axis is D*K wide.  The streamed client
sweep keeps the voter axis at D and folds each client's weighted signs
into a signed integer tally instead (``tally_*`` below; on the fused
transport one ``tally_acc`` launch per client), bitwise the merged vote.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.core import comm, flatbuf, pytree, signs
from repro_torch.core.topology import Topology
from repro_torch.kernels import ops as kops

PACK = signs.PACK_WIDTH

SIGN_TRANSPORTS = ("ag_packed", "ar_int8", "fused")
LEAF_PAD = kops.TILE    # a leaf's [P, D, numel] rows pad to the buffers' tile
CHUNK = 1 << 24     # coordinates a chunk of per_chunk


def _mask_bcast(mask: torch.Tensor | None, ndim_leaf: int):
    """[P, D] voter mask/weights -> broadcastable to [P, D, *leaf]."""
    if mask is None:
        return None
    return mask.reshape(mask.shape + (1,) * ndim_leaf)


def _is_int_weights(mask: torch.Tensor) -> bool:
    return not mask.dtype.is_floating_point and mask.dtype != torch.bool


def _tally_acc(weight_bound: int) -> torch.dtype:
    """Smallest int dtype holding a tally of range ``weight_bound``."""
    if weight_bound <= 127:
        return torch.int8
    if weight_bound <= 32767:
        return torch.int16
    return torch.int32


def _block_cols(topo: Topology | None, n_local: int) -> slice:
    """This rank's voters on its edges' global voter axis, whose
    ``n_local`` voters a rank holds (the whole axis without a mesh)."""
    if topo is None or topo.mesh is None:
        return slice(0, n_local)
    b = topo.mesh.data_rank
    return slice(b * n_local, (b + 1) * n_local)


def _crosses(topo: Topology | None, axis: str) -> bool:
    """Whether a reduction over ``axis`` ("data" or "pods") leaves the
    process: a mesh whose axis has more than one rank."""
    m = None if topo is None else topo.mesh
    return m is not None and getattr(m, axis) > 1


def _across_devices(topo: Topology, fold, x: torch.Tensor) -> torch.Tensor:
    """``fold`` (a coordinate-wise reduction [P, V, *leaf] -> [P, *leaf]
    in one process) of the rank's [P_loc, V_loc, *leaf] terms over its
    edges' whole voter axis: chunk by chunk of the leaf's coordinates,
    each chunk gathered over the data group and folded (``per_chunk``),
    so the bits are the one-process fold's and the gathered terms live
    one chunk at a time."""
    p, v = x.shape[:2]
    x3 = x.reshape(p, v, -1)
    out = torch.empty((p, x3.shape[-1]), dtype=x.dtype, device=x.device)
    per_chunk(lambda c: fold(comm.gather_devices(topo, c)), out, x3)
    return out.reshape((p,) + tuple(x.shape[2:]))


def _abstain(vote: torch.Tensor, n_eff: torch.Tensor) -> torch.Tensor:
    """Vote 0 where the quorum's weight sum is not positive."""
    return torch.where(n_eff > 0, vote, torch.zeros_like(vote))


def vote_ar_int8(s_dev: torch.Tensor, mask: torch.Tensor | None,
                 weight_bound: int | None = None,
                 topo: Topology | None = None) -> torch.Tensor:
    """sgn(sum_k w_k s_k) via an integer tally over the device dim.

    The tally is int8 while its range ``sum(w) <= 127`` fits and int16 /
    int32 beyond; ``weight_bound`` is the static per-edge range
    ``max_q sum_k w_qk``, required for integer weights (None means unit
    weights: the voter count D).  Integer weights without a bound raise:
    defaulting to the voter count could wrap the tally.

    Over a mesh, s_dev is the rank's [P_loc, V_loc, *leaf] block and
    mask its edges' [P_loc, V] rows: the rank's tally is summed over
    the data group in the tally dtype (``comm.sum_devices``), exact."""
    if weight_bound is None and mask is not None and _is_int_weights(mask):
        raise ValueError(
            "vote_ar_int8: integer vote weights need an explicit static "
            "weight_bound (max per-edge sum(w)) to size the tally dtype; "
            "the voter-count default only covers {0,1} masks")
    n_loc = s_dev.shape[1]
    voters = (mask.shape[1] if mask is not None
              else n_loc * (topo.mesh.data if topo and topo.mesh else 1))
    bound = weight_bound if weight_bound is not None else voters
    acc = _tally_acc(bound)
    tally = s_dev.to(acc)
    m = _mask_bcast(None if mask is None
                    else mask[:, _block_cols(topo, n_loc)], s_dev.dim() - 2)
    if m is not None:
        tally = tally * m.to(acc)
    tally = torch.sum(tally, dim=1, dtype=acc)                 # [P, *leaf]
    tally = comm.sum_devices(topo, tally)
    vote = signs.sgn(tally.to(torch.int32))
    if mask is not None:
        n_eff = torch.sum(mask.to(torch.int32), dim=1)
        vote = _abstain(vote, n_eff.reshape((-1,) + (1,) * (vote.dim() - 1)))
    return vote


def vote_ag_packed(s_dev: torch.Tensor, mask: torch.Tensor | None,
                   topo: Topology | None = None) -> torch.Tensor:
    """Bit-packed popcount vote: s_dev [P, D, *leaf] int8 with the leaf's
    minor dim % 32 == 0 -> [P, *leaf] int8.  The packed rows are counted
    one voter at a time (:func:`_popcount_vote_words`), so no [P, D,
    *leaf] int32 bit tensor forms.  Over a mesh the rank packs its
    block's rows and the words are gathered over the data group first
    (mask: the edges' whole [P_loc, D] rows)."""
    if s_dev.shape[-1] % PACK:
        raise ValueError("vote_ag_packed needs a minor dim % 32 == 0")
    p, d = s_dev.shape[:2]
    words = signs.pack_signs(s_dev).reshape(p, d, -1)        # [P, D, W]
    words = comm.gather_devices(topo, words)
    return _popcount_vote_words(words, mask, words.shape[1]).reshape(
        (p,) + tuple(s_dev.shape[2:]))


def _popcount_vote_words(words: torch.Tensor, mask: torch.Tensor | None,
                         n_dev: int) -> torch.Tensor:
    """[P, D, W] packed words (+ [P, D] mask/weights) -> [P, W*32] int8.

    The voter dim is folded one voter at a time, so the [P, D, W*32] bit
    tensor never forms."""
    pos = None
    for k in range(words.shape[1]):
        b = signs.unpack_bits(words[:, k])                     # [P, W*32]
        if mask is not None:
            b = b * mask[:, k].to(torch.int32)[:, None]
        pos = b if pos is None else pos + b
    if mask is not None:
        n_eff = torch.sum(mask.to(torch.int32), dim=1)[:, None]
    else:
        n_eff = n_dev
    one = torch.ones((), dtype=torch.int8, device=words.device)
    vote = torch.where(2 * pos >= n_eff, one, -one)
    if mask is not None:
        vote = _abstain(vote, n_eff)
    return vote


def _fused_kernel_bufs(layout: flatbuf.FlatLayout, u_dev, delta_tree,
                       delta_buf, rho: float):
    """Fold rule + flat views for the kernel route.

    ``sign_pack`` adds rho*delta in f32; folding it there equals the
    per-leaf arithmetic only when every leaf is f32.  Other trees add
    the correction first, in each leaf's own dtype, exactly as the tree
    path does, and hand the kernel no correction.  The correction may
    arrive as a tree ([P, *leaf]) or as a [P, n_pad] buffer."""
    leaves = pytree.flatten_up_to(layout.treedef, u_dev)
    have_delta = (delta_tree is not None or delta_buf is not None) and rho
    fold_in_kernel = (have_delta
                      and all(leaf.dtype == torch.float32 for leaf in leaves))
    if have_delta and not fold_in_kernel:
        if delta_tree is None:
            delta_tree = flatbuf.unflatten_tree(layout, delta_buf,
                                                batch_dims=1, cast=False)
        u_dev = pytree.tree_map(
            lambda u, dl: u + flatbuf.scaled(dl[:, None].to(u.dtype), rho),
            u_dev, delta_tree)
    dt = leaves[0].dtype
    for leaf in leaves[1:]:
        dt = torch.promote_types(dt, leaf.dtype)
    # widening casts never move a value across zero: the signs stay those
    # of the per-leaf arithmetic
    u_buf = flatbuf.flatten_tree(layout, u_dev, batch_dims=2, dtype=dt)
    if not u_buf.dtype.is_floating_point:
        u_buf = u_buf.to(torch.float32)      # pre-signed int8: exact
    d_buf = None
    if fold_in_kernel:
        d_buf = (delta_buf.to(u_buf.dtype) if delta_buf is not None
                 else flatbuf.flatten_tree(layout, delta_tree, batch_dims=1,
                                           dtype=u_buf.dtype))
    return u_buf, d_buf


def _packed_vote(layout: flatbuf.FlatLayout, u_dev, delta_tree, rho: float,
                 mask: torch.Tensor | None) -> torch.Tensor:
    """The per-leaf route of the fused transport: per-leaf fused pack
    (correction added pre-sign in the leaf's dtype), word-level concat,
    one popcount vote -> [P, n_pad] int8.  It shares no code with the
    kernels, and the tests hold the kernel route against it."""
    n_dev = pytree.flatten_up_to(layout.treedef, u_dev)[0].shape[1]
    words = flatbuf.pack_tree(layout, u_dev, batch_dims=2, delta=delta_tree,
                              rho=rho, delta_batch_dims=1)
    return _popcount_vote_words(words, mask, n_dev)


def _fused_vote(topo: Topology | None, u_buf, d_buf, rho: float,
                mask: torch.Tensor | None, v_buf: torch.Tensor | None,
                mu: float) -> torch.Tensor:
    """The kernel route's two halves with the data-axis gather between
    them: ONE ``sign_pack`` over the rank's rows, the [P_loc, D, n_words]
    words gathered over the data group, ONE ``vote_update`` on them
    (updating ``v_buf`` in place, or the int8 vote without it)."""
    words = comm.gather_devices(topo, kops.fused_pack_flat(u_buf, d_buf,
                                                           rho))
    return kops.fused_vote_update_words(words, v_buf, mask, mu)


def fused_sign_vote(u_dev, delta=None, rho: float = 0.0,
                    mask: torch.Tensor | None = None,
                    topo: Topology | None = None):
    """Whole-tree fused sign transport: tree in, vote tree out.

    u_dev: tree of [P, D, *leaf] pre-sign directions; delta: optional
    tree of [P, *leaf] DC corrections, fused pre-sign as
    ``u + rho * delta``; mask: optional [P, D] voter mask or integer
    weights.  Returns the [P, *leaf] int8 vote tree, bit-identical to
    ``ag_packed`` / ``ar_int8`` applied leaf by leaf.  Over a mesh the
    words cross the data group between the two launches."""
    layout = flatbuf.make_layout(u_dev, batch_dims=2)
    u_buf, d_buf = _fused_kernel_bufs(layout, u_dev, delta, None, rho)
    vote = _fused_vote(topo, u_buf, d_buf, rho, mask, None, 0.0)
    return flatbuf.unflatten_tree(layout, vote, batch_dims=1, cast=False)


def fused_sign_vote_update(layout: flatbuf.FlatLayout, u_dev,
                           delta_buf: torch.Tensor | None, rho: float,
                           mask: torch.Tensor | None, v_buf: torch.Tensor,
                           mu: torch.Tensor,
                           mu_static: float | None = None,
                           topo: Topology | None = None) -> torch.Tensor:
    """Flat-state fused transport: ``v_buf <- v_buf - mu * vote``.

    u_dev: tree of [P, D, *leaf] pre-sign directions; delta_buf:
    optional [P, n_pad] DC correction; v_buf: [P, n_pad] master buffer;
    mu: the step size as a 0-dim tensor, flushed (``signs.descend``);
    mu_static: its Python value when it does not change with the step.
    An f32 master with ``mu_static`` goes through the ``vote_update``
    kernel's read-modify-write and is **updated in place**; otherwise
    (e.g. ``decay``) the vote-only kernel route runs and ``v_buf - mu *
    vote`` is a new tensor.  Either way the arithmetic is the tree
    path's ``v - mu * vote``.  Over a mesh: the rank's [P_loc, n_pad]
    master, its rows' signs packed, the words gathered over the data
    group, the vote on its edges' [P_loc, D] mask rows."""
    u_buf, d_buf = _fused_kernel_bufs(layout, u_dev, None, delta_buf, rho)
    if mu_static is not None and v_buf.dtype == torch.float32:
        return _fused_vote(topo, u_buf, d_buf, rho, mask, v_buf,
                           float(mu_static))
    vote = _fused_vote(topo, u_buf, d_buf, rho, mask, None, 0.0)
    return signs.descend(v_buf, mu, vote)


def per_chunk(fn: Callable, out: torch.Tensor,
              *xs: torch.Tensor) -> torch.Tensor:
    """``out[..., c] = fn(*(x[..., c] for x in xs))`` over chunks c of the
    last dim (the leaf's coordinates, flattened by the caller), for an
    ``fn`` that computes each coordinate from that coordinate alone: the
    result is the unchunked ``fn``'s to the bit, with temporaries the
    size of one chunk.  Returns ``out``."""
    n = out.shape[-1]
    for c0 in range(0, n, CHUNK):
        sl = slice(c0, min(c0 + CHUNK, n))
        out[..., sl] = fn(*(x[..., sl] for x in xs))
    return out


def corrected_leaf(g: torch.Tensor, delta: torch.Tensor,
                   rho: float) -> torch.Tensor:
    """``g + rho*delta`` in g's dtype: g [P, D, *leaf], delta [P, *leaf]
    cast to g's dtype first, so in bf16 the product and the sum both
    round in bf16 (the replicated tree path's ``corrected``)."""
    p, d = g.shape[:2]
    g3 = g.reshape(p, d, -1)
    out = torch.empty(g3.shape, dtype=g.dtype, device=g.device)
    per_chunk(lambda gg, dl: gg + flatbuf.scaled(dl[:, None].to(gg.dtype),
                                                 rho),
              out, g3, delta.reshape(p, -1))
    return out.reshape(g.shape)


def fused_sign_vote_leaf(u_dev: torch.Tensor, delta: torch.Tensor | None,
                         rho: float,
                         mask: torch.Tensor | None) -> torch.Tensor:
    """The fused transport on ONE leaf (the FSDP lift's vote): u_dev [P,
    D, *leaf] -> the [P, *leaf] int8 vote of ``sgn(u + rho*delta)``,
    through one ``sign_pack`` and one ``vote_update`` vote-only launch on
    the leaf's [P, D, numel] view (``kops.fused_sign_vote_flat``).

    The fold rule of :func:`fused_sign_vote`, per leaf: an f32 leaf's
    correction (delta [P, *leaf], cast to f32) is added in the kernel,
    in f32; any other dtype adds it first, in the leaf's own dtype.  A
    numel that is not a multiple of ``LEAF_PAD`` is padded with zeros
    (+1 bits, dropped after the vote; gemma3's norms, not its matrices).
    Bitwise ``majority_vote_dev`` of the signs on every transport."""
    p, d = u_dev.shape[:2]
    leaf_shape = tuple(u_dev.shape[2:])
    fold = delta is not None and bool(rho) and u_dev.dtype == torch.float32
    if delta is not None and rho and not fold:
        u_dev = corrected_leaf(u_dev, delta, rho)
    u3 = u_dev.reshape(p, d, -1)
    n = u3.shape[-1]
    d2 = delta.reshape(p, n) if fold else None
    pad = -n % LEAF_PAD
    if pad:
        u3 = torch.nn.functional.pad(u3, (0, pad))
        if d2 is not None:
            d2 = torch.nn.functional.pad(d2.to(u3.dtype), (0, pad))
    vote = kops.fused_sign_vote_flat(u3, d2, rho if fold else 0.0, mask)
    return vote[:, :n].reshape((p,) + leaf_shape)


def majority_vote_dev(s_dev: torch.Tensor, mask: torch.Tensor | None,
                      transport: str, weight_bound: int | None = None,
                      topo: Topology | None = None) -> torch.Tensor:
    """Vote [P, D, *leaf] -> [P, *leaf] by transport and leaf shape: a
    minor dim that is not a multiple of 32 takes the integer tally."""
    if transport in ("ag_packed", "fused") and s_dev.shape[-1] % PACK == 0:
        return vote_ag_packed(s_dev, mask, topo)
    return vote_ar_int8(s_dev, mask, weight_bound=weight_bound, topo=topo)


def weighted_mean_dev(g_dev: torch.Tensor, dev_weights: torch.Tensor,
                      clients: int | None = None,
                      topo: Topology | None = None) -> torch.Tensor:
    """Edge aggregation ``sum_k (|D_qk|/D_q) g_k`` -> [P, *leaf].

    The device sum is a fold in voter order, so a leaf and its slice of
    the flat buffer add in the same order and the two state layouts stay
    bitwise identical.  ``clients=K`` (active virtual clients, merged
    voter axis [P, D*K]) re-associates it as the streamed sweep adds:
    per device a zeros-initialised fold over its K clients, then the
    fold over D (:func:`fold_devices`), so the merged and streamed
    modes give the same bits.

    Every product and partial sum that is subnormal flushes to the zero
    of its sign, as in the eager reference (XLA's CPU backend flushes
    them; with weights in [0, 1] a subnormal operand gives a subnormal
    or zero product, so flushing the results is its whole rule).  So the
    mean is the eager reference's to the last bit where the sums run in
    the same order (``tests/test_torch_means.py``).

    Over a mesh g_dev is the rank's [P_loc, V_loc, *leaf] block and
    dev_weights its edges' whole [P_loc, V] rows: the terms are
    gathered over the data group and folded as above, so the mean is
    the one-process mean to the bit (:func:`_across_devices`)."""
    if _crosses(topo, "data"):
        return _across_devices(
            topo, lambda g: weighted_mean_dev(g, dev_weights, clients),
            g_dev)
    if clients is not None:
        p, dk = g_dev.shape[:2]
        g3 = g_dev.reshape((p, dk // clients, clients) + g_dev.shape[2:])
        w3 = dev_weights.reshape(p, dk // clients, clients)
        acc = torch.zeros((p, dk // clients) + g_dev.shape[2:],
                          dtype=g_dev.dtype, device=g_dev.device)
        for c in range(clients):
            w_c = w3[:, :, c].reshape((p, dk // clients)
                                      + (1,) * (g_dev.dim() - 2))
            acc = signs.ftz(acc + signs.ftz(g3[:, :, c]
                                            * w_c.to(g_dev.dtype)))
        return fold_devices(acc)
    w = dev_weights.reshape(dev_weights.shape + (1,) * (g_dev.dim() - 2))
    w = w.to(g_dev.dtype)
    acc = signs.ftz(g_dev[:, 0] * w[:, 0])
    for k in range(1, g_dev.shape[1]):
        acc = signs.ftz(acc + signs.ftz(g_dev[:, k] * w[:, k]))
    return acc


def fold_devices(acc: torch.Tensor,
                 topo: Topology | None = None) -> torch.Tensor:
    """[P, D, *leaf] -> [P, *leaf], summed over D one device at a time
    (a fixed order: ``torch.sum`` may reduce a leaf and its flat slice
    in different orders), subnormal partial sums flushed.  Over a mesh
    the rank's [P_loc, D_loc, *leaf] terms are gathered over the data
    group first (:func:`_across_devices`)."""
    if _crosses(topo, "data"):
        return _across_devices(topo, fold_devices, acc)
    out = acc[:, 0]
    for k in range(1, acc.shape[1]):
        out = signs.ftz(out + acc[:, k])
    return out


# -- the streamed client sweep (ClientConfig.mode="stream") ------------------
#
# The sweep never widens the voter axis: each client's signs fold into a
# persistent SIGNED tally t += w_c * sgn(u_c), in the tally_dtype of the
# weight bound (every partial sum lies within it), and the threshold is
# deferred until after the client loop: t = 2*pos - n_eff, so t >= 0 is
# exactly the merged transports' 2*pos >= n_eff tie rule, and the two
# modes are bitwise identical by integer associativity.

def tally_dtype(weight_bound: int) -> torch.dtype:
    """The streamed tally's dtype: ``vote_ar_int8``'s promotion rule on
    the static weight bound (int8 / int16 / int32)."""
    return _tally_acc(weight_bound)


def tally_add_signs(tally: torch.Tensor, s: torch.Tensor,
                    weights: torch.Tensor) -> torch.Tensor:
    """One client's weighted signs: ``tally + w * s``.  tally: [P, D,
    *leaf] signed tally; s: [P, D, *leaf] int8 signs of ONE client;
    weights: [P, D] integer vote weights (0 = abstains).  The product is
    int32, narrowed to the tally dtype (exact within the weight bound)."""
    w = weights.to(torch.int32).reshape(weights.shape
                                        + (1,) * (s.dim() - 2))
    return tally + (s.to(torch.int32) * w).to(tally.dtype)


def tally_accumulate_words(words: torch.Tensor, weights: torch.Tensor,
                           tally: torch.Tensor) -> torch.Tensor:
    """Fold ONE client's packed sign words into the tally: words [P, D,
    W] int32, weights [P, D], tally [P, D, W*32]; per coordinate
    ``tally += w * (2*bit - 1)``."""
    sgn_c = 2 * signs.unpack_bits(words) - 1                 # [P, D, W*32]
    add = sgn_c * weights.to(torch.int32)[:, :, None]
    return tally + add.to(tally.dtype)


def tally_vote(tally: torch.Tensor, n_eff: torch.Tensor) -> torch.Tensor:
    """Deferred threshold: [P, *leaf] edge tally (int), [P] int32
    participating weight sum -> int8 vote, ``t >= 0 -> +1`` (merged's
    tie rule), 0 where the quorum is empty."""
    t = tally.to(torch.int32)
    one = torch.ones((), dtype=torch.int8, device=t.device)
    vote = torch.where(t >= 0, one, -one)
    n = n_eff.reshape((-1,) + (1,) * (vote.dim() - 1))
    return torch.where(n > 0, vote, torch.zeros_like(vote))


def tally_vote_dev(tally: torch.Tensor, n_eff: torch.Tensor,
                   topo: Topology | None = None) -> torch.Tensor:
    """[P, D, *leaf] per-device tallies -> [P, *leaf] int8 vote: the sum
    over D in int32 (exact, any order; over a mesh the rank's sum, then
    the sum over the data group), then :func:`tally_vote` (n_eff: the
    edges' global participating weight)."""
    t = torch.sum(tally, dim=1, dtype=torch.int32)
    return tally_vote(comm.sum_devices(topo, t), n_eff)


def fused_sign_tally_accumulate(layout: flatbuf.FlatLayout, u_dev,
                                delta_tree, delta_buf: torch.Tensor | None,
                                rho: float, weights: torch.Tensor,
                                tally: torch.Tensor) -> torch.Tensor:
    """Device-side half of the streamed fused transport: fold ONE
    client's (DC-corrected) signs into the [P, D, n_pad] tally with one
    ``tally_acc`` launch (**in place**; the tally is returned).

    u_dev: tree of [P, D, *leaf] directions of the current client;
    delta_tree / delta_buf: optional correction as a [P, *leaf] tree or
    a [P, n_pad] buffer, folded by the rule of :func:`fused_sign_vote`
    (in the kernel for all-f32 trees, else added first per leaf);
    weights: [P, D] integer vote weights of this client this round."""
    u_buf, d_buf = _fused_kernel_bufs(layout, u_dev, delta_tree, delta_buf,
                                      rho)
    return kops.fused_tally_acc_flat(u_buf, d_buf, rho, weights, tally)


def fused_tally_finish(layout: flatbuf.FlatLayout, tally: torch.Tensor,
                       n_eff: torch.Tensor, v_buf: torch.Tensor | None,
                       mu: torch.Tensor | None,
                       topo: Topology | None = None):
    """Edge-side half of the streamed fused transport, once per local
    step: sum the [P, D, n_pad] tallies over D, threshold them into the
    vote, and return ``v_buf - mu * vote`` (a new [P, n_pad] buffer; mu
    a flushed 0-dim tensor, as ``signs.descend`` takes it) or, without
    ``v_buf``, the vote as a [P, *leaf] int8 tree."""
    vote = tally_vote_dev(tally, n_eff, topo)                # [P, n_pad]
    if v_buf is None:
        return flatbuf.unflatten_tree(layout, vote, batch_dims=1,
                                      cast=False)
    return signs.descend(v_buf, mu, vote)


def pod_weighted_average(v: torch.Tensor, edge_weights: torch.Tensor,
                         topo: Topology | None = None) -> torch.Tensor:
    """Cloud aggregation ``w = sum_q (D_q/N) v_q``, copied back to every
    pod: a new [P, *leaf] tensor (never a broadcast view, since the
    fused update writes each pod's row in place).  Folded in pod order
    with subnormal products and partial sums flushed, as
    :func:`weighted_mean_dev` folds devices.  Over a mesh v is the
    rank's [P_loc, *leaf] edges, gathered over the pod group to [P,
    *leaf] and folded with the global [P] ``edge_weights``; the result
    is [P_loc, *leaf], gathered and folded chunk by chunk of the leaf's
    coordinates (``per_chunk``: the fold is coordinate-wise, so the bits
    are the unchunked fold's, with temporaries of one chunk)."""
    if _crosses(topo, "pods"):
        rows = v.shape[0]
        v2 = v.reshape(rows, -1)
        out = torch.empty_like(v2)
        per_chunk(lambda x: pod_weighted_average(
            comm.gather_pods(topo, x.contiguous()), edge_weights)[:rows],
            out, v2)
        return out.reshape(v.shape)
    w = edge_weights.reshape((-1,) + (1,) * (v.dim() - 1)).to(v.dtype)
    glob = signs.ftz(v[0] * w[0])
    for q in range(1, v.shape[0]):
        glob = signs.ftz(glob + signs.ftz(v[q] * w[q]))
    return glob.unsqueeze(0).expand_as(v).contiguous()
