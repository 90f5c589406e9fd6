"""Move parameters, flat buffers and whole train states between numpy
and the port.

A JAX parameter tree turned into numpy (``jax.tree.map(np.asarray, t)``)
is a dict of arrays; these helpers turn it into the port's tensors, and
back.  Nested dicts carry over leaf for leaf: an LM's tree
(``embed.table``, ``stacks.<block>.<leaf>`` with the leading layer dim
-- a tied block's, zamba2's ``stacks.shared_attn``, without one --,
``head.norm``) is the port's ``models.build`` tree; the flat buffers and
train states of such a tree carry over the same way.  bfloat16 arrays
(numpy dtype ``bfloat16`` from ``ml_dtypes``) move through their 16-bit
pattern, so every value survives bitwise.
A JAX ``TrainState`` mapped the same way (its flat slots keep their
``FlatState`` wrapper, with a numpy ``buf``) carries over slot for slot
with :func:`train_state_from_numpy`, so both packages can start from the
same mid-run state.  A serving cache (``{"stacks": ..., "pos": ...}``,
the JAX package's ``built.prefill``'s second output) carries over with
:func:`cache_from_numpy` and back with :func:`cache_to_numpy`.
Over a process mesh a rank takes its block of a global state
(``train_state_from_numpy(..., topo=)``, the blocks of
``hier.state_blocks``) and :func:`gather_train_state` brings the ranks'
blocks back to the global numpy state, on every rank; a mesh
checkpoint's writer takes from each rank only the blocks no other rank
hands it (:func:`state_pieces`, into the shapes of
:func:`global_like`).  With a model
axis the global state of a flat slot is the JAX sharded layout's
multi-bucket buffer (each model rank's bucket side by side), and of a
tree slot the logical leaves (each sharded leaf's blocks concatenated,
the zero tail dropped); a rank takes bucket ``model_rank`` of the one
and block ``model_rank`` of the other (:func:`local_params` for a
parameter tree).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.core import (comm, device_axis, flatbuf, hier, pytree,
                              shardflat)
from repro_torch.core.topology import Topology

PyTree = Any


def tensor_from_numpy(a, device: str | torch.device = "cpu") -> torch.Tensor:
    """numpy array (any dtype torch has, or bfloat16) -> tensor, bitwise."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.int16).copy())
        return t.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.ascontiguousarray(a).copy()).to(device)


def tensor_to_numpy(t: torch.Tensor) -> np.ndarray:
    """tensor -> numpy array; bfloat16 comes back as float32 (exact)."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.to(torch.float32)
    return t.numpy()


def params_from_numpy(tree: PyTree,
                      device: str | torch.device = "cpu") -> PyTree:
    """A parameter tree with numpy leaves -> the same tree of tensors."""
    return pytree.tree_map(lambda a: tensor_from_numpy(a, device), tree)


def params_to_numpy(tree: PyTree) -> PyTree:
    return pytree.tree_map(tensor_to_numpy, tree)


def local_params(tree: PyTree, topo: Topology, specs: PyTree | None,
                 device: str | torch.device = "cpu",
                 batch_dims: int = 0) -> tuple:
    """A JAX parameter tree (numpy leaves, ``batch_dims`` leading dims)
    -> (this model rank's local tree, the tree's sharded layout, this
    rank's bucket ``[*batch, bucket_pad]``): block ``model_rank`` of
    every leaf ``specs`` split (zero tail included) and every other
    leaf whole; the bucket is bucket ``model_rank`` of the JAX sharded
    layout's buffer, bitwise."""
    full = params_from_numpy(tree, device)
    layout = shardflat.param_layout(topo, specs, full, batch_dims)
    local = shardflat.local_block(topo, layout, full, batch_dims)
    return local, layout, shardflat.flatten(topo, layout, local, batch_dims)


def cache_from_numpy(cache, device: str | torch.device = "cpu") -> dict:
    """A serving cache with numpy leaves (JAX's under ``jax.tree.map(
    np.asarray, ...)``) -> the port's: the stacks leaf for leaf (bfloat16
    bitwise), ``pos`` (JAX's int32 scalar) a host int."""
    return {"stacks": params_from_numpy(cache["stacks"], device),
            "pos": int(np.asarray(cache["pos"]))}


def cache_to_numpy(cache: dict) -> dict:
    """The port's serving cache with numpy leaves (bfloat16 widened to
    float32 exactly) and ``pos`` an int32 scalar, as JAX's has it."""
    return {"stacks": params_to_numpy(cache["stacks"]),
            "pos": np.int32(cache["pos"])}


def flat_state_from_numpy(buf, layout: flatbuf.FlatLayout,
                          batch_dims: int = 1,
                          device: str | torch.device = "cpu"
                          ) -> flatbuf.FlatState:
    """A ``[*batch, n_pad]`` numpy buffer laid out by ``layout`` (the
    port's layout of the same tree: offsets match the JAX package's slot
    for slot) -> a :class:`flatbuf.FlatState`."""
    t = tensor_from_numpy(buf, device)
    if t.shape[-1] != layout.n_pad:
        raise ValueError(f"buffer length {t.shape[-1]} != layout n_pad "
                         f"{layout.n_pad}")
    return flatbuf.FlatState(t, layout, batch_dims)


SLOTS = ("params", "agg_next", "delta", "delta_next", "ef", "mom",
         "corr_cl", "corr_edge")


def _shard_layout(state: hier.TrainState, topo: Topology | None,
                  layout: flatbuf.FlatLayout | None):
    """The master's sharded layout under a model axis (given, or read off
    a flat slot's bucket), else None."""
    if topo is None or topo.model_shards == 1:
        return None
    if layout is None:
        for name in SLOTS:
            slot = getattr(state, name)
            if isinstance(slot, flatbuf.FlatState):
                layout = slot.layout.sharded(topo.model_shards)
                break
    return layout if layout is not None and layout.shards > 1 else None


def train_state_from_numpy(state, like: hier.TrainState,
                           topo: Topology | None = None,
                           layout: flatbuf.FlatLayout | None = None,
                           master_specs: PyTree | None = None
                           ) -> hier.TrainState:
    """A train state with numpy leaves -- a JAX ``TrainState`` under
    ``jax.tree.map(np.asarray, ...)``, or :func:`train_state_to_numpy`'s
    output -- into the port's, every slot included.

    ``like`` is a port state of the same config (``init_fn``'s), which
    gives each slot's layout, dtype and device: a flat slot takes the
    source's ``buf`` (``[P, n_pad]`` or ``[P, D*K, n_pad]``; the port's
    offsets match the JAX package's slot for slot), a tree slot its
    leaves.  Step comes from the source; the generator is ``like``'s (a
    ``jax.random`` key has no torch counterpart: seed ``like`` as the run
    needs).  A slot present in one state and None in the other raises,
    as does a shape that does not match or a dtype that would round.

    With a mesh topology ``state`` is the global state and ``like`` the
    rank's (its ``init_fn``'s): each slot gets the rank's block
    (``hier.state_blocks``), with a model axis its bucket of a flat
    slot and its blocks of a tree slot's sharded leaves (``layout``: the
    master's sharded layout, needed where ``like`` has no flat slot).
    An FSDP state (``master_specs``, the bundle's) gives each rank, of
    every per-edge slot, its shard: its rows, its data rank's block of
    each leaf's data-sharded dim (``hier.fsdp_index``) and its model
    block of the other model-split dims."""
    out = {"step": int(np.asarray(state.step)), "rng": like.rng}
    mesh = topo is not None and topo.mesh is not None
    lay = _shard_layout(like, topo, layout) if mesh else None
    # a tree slot's index is the [P, D] block's; a flat slot's ends in
    # the rank's bucket
    blocks = flat_blocks = fsdp_blocks = None
    if mesh:
        blocks = hier.state_blocks(topo, _clients(like, topo))
        flat_blocks = hier.state_blocks(topo, _clients(like, topo), lay)
        if master_specs is not None:
            fsdp_blocks = hier.state_blocks(topo, master_specs=master_specs,
                                            params=state.params)
    mdims = device_axis.data_dims(master_specs, like.params)
    for name in SLOTS:
        src, ref = getattr(state, name), getattr(like, name)
        if (src is None) != (ref is None):
            raise ValueError(
                f"slot {name}: present in only one of the source and the "
                "port's state (a different config?)")
        if ref is None:
            out[name] = None
            continue
        flat = isinstance(ref, flatbuf.FlatState)
        idx = (getattr(flat_blocks if flat else blocks, name) if mesh
               else None)
        cut = ((lambda a: np.asarray(a)[idx]) if idx is not None
               else (lambda a: a))
        if flat:
            out[name] = ref.replace(_like(
                name, cut(getattr(src, "buf", src)), ref.buf))
            continue
        ref_leaves, td = pytree.tree_flatten(ref)
        fsdp = fsdp_blocks is not None and name not in hier.PER_VOTER
        if fsdp:     # each leaf's own index: its rows and data block
            idxs = pytree.flatten_up_to(td, getattr(fsdp_blocks, name))
            leaves = [np.asarray(a)[i] for a, i in zip(
                pytree.flatten_up_to(td, src), idxs)]
        else:
            leaves = [cut(a) for a in pytree.flatten_up_to(td, src)]
        if lay is not None:
            batch = 2 if name in hier.PER_VOTER else 1
            leaves = [a if fsdp and s.shard_dim == dim
                      else tensor_to_numpy(flatbuf.slot_block(
                          s, tensor_from_numpy(a), topo.model_rank,
                          lay.shards, batch))
                      for s, a, dim in zip(lay.slots, leaves, mdims)]
        out[name] = pytree.tree_unflatten(td, [
            _like(name, a, r) for a, r in zip(leaves, ref_leaves)])
    return hier.TrainState(**out)


def _clients(like: hier.TrainState, topo: Topology) -> int:
    """K, read off the rank's per-voter slots (1 where it has none)."""
    for name in hier.PER_VOTER:
        slot = getattr(like, name)
        if slot is not None:
            lead = (slot.buf if isinstance(slot, flatbuf.FlatState)
                    else pytree.tree_flatten(slot)[0][0]).shape[1]
            return lead // topo.local_devices
    return 1


def gather_train_state(state: hier.TrainState, topo: Topology,
                       layout: flatbuf.FlatLayout | None = None,
                       logical: bool = False,
                       master_specs: PyTree | None = None
                       ) -> hier.TrainState:
    """The global state of a mesh run, as :func:`train_state_to_numpy`
    gives it, on every rank: each per-voter slot gathered over the data
    group, then every slot over the pod group (a collective: every rank
    of the mesh calls it).  With a model axis, a flat slot's buckets
    are gathered over the model group into the JAX sharded layout's
    global multi-bucket buffer, and a tree slot's sharded leaves into
    their logical extent (``layout``: the master's sharded layout,
    needed for a tree state; a flat slot's bucket carries it).
    ``logical=True`` gives every flat slot as its logical numpy tree
    instead (the zero tails and the padding dropped), the form in
    which states of any model axis compare.  An FSDP state
    (``master_specs``) has each per-edge slot's shards gathered over the
    data group first (``hier.gather_shards``)."""
    lay = _shard_layout(state, topo, layout)

    def full(name, x):
        if name in hier.PER_VOTER:
            x = comm.gather_devices(topo, x)
        return comm.gather_pods(topo, x)

    out = {"step": state.step, "rng": None}
    for name in SLOTS:
        slot = getattr(state, name)
        batch = 2 if name in hier.PER_VOTER else 1
        if isinstance(slot, flatbuf.FlatState):
            buf = full(name, slot.buf)
            glay = slot.layout
            if lay is not None:
                buf = comm.gather_model(topo, buf, buf.dim() - 1)
                glay = slot.layout.sharded(topo.model_shards)
            out[name] = (params_to_numpy(flatbuf.unflatten_tree(
                glay, buf, batch, cast=False)) if logical
                else tensor_to_numpy(buf))
        elif slot is None:
            out[name] = None
        else:
            if master_specs is not None and name not in hier.PER_VOTER:
                slot = hier.gather_shards(topo, slot, master_specs)
            tree = pytree.tree_map(lambda x, n=name: full(n, x), slot)
            if lay is not None:
                tree = shardflat.gather(topo, lay, tree, batch)
            out[name] = params_to_numpy(tree)
    return hier.TrainState(**out)


def rank_view(topo: Topology, rank: int) -> Topology:
    """``topo`` as rank ``rank`` of its mesh sees it: the same grid and
    groups at that rank's coordinates (for the block indices of another
    rank; no collective may run on it)."""
    m = topo.mesh
    rest, model_rank = divmod(rank, m.model)
    pod_rank, data_rank = divmod(rest, m.data)
    return dataclasses.replace(topo, mesh=dataclasses.replace(
        m, pod_rank=pod_rank, data_rank=data_rank, model_rank=model_rank))


def _model_dim(slot: flatbuf.LeafSlot | None, data_dim: int | None):
    """The leaf dim the model axis splits on its own (the sharded
    layout's ``shard_dim``, unless an FSDP spec splits that dim over
    model and data together), or None."""
    if slot is None or slot.shard_dim is None or slot.shard_dim == data_dim:
        return None
    return slot.shard_dim


def _fsdp_blocks(spec, topo: Topology) -> int:
    """How many ranks' shards tile a leaf's data-sharded dim: the data
    group's, times the model group's where the spec names both."""
    dim = device_axis.data_dim(spec)
    m = topo.mesh
    return m.data * (m.model if isinstance(spec[dim], tuple) else 1)


def global_like(state: hier.TrainState, topo: Topology,
                layout: flatbuf.FlatLayout | None = None,
                master_specs: PyTree | None = None) -> hier.TrainState:
    """The global state of a mesh run, as meta tensors: what
    :func:`gather_train_state` assembles, by shape and dtype, without
    moving a byte.  Each flat slot is a :class:`flatbuf.FlatState` of
    the global ``[P, (D*K,) n_pad]`` buffer under the global layout (the
    multi-bucket one under a model axis); each tree leaf has its logical
    global shape (``[P, (D*K,) *leaf]``: a model-split dim at its logical
    extent, an FSDP shard's data dim whole).  ``step`` and ``rng`` are
    the rank's own (every rank holds them whole).  ``layout``,
    ``master_specs``: as for :func:`gather_train_state`."""
    lay = _shard_layout(state, topo, layout)
    k = _clients(state, topo)
    out = {"step": state.step, "rng": state.rng}
    for name in SLOTS:
        slot = getattr(state, name)
        if slot is None:
            out[name] = None
            continue
        lead = (topo.pods,) + ((topo.devices_per_pod * k,)
                               if name in hier.PER_VOTER else ())
        if isinstance(slot, flatbuf.FlatState):
            glay = (slot.layout.sharded(topo.model_shards) if lay is not None
                    else slot.layout)
            out[name] = flatbuf.FlatState(torch.empty(
                lead + (glay.n_pad,), dtype=slot.buf.dtype, device="meta"),
                glay, slot.batch_dims)
            continue
        leaves, td = pytree.tree_flatten(slot)
        fsdp = master_specs is not None and name not in hier.PER_VOTER
        specs = (pytree.flatten_up_to(td, master_specs) if fsdp
                 else [None] * len(leaves))
        shapes = []
        for i, (x, spec) in enumerate(zip(leaves, specs)):
            shape = list(x.shape[len(lead):])
            dim = device_axis.data_dim(spec)
            if dim is not None:
                shape[dim] *= _fsdp_blocks(spec, topo)
            s = lay.slots[i] if lay is not None else None
            sd = _model_dim(s, dim)
            if sd is not None:
                shape[sd] = s.global_shape(lay.shards)[sd]
            shapes.append(torch.empty(lead + tuple(shape), dtype=x.dtype,
                                      device="meta"))
        out[name] = pytree.tree_unflatten(td, shapes)
    return hier.TrainState(**out)


@dataclasses.dataclass(frozen=True)
class Piece:
    """A block of a global slot that one rank hands the writer of a mesh
    checkpoint: ``slot``, the leaf's position in the slot's flatten order
    (None for a flat slot's buffer), ``index`` (a tuple of slices into
    the global leaf) and ``block``, the rank's tensor of that shape."""
    slot: str
    leaf: int | None
    index: tuple
    block: torch.Tensor


def _index(ndim: int, at: dict) -> tuple:
    return tuple(at.get(i, slice(None)) for i in range(ndim))


def state_pieces(state: hier.TrainState, topo: Topology,
                 glike: hier.TrainState,
                 layout: flatbuf.FlatLayout | None = None,
                 master_specs: PyTree | None = None) -> list[Piece]:
    """The blocks of this rank's ``state`` that the global state
    ``glike`` (:func:`global_like`) takes from it, each exactly once
    across the mesh: a per-voter slot's block from every rank; a
    per-edge slot's rows from data rank 0 of each pod (the data ranks
    hold the same rows), under FSDP each data rank's shard (a leaf the
    master specs keep whole from data rank 0); with a model axis each
    model rank's bucket of a flat slot and its block of a tree slot's
    split leaf, cut to the leaf's logical extent (a leaf every model
    rank holds whole from model rank 0).  On :func:`rank_view` of
    another rank the pieces are that rank's (their ``block`` has the
    right shape and dtype; its values are this rank's)."""
    lay = _shard_layout(state, topo, layout)
    m = topo.mesh
    k = _clients(state, topo)
    blocks = hier.state_blocks(topo, k)
    flat_blocks = hier.state_blocks(topo, k, lay)
    out = []
    for name in SLOTS:
        slot = getattr(state, name)
        if slot is None:
            continue
        voter = name in hier.PER_VOTER
        if isinstance(slot, flatbuf.FlatState):
            if voter or m.data_rank == 0:
                out.append(Piece(name, None, getattr(flat_blocks, name),
                                 slot.buf))
            continue
        leaves, td = pytree.tree_flatten(slot)
        gleaves = pytree.flatten_up_to(td, getattr(glike, name))
        fsdp = master_specs is not None and not voter
        specs = (pytree.flatten_up_to(td, master_specs) if fsdp
                 else [None] * len(leaves))
        lead = 2 if voter else 1
        for i, (x, g, spec) in enumerate(zip(leaves, gleaves, specs)):
            dim = device_axis.data_dim(spec)
            if fsdp:
                at = dict(enumerate(hier.fsdp_index(topo, spec,
                                                    tuple(g.shape))))
                by_data = dim is not None
                by_model = by_data and isinstance(spec[dim], tuple)
            else:
                at = dict(enumerate(getattr(blocks, name)))
                by_data, by_model = voter, False
            s = lay.slots[i] if lay is not None else None
            sd = _model_dim(s, dim)
            if sd is not None:
                ax = lead + sd
                w = s.shape[sd]
                keep = s.local_extent(lay.shards, m.model_rank)
                if keep == 0:
                    continue
                x = x.narrow(ax, 0, keep)
                at[ax] = slice(m.model_rank * w, m.model_rank * w + keep)
                by_model = True
            if ((by_data or m.data_rank == 0)
                    and (by_model or m.model_rank == 0)):
                out.append(Piece(name, i, _index(x.dim(), at), x))
    return out


def _like(name: str, a, ref: torch.Tensor) -> torch.Tensor:
    """numpy ``a`` as a tensor of ``ref``'s shape, dtype and device;
    a float32 source takes a bfloat16 slot only where that is exact."""
    t = tensor_from_numpy(a, ref.device)
    if t.shape != ref.shape:
        raise ValueError(f"slot {name}: shape {tuple(t.shape)}, the port's "
                         f"state holds {tuple(ref.shape)}")
    if t.dtype != ref.dtype:
        cast = t.to(ref.dtype)
        if not (t.dtype.is_floating_point and ref.dtype.is_floating_point
                and torch.equal(cast.to(t.dtype), t)):
            raise ValueError(f"slot {name}: dtype {t.dtype} does not fit "
                             f"the port's {ref.dtype} exactly")
        t = cast
    return t


def train_state_to_numpy(state: hier.TrainState) -> hier.TrainState:
    """The port's state with numpy leaves (flat slots as their numpy
    buffers, bfloat16 widened to float32 exactly) and no generator:
    :func:`train_state_from_numpy` turns it back."""
    out = {"step": state.step, "rng": None}
    for name in SLOTS:
        slot = getattr(state, name)
        if isinstance(slot, flatbuf.FlatState):
            out[name] = tensor_to_numpy(slot.buf)
        else:
            out[name] = (None if slot is None
                         else pytree.tree_map(tensor_to_numpy, slot))
    return hier.TrainState(**out)
