"""A model rank's part of a sharded flat layout, with no model-axis
collective (the JAX package's ``core/shardflat.py``).

A sharded :class:`~repro_torch.core.flatbuf.FlatLayout` (``shards > 1``,
from ``flatbuf.make_layout(..., sharding=model_sharding(topo, specs))``)
gives each model rank one contiguous, tile-aligned bucket of the flat
coordinates.  Where the JAX package runs a ``shard_map`` program, a rank
here simply holds its own block: its local tree (block ``model_rank`` of
every sharded leaf along the slot's ``shard_dim``, at the padded block
size, and every copy leaf whole) and its ``[*batch, bucket_pad]``
buffer, laid out by ``layout.bucket()``.  So the ordinary flatbuf
flatten / unflatten / pack run on the rank's own block, and the global
multi-bucket buffer -- bitwise the JAX layout's -- is the ranks'
buckets side by side (``convert.gather_train_state``).

An uneven leaf's last blocks carry a zero tail (``slot.shard_pad``):
:func:`local_block` zero-extends it, :func:`logical` cuts a rank's
leaves back to the rows it really holds (what the model's forward and
every norm read), and :func:`gather` drops it.  The tail's coordinates
are don't-care, like the tile padding: they vote +1 and drift, and
nothing reads them back.

With ``topo.model_shards == 1`` (no mesh, or a mesh of model 1) every
function is the unsharded layout's.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.core import comm, flatbuf, pytree
from repro_torch.core.topology import Topology

PyTree = Any
AXIS = "model"


def model_sharding(topo: Topology, specs: PyTree) -> flatbuf.ModelSharding:
    """The :class:`flatbuf.ModelSharding` of this topology's model axis."""
    return flatbuf.ModelSharding(shards=topo.model_shards, axis=AXIS,
                                 specs=specs)


def param_layout(topo: Topology, specs: PyTree | None, tree: PyTree,
                 batch_dims: int = 0) -> flatbuf.FlatLayout:
    """The (sharded, where ``specs`` split a leaf over a model axis above
    1) layout of a GLOBAL tree of ``batch_dims`` leading dims."""
    sharding = (model_sharding(topo, specs)
                if specs is not None and topo.model_shards > 1 else None)
    return flatbuf.make_layout(tree, batch_dims=batch_dims,
                               sharding=sharding)


def local_block(topo: Topology, layout: flatbuf.FlatLayout, tree: PyTree,
                batch_dims: int = 0) -> PyTree:
    """This rank's block of a global (logical) tree: bucket
    ``model_rank``'s slice, with the padded zero tail (``bucket_tree``)."""
    if layout.shards == 1:
        return tree
    return flatbuf.bucket_tree(layout, tree, topo.model_rank, batch_dims)


def flatten(topo: Topology, layout: flatbuf.FlatLayout, tree: PyTree,
            batch_dims: int = 1, dtype: Any = None) -> torch.Tensor:
    """A rank's local tree (:func:`local_block`'s shapes) -> its bucket,
    ``[*batch, bucket_pad]``: bitwise bucket ``model_rank`` of the
    global ``flatbuf.flatten_tree`` of the logical tree."""
    return flatbuf.flatten_tree(layout.bucket(), tree, batch_dims, dtype)


def logical(topo: Topology, layout: flatbuf.FlatLayout, tree: PyTree,
            batch_dims: int = 0) -> PyTree:
    """A rank's local tree cut to the rows it really holds: each sharded
    leaf narrowed to its logical extent on this rank (views; a rank wholly
    in the tail gets an empty block)."""
    if layout.shards == 1 or not any(s.shard_pad for s in layout.slots):
        return tree
    out = []
    for slot, leaf in zip(layout.slots,
                          pytree.flatten_up_to(layout.treedef, tree)):
        if slot.shard_dim is not None and slot.shard_pad:
            leaf = leaf.narrow(batch_dims + slot.shard_dim, 0,
                               slot.local_extent(layout.shards,
                                                 topo.model_rank))
        out.append(leaf)
    return pytree.tree_unflatten(layout.treedef, out)


def gather(topo: Topology, layout: flatbuf.FlatLayout, tree: PyTree,
           batch_dims: int = 0) -> PyTree:
    """The global logical tree from every model rank's local tree (a
    collective over the model group; copies are taken from this rank)."""
    if layout.shards == 1:
        return tree
    out = []
    for slot, leaf in zip(layout.slots,
                          pytree.flatten_up_to(layout.treedef, tree)):
        if slot.shard_dim is not None:
            ax = batch_dims + slot.shard_dim
            leaf = comm.gather_model(topo, leaf, ax)
            leaf = leaf.narrow(ax, 0, leaf.shape[ax] - slot.shard_pad)
        out.append(leaf)
    return pytree.tree_unflatten(layout.treedef, out)
