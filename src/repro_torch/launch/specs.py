"""Serving parameters straight from a training state, on one card or on
a rank of a process mesh.

The JAX package's ``launch/specs.py`` for serving:
:func:`serve_params_from_flat` turns a training run's flat master
(``state_layout="flat"``: ONE ``[P, n_pad]`` buffer, or on a rank of a
mesh with a model axis its ``[P_loc, bucket_pad]`` bucket of the
sharded layout, ``core.shardflat``) into the parameter tree that
``built.prefill`` and ``built.decode_step`` take, as slice views of
edge 0's row -- zero-copy: every leaf shares the buffer's storage, no
per-leaf tree is assembled and nothing crosses the model group; a
sharded leaf's padded block is cut to its logical extent
(``shardflat.logical``), so the zero tail never reaches the model.
After the cloud mean the edge models are equal, so edge 0 stands for
all; a state taken mid-round is served as edge 0 too, on every pod (a
rank of pod 0 serves its own row, the other pods receive that row once
over the pod group).  Cast only when a ``dtype`` is given; the cast is
then the only copy.  :func:`serve_params_from_tree` does the same for a
tree-layout state's ``[P, *leaf]`` edge models (on a rank, its blocks)
-- the FSDP regime's masters, which an FSDP config within
``build.SERVE_RESIDENT_BUDGET`` serves resident in one process, and
which in the gather layout (``built.serve_layout == "gather"``) are
served as they are stored: on a rank of a mesh its data shard of every
leaf, ``[P_loc, *shard]``, as ``run_training`` leaves them, gathered a
layer at a time by the serve itself (``build.ServeGatherPlan``).
:func:`serve_param_specs` (JAX's ``serve_param_shardings``) and
:func:`serve_params_abstract` give the rank's spec tree and shapes.

Not ported yet: the dry run's input and state specs (ROADMAP item 16).
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.core import comm, device_axis, flatbuf, pytree, shardflat
from repro_torch.models import build as build_mod
from repro_torch.models.build import BuiltModel

PyTree = Any


def _cast(tree: PyTree, dtype: torch.dtype | None) -> PyTree:
    if dtype is None:
        return tree
    return pytree.tree_map(
        lambda v: v.to(dtype) if v.dtype.is_floating_point else v, tree)


def _rank_layout(built: BuiltModel) -> flatbuf.FlatLayout:
    """The parameter tree's layout at ``built.topo``'s model axis (the
    sharded one over a model axis above 1)."""
    return shardflat.param_layout(built.topo, built.bundle.specs,
                                  built.abstract_params())


def serve_params_from_flat(built: BuiltModel, fs: flatbuf.FlatState,
                           dtype: torch.dtype | None = None) -> PyTree:
    """Flat-state checkpoint -> the serve parameter tree, zero-copy.

    ``fs`` may carry the training state's leading pod dim ([P, n_pad]):
    serving takes edge 0, as the JAX package does.  On a mesh, pod rank
    0's ranks hold it (their first row, served as views of ``fs``); the
    ranks of the other pods, which hold edges ``p * P_loc`` on, receive
    pod 0's row once over the pod group (``comm.broadcast_pods``; every
    rank of the pod group calls this together) and serve views of it.
    The layout must be that of ``built``'s tree at ``built.topo``'s
    model axis: on a rank of a mesh with a model axis, the bucket of the
    sharded layout that ``run_training`` leaves there, whose views are
    the rank's blocks."""
    want = _rank_layout(built)
    if fs.layout.treedef != want.treedef or [s.shape for s in
                                             fs.layout.slots] != [
            s.shape for s in want.slots]:
        raise ValueError(f"the flat state's layout is not {built.cfg.name}'s "
                         "parameter tree at this model axis")
    if fs.batch_dims:
        row = comm.broadcast_pods(built.topo, fs.buf[(0,) * fs.batch_dims])
        fs = flatbuf.FlatState(row, fs.layout, batch_dims=0)
    tree = shardflat.logical(built.topo, want, fs.tree())
    return _cast(tree, dtype)


def serve_params_from_tree(params: PyTree, dtype: torch.dtype | None = None,
                           built: BuiltModel | None = None) -> PyTree:
    """A tree-layout state's edge models (``[P, *leaf]`` leaves, e.g.
    ``hier.edge_params(state)``; on a rank with a model axis, its
    ``[P_loc, *block]`` blocks, with ``built`` to cut each padded block
    to its logical extent) -> the serve tree: edge 0 of every leaf, as
    views, cast to ``dtype`` when one is given.  On a mesh with pods,
    ``built`` also names the pod group: pod rank 0's ranks serve views
    of their first edge, the other pods' receive it leaf by leaf
    (``comm.broadcast_pods``), as :func:`serve_params_from_flat` does.
    In the gather layout (an FSDP ``built`` whose ``serve_layout`` is
    ``"gather"``) the leaves are the rank's FSDP shards ``[P_loc,
    *shard]`` and stay so -- no gather, no copy but the cast --, each
    checked against :func:`serve_params_abstract`'s shape."""
    topo = None if built is None else built.topo
    tree = pytree.tree_map(lambda v: comm.broadcast_pods(topo, v[0]), params)
    if built is not None and built.serve_layout == "gather" \
            and built.cfg.param_mode == "fsdp":
        want = pytree.flatten_up_to(pytree.tree_flatten(tree)[1],
                                    serve_params_abstract(built))
        for got, w in zip(pytree.tree_flatten(tree)[0], want):
            if got.shape != w.shape:
                raise ValueError(
                    f"a shard of shape {tuple(got.shape)} where "
                    f"{built.cfg.name}'s gather layout holds "
                    f"{tuple(w.shape)} on this rank")
    elif built is not None:
        tree = shardflat.logical(built.topo, _rank_layout(built), tree)
    return _cast(tree, dtype)


def serve_param_specs(built: BuiltModel) -> PyTree:
    """Each served leaf's spec (the JAX ``serve_param_shardings``): the
    compute specs when the weights are resident, the master specs in the
    gather layout (an FSDP config's data-sharded ones)."""
    return (built.bundle.specs if built.serve_layout == "resident"
            else built.bundle.master_specs)


def serve_params_abstract(built: BuiltModel) -> PyTree:
    """The rank's serve tree's shapes and dtypes, on the meta device: each
    leaf its block under :func:`serve_param_specs` -- resident, its block
    at ``built.topo``'s model axis (the whole leaf without one); in the
    gather layout, its FSDP shard over the data ranks too --, its
    floating leaves bfloat16, as they are served."""
    sizes = {"pod": 1, "data": device_axis.data_ranks(built.topo),
             "model": built.topo.model_shards}

    def block(a, spec):
        shape = build_mod.block_shape(tuple(a.shape), tuple(spec or ()),
                                      sizes)
        return torch.empty(shape, device="meta",
                           dtype=torch.bfloat16 if a.dtype.is_floating_point
                           else a.dtype)
    return pytree.tree_map(block, built.abstract_params(),
                           serve_param_specs(built))
