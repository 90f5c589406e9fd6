"""Serving parameters straight from a training state.

The JAX package's ``launch/specs.py`` for serving on one card:
:func:`serve_params_from_flat` turns a training run's flat
master (``state_layout="flat"``: ONE ``[P, n_pad]`` buffer) into the
parameter tree that ``built.prefill`` and ``built.decode_step`` take,
as slice views of edge 0's row -- zero-copy: every leaf shares the
buffer's storage, and no per-leaf tree is assembled.  After the cloud
mean the edge models are equal, so edge 0 stands for all.  Cast only
when a ``dtype`` is given; the cast is then the only copy.
:func:`serve_params_from_tree` does the same for a tree-layout state's
``[P, *leaf]`` edge models -- the FSDP regime's masters, which an FSDP
config within ``build.SERVE_RESIDENT_BUDGET`` serves resident.

Not ported yet: serving over a model axis (``serve_param_shardings``
over the sharded layouts of ``core.shardflat``) and the rest of the
module (the dry run's input and state specs): ROADMAP items 16 and
17d.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.core import flatbuf, pytree
from repro_torch.models.build import BuiltModel

PyTree = Any


def serve_params_from_flat(built: BuiltModel, fs: flatbuf.FlatState,
                           dtype: torch.dtype | None = None) -> PyTree:
    """Flat-state checkpoint -> the serve parameter tree, zero-copy.

    ``fs`` may carry the training state's leading pod dim ([P, n_pad]):
    serving takes edge 0.  Its layout must be that of ``built``'s tree.
    (The JAX package's signature also takes the topology, for its
    sharded layouts.)"""
    want = pytree.tree_flatten(built.abstract_params())[1]
    if fs.layout.treedef != want:
        raise ValueError(f"the flat state's layout is not {built.cfg.name}'s "
                         "parameter tree")
    if fs.batch_dims:
        fs = flatbuf.FlatState(fs.buf[(0,) * fs.batch_dims], fs.layout,
                               batch_dims=0)
    tree = fs.tree()
    if dtype is None:
        return tree
    return pytree.tree_map(
        lambda v: v.to(dtype) if v.dtype.is_floating_point else v, tree)


def serve_params_from_tree(params: PyTree,
                           dtype: torch.dtype | None = None) -> PyTree:
    """A tree-layout state's edge models (``[P, *leaf]`` leaves, e.g.
    ``hier.edge_params(state)``) -> the serve tree: edge 0 of every leaf,
    as views, cast to ``dtype`` when one is given."""
    def take(v):
        v = v[0]
        return v.to(dtype) if dtype is not None and v.dtype.is_floating_point \
            else v
    return pytree.tree_map(take, params)


def serve_params_abstract(built: BuiltModel) -> PyTree:
    """The serve tree's shapes and dtypes, on the meta device: its
    floating leaves bfloat16, as they are served."""
    return pytree.tree_map(
        lambda a: torch.empty(a.shape, device="meta",
                              dtype=torch.bfloat16
                              if a.dtype.is_floating_point else a.dtype),
        built.abstract_params())
