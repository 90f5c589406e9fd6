"""Serving parameters straight from a training state, on one card or on
a rank of a process mesh; and the dry run's abstract inputs and state.

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

The dry run's stand-ins (``launch.dryrun``; the JAX module's
``ShapeDtypeStruct``s with a ``NamedSharding``): :func:`batch_axes`,
:func:`train_batch_abstract`, :func:`weights_abstract`,
:func:`train_state_abstract`, :func:`prefill_batch_abstract` and
:func:`decode_args_abstract`.  Where JAX gives a global shape and its
sharding, each gives *this rank's block* -- what the rank holds, the
shard shape of the JAX sharding -- as tensors with no storage: on the
meta device, or fake tensors of ``topo.device`` made in the
``FakeTensorMode`` ``mode`` a caller passes (the dry run's, in which
the step is traced) -- and the spec tree beside it: ``(blocks,
specs)``, a spec a tuple of axis names (``"pod"``, ``"data"``,
``"model"``, a tuple of them, or None) per dim of the global shape,
``()`` where every rank holds the whole.  The port's tokens are int64
where JAX's are int32 (``data.synthetic``'s stream, and the embedding's
index dtype); every other dtype is JAX's.
"""
from __future__ import annotations

import contextlib
from typing import Any

import torch

from repro_torch.core import (comm, device_axis, flatbuf, hier, pytree,
                              shardflat)
from repro_torch.core.topology import Topology
from repro_torch.models import build as build_mod
from repro_torch.models.build import BuiltModel
from repro_torch.models.config import LMConfig, ShapeCfg

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


def serve_params_abstract(built: BuiltModel, mode=None) -> PyTree:
    """The rank's serve tree's shapes and dtypes, on the meta device (fake
    tensors of the topology's device in ``mode``): each leaf its block
    under :func:`serve_param_specs` -- resident, its block at
    ``built.topo``'s model axis (the whole leaf without one); in the
    gather layout, its FSDP shard over the data ranks too --, its
    floating leaves bfloat16, as they are served."""
    sizes = {"pod": 1, "data": device_axis.data_ranks(built.topo),
             "model": built.topo.model_shards}

    def block(a, spec):
        shape = build_mod.block_shape(tuple(a.shape), tuple(spec or ()),
                                      sizes)
        return _empty(shape, torch.bfloat16 if a.dtype.is_floating_point
                      else a.dtype, built.topo, mode)
    return pytree.tree_map(block, built.abstract_params(),
                           serve_param_specs(built))


# -- the dry run's stand-ins --------------------------------------------------

TOKENS = torch.int64         # the port's token ids (JAX's are int32)


def _empty(shape, dtype, topo: Topology, mode) -> torch.Tensor:
    """A tensor with no storage: meta without ``mode``, else a fake
    tensor of ``topo.device`` made in ``mode``."""
    if mode is None:
        return torch.empty(shape, dtype=dtype, device="meta")
    with mode:
        return torch.empty(shape, dtype=dtype, device=topo.device)


def _abstract(shape, dtype, topo: Topology, spec, mode):
    """(this rank's block of a global ``shape`` under ``spec``, spec)."""
    block = build_mod.block_shape(tuple(shape), tuple(spec),
                                  build_mod.axis_sizes(topo))
    return _empty(block, dtype, topo, mode), tuple(spec)


def batch_axes(topo: Topology):
    """The spec entry splitting a serve batch dim over every data-parallel
    axis: ``("pod", "data")`` over a mesh of more than one pod rank, else
    ``"data"`` (JAX's pod axis exists only then)."""
    multi = build_mod.axis_sizes(topo)["pod"] > 1
    return ("pod", "data") if multi else "data"


def _unzip(tree: dict) -> tuple:
    """``{key: (block, spec)}`` -> ``({key: block}, {key: spec})``."""
    return ({k: v[0] for k, v in tree.items()},
            {k: v[1] for k, v in tree.items()})


def train_batch_abstract(cfg: LMConfig, shape: ShapeCfg, topo: Topology,
                         mode=None):
    """``{"train": {...}}`` of the rank's ``[P_loc, D_loc, b_local, ...]``
    blocks of the global ``[P, D, b_local, ...]`` batch (``b_local`` the
    global batch over P * D): the tokens, whisper's frames and a vlm's
    patches (float32), split over the pod and data axes (the pod axis
    named where the mesh has more than one pod rank, as JAX's)."""
    pd = topo.pods * topo.devices_per_pod
    if shape.global_batch % pd:
        raise ValueError(f"{shape.name}: a global batch of "
                         f"{shape.global_batch} does not split over P x D "
                         f"= {pd} devices")
    b = shape.global_batch // pd
    lead = (topo.pods, topo.devices_per_pod, b)
    pod = "pod" if build_mod.axis_sizes(topo)["pod"] > 1 else None
    sp = lambda n: (pod, "data") + (None,) * n            # noqa: E731
    batch = {"tokens": _abstract(lead + (shape.seq_len,), TOKENS, topo,
                                 sp(2), mode)}
    if cfg.family in ("encdec", "audio"):
        batch["frames"] = _abstract(
            lead + (cfg.encoder_frames, cfg.frontend_dim), torch.float32,
            topo, sp(3), mode)
    if cfg.n_patches:
        batch["patches"] = _abstract(lead + (cfg.n_patches, cfg.d_model),
                                     torch.float32, topo, sp(3), mode)
    blocks, specs = _unzip(batch)
    return {"train": blocks}, {"train": specs}


def weights_abstract(topo: Topology, clients=None, mode=None):
    """``(edge_weights, dev_weights, mask)``: the arrays
    ``runtime.elastic.Membership.weights()`` emits, float32 and whole on
    every rank (the step takes its block of them) -- ``[P]``, ``[P, D]``
    and the ``[P, D]`` mask, or with an active ``ClientConfig`` the
    client-granular ``[P, D, K]`` one; and their specs, ``()``."""
    p, d = topo.pods, topo.devices_per_pod
    shapes = [(p,), (p, d)]
    shapes.append((p, d, clients.count)
                  if clients is not None and clients.active else (p, d))
    return (tuple(_empty(s, torch.float32, topo, mode) for s in shapes),
            ((), (), ()))


def train_state_abstract(built: BuiltModel, topo: Topology,
                         algo: hier.AlgoConfig, mode=None, init_fn=None):
    """The rank's ``TrainState``: ``init_fn`` (``make_hier_step``'s, or
    the caller's, whose train step then takes this state) run on fake
    parameters in ``mode`` (a new ``FakeTensorMode`` without one), so
    every slot is the block the rank holds, as a real ``init_fn`` lays
    it out -- under ``state_layout="flat"`` the rank's ``[P_loc,
    bucket_pad]`` buffer (``[P_loc, D_loc*K, bucket_pad]`` for a
    per-voter slot), under ``"tree"`` its ``[P_loc, *block]`` leaves;
    under FSDP each master and correction the rank's shard.  Beside it,
    ``hier.state_blocks``: each slot's index of the rank's block in the
    global slot (JAX's ``state_shardings``)."""
    if mode is None:
        from torch._subclasses.fake_tensor import FakeTensorMode
        mode = FakeTensorMode()
    with mode:
        if init_fn is None:
            init_fn, _ = hier.make_hier_step(topo, algo, built.bundle)
        params = pytree.tree_map(
            lambda a: torch.empty(a.shape, dtype=a.dtype,
                                  device=topo.device),
            built.abstract_params())
        state = init_fn(params, 0)
    del params
    fsdp = built.cfg.param_mode == "fsdp"
    layout = getattr(state.params, "layout", None)
    index = hier.state_blocks(
        topo, algo.clients.count,
        layout=None if layout is None else layout.sharded(topo.model_shards),
        master_specs=built.bundle.master_specs if fsdp else None,
        params=(pytree.tree_map(lambda a: torch.empty(
            (topo.pods,) + tuple(a.shape), device="meta"),
            built.abstract_params()) if fsdp else None))
    return state, index


def prefill_batch_abstract(cfg: LMConfig, shape: ShapeCfg, topo: Topology,
                           mode=None):
    """The rank's rows of a prefill batch of ``shape.global_batch``
    requests: split over :func:`batch_axes` (whole when one request),
    the tokens, whisper's frames and a vlm's patches (float32)."""
    b = shape.global_batch
    ba = batch_axes(topo) if b > 1 else None
    batch = {"tokens": _abstract((b, shape.seq_len), TOKENS, topo,
                                 (ba, None), mode)}
    if cfg.family in ("encdec", "audio"):
        batch["frames"] = _abstract((b, cfg.encoder_frames, cfg.frontend_dim),
                                    torch.float32, topo, (ba, None, None),
                                    mode)
    if cfg.n_patches:
        batch["patches"] = _abstract((b, cfg.n_patches, cfg.d_model),
                                     torch.float32, topo, (ba, None, None),
                                     mode)
    return _unzip(batch)


def decode_args_abstract(built: BuiltModel, shape: ShapeCfg,
                         topo: Topology, mode=None):
    """``((cache, tokens), (cache specs, tokens spec))`` for
    ``decode_step`` at this shape: the rank's bfloat16 cache of
    ``shape.seq_len`` slots (``build.make_cache``: its rows of the
    batch, its heads; one request -- long_500k -- with the length split
    over the data ranks, ``len_axis="data"``), its ``pos`` the last
    slot, so the token is decoded against a full cache; and its
    ``[b_local, 1]`` tokens."""
    b = shape.global_batch
    ba = batch_axes(topo) if b > 1 else None
    len_axis = "data" if b == 1 else None
    ctx = contextlib.nullcontext() if mode is None else mode
    with ctx:
        cache = built.make_cache(b, shape.seq_len,
                                 "meta" if mode is None else topo.device,
                                 len_axis=len_axis)
    cache["pos"] = shape.seq_len - 1
    cspecs = built.cache_specs(ba, len_axis)
    tokens, tspec = _abstract((b, 1), TOKENS, topo, (ba, None), mode)
    return (cache, tokens), (cspecs, tspec)
