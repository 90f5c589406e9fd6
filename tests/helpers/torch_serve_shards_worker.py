"""The ranks of a gloo process mesh serving from the data ranks' shards:
the gather layout of FSDP-stored weights, one request replicated over
the batch ranks, and a cache split by length over the data ranks.

``run(pods, data, model, job)`` starts ``pods * data * model`` ranks of
this file on the CPU through ``torch_tp_worker.run_mesh`` and returns
rank 0's results.  Jobs:

  * ``fsdp`` -- for each smoke config (set to FSDP): ``run_training``
    over the mesh for one step (DC, fused, tree, float32), then its
    state served from the rank's shards in the gather layout
    (``launch.specs.serve_params_from_tree``) and, resident, from edge 0
    of the global state (``convert.gather_train_state``) cut to the
    rank's compute blocks: 8 requests split over the batch ranks, and one
    request replicated over them, each prefill and decode steps; whether
    the gather layout's logits and caches are bitwise the resident
    ones on every rank, the logits of every row, edge 0's parameters,
    and the bytes of each call;
  * ``split`` -- for each case: one request (b = 1) served with
    ``len_axis="data"`` from the global numpy parameters (the rank's
    model blocks), prefill and decode steps of ``spec["steps"]`` tokens
    each (teacher-forced), and from each cache of ``given`` (global
    numpy caches) a step on the rank's block as it is and widened to
    float32; the logits, the caches gathered, the bytes of the rank's
    cache and of each call.  A case with ``"fault"`` runs with the
    combine over the data group replaced by each rank's own block; one
    with ``"dtype"`` serves the parameters cast to it (float32 else).

:func:`split_case` runs as well on a topology without a mesh: the
one-process reference.  Imports torch, numpy and the port only.
"""
from __future__ import annotations

import dataclasses
import os
import pathlib
import pickle
import sys

import numpy as np
import torch

HERE = pathlib.Path(__file__).resolve().parent
SRC = HERE.parents[1] / "src"
for _p in (str(SRC), str(HERE)):
    if _p not in sys.path:
        sys.path.insert(0, _p)

import torch_tp_serve_worker as SW  # noqa: E402
import torch_tp_worker as TW  # noqa: E402

from repro_torch import configs, convert  # noqa: E402
from repro_torch.core import comm, pytree, shardflat  # noqa: E402
from repro_torch.core.topology import Topology  # noqa: E402
from repro_torch.models import build  # noqa: E402


def run(pods: int, data: int, model: int, job: dict,
        timeout: float = TW.JOIN_S) -> dict:
    return TW.run_mesh(pods, data, model, (1, 1), job, timeout=timeout,
                       script=__file__)


def _numpy(tree):
    return pytree.tree_map(convert.tensor_to_numpy, tree)


def _traffic() -> dict:
    return {op: dict(v) for op, v in comm.traffic.items()}


def _agree(topo: Topology, ok: bool) -> bool:
    """Whether ``ok`` holds on every rank."""
    import torch.distributed as dist

    flag = torch.tensor([int(ok)])
    if topo.mesh is not None:
        dist.all_reduce(flag, op=dist.ReduceOp.MIN)
    return bool(flag)


def _serve(built, prefill, decode, params, batch, max_len, steps):
    """Prefill, then a decode step a token block of ``steps``, each call
    between ``comm.reset_traffic`` and a read: (logits, caches, traffic
    of each call)."""
    comm.reset_traffic()
    logits, cache = prefill(params, batch, max_len)
    out = {"logits": [logits], "caches": [cache], "traffic": [_traffic()]}
    for tok in steps:
        comm.reset_traffic()
        logits, cache = decode(params, cache, tok)
        out["logits"].append(logits)
        out["caches"].append(cache)
        out["traffic"].append(_traffic())
    return out


def _same(a: dict, b: dict) -> bool:
    """Two serve runs bitwise the same: every logit and cache leaf."""
    ok = all(torch.equal(x, y) for x, y in zip(a["logits"], b["logits"]))
    for ca, cb in zip(a["caches"], b["caches"]):
        ok &= ca["pos"] == cb["pos"] and all(
            torch.equal(x, y) for x, y in zip(
                pytree.tree_flatten(ca["stacks"])[0],
                pytree.tree_flatten(cb["stacks"])[0]))
    return ok


def fsdp_case(topo: Topology, spec: dict) -> dict:
    """The ``fsdp`` job's case (the module docstring)."""
    from repro_torch.core import hier
    from repro_torch.launch import specs
    from repro_torch.launch.train import RunCfg, run_training

    cfg = dataclasses.replace(TW.smoke_config(configs, spec["arch"]),
                              param_mode="fsdp")
    algo = hier.AlgoConfig(method="dc_hier_signsgd", mu=1e-3, rho=0.2,
                           t_e=2, transport="fused",
                           compute_dtype=torch.float32)
    state, _ = run_training(cfg, topo, algo, RunCfg(
        steps=1, batch_per_device=1, seq_len=8, log_every=0),
        log=lambda _: None)
    gather = build.build_model(cfg, topo, layout="gather")
    resident = build.build_model(cfg, topo, layout="resident")
    shards = specs.serve_params_from_tree(state.params, None, gather)
    layout = shardflat.param_layout(topo, resident.bundle.specs,
                                    resident.abstract_params())
    full = convert.gather_train_state(
        state, topo, layout=layout if layout.shards > 1 else None,
        master_specs=resident.bundle.master_specs)
    edge0 = pytree.tree_map(lambda a: np.ascontiguousarray(a[0]),
                            full.params)
    whole = convert.params_from_numpy(edge0)
    blocks = shardflat.logical(topo, layout, shardflat.local_block(
        topo, layout, whole))
    batch = SW._rows(topo, spec["requests"])
    steps = [SW._rows(topo, {"tokens": t})["tokens"] for t in spec["steps"]]
    max_len = spec["max_len"]
    b = spec["requests"]["tokens"].shape[0]
    out = {"edge0": edge0 if topo.mesh is None or topo.mesh.rank == 0
           else None}
    for rows in ("split", "replicated"):
        if rows == "split":
            req, toks = batch, steps
        else:
            req = {k: torch.from_numpy(np.ascontiguousarray(v[:1]))
                   for k, v in spec["requests"].items()}
            req["tokens"] = req["tokens"].long()
            toks = [torch.from_numpy(t[:1]).long() for t in spec["steps"]]
        runs = {}
        for name, built, params in (("gather", gather, shards),
                                    ("resident", resident, blocks)):
            prefill, decode = build.make_serve_fns(
                built.arch, topo, name, rows=rows)
            runs[name] = _serve(built, prefill, decode, params, req,
                                max_len, toks)
        g = runs["gather"]
        logits = [convert.tensor_to_numpy(
            SW._all_rows(topo, x) if rows == "split"
            else comm.gather_batch(topo, x).flatten(0, 1)) for x in
            g["logits"]]
        out[rows] = {
            "bitwise": _agree(topo, _same(g, runs["resident"])),
            "logits": logits,
            "cache_bytes": [SW._cache_bytes(c) for c in g["caches"]],
            "reckoned": build.cache_bytes(gather.arch, b if rows == "split"
                                          else 1, max_len, topo,
                                          torch.float32),
            "traffic": g["traffic"],
            "resident_traffic": runs["resident"]["traffic"]}
    return out


def _len_dims(arch) -> dict:
    """Each cache leaf's (length dim or None, model dim or None) under
    the split layout's specs (one request)."""
    def dims(sp):
        def find(ax):
            hit = [i for i, e in enumerate(sp)
                   if e == ax or (isinstance(e, tuple) and ax in e)]
            return hit[0] if hit else None
        return find("data"), find("model")
    return pytree.tree_map(dims, build.cache_specs(arch, None,
                                                   "data")["stacks"])


def split_block(arch, cache: dict, topo: Topology) -> dict:
    """This rank's block of a global one-request cache: its block of the
    length where the split layout names ``"data"``, and its model
    block."""
    data, dr = ((topo.mesh.data, topo.mesh.data_rank) if topo.mesh
                else (1, 0))
    m, mr = topo.model_shards, topo.model_rank

    def cut(x, dims):
        ldim, mdim = dims
        if ldim is not None:
            n = x.shape[ldim] // data
            x = x.narrow(ldim, dr * n, n)
        if mdim is not None:
            n = x.shape[mdim] // m
            x = x.narrow(mdim, mr * n, n)
        return x
    return {"stacks": pytree.tree_map(cut, cache["stacks"], _len_dims(arch)),
            "pos": cache["pos"]}


def gather_split(arch, cache: dict, topo: Topology) -> dict:
    """The global cache from the ranks' blocks, numpy, with the dtypes."""
    def whole(x, dims):
        ldim, mdim = dims
        if mdim is not None:
            x = comm.gather_model(topo, x, mdim)
        if ldim is not None:
            x = comm.gather_shards(topo, x, ldim)
        return x
    stacks = pytree.tree_map(whole, cache["stacks"], _len_dims(arch))
    return {"stacks": _numpy(stacks), "pos": cache["pos"],
            "dtypes": pytree.tree_map(lambda x: str(x.dtype).split(".")[-1],
                                      stacks)}


def _own_block(topo, m_r, l_r, o_r):
    """The planted fault: the rank's own block alone, no combine."""
    return o_r / l_r


def split_case(topo: Topology, spec: dict) -> dict:
    """The ``split`` job's case (the module docstring), on a mesh rank or
    in one process (the cache whole)."""
    from repro_torch.models import attention

    cfg = TW.smoke_config(configs, spec["arch"], spec.get("overrides"))
    built = build.build_model(cfg, topo)
    full = convert.params_from_numpy(spec["params"])
    layout = shardflat.param_layout(topo, built.bundle.specs, full)
    dtype = getattr(torch, spec.get("dtype", "float32"))
    params = pytree.tree_map(lambda x: x.to(dtype), shardflat.logical(
        topo, layout, shardflat.local_block(topo, layout, full)))
    prefill, decode = build.make_serve_fns(built.arch, topo, "resident",
                                           rows="replicated",
                                           len_axis="data")
    req = {k: torch.from_numpy(np.ascontiguousarray(v))
           for k, v in spec["requests"].items()}
    req["tokens"] = req["tokens"].long()
    steps = [torch.from_numpy(t).long() for t in spec["steps"]]
    max_len = spec["max_len"]
    combine = attention.comm.combine_softmax
    if spec.get("fault"):
        attention.comm.combine_softmax = _own_block
    try:
        own = _serve(built, prefill, decode, params, req, max_len, steps)
        given = []
        for c, tok in zip(spec.get("given", ()), spec.get("given_tokens",
                                                          ())):
            step = {}
            for name, cast in (("bf16", None), ("f32", torch.float32)):
                block = split_block(built.arch, convert.cache_from_numpy(c),
                                    topo)
                if cast is not None:
                    block["stacks"] = pytree.tree_map(lambda x: x.to(cast),
                                                      block["stacks"])
                lg, nc = decode(params, block, torch.from_numpy(tok).long())
                step[name] = {"logits": convert.tensor_to_numpy(lg),
                              "cache": gather_split(built.arch, nc, topo)}
            given.append(step)
    finally:
        attention.comm.combine_softmax = combine
    return {"logits": [convert.tensor_to_numpy(x) for x in own["logits"]],
            "caches": [gather_split(built.arch, c, topo)
                       for c in own["caches"]],
            "cache_bytes": [SW._cache_bytes(c) for c in own["caches"]],
            "reckoned": build.cache_bytes(built.arch, 1, max_len, topo,
                                          dtype, len_axis="data"),
            "traffic": own["traffic"], "given": given}


def _rank_main(tmp: str, rank: int) -> None:
    import torch.distributed as dist

    from repro_torch.launch import mesh

    torch.set_num_threads(1)
    d = pathlib.Path(tmp)
    with open(d / "job.pkl", "rb") as f:
        job = pickle.load(f)
    pods, data, model = job["grid"]
    dist.init_process_group("gloo", init_method=f"file://{d / 'rdv'}",
                            rank=rank, world_size=pods * data * model,
                            timeout=mesh.TIMEOUT)
    topo = mesh.make_host_topology(pods, data, model, backend="gloo",
                                   device="cpu", block=job["block"])
    m = topo.mesh
    res = {"coords": (m.pod_rank, m.data_rank, m.model_rank),
           "fsdp": {name: fsdp_case(topo, spec)
                    for name, spec in job.get("fsdp", {}).items()},
           "split": {name: split_case(topo, spec)
                     for name, spec in job.get("split", {}).items()}}
    # every rank's results: the tests read each rank's bytes and logits
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, res)
    if rank == 0:
        with open(d / "results.tmp", "wb") as f:
            pickle.dump(every, f)
        os.replace(d / "results.tmp", d / "results.pkl")
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    _rank_main(sys.argv[1], int(sys.argv[2]))
