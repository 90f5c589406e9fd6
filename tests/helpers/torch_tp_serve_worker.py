"""The ranks of a gloo process mesh serving a smoke config, tensor-parallel
over the model axis with the request batch over the pod and data ranks.

``run(pods, data, model, job)`` starts ``pods * data * model`` ranks of
this file on the CPU through ``torch_tp_worker.run_mesh`` and returns
rank 0's results.  Each rank builds the case's config at its topology,
takes its blocks of the global numpy parameters (``shardflat``, cut to
their logical extent) in the case's dtype, and serves its rows of the
global requests:

  * ``own`` -- prefill, then a decode step for each of ``steps``'s
    tokens (teacher-forced: the same tokens on every rank and in the
    reference), each on the cache the step before left; the logits of
    every row and the caches, gathered over every axis, and the bytes
    of the rank's cache after each call;
  * ``given`` -- a decode step from each cache of ``given`` (global
    numpy caches, e.g. JAX's after prefill and each step), the rank's
    block of it as it is (bfloat16) and widened to float32, with
    ``given_tokens``; the logits and the next caches gathered;
  * ``chip`` -- ``chip_smoke.py``'s serve part (``tp_serve``) at smoke
    configs, every rank's results gathered on rank 0;
  * ``flat`` -- ``run_training`` of the case's config over the mesh for
    ``flat["steps"]`` steps (fused, flat), its state served through
    ``launch.specs.serve_params_from_flat``: whether every rank's views
    share one buffer (on pod 0 its bucket), whether the pods' first
    edges differ (a state taken mid-round), and the prefill logits
    gathered, with the served parameters gathered over the model group
    and each pod's stacked ([pods, *leaf]: every pod serves edge 0).

:func:`serve_case` runs as well on a topology without a mesh: the
one-process reference.  Imports torch, numpy and the port only.
"""
from __future__ import annotations

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

import torch_tp_worker as TW  # noqa: E402

from repro_torch import configs  # noqa: E402
from repro_torch.convert import (cache_from_numpy,  # noqa: E402
                                 params_from_numpy, tensor_to_numpy)
from repro_torch.core import comm, pytree, shardflat  # noqa: E402
from repro_torch.core.topology import Topology  # noqa: E402
from repro_torch.models import build  # noqa: E402
from repro_torch.models import moe  # noqa: E402


def run(pods: int, data: int, model: int, job: dict,
        timeout: float = TW.JOIN_S) -> dict:
    return TW.run_mesh(pods, data, model, (1, 1), job, timeout=timeout,
                       script=__file__)


def _numpy(tree):
    return pytree.tree_map(tensor_to_numpy, tree)


def _cache_dims(arch) -> dict:
    """Each block's cache leaves' (batch dim, model dim or None), from
    the specs over ``build.SERVE_BATCH_AXES``."""
    def dims(sp):
        model = [i for i, e in enumerate(sp)
                 if e == "model" or (isinstance(e, tuple) and "model" in e)]
        return sp.index(build.SERVE_BATCH_AXES), (model[0] if model
                                                   else None)
    return pytree.tree_map(dims, build.cache_specs(
        arch, build.SERVE_BATCH_AXES)["stacks"])


def cache_block(arch, cache: dict, topo: Topology) -> dict:
    """This rank's block of a global cache (views): its batch rows and
    its model block of each leaf the specs split."""
    nb, r = moe.batch_ranks(topo)
    m, mr = topo.model_shards, topo.model_rank

    def cut(x, dims):
        bdim, mdim = dims
        rows = x.shape[bdim] // nb
        x = x.narrow(bdim, r * rows, rows)
        if mdim is not None:
            n = x.shape[mdim] // m
            x = x.narrow(mdim, mr * n, n)
        return x
    return {"stacks": pytree.tree_map(cut, cache["stacks"],
                                      _cache_dims(arch)),
            "pos": cache["pos"]}


def gather_cache(arch, cache: dict, topo: Topology) -> dict:
    """The global cache from every rank's block (collectives over the
    model group and the batch ranks, on every rank)."""
    def whole(x, dims):
        bdim, mdim = dims
        if mdim is not None:
            x = comm.gather_model(topo, x, mdim)
        x = comm.gather_batch(topo, x).movedim(0, bdim)
        return x.flatten(bdim, bdim + 1)
    return {"stacks": pytree.tree_map(whole, cache["stacks"],
                                      _cache_dims(arch)),
            "pos": cache["pos"]}


def _whole_cache(built, cache: dict, topo: Topology) -> dict:
    """The global cache gathered from the ranks' blocks, numpy."""
    whole = gather_cache(built.arch, cache, topo)
    return {"stacks": _numpy(whole["stacks"]), "pos": whole["pos"],
            "dtypes": pytree.tree_map(lambda x: str(x.dtype).split(".")[-1],
                                      whole["stacks"])}


def _rows(topo: Topology, tree: dict) -> dict:
    """The rank's rows of a global numpy batch, as tensors."""
    nb, r = moe.batch_ranks(topo)
    out = {}
    for k, v in tree.items():
        rows = v.shape[0] // nb
        out[k] = torch.from_numpy(np.ascontiguousarray(
            v[r * rows:(r + 1) * rows]))
        if k == "tokens":
            out[k] = out[k].long()
    return out


def _all_rows(topo: Topology, x: torch.Tensor) -> torch.Tensor:
    """Every batch rank's rows of x [b_loc, ...], in batch order."""
    return comm.gather_batch(topo, x).flatten(0, 1)


def _cache_bytes(cache: dict) -> int:
    return sum(x.numel() * x.element_size()
               for x in pytree.tree_flatten(cache["stacks"])[0])


def _given_cache(built, cache: dict, topo: Topology, dtype) -> dict:
    block = cache_block(built.arch, cache_from_numpy(cache), topo)
    if dtype is not None:
        block["stacks"] = pytree.tree_map(lambda x: x.to(dtype),
                                          block["stacks"])
    return block


def serve_case(topo: Topology, spec: dict) -> dict:
    """One case's ``own`` and ``given`` runs (the module docstring) at
    ``topo``: a mesh rank's, or the whole batch in one process."""
    cfg = TW.smoke_config(configs, spec["arch"], spec.get("overrides"))
    built = build.build_model(cfg, topo)
    full = params_from_numpy(spec["params"])
    layout = shardflat.param_layout(topo, built.bundle.specs, full)
    dtype = getattr(torch, spec.get("dtype", "float32"))
    params = pytree.tree_map(lambda x: x.to(dtype), shardflat.logical(
        topo, layout, shardflat.local_block(topo, layout, full)))
    batch = _rows(topo, spec["requests"])
    b = spec["requests"]["tokens"].shape[0]
    max_len = spec["max_len"]
    reckoned = build.cache_bytes(built.arch, b, max_len, topo, dtype)
    logits, cache = built.prefill(params, batch, max_len)
    own = {"logits": [tensor_to_numpy(_all_rows(topo, logits))],
           "caches": [_whole_cache(built, cache, topo)],
           "bytes": [_cache_bytes(cache)], "reckoned": reckoned}
    for tok in spec.get("steps", ()):
        logits, cache = built.decode_step(
            params, cache, _rows(topo, {"tokens": tok})["tokens"])
        own["logits"].append(tensor_to_numpy(_all_rows(topo, logits)))
        own["caches"].append(_whole_cache(built, cache, topo))
        own["bytes"].append(_cache_bytes(cache))
    given = []
    for c, tok in zip(spec.get("given", ()), spec.get("given_tokens", ())):
        tokens = _rows(topo, {"tokens": tok})["tokens"]
        step = {}
        for name, cast in (("bf16", None), ("f32", torch.float32)):
            lg, nc = built.decode_step(
                params, _given_cache(built, c, topo, cast), tokens)
            step[name] = {"logits": tensor_to_numpy(_all_rows(topo, lg)),
                          "cache": _whole_cache(built, nc, topo)}
        given.append(step)
    return {"own": own, "given": given,
            "shards": layout.shards, "rows": batch["tokens"].shape[0]}


def flat_case(topo: Topology, spec: dict) -> dict:
    """``run_training`` over the mesh, then its state served from the
    rank's bucket (the module docstring's ``flat``)."""
    from repro_torch.core import flatbuf
    from repro_torch.launch import specs

    cfg = TW.smoke_config(configs, spec["arch"], spec.get("overrides"))
    state = _train_flat(topo, cfg, spec["steps"])
    built = build.build_model(cfg, topo)
    assert isinstance(state.params, flatbuf.FlatState)
    bucket = state.params.buf
    views = specs.serve_params_from_flat(built, state.params)
    ptrs = {v.untyped_storage().data_ptr()
            for v in pytree.tree_flatten(views)[0]}
    # one buffer: the bucket itself on pod 0, the row received elsewhere
    shared = len(ptrs) == 1 and (
        topo.mesh.pod_rank > 0
        or ptrs == {bucket.untyped_storage().data_ptr()})
    logits, _ = built.prefill(views, _rows(topo, spec["requests"]),
                              spec["max_len"])
    layout = shardflat.param_layout(topo, built.bundle.specs,
                                    built.abstract_params())
    whole = pytree.tree_map(lambda x: comm.gather_pods(topo, x[None]),
                            shardflat.gather(topo, layout, views))
    firsts = comm.gather_pods(topo, bucket[:1])     # each pod's first edge
    ok = torch.tensor([int(shared)])
    shared = bool(comm.gather_batch(topo, comm.gather_model(topo, ok, 0))
                  .min())
    return {"shared_storage": shared, "bucket": tuple(bucket.shape),
            "edges_differ": not torch.equal(firsts[0], firsts[1]),
            "logits": tensor_to_numpy(_all_rows(topo, logits)),
            "params": _numpy(whole)}


def _chip_smoke():
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", HERE.parents[1] / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


def _train_flat(topo: Topology, cfg, steps: int = 1):
    """The flat master ``run_training`` (DC, fused, flat, float32) leaves
    on the rank after ``steps`` steps of 2 x 8 tokens a device."""
    from repro_torch.core import hier
    from repro_torch.launch.train import RunCfg, run_training

    algo = hier.AlgoConfig(method="dc_hier_signsgd", mu=1e-3, rho=0.2,
                           t_e=2, transport="fused", state_layout="flat",
                           compute_dtype=torch.float32)
    state, _ = run_training(cfg, topo, algo, RunCfg(
        steps=steps, batch_per_device=2, seq_len=8, log_every=100),
        log=lambda _: None)
    return state


def chip_serve(topo: Topology, job: dict) -> dict:
    """``chip_smoke.py``'s serve part on these ranks, at the smoke
    configs ``job`` names (name -> (arch, overridden fields, whether the
    master a 1-step ``run_training`` leaves is served, else the seed-0
    tree)): this rank's results, as the card's ranks return them."""
    cs = _chip_smoke()
    out = {}
    for name, (arch, over, trained) in job.items():
        cfg = TW.smoke_config(configs, arch, over)
        if trained:
            out[name] = cs.tp_serve_state(torch, topo, name, cfg,
                                          _train_flat(topo, cfg).params)
        else:
            host = build.build_model(cfg, Topology(1, 1, "cpu")).init_params(
                torch.Generator().manual_seed(0))
            out[name] = cs.tp_serve_host(torch, topo, name, cfg, host)
    return {"rank": topo.mesh.rank, "serve_tp": out}


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
           "cases": {name: serve_case(topo, spec)
                     for name, spec in job.get("cases", {}).items()}}
    if "flat" in job:
        res["flat"] = flat_case(topo, job["flat"])
    res["traffic"] = comm.group_bytes()
    if "chip" in job:
        mine = chip_serve(topo, job["chip"])
        res["chip"] = [None] * dist.get_world_size()
        dist.all_gather_object(res["chip"], mine)
    if rank == 0:
        with open(d / "results.tmp", "wb") as f:
            pickle.dump(res, f)
        os.replace(d / "results.tmp", d / "results.pkl")
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    _rank_main(sys.argv[1], int(sys.argv[2]))
