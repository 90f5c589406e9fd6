"""The ranks of a gloo process mesh running the FSDP regime, and their runs.

``run(pods, data, model, block, job)`` starts the ``pods * data *
model`` ranks of this file on the CPU through
``torch_tp_worker.run_mesh`` (gloo over a file, each rank a ``block`` of
edges and devices, one model shard) and returns rank 0's results.

The job:

  * ``lift`` -- a list of :func:`lift_case` specs: one leaf's lift
    (``core.device_axis.fsdp_lift``) on the rank's shard of global
    numpy inputs, its forward copies checked against the rank's block of
    the master, its backward's direction gathered back to the global
    ``[P, *leaf]``;
  * ``cells`` -- name -> :func:`run_cell` spec: a train step in the FSDP
    or the replicated regime, over injected gradients
    (``injected_grads.make_fsdp_bundle``) or a small LM config (a
    ``TINY`` one or an arch's smoke config, :func:`config`, with the
    spec's ``overrides`` replaced, ``torch_tp_worker.smoke_config``), from
    global numpy parameters and batches; the final edge models gathered
    back, every step's loss, the traffic, and each master and
    correction leaf's shape on the rank;
  * ``state`` -- a JAX FSDP ``TrainState`` (numpy) and the config it
    belongs to: each rank takes its shards
    (``convert.train_state_from_numpy``) and gathers them back
    (``convert.gather_train_state``);
  * ``train`` -- a list of :func:`train_run` specs: ``run_training`` of
    a smoke config set to FSDP.

:func:`run_cell` and :func:`lift_case` run as well on a topology
without a mesh: the one-process reference.  Imports torch, numpy and
the port only (no JAX).
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

import injected_grads  # noqa: E402
import torch_tp_worker as TW  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch.core import (comm, device_axis, hier, pytree,  # noqa: E402
                              shardflat)
from repro_torch.core.topology import Topology  # noqa: E402
from repro_torch.models import build  # noqa: E402
from repro_torch.models.config import LMConfig, MoECfg  # noqa: E402

TORCH_DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}

# the JAX package's own FSDP gate's configs
# (tests/helpers/engine_fsdp_check.py), field for field
TINY = {
    "tiny-dense": LMConfig(
        name="tiny-dense", family="dense", n_layers=4, d_model=64,
        n_heads=4, n_kv_heads=2, d_ff=128, vocab=128, head_dim=16,
        remat=True),
    "tiny-moe": LMConfig(
        name="tiny-moe", family="moe", n_layers=4, d_model=64, n_heads=4,
        n_kv_heads=2, d_ff=64, vocab=128, head_dim=16,
        moe=MoECfg(n_experts=8, top_k=2, d_expert=64, capacity_factor=1.5,
                   group_tokens=32), remat=True),
}


def run(pods: int, data: int, model: int, block: tuple, job: dict,
        timeout: float = TW.JOIN_S) -> dict:
    return TW.run_mesh(pods, data, model, block, job, timeout=timeout,
                       script=__file__)


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
    res = {"blocks": (topo.local_pods, topo.local_devices),
           "lift": [lift_case(topo, c) for c in job.get("lift", ())],
           "cells": {name: run_cell(topo, spec)
                     for name, spec in job.get("cells", {}).items()}}
    if "state" in job:
        res["state"] = state_round_trip(topo, job["state"])
    res["train"] = {spec["arch"]: train_run(topo, spec)
                    for spec in job.get("train", ())}
    if rank == 0:
        with open(d / "results.tmp", "wb") as f:
            pickle.dump(res, f)
        os.replace(d / "results.tmp", d / "results.pkl")
    dist.barrier()
    dist.destroy_process_group()


def _model_block(topo: Topology, x: torch.Tensor, spec, batch_dims: int):
    """The rank's model block of a global leaf (its ``("model", ...)``
    dim cut in ``topo.model_shards`` even blocks)."""
    for i, entry in enumerate(spec or ()):
        names = entry if isinstance(entry, tuple) else (entry,)
        if "model" in names and topo.model_shards > 1:
            ax = batch_dims + i
            s = x.shape[ax] // topo.model_shards
            return x.narrow(ax, topo.model_rank * s, s)
    return x


def _gather_leaf(topo: Topology, x: torch.Tensor, spec) -> torch.Tensor:
    """A rank's [P_loc, *shard] leaf -> the global [P, *leaf]."""
    dim = device_axis.data_dim(spec)
    if dim is not None:
        x = comm.gather_shards(topo, x, 1 + dim)
    for i, entry in enumerate(spec or ()):
        names = entry if isinstance(entry, tuple) else (entry,)
        if "model" in names and topo.model_shards > 1:
            x = comm.gather_model(topo, x, 1 + i)
    return comm.gather_pods(topo, x)


def lift_case(topo: Topology, case: dict) -> dict:
    """One leaf's lift over ``topo``: ``case`` holds the global numpy
    ``w`` [P, *leaf], ``delta``, ``g`` [P, D, *leaf], ``maskf``,
    ``devwf`` [P, D], the leaf's master ``spec``, the ``transport``,
    ``rho`` and the compute ``dtype``.  Returns the gathered [P, *leaf]
    direction (float32 numpy, bitwise the master dtype's values),
    whether the forward's copies were the block's, and the shard's
    shape on this rank."""
    dt = TORCH_DTYPES[case["dtype"]]
    spec = case["spec"]
    rows = topo.pod_rows
    w = _model_block(topo, torch.from_numpy(case["w"])[rows], spec, 1)
    delta = _model_block(topo, torch.from_numpy(case["delta"])[rows], spec,
                         1).to(dt)
    g = _model_block(topo, torch.from_numpy(topo.block(case["g"])), spec,
                     2).to(dt)
    dim = device_axis.data_dim(spec)
    w_sh = device_axis.shard(w, dim, topo).contiguous().requires_grad_(True)
    d_sh = device_axis.shard(delta, dim, topo).contiguous()
    cfg = device_axis.LiftCfg(devices=topo.local_devices,
                              transport=case["transport"], rho=case["rho"],
                              compute_dtype=dt, topo=topo)
    out = device_axis.fsdp_lift(
        cfg, w_sh, d_sh, spec, maskf=torch.from_numpy(case["maskf"])[rows],
        devwf=torch.from_numpy(case["devwf"])[rows])
    copies_ok = torch.equal(out, w.to(dt).unsqueeze(1).expand(out.shape))
    out.backward(g)
    full = _gather_leaf(topo, w_sh.grad, spec)
    return {"direction": full.float().numpy(), "copies_ok": bool(copies_ok),
            "shard_shape": tuple(w_sh.shape)}


# -- the train step ---------------------------------------------------------------

def _algo(spec: dict) -> hier.AlgoConfig:
    dt = TORCH_DTYPES[spec.get("dtype", "f32")]
    return hier.AlgoConfig(
        method=spec["method"], transport=spec["transport"],
        state_layout="tree", t_e=spec["t_e"], mu=spec["mu"],
        mu_sgd=spec["mu_sgd"], rho=spec["rho"], compute_dtype=dt,
        master_dtype=torch.float32, delta_dtype=dt)


def config(kind: str) -> LMConfig:
    """A tiny config of ``TINY``, or the port's smoke config of the arch
    ``kind`` names."""
    if kind in TINY:
        return TINY[kind]
    from repro_torch import configs
    return configs.get_smoke(kind)


def _bundle(topo: Topology, spec: dict):
    """(bundle, master specs or None, compute specs or None) of a cell."""
    if spec["kind"] == "injected":
        mspecs = spec.get("mspecs")
        return (injected_grads.make_fsdp_bundle(mspecs) if spec["fsdp"]
                else injected_grads.make_bundle()), mspecs, None
    from repro_torch import configs

    cfg = (TW.smoke_config(configs, spec["kind"], spec["overrides"])
           if spec.get("overrides") else config(spec["kind"]))
    cfg = dataclasses.replace(cfg, param_mode=(
        "fsdp" if spec["fsdp"] else "replicated"))
    b = build.build_model(cfg, topo).bundle
    return b, b.master_specs if spec["fsdp"] else None, b.specs


def run_cell(topo: Topology, spec: dict) -> dict:
    """``spec["steps"]`` train steps from ``spec["w0"]`` (numpy, one
    replica) on ``spec["batches"]`` (global numpy [P, D, ...] trees)
    under the membership ``ew``, ``dw``, ``mask``: every step's loss,
    the gathered [P, *leaf] edge models, this rank's master and
    correction leaf shapes, and the step's traffic."""
    algo = _algo(spec)
    bundle, mspecs, cspecs = _bundle(topo, spec)
    init_fn, step = hier.make_hier_step(topo, algo, bundle)
    w0 = convert.params_from_numpy(spec["w0"])
    state = init_fn(w0, seed=3)
    layout = (shardflat.param_layout(topo, cspecs, pytree.tree_map(
        lambda x: x.unsqueeze(0), w0), batch_dims=1)
        if cspecs is not None and topo.model_shards > 1 else None)
    comm.reset_traffic()
    losses = []
    for s in range(spec["steps"]):
        batch = pytree.tree_map(torch.from_numpy,
                                topo.block(spec["batches"][s]))
        state, metrics = step(
            state, {"train": batch}, torch.from_numpy(spec["ew"]),
            torch.from_numpy(spec["dw"]), torch.from_numpy(spec["mask"]))
        losses.append(float(metrics["loss"]))
    traffic = comm.group_bytes()
    params = hier.edge_params(state, topo, layout, master_specs=mspecs)
    return {"losses": losses, "traffic": traffic,
            "params": pytree.tree_map(convert.tensor_to_numpy, params),
            "shapes": {name: [tuple(x.shape) for x in pytree.tree_flatten(
                getattr(state, name))[0]]
                for name in ("params", "delta", "delta_next")
                if getattr(state, name) is not None}}


def state_round_trip(topo: Topology, spec: dict) -> dict:
    """A global numpy FSDP state (``spec["state"]``, a JAX one) onto this
    rank: its shards' shapes, and the state gathered back over every
    axis (numpy, every slot)."""
    cfg = dataclasses.replace(TINY[spec["kind"]], param_mode="fsdp")
    built = build.build_model(cfg, topo)
    algo = _algo(spec)
    init_fn, _ = hier.make_hier_step(topo, algo, built.bundle)
    w0 = convert.params_from_numpy(spec["w0"])
    like = init_fn(w0, seed=3)
    layout = (shardflat.param_layout(topo, built.bundle.specs, pytree.tree_map(
        lambda x: x.unsqueeze(0), w0), batch_dims=1)
        if topo.model_shards > 1 else None)
    mspecs = built.bundle.master_specs
    src = hier.TrainState(**dict(spec["state"], rng=None))
    mine = convert.train_state_from_numpy(src, like, topo, layout, mspecs)
    full = convert.gather_train_state(mine, topo, layout,
                                      master_specs=mspecs)
    return {"shapes": [tuple(x.shape) for x in pytree.tree_flatten(
        mine.params)[0]],
        "state": {k: v for k, v in full._asdict().items() if k != "rng"}}


def train_run(topo: Topology, spec: dict) -> dict:
    """``launch.train.run_training`` of ``spec["arch"]``'s smoke config
    in the FSDP regime on ``topo`` (DC, fused, tree, f32 compute):
    every step's loss and the gathered [P, *leaf] edge models."""
    from repro_torch import configs
    from repro_torch.launch.train import RunCfg, run_training

    cfg = dataclasses.replace(configs.get_smoke(spec["arch"]),
                              param_mode="fsdp")
    algo = hier.AlgoConfig(t_e=spec["t_e"], transport="fused",
                           compute_dtype=torch.float32)
    state, history = run_training(
        cfg, topo, algo, RunCfg(steps=spec["steps"], batch_per_device=1,
                                seq_len=spec["seq"], log_every=0),
        log=lambda line: None)
    mspecs = build.build_model(cfg, topo).bundle.master_specs
    return {"losses": [h["loss"] for h in history],
            "params": pytree.tree_map(convert.tensor_to_numpy,
                                      hier.edge_params(state, topo,
                                                       master_specs=mspecs))}


if __name__ == "__main__":
    _rank_main(sys.argv[1], int(sys.argv[2]))
