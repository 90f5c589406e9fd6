"""The ranks of a gloo process mesh on the CPU, and the runs they make.

``run_mesh(pods, data, block, job)`` starts ``pods * data`` Python
processes of this file, one a rank, which meet through a file in a
temporary directory (``init_method="file://..."``, gloo), lay the
``[P, D]`` hierarchy over a ``pods x data`` grid
(``repro_torch.launch.mesh.make_host_topology``; each rank's block is
``block``), run the job and write rank 0's results back.  A run that
does not end within ``timeout`` seconds (120 by default) is killed,
every rank of it, and raises; every process group has a 60 s timeout,
so a rank that raises fails its peers' next collective instead of
hanging them.

The job (a dict of numpy arrays and plain values):

  * ``cells`` -- name -> :func:`run_cell` spec: the train step of one
    method / transport / layout / option over a problem, whose final
    state comes back gathered to the global numpy state
    (``convert.gather_train_state``), with every step's loss;
  * ``votes`` -- the inputs of :func:`vote_checks`: the topology-aware
    votes and means on each rank's block of global inputs, each result
    gathered back to its global shape;
  * ``grads`` -- an MLP problem whose step-0 per-device gradients each
    rank takes on its block (gathered back): the same slice of the
    one-process run's gradients need not be bitwise, since the matmuls
    see other batch counts;
  * ``lm`` -- a :func:`lm_run` spec: ``launch.train.run_training`` of a
    smoke LM config over the mesh;
  * ``lm_ckpt`` -- the same with a checkpoint directory, stopped and run
    again on it (:func:`lm_ckpt_run`);
  * ``paper`` -- name -> ``FedBenchCfg`` fields: the paper task
    (``launch.train.run_paper_task``) over the mesh (:func:`paper_run`).

:func:`run_cell` runs as well on a topology without a mesh: the
one-process reference the tests hold every mesh run against.  Imports
torch, numpy and the port only (no JAX).
"""
from __future__ import annotations

import os
import pathlib
import pickle
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

HERE = pathlib.Path(__file__).resolve().parent
SRC = HERE.parents[1] / "src"
for _p in (str(SRC), str(HERE)):
    if _p not in sys.path:
        sys.path.insert(0, _p)

import injected_grads  # noqa: E402

from repro_torch.convert import (gather_train_state,  # noqa: E402
                                 params_from_numpy, tensor_to_numpy,
                                 train_state_from_numpy)
from repro_torch.core import comm, flatbuf, hier, pytree, votes  # noqa: E402
from repro_torch.core.clients import ClientConfig  # noqa: E402
from repro_torch.core.topology import Topology  # noqa: E402
from repro_torch.models import mlp  # noqa: E402

JOIN_S = 120.0


# -- the launcher -------------------------------------------------------------

def run_mesh(pods: int, data: int, block: tuple, job: dict,
             timeout: float = JOIN_S) -> dict:
    """Run ``job`` on a ``pods x data`` gloo mesh of CPU processes and
    return rank 0's results; raises if a rank fails or the run outlives
    ``timeout`` seconds (all ranks are killed first)."""
    world = pods * data
    with tempfile.TemporaryDirectory() as tmp:
        d = pathlib.Path(tmp)
        with open(d / "job.pkl", "wb") as f:
            pickle.dump({"pods": pods, "data": data, "block": tuple(block),
                         **job}, f)
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            [str(SRC), str(HERE), os.environ.get("PYTHONPATH", "")]),
            OMP_NUM_THREADS="1")
        logs = [open(d / f"rank{r}.log", "w+") for r in range(world)]
        procs = [subprocess.Popen([sys.executable, __file__, tmp, str(r)],
                                  env=env, stdout=logs[r],
                                  stderr=subprocess.STDOUT)
                 for r in range(world)]
        deadline = time.monotonic() + timeout
        try:
            for proc in procs:
                proc.wait(timeout=max(deadline - time.monotonic(), 0.0))
        except subprocess.TimeoutExpired:
            for proc in procs:
                proc.kill()
            for proc in procs:
                proc.wait()
            raise RuntimeError(f"the {pods} x {data} mesh run outlived its "
                               f"{timeout} s limit: ranks killed\n"
                               + _tails(logs))
        if any(proc.returncode for proc in procs):
            raise RuntimeError(f"a rank of the {pods} x {data} mesh failed "
                               f"(exit codes "
                               f"{[proc.returncode for proc in procs]})\n"
                               + _tails(logs))
        for log in logs:
            log.close()
        with open(d / "results.pkl", "rb") as f:
            return pickle.load(f)


def _tails(logs) -> str:
    out = []
    for r, log in enumerate(logs):
        log.flush()
        log.seek(0)
        out.append(f"--- rank {r}\n" + log.read()[-3000:])
    return "\n".join(out)


def _rank_main(tmp: str, rank: int) -> None:
    import torch.distributed as dist

    from repro_torch.launch import mesh

    torch.set_num_threads(1)
    d = pathlib.Path(tmp)
    with open(d / "job.pkl", "rb") as f:
        job = pickle.load(f)
    world = job["pods"] * job["data"]
    dist.init_process_group("gloo", init_method=f"file://{d / 'rdv'}",
                            rank=rank, world_size=world,
                            timeout=mesh.TIMEOUT)
    topo = mesh.make_host_topology(job["pods"], job["data"],
                                   backend="gloo", device="cpu",
                                   block=job["block"])
    res = {"cells": {}, "blocks": (topo.local_pods, topo.local_devices)}
    for name, spec in job.get("cells", {}).items():
        res["cells"][name] = run_cell(topo, spec)
    if "votes" in job:
        res["votes"] = vote_checks(topo, job["votes"])
    if "grads" in job:
        res["grads"] = step0_grads(topo, job["grads"])
    if "lm" in job:
        res["lm"] = lm_run(topo, job["lm"])
    if "lm_ckpt" in job:
        res["lm_ckpt"] = lm_ckpt_run(topo, job["lm_ckpt"], tmp)
    if "paper" in job:
        res["paper"] = {name: paper_run(topo, fields)
                        for name, fields in job["paper"].items()}
    if rank == 0:
        with open(d / "results.tmp", "wb") as f:
            pickle.dump(res, f)
        os.replace(d / "results.tmp", d / "results.pkl")
    dist.barrier()
    dist.destroy_process_group()


# -- the train step -------------------------------------------------------------

def client_config(spec: dict | None) -> ClientConfig:
    return ClientConfig() if spec is None else ClientConfig(**spec)


def run_cell(topo: Topology, spec: dict) -> dict:
    """The train step of ``spec`` for ``spec["steps"]`` steps on
    ``topo``'s block of ``spec["problem"]``: the final global state
    (numpy, ``convert.train_state_to_numpy``'s form, as a dict of
    slots), the [P, *leaf] edge models as a numpy tree, every step's
    loss and the run's collective traffic (``comm.traffic``).

    spec: method, transport, state_layout, t_e, mu, mu_sgd, rho,
    clients (ClientConfig fields or None), algo (other AlgoConfig
    fields), problem ({"kind": "injected" | "mlp", "w0", "batches":
    [S] trees of [P, D, ...] arrays, "ew" [P], "dw" [P, D], "mask"
    [P, D] or [P, D, K]}), steps, and optionally start: a global numpy
    state (this function's ``state``) to go on from, each rank taking
    its block of it (``convert.train_state_from_numpy(..., topo=)``)."""
    prob = spec["problem"]
    algo = hier.AlgoConfig(
        method=spec["method"], transport=spec["transport"],
        state_layout=spec["state_layout"], t_e=spec["t_e"], mu=spec["mu"],
        mu_sgd=spec["mu_sgd"], rho=spec["rho"],
        clients=client_config(spec.get("clients")),
        compute_dtype=torch.float32, master_dtype=torch.float32,
        delta_dtype=torch.float32, **spec.get("algo", {}))
    bundle = (injected_grads.make_bundle() if prob["kind"] == "injected"
              else mlp.make_bundle())
    init_fn, step = hier.make_hier_step(topo, algo, bundle)
    state = init_fn(params_from_numpy(prob["w0"]), seed=3)
    if spec.get("start") is not None:
        state = train_state_from_numpy(
            hier.TrainState(rng=None, **spec["start"]), state, topo)
    comm.reset_traffic()
    losses = []
    for s in range(state.step, spec["steps"]):
        batch = pytree.tree_map(torch.from_numpy,
                                topo.block(prob["batches"][s]))
        state, metrics = step(
            state, {"train": batch}, torch.from_numpy(prob["ew"]),
            torch.from_numpy(prob["dw"]), torch.from_numpy(prob["mask"]))
        losses.append(float(metrics["loss"]))
    traffic = {op: dict(v) for op, v in comm.traffic.items()}
    full = gather_train_state(state, topo)
    return {"state": {k: v for k, v in full._asdict().items()
                      if k != "rng"},
            "params": pytree.tree_map(tensor_to_numpy,
                                      hier.edge_params(state, topo)),
            "losses": losses, "traffic": traffic}


def step0_grads(topo: Topology, spec: dict) -> dict:
    """Per-device gradients of the MLP at w0 on step 0's batch: the
    rank's [P_loc, D_loc, *leaf] block, gathered to [P, D, *leaf]."""
    params = params_from_numpy(spec["w0"])
    batch = pytree.tree_map(torch.from_numpy, topo.block(spec["batch"]))
    leaves, td = pytree.tree_flatten(params)
    copies = [x.unsqueeze(0).unsqueeze(0).expand(
        (topo.local_pods, topo.local_devices) + tuple(x.shape))
        .contiguous().requires_grad_(True) for x in leaves]
    grads = torch.autograd.grad(
        mlp.loss_fn(pytree.tree_unflatten(td, copies), batch).sum(), copies)
    return pytree.tree_unflatten(td, [
        tensor_to_numpy(comm.gather_pods(topo, comm.gather_devices(topo, g)))
        for g in grads])


def lm_run(topo: Topology, spec: dict) -> dict:
    """``run_training`` of ``spec["arch"]``'s smoke config on ``topo``
    (DC, fused, flat, f32 compute): every step's loss and the gathered
    [P, *leaf] edge models."""
    from repro_torch import configs
    from repro_torch.launch.train import RunCfg, run_training

    algo = hier.AlgoConfig(
        t_e=spec["t_e"], transport="fused", state_layout="flat",
        compute_dtype=torch.float32)
    state, history = run_training(
        configs.get_smoke(spec["arch"]), topo, algo,
        RunCfg(steps=spec["steps"], batch_per_device=spec["batch"],
               seq_len=spec["seq"], log_every=0), log=lambda line: None)
    return {"losses": [h["loss"] for h in history],
            "params": pytree.tree_map(tensor_to_numpy,
                                      hier.edge_params(state, topo))}


def lm_ckpt_run(topo: Topology, spec: dict, tmp: str) -> dict:
    """:func:`lm_run`'s run with a checkpoint directory: stopped at step
    ``spec["stop"]`` (saved there) and run again on the directory to
    ``spec["steps"]``: the two parts' losses, the checkpoint events and
    the final gathered [P, *leaf] edge models."""
    from repro_torch import configs
    from repro_torch.launch.train import RunCfg, run_training

    algo = hier.AlgoConfig(
        t_e=spec["t_e"], transport="fused", state_layout="flat",
        compute_dtype=torch.float32)
    out = {"losses": [], "events": []}
    for steps in (spec["stop"], spec["steps"]):
        state, history = run_training(
            configs.get_smoke(spec["arch"]), topo, algo,
            RunCfg(steps=steps, batch_per_device=spec["batch"],
                   seq_len=spec["seq"], log_every=0,
                   ckpt_every=spec["stop"],
                   ckpt_dir=str(pathlib.Path(tmp) / "lm_ckpt")),
            log=lambda line: None, on_checkpoint=out["events"].append)
        out["losses"].append([h["loss"] for h in history])
    out["params"] = pytree.tree_map(tensor_to_numpy,
                                    hier.edge_params(state, topo))
    return out


def paper_run(topo: Topology, fields: dict) -> dict:
    """``run_paper_task`` of ``FedBenchCfg(**fields)`` on ``topo``: its
    curves and the [P, *leaf] edge models (numpy)."""
    from repro_torch.launch.train import FedBenchCfg, run_paper_task

    res = run_paper_task(FedBenchCfg(**fields), device="cpu",
                         log=lambda line: None, topo=topo)
    return {"curves": {k: res[k] for k in ("loss", "acc", "train_loss")},
            "params": pytree.tree_map(tensor_to_numpy, res["params"])}


# -- the votes and means, one call each ------------------------------------------

def _t(a):
    return None if a is None else torch.from_numpy(np.asarray(a))


def vote_checks(topo: Topology, inp: dict) -> dict:
    """Each topology-aware vote and mean on the rank's block of the
    global inputs ``inp`` (see ``tests/test_torch_mesh.py``), gathered
    back to its global [P, ...] result, as numpy."""
    rows = topo.pod_rows
    k = inp["clients"]

    def edges(x):                     # [P, ...] -> the rank's edges
        return None if x is None else _t(x)[rows]

    def dev(x, per_device=1):         # [P, D*per_device, ...] -> block
        return _t(topo.block(np.asarray(x), per_device))

    def full(x):                      # [P_loc, ...] -> [P, ...]
        return tensor_to_numpy(comm.gather_pods(topo, x))

    def tree_full(t):
        return pytree.tree_map(full, t)

    out = {}
    for name, mask in inp["masks"].items():
        m = edges(mask)
        out[f"ag_packed/{name}"] = full(votes.vote_ag_packed(
            dev(inp["s"]), m, topo))
        out[f"ar_int8/{name}"] = full(votes.vote_ar_int8(
            dev(inp["s"]), m, weight_bound=inp["bound"], topo=topo))
        u = pytree.tree_map(dev, inp["u"])
        delta = pytree.tree_map(edges, inp["delta"])
        out[f"fused/{name}"] = tree_full(votes.fused_sign_vote(
            u, delta, inp["rho"], m, topo))
        layout = flatbuf.make_layout(pytree.tree_map(_t, inp["v"]),
                                     batch_dims=1)
        for mu_static in (inp["mu"], None):
            v_buf = flatbuf.flatten_tree(
                layout, pytree.tree_map(edges, inp["v"]), 1)
            d_buf = flatbuf.flatten_tree(layout, delta, 1)
            got = votes.fused_sign_vote_update(
                layout, u, d_buf, inp["rho"], m, v_buf,
                torch.tensor(inp["mu"], dtype=torch.float32),
                mu_static=mu_static, topo=topo)
            out[f"fused_update/{name}/{mu_static is not None}"] = full(got)
    g, w = inp["g"], inp["w"]
    out["weighted_mean_dev"] = full(votes.weighted_mean_dev(
        dev(g), edges(w), topo=topo))
    out["weighted_mean_dev/clients"] = full(votes.weighted_mean_dev(
        dev(inp["g_k"], k), edges(inp["w_k"]), clients=k, topo=topo))
    out["fold_devices"] = full(votes.fold_devices(dev(g), topo))
    # the same with the coordinates cut into chunks of a few
    chunk, votes.CHUNK = votes.CHUNK, 7
    out["weighted_mean_dev/chunked"] = full(votes.weighted_mean_dev(
        dev(g), edges(w), topo=topo))
    out["fold_devices/chunked"] = full(votes.fold_devices(dev(g), topo))
    out["pod_weighted_average/chunked"] = full(votes.pod_weighted_average(
        edges(g[:, 0]), _t(inp["ew"]), topo))
    votes.CHUNK = chunk
    out["pod_weighted_average"] = full(votes.pod_weighted_average(
        edges(g[:, 0]), _t(inp["ew"]), topo))
    for name, tally in inp["tallies"].items():
        out[f"tally_vote_dev/{name}"] = full(votes.tally_vote_dev(
            dev(tally), edges(inp["n_eff"]), topo))
        layout = flatbuf.make_layout({"t": _t(tally[:, 0])}, batch_dims=1)
        out[f"fused_tally_finish/{name}"] = full(votes.fused_tally_finish(
            layout, dev(tally), edges(inp["n_eff"]),
            edges(inp["v_flat"]).clone(),
            torch.tensor(inp["mu"], dtype=torch.float32), topo))
    return out


if __name__ == "__main__":
    _rank_main(sys.argv[1], int(sys.argv[2]))
