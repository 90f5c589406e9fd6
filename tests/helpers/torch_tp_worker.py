"""The ranks of a gloo process mesh with a model axis, and their runs.

``run_mesh(pods, data, model, block, job)`` starts ``pods * data *
model`` Python processes of this file, one a rank, which meet through a
file in a temporary directory (gloo), lay the ``[P, D]`` hierarchy over
a ``pods x data x model`` grid (``launch.mesh.make_host_topology``, each
rank a ``block`` of edges and devices and one model shard) and run the
job; rank 0's results come back.  A run that does not end within
``timeout`` seconds is killed, every rank of it, and raises.

The job:

  * ``cells`` -- name -> :func:`run_cell` spec: a train step over the
    parity toy, on injected gradients (``kind`` "injected") or on its
    own regression (``kind`` "toy": ``w`` column-parallel, ``w2``
    row-parallel, the product summed over the model group), whose final
    state comes back gathered over every axis as logical numpy trees
    (``convert.gather_train_state(..., logical=True)``), with every
    step's loss, whether every copy leaf of every slot is bitwise the
    same on each model rank and, for a flat state, the gathered global
    multi-bucket master; a cell with ``restart_at`` gathers its global
    state there and starts again from it
    (``convert.train_state_from_numpy``);
  * ``transport`` -- one fused vote-update on the sharded layout of a
    toy tree (``votes.fused_sign_vote_update`` on the rank's bucket),
    the global multi-bucket buffer gathered back;
  * ``dense`` -- name -> :func:`dense_grads` spec: an LM smoke config's
    (any tensor-parallel family's, fields overridden) loss and per-device
    gradients on each rank's blocks;
  * ``lm`` -- ``launch.train.run_training`` of a smoke config; ``lm_ckpt``
    the same with a checkpoint directory, stopped and run again on it
    (``torch_mesh_worker.lm_ckpt_run``);
  * ``production`` -- ``launch.mesh.make_topology`` on this world, for
    each ``multi_pod`` value listed (the error it raises);
  * ``identity`` -- names of ``core.comm``'s model collectives that the
    ranks replace with the identity before the job (a dropped
    collective, for ``torch_tp_step0_bound.py``).

:func:`run_cell` runs as well on a topology without a mesh: the
one-process reference.  Imports torch, numpy and the port only.
"""
from __future__ import annotations

import os
import pathlib
import pickle
import re
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
import torch_mesh_worker as MW  # noqa: E402

from repro_torch.convert import (gather_train_state,  # noqa: E402
                                 params_from_numpy, tensor_to_numpy,
                                 train_state_from_numpy)
from repro_torch.core import (comm, flatbuf, hier, pytree,  # noqa: E402
                              shardflat, votes)
from repro_torch.core.topology import Topology  # noqa: E402

JOIN_S = 150.0
TOY_SPECS = {"w": (None, "model"), "b": (None,), "w2": ("model", None)}


# -- the launcher -------------------------------------------------------------

def run_mesh(pods: int, data: int, model: int, block: tuple, job: dict,
             timeout: float = JOIN_S, script: str | None = None) -> dict:
    """Run ``job`` on a ``pods x data x model`` gloo mesh of CPU processes
    and return rank 0's results; raises if a rank fails or the run
    outlives ``timeout`` seconds (all ranks are killed first).
    ``script``: the rank program (``python SCRIPT TMP RANK``; this file
    by default)."""
    world = pods * data * model
    with tempfile.TemporaryDirectory() as tmp:
        d = pathlib.Path(tmp)
        with open(d / "job.pkl", "wb") as f:
            pickle.dump({"grid": (pods, data, model), "block": tuple(block),
                         **job}, f)
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            [str(SRC), str(HERE), os.environ.get("PYTHONPATH", "")]),
            OMP_NUM_THREADS="1")
        logs = [open(d / f"rank{r}.log", "w+") for r in range(world)]
        procs = [subprocess.Popen([sys.executable, script or __file__, tmp,
                                   str(r)],
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
            raise RuntimeError(f"the {pods} x {data} x {model} mesh run "
                               f"outlived its {timeout} s limit: ranks "
                               "killed\n" + MW._tails(logs))
        if any(proc.returncode for proc in procs):
            raise RuntimeError(
                f"a rank of the {pods} x {data} x {model} mesh failed (exit "
                f"codes {[proc.returncode for proc in procs]})\n"
                + MW._tails(logs))
        for log in logs:
            log.close()
        with open(d / "results.pkl", "rb") as f:
            return pickle.load(f)


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
    if "piece" in job:
        from repro_torch.core import host_exchange
        host_exchange.PIECE = job["piece"]
    topo = mesh.make_host_topology(
        pods, data, model, backend="gloo", device="cpu", block=job["block"],
        shared_dir=d if job.get("shared") else None)
    for name in job.get("identity", ()):
        setattr(comm, name, lambda topo, x: x)
    m = topo.mesh
    res = {"cells": {}, "blocks": (topo.local_pods, topo.local_devices),
           "coords": (m.pod_rank, m.data_rank, m.model_rank),
           "rank": m.rank}
    for name, spec in job.get("cells", {}).items():
        res["cells"][name] = run_cell(topo, spec)
    if "transport" in job:
        res["transport"] = transport(topo, job["transport"])
    if "exchange" in job:
        res["exchange"] = exchange_checks(topo, job["exchange"])
        res["left"] = sorted(p.name for p in d.iterdir() if re.fullmatch(
            r"(data|pod|model)\d+\.\d+", p.name))
    res["dense"] = {name: dense_grads(topo, spec)
                    for name, spec in job.get("dense", {}).items()}
    if "lm" in job:
        res["lm"] = MW.lm_run(topo, job["lm"])
    if "lm_ckpt" in job:
        res["lm_ckpt"] = MW.lm_ckpt_run(topo, job["lm_ckpt"], tmp)
    res["production"] = {}
    for multi_pod in job.get("production", ()):
        try:
            mesh.make_topology(multi_pod=multi_pod, device="cpu")
            res["production"][multi_pod] = None
        except ValueError as e:
            res["production"][multi_pod] = str(e)
    if rank == 0:
        with open(d / "results.tmp", "wb") as f:
            pickle.dump(res, f)
        os.replace(d / "results.tmp", d / "results.pkl")
    dist.barrier()
    dist.destroy_process_group()


def exchange_checks(topo: Topology, seed: int) -> dict:
    """Each all-gather and the all-to-all of ``core.comm`` through the
    mesh's shared host memory (``topo``'s) against the backend's on the
    same ranks (a second mesh without it): per case, whether the results
    have the same bits and ``comm.traffic`` the same counts (gathered to
    rank 0 as a bool each rank)."""
    import copy

    import torch.distributed as dist

    from repro_torch.launch import mesh

    m = topo.mesh
    plain = mesh.make_host_topology(
        m.pods, m.data, m.model, backend="gloo", device="cpu",
        block=(topo.local_pods, topo.local_devices))
    gen = torch.Generator().manual_seed(seed + m.rank)
    x = torch.randn((2, 3, 5, 7), generator=gen)      # 840 B: 1 piece
    big = torch.randn((1, 2, 1500), generator=gen)    # pieces and halves
    parts = torch.randn((m.data, 1, 2, 700), generator=gen)
    w = torch.randn((2, 3 * m.model, 5, 7), generator=gen)

    def with_grad(t, grad):
        y = x.clone().requires_grad_(True)
        z = comm.all_gather_model(t, y, 1, grad)
        (g,) = torch.autograd.grad((z * w).sum(), y)
        return torch.cat([z.detach().flatten(), g.flatten()])

    cases = {
        "gather_devices": lambda t: comm.gather_devices(t, big),
        "gather_pods": lambda t: comm.gather_pods(t, x),
        "gather_pods bf16": lambda t: comm.gather_pods(t, big.bfloat16()),
        "gather_pods bool": lambda t: comm.gather_pods(t, big > 0),
        "gather_shards dim 2": lambda t: comm.gather_shards(t, x, 2),
        "gather_shards int32": lambda t: comm.gather_shards(
            t, (big * 1e3).to(torch.int32), 0),
        "scatter_shards": lambda t: comm.scatter_shards(t, parts),
        "scatter_shards int8": lambda t: comm.scatter_shards(
            t, (parts * 50).to(torch.int8)),
        "gather_model dim 3": lambda t: comm.gather_model(t, x, 3),
        "all_gather_model slice": lambda t: with_grad(t, "slice"),
        "all_gather_model sum": lambda t: with_grad(t, "sum"),
    }
    out = {}
    for name, fn in cases.items():
        comm.reset_traffic()
        want = fn(plain)
        counted = copy.deepcopy(comm.traffic)
        comm.reset_traffic()
        got = fn(topo)
        ok = torch.tensor([
            got.dtype == want.dtype and got.shape == want.shape
            and torch.equal(got, want), comm.traffic == counted])
        every = [torch.empty_like(ok) for _ in range(m.size)]
        dist.all_gather(every, ok)
        out[name] = torch.stack(every).tolist()
    return out


# -- the toy's bundles ------------------------------------------------------------

def toy_bundle(topo: Topology) -> hier.ModelBundle:
    """The parity toy's regression ``mean((x @ w @ w2 + b - y)^2)`` on
    [P, V, *leaf] copies and batches ``{"x": [P, V, B, DIN], "y": [P, V,
    B, DOUT]}``; over a model axis ``w`` column-parallel (its input
    marked ``copy_to_model``) and ``w2`` row-parallel (the product
    summed over the model group)."""
    tp = topo if topo.model_shards > 1 else None

    def loss(params, batch):
        x = comm.copy_to_model(tp, batch["x"].to(params["w"].dtype))
        h = x @ params["w"]
        pred = comm.sum_model(tp, h @ params["w2"]) + params["b"][:, :, None]
        return torch.mean((pred - batch["y"]) ** 2, dim=(-2, -1))

    return hier.ModelBundle(loss=loss, specs=TOY_SPECS)


def bundle_for(topo: Topology, prob: dict) -> hier.ModelBundle:
    if prob["kind"] == "toy":
        return toy_bundle(topo)
    shapes = {n: np.shape(a) for n, a in prob["w0"].items()}
    return injected_grads.make_tp_bundle(topo, shapes, TOY_SPECS)


# -- the train step ---------------------------------------------------------------

def copies_agree(topo: Topology, state: hier.TrainState,
                 layout: flatbuf.FlatLayout) -> bool:
    """Whether every copy leaf (a leaf no spec splits) of every slot is
    bitwise the same on each rank of this rank's model group (True
    without a model axis)."""
    if topo.model_shards == 1 or layout.shards == 1:
        return True
    ok = True
    for name in MW_SLOTS:
        slot = getattr(state, name)
        if slot is None:
            continue
        tree = slot.tree(cast=False) if isinstance(
            slot, flatbuf.FlatState) else slot
        for s, leaf in zip(layout.slots, pytree.tree_flatten(tree)[0]):
            if s.shard_dim is not None:
                continue
            got = comm.gather_model(topo, leaf.unsqueeze(0).contiguous(), 0)
            ok &= all(torch.equal(got[0].view(torch.uint8),
                                  g.view(torch.uint8)) for g in got[1:])
    return bool(ok)


MW_SLOTS = ("params", "agg_next", "delta", "delta_next", "ef", "mom",
            "corr_cl", "corr_edge")


def run_cell(topo: Topology, spec: dict) -> dict:
    """``torch_mesh_worker.run_cell``'s spec on ``topo`` with the toy's
    specs over its model axis: the final global state as logical numpy
    trees (every slot), the [P, *leaf] edge models, every step's loss,
    the run's traffic and whether every copy agreed across the model
    group after every step."""
    prob = spec["problem"]
    algo = hier.AlgoConfig(
        method=spec["method"], transport=spec["transport"],
        state_layout=spec["state_layout"], t_e=spec["t_e"], mu=spec["mu"],
        mu_sgd=spec["mu_sgd"], rho=spec["rho"],
        clients=MW.client_config(spec.get("clients")),
        compute_dtype=torch.float32, master_dtype=torch.float32,
        delta_dtype=torch.float32, **spec.get("algo", {}))
    init_fn, step = hier.make_hier_step(topo, algo, bundle_for(topo, prob))
    w0 = params_from_numpy(prob["w0"])
    state = init_fn(w0, seed=3)
    layout = shardflat.param_layout(topo, TOY_SPECS, w0)
    comm.reset_traffic()
    losses, agree = [], True
    for s in range(spec["steps"]):
        if s == spec.get("restart_at"):
            # gather the global state and start again from it, each rank
            # taking its block and its model shard
            full = gather_train_state(state, topo, layout=layout)
            state = train_state_from_numpy(full, init_fn(w0, seed=3), topo,
                                           layout)
        batch = pytree.tree_map(torch.from_numpy,
                                topo.block(prob["batches"][s]))
        state, metrics = step(
            state, {"train": batch}, torch.from_numpy(prob["ew"]),
            torch.from_numpy(prob["dw"]), torch.from_numpy(prob["mask"]))
        losses.append(float(metrics["loss"]))
        agree &= copies_agree(topo, state, layout)
    traffic = {op: dict(v) for op, v in comm.traffic.items()}
    full = gather_train_state(state, topo, layout=layout, logical=True)
    buf = (gather_train_state(state, topo, layout=layout).params
           if isinstance(state.params, flatbuf.FlatState) else None)
    return {"state": {k: v for k, v in full._asdict().items()
                      if k != "rng"}, "buffer": buf,
            "params": pytree.tree_map(tensor_to_numpy, hier.edge_params(
                state, topo, layout)),
            "losses": losses, "traffic": traffic, "copies_agree": agree,
            "shards": layout.shards}


# -- one fused vote-update on the sharded layout --------------------------------

def transport(topo: Topology, inp: dict) -> dict:
    """``votes.fused_sign_vote_update`` on the rank's bucket of the toy
    tree's sharded layout (directions ``u`` [P, D, *leaf], master ``v``
    [P, *leaf], correction ``delta`` [P, *leaf], global numpy): the
    words gathered over the data group only, the master updated in
    place; the global multi-bucket buffer and the traffic come back."""
    rows = topo.pod_rows
    v = params_from_numpy(inp["v"])
    layout = shardflat.param_layout(topo, TOY_SPECS, v, batch_dims=1)
    v_loc = shardflat.local_block(topo, layout, pytree.tree_map(
        lambda x: x[rows], v), 1)
    v_buf = shardflat.flatten(topo, layout, v_loc, 1)
    d_buf = shardflat.flatten(topo, layout, shardflat.local_block(
        topo, layout, pytree.tree_map(lambda x: torch.from_numpy(x)[rows],
                                      inp["delta"]), 1), 1)
    u = shardflat.local_block(topo, layout, pytree.tree_map(
        lambda x: torch.from_numpy(topo.block(x)), inp["u"]), 2)
    mask = torch.ones((topo.local_pods, topo.devices_per_pod),
                      dtype=torch.bool)
    comm.reset_traffic()
    out = votes.fused_sign_vote_update(
        layout.bucket(), u, d_buf, inp["rho"], mask, v_buf,
        torch.tensor(inp["mu"], dtype=torch.float32), mu_static=inp["mu"],
        topo=topo)
    traffic = {op: dict(v) for op, v in comm.traffic.items()}
    full = comm.gather_pods(topo, comm.gather_model(topo, out, 1))
    return {"buf": tensor_to_numpy(full), "in_place": out is v_buf,
            "traffic": traffic, "n_pad": layout.n_pad,
            "bucket_words": layout.bucket_words}


# -- the tensor-parallel families ------------------------------------------

def smoke_config(configs, arch: str, overrides: dict | None = None):
    """``configs.get_smoke(arch)`` with ``overrides``' fields replaced (a
    ``"moe"`` or ``"mla"`` entry: a dict of that sub-config's fields);
    ``configs`` is either package's registry."""
    import dataclasses

    cfg = configs.get_smoke(arch)
    kw = dict(overrides or {})
    for sub in ("moe", "mla"):
        if sub in kw:
            kw[sub] = dataclasses.replace(getattr(cfg, sub), **kw[sub])
    return dataclasses.replace(cfg, **kw)


def dense_grads(topo: Topology, spec: dict) -> dict:
    """A smoke config's per-device gradients at ``spec["params"]`` (numpy,
    one replica) on the rank's [P_loc, D_loc] block of ``spec["tokens"]``
    ([P, D, b, L]; a vlm's ``spec["patches"]`` [P, D, b, n_patches, d]
    or whisper's ``spec["frames"]`` [P, D, b, frames, frontend_dim]
    too): copies of the rank's blocks in ``spec["dtype"]`` (float32
    unless it names another torch dtype) through the bundle's loss
    (tensor-parallel over the model axis) of ``spec["arch"]``'s smoke
    config with ``spec["overrides"]`` (:func:`smoke_config`); the [P,
    D] losses and every gradient leaf gathered over every axis, the
    tails dropped, and whether the copies' gradients agree across the
    model group."""
    from repro_torch import configs
    from repro_torch.models import build

    cfg = smoke_config(configs, spec["arch"], spec.get("overrides"))
    built = build.build_model(cfg, topo)
    full = params_from_numpy(spec["params"])
    layout = shardflat.param_layout(topo, built.bundle.specs, full)
    local = shardflat.local_block(topo, layout, full)
    leaves, td = pytree.tree_flatten(local)
    shape = (topo.local_pods, topo.local_devices)
    dtype = getattr(torch, spec.get("dtype", "float32"))
    copies = [x.expand(shape + tuple(x.shape)).to(dtype).contiguous()
              .requires_grad_(True) for x in leaves]
    batch = {"tokens": torch.from_numpy(topo.block(spec["tokens"]))}
    for extra in ("patches", "frames"):
        if extra in spec:
            batch[extra] = torch.from_numpy(topo.block(spec[extra]))
    tree = shardflat.logical(topo, layout, pytree.tree_unflatten(td, copies),
                             2)
    losses = built.bundle.loss(tree, batch)
    grads = torch.autograd.grad(losses.sum(), copies)
    agree = True
    if layout.shards > 1:
        for s, g in zip(layout.slots, grads):
            if s.shard_dim is None:
                got = comm.gather_model(topo, g.unsqueeze(0), 0)
                agree &= all(torch.equal(got[0], x) for x in got[1:])
    gtree = shardflat.gather(topo, layout, pytree.tree_unflatten(
        td, list(grads)), 2)
    whole = pytree.tree_map(lambda g: tensor_to_numpy(comm.gather_pods(
        topo, comm.gather_devices(topo, g))), gtree)
    return {"losses": tensor_to_numpy(comm.gather_pods(
        topo, comm.gather_devices(topo, losses.detach()))),
            "grads": whole, "copies_agree": bool(agree),
            "shards": layout.shards,
            "sharded": [s.shard_dim is not None for s in layout.slots]}


if __name__ == "__main__":
    _rank_main(sys.argv[1], int(sys.argv[2]))


# -- the toy matrix's cells ---------------------------------------------------------

METHODS = ("hier_signsgd", "dc_hier_signsgd", "scaffold_hier_signsgd",
           "mtgc_hier_signsgd", "hier_sgd", "hier_local_qsgd")
SHORT = dict(zip(METHODS, ("hier", "dc", "scaffold", "mtgc", "sgd", "qsgd")))
TRANSPORTS = ("ag_packed", "ar_int8", "fused")
LAYOUTS = ("tree", "flat")
T_E, STEPS, K = 3, 6, 2
MU, MU_SGD = 5e-3, 0.05


def toy_shapes(hid: int) -> dict:
    return {"w": (16, hid), "b": (33,), "w2": (hid, 33)}


def membership(p, d, k, seed):
    rng = np.random.default_rng(seed)
    ew = rng.random(p).astype(np.float32)
    dw = rng.random((p, d)).astype(np.float32)
    if k == 1:
        mask = np.ones((p, d), np.float32)
        mask[-1, 0] = 0.0                       # a dropped device
    else:
        mask = np.ones((p, d, k), np.float32)
        mask[0, -1, 1] = 0.0                    # a dropped client
    return ew / ew.sum(), dw / dw.sum(1, keepdims=True), mask


def injected_problem(p, d, k, hid, seed=21) -> dict:
    """Seeded injected gradients of the toy at hidden width ``hid``."""
    rng = np.random.default_rng(seed)
    shapes = toy_shapes(hid)
    w0 = {n: rng.standard_normal(s).astype(np.float32)
          for n, s in shapes.items()}
    batches = [{"g": {n: rng.standard_normal((p, d, k) + s).astype(
        np.float32) for n, s in shapes.items()}} for _ in range(STEPS)]
    ew, dw, mask = membership(p, d, k, seed + 1)
    return {"kind": "injected", "w0": w0, "batches": batches, "ew": ew,
            "dw": dw, "mask": mask}


def spec(method, transport, layout, problem, clients=None, **algo):
    return {"method": method, "transport": transport, "state_layout": layout,
            "t_e": T_E, "mu": MU, "mu_sgd": MU_SGD, "rho": 0.2,
            "clients": clients, "algo": algo, "problem": problem,
            "steps": STEPS}


def client_fields(p, d, mode):
    weights = tuple(tuple(tuple((q + 2 * j + 3 * c) % 5 + 1
                                for c in range(K)) for j in range(d))
                    for q in range(p))
    return {"count": K, "participation": "bernoulli", "rate": 0.5,
            "seed": 11, "weights": weights, "mode": mode}


def cells(p: int, d: int, hid: int) -> dict:
    """The toy matrix at hidden width ``hid``: the six methods x the
    three transports x the two layouts; K=2 clients, merged and stream,
    under Bernoulli(0.5); EF, momentum and the overlapped cloud."""
    one, many = injected_problem(p, d, 1, hid), injected_problem(p, d, K, hid)
    out = {}
    for m in METHODS:
        for t in TRANSPORTS:
            for lay in LAYOUTS:
                out[f"{SHORT[m]}/{t}/{lay}"] = spec(m, t, lay, one)
        for mode in ("merged", "stream"):
            out[f"{SHORT[m]}/fused/flat/K2-{mode}"] = spec(
                m, "fused", "flat", many, client_fields(p, d, mode))
    for t, lay in (("fused", "flat"), ("ar_int8", "tree")):
        out[f"dc/{t}/{lay}/ef"] = spec("dc_hier_signsgd", t, lay, one,
                                       error_feedback=True)
        out[f"dc/{t}/{lay}/momentum"] = spec("dc_hier_signsgd", t, lay, one,
                                             momentum=0.9)
        out[f"dc/{t}/{lay}/overlap"] = spec("dc_hier_signsgd", t, lay, one,
                                            cloud_overlap="overlap")
    out["dc/fused/flat/ef-K2-stream"] = spec(
        "dc_hier_signsgd", "fused", "flat", many,
        client_fields(p, d, "stream"), error_feedback=True)
    for name in RESTARTED:     # gathered and restarted after round 1
        out[f"{name}/restarted"] = dict(out[name], restart_at=T_E)
    return {f"h{hid}/{name}": c for name, c in out.items()}


RESTARTED = ("dc/fused/flat", "scaffold/ag_packed/tree",
             "mtgc/fused/flat/K2-stream", "dc/ar_int8/tree/momentum")


def held_at_tolerance(name: str) -> bool:
    """QSGD's norms and EF's scale sum over the model group: those cells
    are held at atol 1e-5, every other bitwise."""
    return "qsgd" in name or "ef" in name.split("/")[-1]
