"""The ranks of a mesh checkpoint's tests: 8 gloo CPU processes.

``run(job, timeout)`` starts 8 ranks of this file (through
``torch_tp_worker.run_mesh``), which lay three grids over the same
world -- 2 x 2 x 2 (P=2 x D=2, M=2), 2 x 4 x 1 (P=2 x D=4, M=1) and 2 x
1 x 4 (P=2 x D=2, data 1, M=4) -- and run the job's parts in order,
rank 0's results coming back:

  * ``files`` -- name -> (kind, layout, grid): a state of the parity
    toy (``"toy"``, hidden 65: uneven model blocks; DC with error
    feedback, so a per-voter slot too; 2 steps on injected gradients) or
    of gemma3-1b's smoke config (``"gemma"``, DC, the first step of
    ``run_training``), saved by the mesh saver to ``DIR/port/<name>``,
    with its global state (``convert.gather_train_state``) and the
    bytes each rank sent the writer;
  * ``resume`` -- name -> a :func:`resume_case` spec: an uninterrupted
    ``run_training``, the same run with a nan restored and replayed,
    and the same run stopped and run again on its directory, each
    final state gathered;
  * ``reshape`` -- name -> (checkpoint directory, pickled logical global
    state, grid, layout): gemma3-1b smoke's checkpoint restored onto a grid,
    each rank's logical blocks against that state, counted as differing
    bytes on every rank;
  * ``failures`` -- a planted failure of rank 0's write and differing
    generator seeds: what each rank raised and how long it took;
  * ``jax`` -- JAX's checkpoints (written by
    ``torch_ckpt_jax_check.py``, waited for) restored onto the 2 x 2 x 2
    ranks, each rank's blocks against the global state JAX wrote beside
    them;
  * ``cli`` -- ``launch.train.lm_main``'s arguments: after the world is
    torn down, ranks 0-3 run the CLI as ``torchrun`` would (``WORLD_SIZE``
    4, ``env://``), rank 0's printed lines come back.

Imports torch, numpy and the port only.
"""
from __future__ import annotations

import contextlib
import dataclasses
import io
import os
import pathlib
import pickle
import sys
import time

import numpy as np
import torch

HERE = pathlib.Path(__file__).resolve().parent
SRC = HERE.parents[1] / "src"
for _p in (str(SRC), str(HERE)):
    if _p not in sys.path:
        sys.path.insert(0, _p)

import torch_tp_worker as TW  # noqa: E402

from repro_torch import configs, convert  # noqa: E402
from repro_torch.checkpoint import store  # noqa: E402
from repro_torch.checkpoint.async_ckpt import AsyncSaver  # noqa: E402
from repro_torch.convert import (gather_train_state,  # noqa: E402
                                 params_from_numpy, tensor_to_numpy)
from repro_torch.core import comm, flatbuf, hier, pytree, shardflat  # noqa
from repro_torch.core.topology import Topology  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.runtime.chaos import ChaosEvent, FaultInjector  # noqa: E402

GRIDS = {"2x2x2": ((2, 2, 2), (1, 1), (2, 2)),    # grid, block, (P, D)
         "2x4x1": ((2, 4, 1), (1, 1), (2, 4)),
         "2x1x4": ((2, 1, 4), (1, 2), (2, 2))}
TOY_HID = 65
TOY_STEPS = 2
LM = dict(steps=3, t_e=3, seq=8, batch=1)
WAIT_S = 80.0


def run(job: dict, timeout: float = 150.0) -> dict:
    return TW.run_mesh(2, 2, 2, (1, 1), job, timeout=timeout,
                       script=__file__)


def smoke(fsdp: bool = False):
    cfg = configs.get_smoke("gemma3_1b")
    return dataclasses.replace(cfg, param_mode="fsdp") if fsdp else cfg


def lm_algo(layout: str) -> hier.AlgoConfig:
    return hier.AlgoConfig(
        method="dc_hier_signsgd", t_e=LM["t_e"],
        transport="fused" if layout == "flat" else "ag_packed",
        state_layout=layout, compute_dtype=torch.float32)


def lm_run() -> train.RunCfg:
    return train.RunCfg(steps=LM["steps"], batch_per_device=LM["batch"],
                        seq_len=LM["seq"], log_every=0, ckpt_every=2)


def lm_args(topo: Topology, cfg, layout: str) -> tuple:
    """(init_fn, layout, master_specs) of a smoke run on ``topo``."""
    from repro_torch.models import build

    built = build.build_model(cfg, topo)
    init_fn, _ = hier.make_hier_step(topo, lm_algo(layout), built.bundle)
    lay, specs = train.checkpoint_args(topo, built.bundle,
                                       built.abstract_params())
    return built, init_fn, lay, specs


def toy_algo(layout: str) -> hier.AlgoConfig:
    return hier.AlgoConfig(
        method="dc_hier_signsgd", t_e=TOY_STEPS,
        transport="fused" if layout == "flat" else "ag_packed",
        state_layout=layout, error_feedback=True, mu=5e-3, rho=0.2,
        compute_dtype=torch.float32, master_dtype=torch.float32,
        delta_dtype=torch.float32)


def toy_problem(p: int, d: int) -> dict:
    return TW.injected_problem(p, d, 1, TOY_HID)


def toy_state(topo: Topology, layout: str, p: int, d: int) -> tuple:
    """The toy's state after ``TOY_STEPS`` steps on ``topo``, with its
    sharded layout."""
    prob = toy_problem(p, d)
    init_fn, step = hier.make_hier_step(topo, toy_algo(layout),
                                        TW.bundle_for(topo, prob))
    w0 = params_from_numpy(prob["w0"])
    state = init_fn(w0, seed=3)
    lay = shardflat.param_layout(topo, TW.TOY_SPECS, w0)
    for s in range(TOY_STEPS):
        batch = pytree.tree_map(torch.from_numpy,
                                topo.block(prob["batches"][s]))
        state, _ = step(state, {"train": batch},
                        torch.from_numpy(prob["ew"]),
                        torch.from_numpy(prob["dw"]),
                        torch.from_numpy(prob["mask"]))
    return state, (lay if lay.shards > 1 else None)


def gathered(state, topo, layout=None, master_specs=None,
             logical: bool = False) -> dict:
    full = gather_train_state(state, topo, layout=layout, logical=logical,
                              master_specs=master_specs)
    return {k: v for k, v in full._asdict().items() if k != "rng"}


def file_case(topo: Topology, name: str, kind: str, layout: str,
              pd: tuple, d: pathlib.Path) -> dict:
    if kind == "toy":
        state, lay = toy_state(topo, layout, *pd)
        specs = None
    else:
        built, _, lay, specs = lm_args(topo, smoke(), layout)
        state, _ = train.run_training(
            smoke(), topo, lm_algo(layout),
            dataclasses.replace(lm_run(), steps=1),
            log=lambda line: None)
    comm.reset_traffic()
    saver = AsyncSaver(d / "port" / name, topo=topo, layout=lay,
                       master_specs=specs)
    saver.submit(int(state.step), state)
    saver.close()
    sent = dict(comm.traffic["checkpoint"])
    own = sum(p.block.numel() * p.block.element_size()
              for p in _pieces(state, topo, lay, specs))
    local = sum(x.numel() * x.element_size() for x in _tensors(state))
    out = {"state": gathered(state, topo, lay, specs),
           "logical": gathered(state, topo, lay, specs, logical=True),
           "seed": state.rng.initial_seed(),
           "bytes": comm.agree(topo, [sent["sent"], sent["received"], own,
                                      local]),
           "records": saver.records}
    if topo.mesh.rank == 0:                   # for the JAX side
        with open(d / "port" / f"{name}.pkl", "wb") as f:
            pickle.dump(out, f)
    return out


def _pieces(state, topo, lay, specs):
    glike = convert.global_like(state, topo, lay, specs)
    return convert.state_pieces(state, topo, glike, lay, specs)


def _tensors(state) -> list:
    out = []
    for name in ("params", "agg_next", "delta", "delta_next", "ef", "mom",
                 "corr_cl", "corr_edge"):
        slot = getattr(state, name)
        if isinstance(slot, flatbuf.FlatState):
            out.append(slot.buf)
        elif slot is not None:
            out += pytree.tree_flatten(slot)[0]
    return out


def resume_case(topo: Topology, spec: dict, d: pathlib.Path) -> dict:
    """``spec``: fsdp (bool), layout, nan (the step of the injected nan)
    and, if given, stop (the step a stopped run ends at, run again on its
    directory): each run's final gathered state, losses and checkpoint
    events."""
    cfg = smoke(spec["fsdp"])
    _, _, lay, specs = lm_args(topo, cfg, spec["layout"])
    algo = lm_algo(spec["layout"])
    base = [ChaosEvent(1, "device", 1, 1)]
    out = {}

    def go(tag, run, events):
        events_seen = []
        state, hist = train.run_training(
            cfg, topo, algo, run, fault_injector=FaultInjector(events),
            log=lambda line: None, on_checkpoint=events_seen.append)
        out[tag] = {"state": gathered(state, topo, lay, specs),
                    "losses": [h["loss"] for h in hist],
                    "events": events_seen}

    go("uninterrupted", lm_run(), base)
    go("replayed", dataclasses.replace(
        lm_run(), ckpt_dir=str(d / "nan")),
       base + [ChaosEvent(spec["nan"], "nan")])
    if "stop" in spec:
        go("stopped", dataclasses.replace(
            lm_run(), steps=spec["stop"], ckpt_dir=str(d / "stop")), base)
        go("resumed", dataclasses.replace(
            lm_run(), ckpt_dir=str(d / "stop")), base)
    return out


def logical_block(topo: Topology, name: str, tree, lay) -> list:
    """This rank's block of a slot's logical global tree (numpy leaves
    ``[P, (D,) *leaf]``): its rows (and voters), its model block cut to
    the logical extent."""
    voter = name in hier.PER_VOTER
    idx = (topo.pod_rows, topo.voter_cols()) if voter else (topo.pod_rows,)
    out = []
    for i, a in enumerate(pytree.tree_flatten(tree)[0]):
        a = np.asarray(a)[idx]
        s = lay.slots[i] if lay is not None else None
        if s is not None and s.shard_dim is not None:
            w = s.shape[s.shard_dim]
            keep = s.local_extent(lay.shards, topo.model_rank)
            a = np.take(a, range(topo.model_rank * w,
                                 topo.model_rank * w + keep),
                        axis=(2 if voter else 1) + s.shard_dim)
        out.append(np.ascontiguousarray(a))
    return out


def local_logical(state, topo, lay, name: str) -> list:
    """A rank's slot as its logical blocks (the zero tails and the
    padding dropped), numpy."""
    slot = getattr(state, name)
    voter = name in hier.PER_VOTER
    if isinstance(slot, flatbuf.FlatState):
        slot = slot.tree(cast=False)
    leaves = pytree.tree_flatten(slot)[0]
    out = []
    for i, x in enumerate(leaves):
        s = lay.slots[i] if lay is not None else None
        if s is not None and s.shard_dim is not None:
            ax = (2 if voter else 1) + s.shard_dim
            x = x.narrow(ax, 0, s.local_extent(lay.shards, topo.model_rank))
        out.append(tensor_to_numpy(x))
    return out


def reshape_case(topo: Topology, src: str, want: str, layout: str) -> dict:
    """Checkpoint directory ``src`` restored onto ``topo`` as a
    ``layout`` state: the bytes of each slot's logical blocks that
    differ from the logical global state pickled at ``want`` (under
    ``"logical"``), on every rank."""
    with open(want, "rb") as f:
        want = pickle.load(f)["logical"]
    built, init_fn, lay, specs = lm_args(topo, smoke(), layout)
    like = init_fn(built.init_params(torch.Generator().manual_seed(0)), 1)
    t0 = time.perf_counter()
    step, state = store.restore_latest_mesh(src, like, topo, lay, specs)
    secs = time.perf_counter() - t0
    differ = 0
    for name, tree in want.items():
        if name == "step" or tree is None:
            continue
        for a, b in zip(local_logical(state, topo, lay, name),
                        logical_block(topo, name, tree, lay)):
            differ += int((a.view(np.uint8) != b.view(np.uint8)).sum()
                          if a.shape == b.shape else a.size + 1)
    return {"step": step, "differ": comm.agree(topo, [differ]),
            "restore_s": secs}


def failures(topo: Topology, d: pathlib.Path) -> dict:
    """A planted failure of rank 0's write: what each rank raises at its
    next ``submit``, and after how long; then differing seeds."""
    state, lay = toy_state(topo, "flat", 2, 2)
    out = {}
    saver = AsyncSaver(d / "fail", topo=topo, layout=lay)
    real = store.save
    if topo.mesh.rank == 0:
        def broken(*a, **kw):
            raise OSError("planted: the disk refused the write")
        store.save = broken
    saver.submit(2, state)
    t0 = time.perf_counter()
    try:
        saver.submit(3, state)
        out["write"] = ("nothing", time.perf_counter() - t0)
    except RuntimeError as e:
        out["write"] = (str(e), time.perf_counter() - t0)
    finally:
        store.save = real
    saver.close()
    if topo.mesh.rank == 1:
        state = state._replace(rng=torch.Generator().manual_seed(99))
    saver = AsyncSaver(d / "seeds", topo=topo, layout=lay)
    t0 = time.perf_counter()
    try:
        saver.submit(2, state)
        out["seeds"] = ("nothing", time.perf_counter() - t0)
    except ValueError as e:
        out["seeds"] = (str(e), time.perf_counter() - t0)
    saver.close()
    rows = [None] * topo.mesh.size
    import torch.distributed as dist
    dist.all_gather_object(rows, out)
    return rows


def wait_for(path: pathlib.Path, limit: float = WAIT_S) -> None:
    t0 = time.monotonic()
    while not path.exists():
        if time.monotonic() - t0 > limit:
            raise TimeoutError(f"{path} did not appear in {limit} s")
        time.sleep(0.1)


def jax_blocks(topo: Topology, d: pathlib.Path, names: list) -> dict:
    """JAX's checkpoints restored on the ranks: each slot's bytes that
    differ from the rank's block of the global state JAX wrote."""
    wait_for(d / "jax.done")
    out = {}
    for name in names:
        layout = "flat" if "flat" in name else "tree"
        prob = toy_problem(2, 2)
        init_fn, _ = hier.make_hier_step(topo, toy_algo(layout),
                                         TW.bundle_for(topo, prob))
        w0 = params_from_numpy(prob["w0"])
        like = init_fn(w0, seed=3)
        lay = shardflat.param_layout(topo, TW.TOY_SPECS, w0)
        with open(d / "jax" / f"{name}.pkl", "rb") as f:
            full = pickle.load(f)
        step, got = store.restore_latest_mesh(d / "jax" / name, like, topo,
                                              lay)
        want = convert.train_state_from_numpy(
            hier.TrainState(**full, rng=None), like, topo, lay)
        differ = 0
        for a, b in zip(_tensors(got), _tensors(want)):
            differ += int((a.view(torch.uint8) != b.view(torch.uint8)).sum())
        out[name] = {"step": step, "differ": comm.agree(topo, [differ])}
    return out


def cli(rank: int, args: list, port: int) -> list:
    """``lm_main(args)`` as rank ``rank`` of 4 under torchrun's
    environment: rank 0's printed lines."""
    os.environ.update(WORLD_SIZE="4", RANK=str(rank), LOCAL_RANK=str(rank),
                      LOCAL_WORLD_SIZE="4", MASTER_ADDR="127.0.0.1",
                      MASTER_PORT=str(port))
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        train.main(args)
    return buf.getvalue().splitlines()


def _rank_main(tmp: str, rank: int) -> None:
    import torch.distributed as dist

    from repro_torch.launch import mesh

    torch.set_num_threads(1)
    comm.CHUNK_BYTES = 1 << 16        # many chunks a block, as on the card
    d = pathlib.Path(tmp)
    with open(d / "job.pkl", "rb") as f:
        job = pickle.load(f)
    dist.init_process_group("gloo", init_method=f"file://{d / 'rdv'}",
                            rank=rank, world_size=8, timeout=mesh.TIMEOUT)
    topos = {name: mesh.make_host_topology(*grid, backend="gloo",
                                           device="cpu", block=block)
             for name, (grid, block, _) in GRIDS.items()}
    res = {"files": {}, "resume": {}, "reshape": {}, "times": {}}
    work = pathlib.Path(job["dir"])
    (work / "port").mkdir(exist_ok=True)
    t0 = time.perf_counter()
    for name, (kind, layout, grid) in job.get("files", {}).items():
        res["files"][name] = file_case(topos[grid], name, kind, layout,
                                       GRIDS[grid][2], work)
    if rank == 0:
        (work / "port.done").touch()
    res["times"]["files"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    for name, spec in job.get("resume", {}).items():
        res["resume"][name] = resume_case(topos["2x2x2"], spec,
                                          work / "resume" / name)
    res["times"]["resume"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    for name, (src, want, grid, layout) in job.get("reshape", {}).items():
        res["reshape"][name] = reshape_case(topos[grid], src, want, layout)
    res["times"]["reshape"] = time.perf_counter() - t0
    if "failures" in job:
        t0 = time.perf_counter()
        res["failures"] = failures(topos["2x2x2"], work)
        res["times"]["failures"] = time.perf_counter() - t0
    if "jax" in job:
        t0 = time.perf_counter()
        res["jax"] = jax_blocks(topos["2x2x2"], work, job["jax"])
        res["times"]["jax"] = time.perf_counter() - t0
    dist.barrier()
    dist.destroy_process_group()
    if "cli" in job and rank < 4:
        t0 = time.perf_counter()
        res["cli"] = cli(rank, job["cli"], job["port"])
        res["times"]["cli"] = time.perf_counter() - t0
    if rank == 0:
        with open(d / "results.tmp", "wb") as f:
            pickle.dump(res, f)
        os.replace(d / "results.tmp", d / "results.pkl")


if __name__ == "__main__":
    _rank_main(sys.argv[1], int(sys.argv[2]))
