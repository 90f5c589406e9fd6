"""The ranks of the dry run's traffic test: 8 gloo CPU processes.

``run(job)`` starts 8 ranks of this file (through
``torch_tp_worker.run_mesh``) on a 2 x 2 x 2 grid (P=2 x D=2, a model
axis of 2, a [1, 1] block a rank).  For each case of ``job["cases"]``
-- name -> (the smoke config's overridden fields, ``AlgoConfig``
fields) -- each rank trains ``job["arch"]``'s smoke config two steps
from its ``init_fn`` state: step 0, at a round boundary (the prologue:
the cloud mean and the anchors), and step 1, inside the round.  Each
step's record: ``core.comm``'s traffic by op (the ops called) and
``group_bytes()``, and its calls of each kernel wrapper, counted here
-- on the CPU the wrappers run their plain versions and count no
launch, so every module's reference to a wrapper is replaced by one
that counts its calls.  Every rank's records come back, in rank order.

Imports torch, numpy and the port only.
"""
from __future__ import annotations

import dataclasses
import os
import pathlib
import pickle
import sys

import torch

HERE = pathlib.Path(__file__).resolve().parent
SRC = HERE.parents[1] / "src"
for _p in (str(SRC), str(HERE)):
    if _p not in sys.path:
        sys.path.insert(0, _p)

import torch_tp_worker as TW  # noqa: E402

from repro_torch import configs  # noqa: E402
from repro_torch.core import comm, hier  # noqa: E402
from repro_torch.kernels import build as kbuild  # noqa: E402

GRID = (2, 2, 2)
STEPS = ("sync_step", "local_step")     # state step 0, then 1


def run(job: dict, timeout: float = 150.0) -> dict:
    return TW.run_mesh(*GRID, (1, 1), job, timeout=timeout, script=__file__)


def count_calls() -> dict:
    """Replace every loaded port module's reference to a kernel wrapper
    by one that counts its calls; the counts."""
    import functools

    calls = dict.fromkeys(kbuild.KERNELS, 0)
    mods = [m for n, m in sys.modules.items() if n.startswith("repro_torch")]
    for name in kbuild.KERNELS:
        wrapper = getattr(sys.modules[f"repro_torch.kernels.{name}"], name)

        @functools.wraps(wrapper)
        def counted(*a, _name=name, _fn=wrapper, **kw):
            calls[_name] += 1
            return _fn(*a, **kw)
        for mod in mods:
            if getattr(mod, name, None) is wrapper:
                setattr(mod, name, counted)
    return calls


def case_cfg(arch: str, fields: dict):
    return dataclasses.replace(configs.get_smoke(arch), **fields)


def steps(topo, job: dict, calls: dict) -> dict:
    """Each case's two steps on this rank: its records."""
    from repro_torch.models import build

    out = {}
    b, seq = job["batch"], job["seq"]
    for name, (fields, algo_kw) in job["cases"].items():
        cfg = case_cfg(job["arch"], fields)
        built = build.build_model(cfg, topo)
        algo = hier.AlgoConfig(**algo_kw)
        init_fn, step = hier.make_hier_step(topo, algo, built.bundle)
        gen = torch.Generator().manual_seed(job["seed"])
        state = init_fn(built.init_params(gen), 1)
        tokens = torch.randint(0, cfg.vocab, (topo.local_pods,
                                              topo.local_devices, b, seq),
                               generator=gen)
        p, d = topo.pods, topo.devices_per_pod
        weights = (torch.full((p,), 1.0 / p), torch.full((p, d), 1.0 / d),
                   torch.ones(p, d))
        out[name] = {}
        for label in STEPS:
            comm.reset_traffic()
            for k in calls:
                calls[k] = 0
            state, _ = step(state, {"train": {"tokens": tokens}}, *weights)
            out[name][label] = {
                "ops": {op: dict(v) for op, v in comm.traffic.items()
                        if v["calls"]},
                "groups": comm.group_bytes(), "calls": dict(calls)}
    return out


def _rank_main(tmp: str, rank: int) -> None:
    import torch.distributed as dist

    from repro_torch.launch import mesh

    torch.set_num_threads(1)
    d = pathlib.Path(tmp)
    with open(d / "job.pkl", "rb") as f:
        job = pickle.load(f)
    dist.init_process_group("gloo", init_method=f"file://{d / 'rdv'}",
                            rank=rank, world_size=8, timeout=mesh.TIMEOUT)
    topo = mesh.make_host_topology(*GRID, backend="gloo", device="cpu")
    calls = count_calls()
    res = steps(topo, job, calls)
    rows = [None] * dist.get_world_size()
    dist.all_gather_object(rows, res)
    if rank == 0:
        with open(d / "results.tmp", "wb") as f:
            pickle.dump(rows, f)
        os.replace(d / "results.tmp", d / "results.pkl")
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    _rank_main(sys.argv[1], int(sys.argv[2]))
