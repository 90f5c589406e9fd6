"""Where the paper task's time goes on the card.

For each of six runs -- the paper task (the fused transport on the
flat state, B=400, Q=4 x D=5, T_E=15 steps), the same task on the plain
ag_packed transport and tree state (no kernel; the update runs per
leaf), the fused task with K=2 virtual clients per device on the
streamed sweep (Bernoulli(0.5) participation, |D_qk| weights, one
``tally_acc`` launch per client), and on fused/flat the QSGD baseline
(``hier_local_qsgd``: 4 ``ternary_quant`` launches a step), SCAFFOLD
and DC with error feedback -- runs one warm-up round, then one
round of ``run_paper_task`` under ``torch.profiler`` and prints one JSON
line: the host-clock step and data times per step, the device time per
step of kernels and of copies (the round's evaluation included), the
kernels' share of the step time -- the rest the device sat idle -- and
the activities that took the most device time. The profiler's own
overhead lengthens the host times, so read the step time from
``chip_smoke.py`` and the shares from here.

  PYTHONPATH=src python -m repro_torch.launch.profile_step
"""
from __future__ import annotations

import dataclasses
import json

import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.launch.train import FedBenchCfg, run_paper_task


def device_us(event) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(event, name):
            return float(getattr(event, name))
    return 0.0


def on_device(event) -> bool:
    """A kernel or copy the device ran (not a CPU op, whose device time
    repeats its children's)."""
    return str(getattr(event, "device_type", "")).endswith("CUDA")


def profile_run(name: str, cfg: FedBenchCfg) -> dict:
    run_paper_task(cfg, device="cuda", log=lambda line: None)   # warm-up
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        res = run_paper_task(cfg, device="cuda", log=lambda line: None)
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if on_device(e) and device_us(e) > 0]
    events.sort(key=device_us, reverse=True)
    steps = cfg.rounds * cfg.t_e
    copies = [e for e in events if e.key.startswith(("Memcpy", "Memset"))]
    kernels = [e for e in events if e not in copies]
    per_step = lambda evs: sum(map(device_us, evs)) / 1e3 / steps  # noqa
    step_ms, data_ms = res["ms_per_step"][0], res["data_ms_per_step"][0]
    return {
        "run": name, "device": torch.cuda.get_device_name(0),
        "steps": steps, "step_ms": step_ms, "data_ms": data_ms,
        "kernel_ms_per_step": per_step(kernels),
        "copy_ms_per_step": per_step(copies),
        "kernel_share_of_step": per_step(kernels) / step_ms,
        "kernels_per_step": sum(e.count for e in kernels) / steps,
        "top": [{"name": e.key[:120], "calls": e.count,
                 "device_ms_per_step": device_us(e) / 1e3 / steps}
                for e in events[:12]]}


def main() -> None:
    cfg = FedBenchCfg(rounds=1, t_e=15, batch=400, n_train=20000)
    clients = dataclasses.replace(
        cfg, clients_per_device=2, participation="bernoulli", rate=0.5,
        client_seed=11, data_weights=True, client_mode="stream")
    tree = dataclasses.replace(cfg, transport="ag_packed",
                               state_layout="tree")
    for name, c in (("paper task, fused/flat", cfg),
                    ("paper task, ag_packed/tree", tree),
                    ("clients K=2, stream fused/flat", clients),
                    ("hier_local_qsgd, fused/flat", dataclasses.replace(
                        cfg, method="hier_local_qsgd")),
                    ("scaffold, fused/flat", dataclasses.replace(
                        cfg, method="scaffold_hier_signsgd")),
                    ("dc + EF, fused/flat", dataclasses.replace(
                        cfg, error_feedback=True))):
        print(json.dumps(profile_run(name, c)), flush=True)


if __name__ == "__main__":
    main()
