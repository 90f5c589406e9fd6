"""Fault-tolerance demo: checkpointed training that survives a chaos
schedule -- client kill, straggler demotion, an injected nan-loss
(restore + replay from the newest checkpoint), and a simulated process
crash (automatic resume).

    PYTHONPATH=src python -m repro_torch.examples.fault_tolerant_train
    PYTHONPATH=src python -m repro_torch.examples.fault_tolerant_train \\
        --device cpu

The JAX package's ``examples/fault_tolerant_train.py`` on the port (a
reduced stablelm-3b, K=2 virtual clients per device), on the card unless
``--device`` says otherwise.
"""
import argparse
import tempfile

import torch

from repro_torch import configs
from repro_torch.core import clients as vclients
from repro_torch.core import hier
from repro_torch.core.topology import Topology
from repro_torch.launch.train import RunCfg, run_training
from repro_torch.runtime.chaos import ChaosEvent, FaultInjector


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = configs.get_smoke("stablelm_3b")
    topo = Topology(1, 1, args.device)
    algo = hier.AlgoConfig(method="dc_hier_signsgd", mu=2e-3, t_e=4,
                           rho=0.3, compute_dtype=torch.float32,
                           clients=vclients.ClientConfig(count=2))

    with tempfile.TemporaryDirectory() as ckpt:
        run = RunCfg(steps=12, batch_per_device=4, seq_len=64,
                     ckpt_dir=ckpt, ckpt_every=4, log_every=4)
        # One explicit chaos schedule drives everything (events at step s
        # apply before step s; the same schedule form feeds the chaos
        # parity cells and `launch.train --chaos SEED`):
        inj = FaultInjector([
            ChaosEvent(3, "client", 0, 0, 1),      # virtual client dies
            ChaosEvent(5, "recover", 0, 0, 1),     # ...and rejoins
            ChaosEvent(6, "straggler", 0, 0, 0),   # demoted to abstention
            ChaosEvent(8, "recover", 0, 0, 0),
            ChaosEvent(9, "nan"),                  # numeric blow-up: the
            # trainer restores the newest checkpoint and replays -- batches
            # are cursor-addressable and membership replays from the
            # schedule, so the rerun is deterministic
        ])
        _, hist = run_training(cfg, topo, algo, run, fault_injector=inj)
        assert min(h["live"] for h in hist) < 1.0, "churn should be visible"
        assert hist[-1]["live"] == 1.0, "everyone recovered"
        print(f"\nphase 1 done at step {hist[-1]['step']} "
              f"(loss {hist[-1]['loss']:.3f}); simulating crash + "
              "restart...")
        # "crash": rerun with a longer horizon -- run_training resumes
        # from the newest intact checkpoint automatically
        run2 = RunCfg(steps=18, batch_per_device=4, seq_len=64,
                      ckpt_dir=ckpt, ckpt_every=4, log_every=4)
        _, hist2 = run_training(cfg, topo, algo, run2)
        assert hist2[0]["step"] >= 8, "should resume from a checkpoint"
        print(f"resumed at step {hist2[0]['step']}, finished at "
              f"{hist2[-1]['step']} (loss {hist2[-1]['loss']:.3f})")
    print("OK")


if __name__ == "__main__":
    main()
