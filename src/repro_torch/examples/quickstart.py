"""Quickstart: train a reduced gemma3-1b under DC-HierSignSGD.

    PYTHONPATH=src python -m repro_torch.examples.quickstart
    PYTHONPATH=src python -m repro_torch.examples.quickstart --device cpu

The JAX package's ``examples/quickstart.py`` on the port: pick an
architecture config (the reduced same-family one), make the hierarchical
sign-SGD step for a topology (P=1 pod, D=1 device), and train on the
synthetic heterogeneous token stream -- on the card unless ``--device``
says otherwise.
"""
import argparse

import torch

from repro_torch import configs
from repro_torch.core import hier
from repro_torch.core.topology import Topology
from repro_torch.launch.train import RunCfg, run_training


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = configs.get_smoke("gemma3_1b")     # reduced same-family config
    topo = Topology(1, 1, args.device)       # P=1 pod, D=1 device
    algo = hier.AlgoConfig(
        method="dc_hier_signsgd",            # the paper's Algorithm 2
        mu=2e-3,                             # sign step size
        t_e=5,                               # local 1-bit steps per round
        rho=0.3,                             # correction strength
        compute_dtype=torch.float32,
    )
    _, history = run_training(
        cfg, topo, algo,
        RunCfg(steps=30, batch_per_device=8, seq_len=64, log_every=5))

    print(f"\nquickstart: loss {history[0]['loss']:.3f} -> "
          f"{history[-1]['loss']:.3f} over {len(history)} steps")
    assert history[-1]["loss"] < history[0]["loss"]
    print("OK")


if __name__ == "__main__":
    main()
