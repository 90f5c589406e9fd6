"""The loss of a few DC steps at the published widths, in the JAX package
and in the port, on the CPU: does the reference's loss rise where the
port's does?

Both packages start from the same parameters (the port's ``init_params``
from seed 0, handed to JAX through numpy) and read the same batches
(Zipf tokens at the synthetic stream's skew, drawn by numpy from a seed;
a vlm's patches 0.02 * normal), and take ``--steps`` steps of
DC-HierSignSGD at P = D = 1 (T_E=3, rho 0.2, bf16 compute and delta, f32
master, ag_packed on the tree state, the replicated regime; JAX's step
jitted) for each ``--mus``.  Every width stays as published; the counts
are cut so that one package's run fits a few GB of host memory: one
layer (an MoE layer for the moe family), ``--experts`` routed experts,
``--vocab`` words, MTP off unless ``--mtp``.  Each (package, mu) runs in
its own process.  Prints one JSON line a run and then a table of the
losses side by side.

  PYTHONPATH=src:tests python tests/helpers/torch_mu_witness.py \\
      --arch deepseek_v3_671b --vocab 2020 --experts 8 --seq 256
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time

import numpy as np

T_E, RHO = 3, 0.2


def cut(configs, args):
    """The arch's full config with only its counts cut (the module
    docstring)."""
    cfg = (configs.get_smoke if args.smoke else configs.get_config)(
        args.arch)
    kw = dict(n_layers=1, vocab=args.vocab, param_mode="replicated")
    if cfg.moe is not None:
        kw["moe"] = dataclasses.replace(cfg.moe, n_experts=args.experts,
                                        first_dense=0)
    if cfg.mtp:
        kw["mtp"] = bool(args.mtp)
    return dataclasses.replace(cfg, **kw)


def batches(cfg, args) -> list[dict]:
    """``args.steps`` numpy batches of [1, 1, 1, seq] tokens (and [1, 1,
    1, n_patches, d_model] patches for a vlm)."""
    rng = np.random.default_rng(args.seed)
    logits = -1.2 * np.log(np.arange(1, cfg.vocab + 1))
    p = np.exp(logits - logits.max())
    p = p[rng.permutation(cfg.vocab)] / p.sum()
    out = []
    for _ in range(args.steps):
        b = {"tokens": rng.choice(cfg.vocab, (1, 1, 1, args.seq),
                                  p=p).astype(np.int32)}
        if cfg.n_patches:
            b["patches"] = (0.02 * rng.standard_normal(
                (1, 1, 1, cfg.n_patches, cfg.d_model))).astype(np.float32)
        out.append(b)
    return out


def initial_params(args):
    """The port's parameters from seed 0 as a numpy tree, and the cut
    config of the port."""
    import torch

    from repro_torch import configs
    from repro_torch.convert import params_to_numpy
    from repro_torch.core.topology import Topology
    from repro_torch.models import build
    cfg = cut(configs, args)
    built = build.build_model(cfg, Topology(1, 1, "cpu"))
    return cfg, params_to_numpy(built.init_params(
        torch.Generator().manual_seed(0)))


def run_jax(args) -> list[float]:
    import jax
    import jax.numpy as jnp

    from repro import configs as jconfigs
    from repro.core import hier as jhier
    from repro.core.topology import single_device_topology
    from repro.models import build as jbuild

    _, p = initial_params(args)
    jcfg = cut(jconfigs, args)
    built = jbuild.build_model(jcfg, single_device_topology())
    p = jax.tree.map(jnp.asarray, p)
    algo = jhier.AlgoConfig(method="dc_hier_signsgd", mu=args.mu, rho=RHO,
                            t_e=T_E, transport="ag_packed",
                            state_layout="tree", compute_dtype=jnp.bfloat16,
                            master_dtype=jnp.float32,
                            delta_dtype=jnp.bfloat16)
    init_fn, step = jhier.make_hier_step(single_device_topology(), algo,
                                         built.bundle)
    state = jax.jit(init_fn)(p, jax.random.PRNGKey(1))
    del p
    jstep = jax.jit(step, donate_argnums=0)
    ones = jnp.ones((1, 1))
    losses = []
    for b in batches(jcfg, args):
        state, metrics = jstep(state, {"train": b}, jnp.ones(1), ones, ones)
        losses.append(float(metrics["loss"]))
    return losses


def run_torch(args) -> list[float]:
    import torch

    from repro_torch.convert import params_from_numpy
    from repro_torch.core import hier
    from repro_torch.core.topology import Topology
    from repro_torch.models import build

    cfg, p = initial_params(args)
    topo = Topology(1, 1, "cpu")
    built = build.build_model(cfg, topo)
    algo = hier.AlgoConfig(method="dc_hier_signsgd", mu=args.mu, rho=RHO,
                           t_e=T_E, transport="ag_packed",
                           state_layout="tree", compute_dtype=torch.bfloat16,
                           master_dtype=torch.float32,
                           delta_dtype=torch.bfloat16)
    init_fn, step = hier.make_hier_step(topo, algo, built.bundle)
    state = init_fn(params_from_numpy(p))
    del p
    losses = []
    for b in batches(cfg, args):
        tb = {k: torch.from_numpy(v) for k, v in b.items()}
        tb["tokens"] = tb["tokens"].long()
        state, metrics = step(state, {"train": tb}, torch.ones(1),
                              torch.ones(1, 1), torch.ones(1, 1))
        losses.append(float(metrics["loss"]))
    return losses


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="deepseek_v3_671b")
    ap.add_argument("--vocab", type=int, default=2020)
    ap.add_argument("--experts", type=int, default=8)
    ap.add_argument("--mtp", type=int, default=0)
    ap.add_argument("--smoke", type=int, default=0,
                    help="1: the smoke widths (a check of this script)")
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--steps", type=int, default=6)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--mus", default="1e-3,1e-4,1e-5")
    ap.add_argument("--pkg", choices=("jax", "torch"), default=None,
                    help="run one package at --mu in this process")
    ap.add_argument("--mu", type=float, default=None)
    args = ap.parse_args()
    if args.pkg is not None:
        t0 = time.perf_counter()
        losses = (run_jax if args.pkg == "jax" else run_torch)(args)
        import resource
        print(json.dumps({"pkg": args.pkg, "arch": args.arch,
                          "mu": args.mu, "losses": losses,
                          "wall_s": time.perf_counter() - t0,
                          "max_rss_gb": resource.getrusage(
                              resource.RUSAGE_SELF).ru_maxrss / 1e6}),
              flush=True)
        return
    rows = []
    for mu in map(float, args.mus.split(",")):
        for pkg in ("jax", "torch"):
            cmd = [sys.executable, __file__, "--pkg", pkg, "--mu", str(mu)]
            for k in ("arch", "vocab", "experts", "mtp", "smoke", "seq",
                      "steps", "seed"):
                cmd += [f"--{k}", str(getattr(args, k))]
            out = subprocess.run(cmd, check=True, capture_output=True,
                                 text=True).stdout
            rows.append(json.loads(out.strip().splitlines()[-1]))
            print(json.dumps(rows[-1]), flush=True)
    for jr, tr in zip(rows[::2], rows[1::2]):
        steps0 = jr["losses"][0]
        print(f"mu {jr['mu']:.0e}: step 0 {steps0:.4f}; jax "
              f"{' '.join(f'{x:.4f}' for x in jr['losses'])} | torch "
              f"{' '.join(f'{x:.4f}' for x in tr['losses'])} | round 2 "
              f"mean jax {np.mean(jr['losses'][T_E:2 * T_E]):.4f} torch "
              f"{np.mean(tr['losses'][T_E:2 * T_E]):.4f}")


if __name__ == "__main__":
    main()
