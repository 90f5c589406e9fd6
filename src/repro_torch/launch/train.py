"""The paper's EMNIST-like task (Figs. 2-4) through the port's train step.

``run_paper_task`` builds the federated task of ``data.emnist_like``
(Q edges x D devices, Dirichlet(alpha=0.1) inter-edge skew), trains the
784-64-10 MLP with ``core.hier.make_hier_step`` for ``rounds * t_e``
local steps -- each device samples exactly B rows per step, with
replacement -- and after every round evaluates the cloud aggregate
``sum_q (D_q/N) v_q`` on the test set.  The anchor pass of a round reads
that round's first batch, as the JAX package's train loop does.

Virtual clients (``--clients_per_device K`` and the other client
fields): the data is split over D*K clients per edge, client c of device
d being data client ``d*K + c``; each device's batch stacks its K
clients' B/K rows in carve order, and the step votes with the
participation and |D_qk| weights of ``core.clients``.

The methods and options of ``core.hier`` are fields: ``--method`` any of
``hier_signsgd``, ``dc_hier_signsgd``, ``scaffold_hier_signsgd``,
``mtgc_hier_signsgd`` (``--cloud_period``), ``hier_sgd`` and
``hier_local_qsgd`` (step ``--mu_sgd``), ``--error_feedback``,
``--momentum`` and ``--cloud_overlap overlap``.

CLI (the paper's setup on the card):

  PYTHONPATH=src python -m repro_torch.launch.train --rounds 2 \\
      --batch 400 --n_train 20000
  PYTHONPATH=src python -m repro_torch.launch.train --rounds 2 \\
      --batch 400 --n_train 20000 --method hier_local_qsgd
  PYTHONPATH=src python -m repro_torch.launch.train --rounds 2 \\
      --batch 400 --n_train 20000 --clients_per_device 2 \\
      --participation bernoulli --rate 0.5 --client_seed 11 \\
      --data_weights --client_mode stream

``--device cpu`` runs the same code with the kernels' plain versions.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.core import clients as vclients
from repro_torch.core import hier, signs, votes
from repro_torch.core.topology import Topology, resolve_device
from repro_torch.data import emnist_like
from repro_torch.models import mlp

N_TEST = 1500

@dataclasses.dataclass
class FedBenchCfg:
    """The JAX package's ``benchmarks/fed_runner.FedBenchCfg`` fields (same
    defaults: B=64 at n_train=6000 is its CPU scaling of the paper's
    B=400 at 20000; the test set is ``N_TEST`` rows, as there), plus the
    port's transport and state layout, and the virtual-client fields of
    the JAX launchers: K clients per device, participation (full |
    bernoulli | fixed) at ``rate`` drawn from ``client_seed``, merged or
    stream ``client_mode``, and ``data_weights`` (vote weights |D_qk| =
    each client's row count, else unit weights)."""
    method: str = "dc_hier_signsgd"
    rho: float = 0.2
    iid: bool = False
    rounds: int = 8
    t_e: int = 15
    batch: int = 64
    mu: float = 5e-3
    mu_sgd: float = 0.5
    seed: int = 0
    q_edges: int = 4
    devices_per_edge: int = 5
    n_train: int = 6000
    decay: bool = False
    transport: str = "fused"
    state_layout: str = "flat"
    clients_per_device: int = 1
    participation: str = "full"
    rate: float = 1.0
    client_seed: int = 0
    client_mode: str = "merged"
    data_weights: bool = False
    error_feedback: bool = False
    momentum: float = 0.0
    cloud_overlap: str = "sync"
    cloud_period: int = 2


def client_config(cfg: FedBenchCfg, data) -> vclients.ClientConfig:
    """The run's ClientConfig; ``data`` is the [Q][D*K] client split."""
    k = cfg.clients_per_device
    weights = None
    if cfg.data_weights:
        weights = tuple(tuple(tuple(len(data[q][d * k + c]["y"])
                                    for c in range(k))
                              for d in range(cfg.devices_per_edge))
                        for q in range(cfg.q_edges))
    return vclients.ClientConfig(
        count=k, participation=cfg.participation, rate=cfg.rate,
        seed=cfg.client_seed, weights=weights, mode=cfg.client_mode)


def _stack_batches(client_data, cfg: FedBenchCfg, rng, dev):
    """One step's [P, D, B, ...] batch: per device its K clients' B/K
    rows each, stacked in carve order (client c of device d is data
    client ``d*K + c``), sampled in (edge, device, client) order."""
    k = cfg.clients_per_device
    rows = [[[emnist_like.device_batches(client_data, q, d * k + c,
                                         cfg.batch // k, rng)
              for c in range(k)]
             for d in range(cfg.devices_per_edge)]
            for q in range(cfg.q_edges)]
    return {key: torch.from_numpy(np.stack(
        [np.stack([np.concatenate([r[key] for r in dev_rows])
                   for dev_rows in edge]) for edge in rows])).to(dev)
        for key in ("x", "y")}


def _federated_data(cfg: FedBenchCfg):
    """The run's client split, test set and weights (checked)."""
    k = cfg.clients_per_device
    vclients.validate_batch_carve(cfg.batch, k)
    dcfg = emnist_like.FedDataCfg(
        n_train=cfg.n_train, n_test=N_TEST, alpha=0.1, iid=cfg.iid,
        seed=cfg.seed, q_edges=cfg.q_edges,
        devices_per_edge=cfg.devices_per_edge * k)
    data, test, ew, dw = emnist_like.make_federated_data(dcfg)
    smallest = min(len(d["y"]) for edge in data for d in edge)
    if smallest < cfg.batch // k:
        raise ValueError(
            f"the smallest {'client' if k > 1 else 'device'} holds "
            f"{smallest} rows < its batch {cfg.batch // k}: raise n_train "
            "or lower the batch")
    return data, test, ew, dw


def sample_batches(cfg: FedBenchCfg, device: str = "cuda") -> list:
    """The ``rounds * t_e`` batches ``run_paper_task`` samples for this
    config, in order, on the device: pass them back as its ``batches`` to
    run several methods on the same data without sampling again."""
    dev = resolve_device(device)
    data = _federated_data(cfg)[0]
    rng = np.random.default_rng(cfg.seed)
    return [_stack_batches(data, cfg, rng, dev)
            for _ in range(cfg.rounds * cfg.t_e)]


def run_paper_task(cfg: FedBenchCfg, device: str = "cuda", log=print,
                   batches: list | None = None) -> dict:
    """Train and evaluate; returns per-round curves (and ``loss_init``,
    the test loss of the initial model), timings, the final state and
    its edge models.  Deterministic given ``cfg.seed``; ``batches`` (from
    :func:`sample_batches` of the same data fields) replaces the
    sampling, with the same result; the data time is then a lookup."""
    dev = resolve_device(device)
    k = cfg.clients_per_device
    data, test, ew, dw = _federated_data(cfg)
    topo = Topology(cfg.q_edges, cfg.devices_per_edge, dev)
    cc = client_config(cfg, data)
    algo = hier.AlgoConfig(
        method=cfg.method, mu=cfg.mu, mu_sgd=cfg.mu_sgd, t_e=cfg.t_e,
        rho=cfg.rho, transport=cfg.transport, state_layout=cfg.state_layout,
        cloud_period=cfg.cloud_period, cloud_overlap=cfg.cloud_overlap,
        error_feedback=cfg.error_feedback, momentum=cfg.momentum,
        compute_dtype=torch.float32, master_dtype=torch.float32,
        delta_dtype=torch.float32, decay=cfg.decay, clients=cc)
    if cc.active:
        # the participating shares |D_qk| m_qk / sum_j |D_qj| m_qj come
        # from the client weights; the per-device factor is one
        dw = np.ones((cfg.q_edges, cfg.devices_per_edge), np.float32)
    init_fn, step = hier.make_hier_step(topo, algo, mlp.make_bundle())
    params0 = mlp.init_mlp(torch.Generator().manual_seed(cfg.seed))
    state = init_fn(params0, cfg.seed)
    ew_t = torch.tensor(ew, dtype=torch.float32, device=dev)
    dw_t = torch.tensor(dw, dtype=torch.float32, device=dev)
    mask = torch.ones((cfg.q_edges, cfg.devices_per_edge), device=dev)
    test_t = {"x": torch.from_numpy(test["x"]).to(dev),
              "y": torch.from_numpy(test["y"]).to(dev)}
    sub = {k: v[:512] for k, v in test_t.items()}
    rng = np.random.default_rng(cfg.seed)
    out = {"loss": [], "acc": [], "train_loss": [], "ms_per_step": [],
           "data_ms_per_step": [],
           "loss_init": float(mlp.loss_fn(
               {n: v.to(dev) for n, v in params0.items()}, sub))}
    for t in range(cfg.rounds):
        step_s = data_s = 0.0
        for tau in range(cfg.t_e):
            t0 = time.perf_counter()
            batch = {"train": (batches[t * cfg.t_e + tau] if batches
                               else _stack_batches(data, cfg, rng, dev))}
            t1 = time.perf_counter()
            state, metrics = step(state, batch, ew_t, dw_t, mask)
            train_loss = float(metrics["loss"])      # waits for the step
            step_s += time.perf_counter() - t1
            data_s += t1 - t0
        w = {k: votes.pod_weighted_average(v, ew_t)[0]
             for k, v in hier.edge_params(state).items()}
        out["train_loss"].append(train_loss)
        out["loss"].append(float(mlp.loss_fn(w, sub)))
        out["acc"].append(float(mlp.accuracy(w, test_t)))
        out["ms_per_step"].append(1e3 * step_s / cfg.t_e)
        out["data_ms_per_step"].append(1e3 * data_s / cfg.t_e)
        log(f"[train] round {t} train_loss {train_loss:.4f} "
            f"test_loss {out['loss'][-1]:.4f} acc {out['acc'][-1]:.4f} "
            f"ms/step {out['ms_per_step'][-1]:.3f} "
            f"(+ data {out['data_ms_per_step'][-1]:.3f})")
    d = mlp.param_count(params0)
    rate = cfg.rate if cfg.participation != "full" else 1.0
    out.update(state=state, params=hier.edge_params(state), d=d,
               clients=cc,
               uplink_bits_per_round=signs.uplink_bits(
                   cfg.method, d, cfg.t_e, clients=k,
                   participation_rate=rate))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    for f in dataclasses.fields(FedBenchCfg):
        if f.type == "bool":
            ap.add_argument(f"--{f.name}", action="store_true")
        else:
            ap.add_argument(f"--{f.name}", default=f.default,
                            type={"int": int, "float": float}.get(f.type, str))
    ap.add_argument("--device", default="cuda")
    args = vars(ap.parse_args(argv))
    device = args.pop("device")
    res = run_paper_task(FedBenchCfg(**args), device=device)
    print(f"[train] done: test loss {res['loss'][0]:.4f} -> "
          f"{res['loss'][-1]:.4f}, acc {res['acc'][-1]:.4f}")


if __name__ == "__main__":
    main()
