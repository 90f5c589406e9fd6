"""The trainers: the paper's EMNIST-like task and the LM zoo.

Two trainers on the port's train step (``core.hier.make_hier_step``):
``run_paper_task`` trains the paper's MLP task (below), and
``run_training`` an LM of the zoo (``--arch NAME``: the dense, vlm,
moe, ssm, hybrid and encdec/audio families, in the replicated regime or,
for an FSDP config -- gemma3-12b, internvl2, arctic, deepseek-v3 -- in
the FSDP regime of ``core.hier``; their ``--smoke`` configs are
replicated):
the JAX package's ``launch/train.py`` trainer -- config -> model ->
DC-HierSignSGD step -> synthetic token stream -> elastic membership ->
async checkpointing -> failure recovery -- on one card, the P edges x D
devices as leading dims (``--pods``/``--devices_per_pod``, 1 x 1 by
default: the on-card counterpart of the JAX CLI's one-device mesh).
``--ckpt DIR`` resumes from and saves to a checkpoint store
(``checkpoint.store``, the JAX package's format); ``--chaos SEED`` runs
under a seeded fault schedule (``runtime.chaos``), an injected nan
answered by restore-and-replay.

Under ``torchrun`` (``WORLD_SIZE`` > 1) the LM CLI lays ``--pods x
--devices_per_pod`` over the ranks (``launch.mesh``): each rank trains
its block of edges and devices and the votes and means cross ranks
(``core.comm``), printing the one-process run's digits; an FSDP config
(``--arch gemma3_12b`` and the other large ones) trains in the FSDP
regime over the ranks, each holding its shard of every master
(``core.device_axis``).  The backend is
gloo on the CPU and for ranks that share a card, NCCL with a card a
rank.  ``--multi_pod`` lays the production grid (2 pods x 16 data x 16
model, ``mesh.make_topology``) over 512 ranks: P = 2 x D = 16, the
dense, vlm and moe families tensor-parallel over the model axis
(``ValueError`` on another world size).  ``--ckpt DIR`` under a mesh
saves and resumes the mesh run's one checkpoint, the JAX store's file of
the global state (rank 0 writes it from the ranks' blocks and chooses
the step a restore reads, each rank reading its block); ``DIR`` must be
one every rank reads (one host, or a shared file system).

  PYTHONPATH=src torchrun --nproc_per_node 4 -m repro_torch.launch.train \\
      --device cpu --arch gemma3_1b --smoke --steps 6 --t_e 3 --pods 2 \\
      --devices_per_pod 2
  rm -rf build/ckpt_mesh
  PYTHONPATH=src torchrun --nproc_per_node 4 -m repro_torch.launch.train \\
      --device cpu --arch gemma3_1b --smoke --steps 12 --t_e 3 --pods 2 \\
      --devices_per_pod 2 --ckpt build/ckpt_mesh --chaos 3

  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
      --arch gemma3_1b --smoke --steps 6 --t_e 3
  rm -rf build/ckpt
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
      --arch gemma3_1b --smoke --steps 12 --t_e 3 --ckpt build/ckpt \\
      --chaos 3
  # the same directory again: resumes at step 12 and runs to 18
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
      --arch gemma3_1b --smoke --steps 18 --t_e 3 --ckpt build/ckpt \\
      --chaos 3

The paper task:

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
import math
import os
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import configs
from repro_torch.checkpoint import store
from repro_torch.checkpoint.async_ckpt import AsyncSaver
from repro_torch.core import clients as vclients
from repro_torch.core import (comm, hier, pytree, schedule, shardflat, signs,
                              votes)
from repro_torch.core.topology import Topology, resolve_device
from repro_torch.data import cluster, emnist_like, synthetic
from repro_torch.launch import mesh
from repro_torch.models import build, mlp
from repro_torch.runtime import chaos, elastic, failures

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


def _stack_batches(client_data, cfg: FedBenchCfg, rng, dev,
                   topo: Topology | None = None):
    """One step's [P, D, B, ...] batch: per device its K clients' B/K
    rows each, stacked in carve order (client c of device d is data
    client ``d*K + c``), sampled in (edge, device, client) order.  With
    a mesh topology the whole batch is sampled (so the stream is the
    one-process run's) and the rank's block kept."""
    k = cfg.clients_per_device
    rows = [[[emnist_like.device_batches(client_data, q, d * k + c,
                                         cfg.batch // k, rng)
              for c in range(k)]
             for d in range(cfg.devices_per_edge)]
            for q in range(cfg.q_edges)]
    batch = {key: np.stack(
        [np.stack([np.concatenate([r[key] for r in dev_rows])
                   for dev_rows in edge]) for edge in rows])
        for key in ("x", "y")}
    if topo is not None:
        batch = topo.block(batch)
    return {key: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
            for key, v in batch.items()}


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


def sample_batches(cfg: FedBenchCfg, device: str = "cuda",
                   topo: Topology | None = None) -> list:
    """The ``rounds * t_e`` batches ``run_paper_task`` samples for this
    config, in order, on the device (with a mesh topology, the rank's
    blocks of them): pass them back as its ``batches`` to run several
    methods on the same data without sampling again."""
    dev = resolve_device(device)
    data = _federated_data(cfg)[0]
    rng = np.random.default_rng(cfg.seed)
    return [_stack_batches(data, cfg, rng, dev, topo)
            for _ in range(cfg.rounds * cfg.t_e)]


def run_paper_task(cfg: FedBenchCfg, device: str = "cuda", log=print,
                   batches: list | None = None,
                   topo: Topology | None = None) -> dict:
    """Train and evaluate; returns per-round curves (and ``loss_init``,
    the test loss of the initial model), timings, the final state and
    its edge models.  Deterministic given ``cfg.seed``; ``batches`` (from
    :func:`sample_batches` of the same data fields) replaces the
    sampling, with the same result; the data time is then a lookup.
    ``topo``: a mesh topology of Q x D (``launch.mesh``) to train the
    rank's block on (the state is the rank's, the edge models and the
    curves the whole run's); None trains all of it in this process."""
    dev = resolve_device(device)
    k = cfg.clients_per_device
    data, test, ew, dw = _federated_data(cfg)
    if topo is None:
        topo = Topology(cfg.q_edges, cfg.devices_per_edge, dev)
    elif (topo.pods, topo.devices_per_pod) != (cfg.q_edges,
                                               cfg.devices_per_edge):
        raise ValueError(f"topology {topo.pods} x {topo.devices_per_pod} "
                         f"!= the task's {cfg.q_edges} x "
                         f"{cfg.devices_per_edge}")
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
                               else _stack_batches(data, cfg, rng, dev,
                                                   topo))}
            t1 = time.perf_counter()
            state, metrics = step(state, batch, ew_t, dw_t, mask)
            train_loss = float(metrics["loss"])      # waits for the step
            step_s += time.perf_counter() - t1
            data_s += t1 - t0
        w = {k: votes.pod_weighted_average(v, ew_t)[0]
             for k, v in hier.edge_params(state, topo).items()}
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
    out.update(state=state, params=hier.edge_params(state, topo), d=d,
               clients=cc,
               uplink_bits_per_round=signs.uplink_bits(
                   cfg.method, d, cfg.t_e, clients=k,
                   participation_rate=rate))
    return out


@dataclasses.dataclass
class RunCfg:
    """The JAX package's ``launch/train.RunCfg``: steps, the per-device
    batch and sequence length, the checkpoint directory and interval,
    logging, the stream's heterogeneity and the seed; plus ``ckpt_keep``,
    the checkpoints the store keeps (the JAX trainer's saver keeps 3)."""
    steps: int = 50
    batch_per_device: int = 4
    seq_len: int = 128
    ckpt_dir: str | None = None
    ckpt_every: int = 20
    ckpt_keep: int = 3
    log_every: int = 5
    hetero: float = 1.0
    alpha_client: float | None = None
    edge_assign: str = "fixed"
    seed: int = 0


def checkpoint_args(topo: Topology, bundle: hier.ModelBundle, params,
                    master_dtype=torch.float32) -> tuple:
    """What a mesh run's checkpoint needs to know of its state beyond
    the state (``AsyncSaver``'s and ``store.restore_latest_mesh``'s
    ``layout`` and ``master_specs``): the master's sharded layout where
    a model axis splits a leaf (None otherwise: a flat slot carries it)
    and, in the FSDP regime, the bundle's master specs.  ``params``: one
    replica's parameters, or anything of their shapes."""
    layout = master_specs = None
    if topo.mesh is None:
        return layout, master_specs
    if topo.model_shards > 1 and bundle.specs is not None:
        layout = shardflat.param_layout(topo, bundle.specs, pytree.tree_map(
            lambda x: torch.empty((1,) + tuple(x.shape), dtype=master_dtype,
                                  device="meta"), params), batch_dims=1)
    if bundle.param_mode == "fsdp":
        master_specs = bundle.master_specs
    return layout, master_specs


def run_training(cfg, topo: Topology, algo: hier.AlgoConfig, run: RunCfg,
                 fault_injector: chaos.FaultInjector | None = None,
                 on_metrics=None, params=None, log=print,
                 on_checkpoint=None, on_state=None):
    """Train the LM ``cfg`` for ``run.steps`` steps; returns (final_state,
    history).  Deterministic given the seeds.

    ``params``: one replica's initial parameters (e.g. the JAX package's,
    converted); None draws them from ``run.seed`` on ``topo.device``.
    ``history`` holds per executed step its loss, the live share of the
    membership, the step's host-clock ms (ending when the loss is on
    the host) and the ms the batch took to make; a replayed step is
    listed again.

    Fault tolerance, as the JAX trainer has it: with ``run.ckpt_dir`` the
    run resumes from the newest intact checkpoint, submits one to an
    :class:`AsyncSaver` every ``run.ckpt_every`` steps and at the end
    (not twice for one step).  ``fault_injector``'s events at step s
    apply to the membership before step s.  A non-finite loss -- real,
    or the injector's ``nan`` -- drains the saver, restores the newest
    checkpoint and replays from it, the membership replayed from the
    schedule (so is a resumed run's); without a checkpoint, or past the
    detector's restore budget, it raises.  ``on_checkpoint(event)``
    hears of each resume and restore (``restore_s``, the seconds to
    verify and load) and, at the end, of each save (the saver's
    ``records``); ``on_state(step, state)`` sees the state after each
    executed step.

    With a mesh topology (``launch.mesh``) the rank trains its block:
    every rank draws the whole token stream and keeps its block, the
    membership stays global (the step takes the rank's block of it), and
    the loss is the whole run's.  With a model axis the ranks of a (pod,
    device) cell draw the same batch, and a dense, vlm or moe model
    trains tensor-parallel on each rank's blocks (``models.build``).  An
    FSDP config holds each master's shard on each rank (``core.hier``),
    over a model axis its model block's.

    Checkpoints under a mesh are the JAX store's file of the global
    state, one a step, in ``run.ckpt_dir``, which every rank must read
    (one host, or a file system they share): rank 0 writes it from the
    blocks the ranks send it (``AsyncSaver`` under a mesh,
    ``store.gather_to_writer``); a resume or a restore is rank 0's
    choice of the newest intact step, heard by every rank, each reading
    its block (``store.restore_latest_mesh``), after every rank drained
    its saver.  The non-finite loss is rank 0's reading, heard by every
    rank, so every rank takes the same branch.  A run resumes from a
    checkpoint of another mesh shape, or of one process, as well."""
    built = build.build_model(cfg, topo)
    init_fn, step_fn = hier.make_hier_step(topo, algo, built.bundle)
    if params is None:
        params = built.init_params(
            torch.Generator(device=topo.device).manual_seed(run.seed))
    mesh_run = topo.mesh is not None
    layout, master_specs = checkpoint_args(topo, built.bundle, params,
                                           algo.master_dtype)
    state = init_fn(params, run.seed + 1)
    del params
    stream = synthetic.make_stream(synthetic.LMStreamCfg(
        vocab=cfg.vocab, seq_len=run.seq_len,
        batch_per_device=run.batch_per_device, pods=topo.pods,
        devices_per_pod=topo.devices_per_pod, seed=run.seed,
        hetero=run.hetero, clients_per_device=algo.clients.count,
        alpha_client=run.alpha_client, edge_assign=run.edge_assign,
        frames=(cfg.encoder_frames if cfg.family in ("encdec", "audio")
                else 0),
        frontend_dim=cfg.frontend_dim, n_patches=cfg.n_patches,
        d_model=cfg.d_model))
    # with an active ClientConfig the membership mask is client-granular
    # [P, D, K], the step's own vocabulary
    member = elastic.Membership(topo.pods, topo.devices_per_pod,
                                clients=algo.clients)
    detector = failures.FailureDetector()
    saver = (AsyncSaver(run.ckpt_dir, keep=run.ckpt_keep, topo=topo,
                        layout=layout, master_specs=master_specs)
             if run.ckpt_dir else None)
    notify = on_checkpoint or (lambda event: None)

    def restore():
        t0 = time.perf_counter()
        restored = (store.restore_latest_mesh(run.ckpt_dir, state, topo,
                                              layout, master_specs)
                    if mesh_run else store.restore_latest(run.ckpt_dir, state))
        return restored, time.perf_counter() - t0

    start = saved = 0
    if run.ckpt_dir:
        restored, secs = restore()
        if restored is not None:
            start, state = restored
            saved = start
            log(f"[train] resumed from step {start}")
            notify({"event": "resume", "step": start, "restore_s": secs})
            if fault_injector is not None:
                member = chaos.replay_membership(fault_injector, member,
                                                 start)
    history = []
    step = start
    while step < run.steps:
        if fault_injector is not None:
            # events at step s apply BEFORE step s runs -- the semantics
            # chaos.compile_schedule gives the parity tests
            chaos.apply_events(member, fault_injector.at(step),
                               now=float(step))
        arrays = member.weights()
        t0 = time.perf_counter()
        batch = {"train": topo.block(stream(step))}
        t1 = time.perf_counter()
        state, metrics = step_fn(state, batch, arrays.edge_weights,
                                 arrays.dev_weights, arrays.mask)
        loss = float(metrics["loss"])             # waits for the step
        dt = time.perf_counter() - t1
        detector.record_step(dt)
        if fault_injector is not None and fault_injector.nan_due(step):
            loss = float("nan")                   # injected blow-up
        finite = detector.check_loss(loss)
        if mesh_run and run.ckpt_dir:             # rank 0's reading
            finite = bool(comm.agree(topo, [finite])[0][0])
        if not finite:
            if saver:
                saver.wait()
            restored, secs = (restore() if run.ckpt_dir else (None, 0.0))
            if restored is None:
                raise RuntimeError(
                    f"non-finite loss at step {step}, no checkpoint")
            if not detector.may_restore():
                raise RuntimeError(
                    f"non-finite loss at step {step}, restore budget "
                    f"({detector.policy.max_restores}) spent")
            detector.record_restore()   # may_restore() is a pure query
            bad, (step, state) = step, restored
            if fault_injector is not None:
                # membership replays from the schedule so the replayed
                # steps see the same arrays as the first pass
                member = chaos.replay_membership(fault_injector, member,
                                                 step)
            log(f"[train] non-finite loss at step {bad}; restored step "
                f"{step}")
            notify({"event": "restore", "step": step, "at": bad,
                    "restore_s": secs})
            continue
        history.append({"step": step, "loss": loss,
                        "live": float(np.mean(member.live)),
                        "ms": 1e3 * dt, "data_ms": 1e3 * (t1 - t0)})
        if on_metrics:
            on_metrics(step, metrics)
        if on_state:
            on_state(step, state)
        if run.log_every and step % run.log_every == 0:
            log(f"[train] step {step:5d} loss {loss:.4f} "
                f"mu {float(metrics['mu']):.2e} "
                f"live {member.live.mean():.2f}")
        step += 1
        if saver and step % run.ckpt_every == 0:
            saver.submit(step, state)
            saved = step
    if saver:
        if saved != step:
            saver.submit(step, state)
        saver.close()
        for rec in saver.records:
            notify(dict(rec, event="save"))
    return state, history


def lm_main(argv=None):
    """The JAX package's LM CLI (``repro.launch.train``), flags and
    defaults, plus ``--pods``/``--devices_per_pod`` and ``--device``."""
    ap = argparse.ArgumentParser(description="LM training (the zoo's dense, "
                                 "vlm, moe, ssm, hybrid and encdec/audio "
                                 "families) through the port's step")
    ap.add_argument("--arch", default="gemma3_1b")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--t_e", type=int, default=5)
    ap.add_argument("--method", default="dc_hier_signsgd",
                    choices=hier.ALL_METHODS)
    ap.add_argument("--transport", default="ag_packed",
                    choices=votes.SIGN_TRANSPORTS)
    ap.add_argument("--state_layout", default="tree",
                    choices=["tree", "flat"])
    ap.add_argument("--mu", type=float, default=1e-3)
    ap.add_argument("--rho", type=float, default=0.2)
    ap.add_argument("--cloud_period", type=int, default=2)
    ap.add_argument("--cloud_overlap", default="sync",
                    choices=list(schedule.CLOUD_OVERLAP_MODES))
    ap.add_argument("--clients_per_device", type=int, default=1)
    ap.add_argument("--client_mode", default="merged",
                    choices=list(vclients.CLIENT_MODES))
    ap.add_argument("--alpha_client", type=float, default=None)
    ap.add_argument("--edge_assign", default="fixed",
                    choices=list(cluster.EDGE_ASSIGN_MODES))
    ap.add_argument("--participation", default="full",
                    choices=list(vclients.PARTICIPATION_MODES))
    ap.add_argument("--participation_rate", type=float, default=1.0)
    ap.add_argument("--participation_seed", type=int, default=0)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt", default=None, metavar="DIR",
                    help="checkpoint directory: resume from its newest "
                         "intact checkpoint, save every 20 steps and at "
                         "the end (under torchrun: one every rank reads)")
    ap.add_argument("--chaos", type=int, default=None, metavar="SEED",
                    help="run under a seeded fault schedule "
                         "(runtime.chaos.FaultInjector.seeded: client/"
                         "pod kills, heartbeat loss, straggler "
                         "demotion, recoveries -- same seed, same "
                         "schedule); nan-loss recovery needs --ckpt")
    ap.add_argument("--multi_pod", action="store_true",
                    help="the production mesh (2 pods x 16 data x 16 "
                         "model): 512 ranks under torchrun")
    ap.add_argument("--pods", type=int, default=1)
    ap.add_argument("--devices_per_pod", type=int, default=1)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    try:
        vclients.validate_batch_carve(args.batch, args.clients_per_device,
                                      flag="clients_per_device")
        synthetic.validate_scenario(synthetic.LMStreamCfg(
            vocab=2, seq_len=args.seq, batch_per_device=args.batch,
            pods=1, devices_per_pod=1,
            clients_per_device=args.clients_per_device,
            alpha_client=args.alpha_client, edge_assign=args.edge_assign))
    except ValueError as e:
        ap.error(str(e))
    cfg = (configs.get_smoke(args.arch) if args.smoke
           else configs.get_config(args.arch))
    # the schedule x regime combination, up front as the JAX CLI checks it
    if args.cloud_overlap == "overlap" and cfg.param_mode == "fsdp":
        ap.error(f"--cloud_overlap=overlap requires the replicated "
                 f"regime, but --arch {args.arch} uses param_mode='fsdp' "
                 f"(the staged in-flight aggregate is a whole-model "
                 f"master snapshot the FSDP lift never materializes)")
    topo = launch_topology(args.pods, args.devices_per_pod, args.device,
                           multi_pod=args.multi_pod)
    # over a mesh every rank prints the same digits: rank 0 says them
    log = (print if topo.mesh is None or topo.mesh.rank == 0
           else (lambda *a, **kw: None))
    algo = hier.AlgoConfig(
        method=args.method, mu=args.mu, rho=args.rho,
        cloud_period=args.cloud_period, cloud_overlap=args.cloud_overlap,
        t_e=args.t_e, transport=args.transport,
        state_layout=args.state_layout,
        clients=vclients.ClientConfig(
            count=args.clients_per_device, participation=args.participation,
            rate=args.participation_rate, seed=args.participation_seed,
            mode=args.client_mode),
        compute_dtype=torch.float32 if args.smoke else torch.bfloat16)
    run = RunCfg(steps=args.steps, batch_per_device=args.batch,
                 seq_len=args.seq, ckpt_dir=args.ckpt,
                 alpha_client=args.alpha_client,
                 edge_assign=args.edge_assign)
    injector = None
    if args.chaos is not None:
        injector = chaos.FaultInjector.seeded(
            args.chaos, args.steps, topo.pods, topo.devices_per_pod,
            algo.clients.count)
        log(f"[train] chaos seed {args.chaos}: "
            f"{len(injector.events)} scheduled events")
    _, history = run_training(cfg, topo, algo, run,
                              fault_injector=injector, log=log)
    if topo.mesh is not None:
        dist.destroy_process_group()
    if not history:
        log(f"[train] done: the checkpoint in {args.ckpt} is at or past "
            f"--steps {args.steps}, no step to run")
        return
    log(f"[train] done: loss {history[0]['loss']:.4f} -> "
        f"{history[-1]['loss']:.4f}")


def launch_topology(pods: int, devices_per_pod: int, device: str,
                    multi_pod: bool = False) -> Topology:
    """The CLI's topology: P x D in this process, or under ``torchrun``
    (``WORLD_SIZE`` > 1) laid over the ranks (``mesh.host_grid``, a model
    axis of 1: the JAX CLI has no flag for the host mesh's model axis)
    after the default group is initialised from torchrun's environment.
    ``multi_pod``: the production grid of 2 pods x 16 data x 16 model
    ranks (``mesh.make_topology``, P = 2 x D = 16), which needs 512 ranks
    (``ValueError`` before any group is made otherwise).  The backend:
    NCCL when every rank of the host has a card of its own
    (``cuda:LOCAL_RANK``), else gloo (the CPU, or ranks sharing a card,
    which NCCL refuses)."""
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if multi_pod:
        shape, _ = mesh.make_production_mesh(multi_pod=True)
        if world != math.prod(shape):
            raise ValueError(
                f"--multi_pod: the production grid "
                f"{' x '.join(map(str, shape))} needs {math.prod(shape)} "
                f"ranks, torchrun gave {world}")
    if world == 1:
        return Topology(pods, devices_per_pod, device)
    local = int(os.environ.get("LOCAL_RANK", "0"))
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", str(world)))
    if torch.device(device).type == "cuda":
        resolve_device(device)
        own_card = torch.cuda.device_count() >= local_world
        device = f"cuda:{local if own_card else 0}"
        backend = "nccl" if own_card else "gloo"
    else:
        backend = "gloo"
    dist.init_process_group(backend, init_method="env://",
                            timeout=mesh.TIMEOUT)
    if multi_pod:
        return mesh.make_topology(multi_pod=True, backend=backend,
                                  device=device)
    grid = mesh.host_grid(world, pods, devices_per_pod)
    return mesh.make_host_topology(
        *grid, backend=backend, device=device,
        block=(pods // grid[0], devices_per_pod // grid[1]))


def main(argv=None):
    """``--arch NAME`` runs the LM trainer (:func:`lm_main`); without it,
    the paper task."""
    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument("--arch")
    if pre.parse_known_args(argv)[0].arch is not None:
        return lm_main(argv)
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
