"""Synthetic EMNIST-Digits-like classification task (paper Figs. 2-4).

Offline-deterministic replacement for the paper's datasets: a 10-class
Gaussian mixture in 784-d (class means on a scaled random simplex, shared
within-class covariance structure via random projections).  Heterogeneity
is two-level:

  * **inter-edge** (the paper's setting): for each class m a
    Dirichlet(alpha * 1_Q) probability vector splits the class's samples
    across the Q edges (alpha=0.1 -> the paper's extreme non-IID split);
  * **intra-edge** (``alpha_client``): within each edge, a second
    Dirichlet(alpha_client * 1_K) draw per class splits the edge's
    samples across its devices, so devices under one edge server carry
    genuinely distinct class skews.  ``alpha_client=None`` (default) or
    ``inf`` keeps the legacy devices-IID-within-edge split BITWISE
    (paper Sec. V-A / Remark 3).

Both splits apportion integer sample counts by the largest-remainder
method (``data.cluster.largest_remainder``) -- proportional to the
Dirichlet draw with no rounding-residue bias on the last bucket.

``edge_assign`` selects how clients map to edges: ``fixed`` keeps the
generative grouping above, ``random`` scatters clients uniformly
(seeded), and ``clustered`` regroups them by label-histogram similarity
via the deterministic balanced clustering in ``data.cluster`` -- only
histograms cross the tier boundary, never samples.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.data import cluster


@dataclasses.dataclass(frozen=True)
class FedDataCfg:
    n_classes: int = 10
    dim: int = 784
    n_train: int = 20000
    n_test: int = 4000
    q_edges: int = 4
    devices_per_edge: int = 5
    alpha: float = 0.1           # Dirichlet concentration (0.1 = paper)
    iid: bool = False
    seed: int = 0
    class_sep: float = 1.2
    noise_dim: int = 96          # intrinsic subspace dimensionality
    alpha_client: float | None = None  # intra-edge Dirichlet concentration
                                 # (per-class skew ACROSS the edge's
                                 # devices); None or inf = legacy
                                 # devices-IID split, bitwise
    edge_assign: str = "fixed"   # fixed | random | clustered (see
                                 # data.cluster); fixed = generative
                                 # grouping, bitwise legacy


def _make_task(cfg: FedDataCfg, rng: np.random.Generator):
    """Fixed class geometry (means + covariance projection) shared by every
    split -- train and test MUST come from the same mixture."""
    means = rng.normal(size=(cfg.n_classes, cfg.dim))
    means *= cfg.class_sep / np.linalg.norm(means, axis=1, keepdims=True)
    proj = (rng.normal(size=(cfg.noise_dim, cfg.dim))
            / np.sqrt(cfg.noise_dim))
    return means, proj


def _sample(cfg: FedDataCfg, means, proj, n: int,
            rng: np.random.Generator):
    y = rng.integers(0, cfg.n_classes, size=n)
    z = rng.normal(size=(n, cfg.noise_dim))
    x = means[y] + z @ proj + 0.3 * rng.normal(size=(n, cfg.dim))
    return x.astype(np.float32), y.astype(np.int32)


def make_federated_data(cfg: FedDataCfg):
    """Returns (device_data, test_set, edge_weights, device_weights).

    device_data[q][k] = {"x": ..., "y": ...} -- device k of edge q.
    edge_weights[q] = D_q / N;  device_weights[q][k] = |D_qk| / D_q.
    """
    if cfg.edge_assign not in cluster.EDGE_ASSIGN_MODES:
        raise ValueError(
            f"unknown edge_assign {cfg.edge_assign!r}; expected one of "
            f"{cluster.EDGE_ASSIGN_MODES}")
    if cfg.alpha_client is not None and cfg.alpha_client <= 0:
        raise ValueError(
            f"alpha_client must be positive (or None): {cfg.alpha_client}")
    rng = np.random.default_rng(cfg.seed)
    means, proj = _make_task(cfg, rng)
    x, y = _sample(cfg, means, proj, cfg.n_train, rng)
    xt, yt = _sample(cfg, means, proj, cfg.n_test, rng)

    # --- class -> edge assignment (paper: p_m ~ Dir(alpha 1_Q) per
    # class), apportioned by largest remainder (floor residue used to
    # land entirely on the last edge, biasing its size under small
    # alpha)
    edge_cls: list[list[np.ndarray]] = [[] for _ in range(cfg.q_edges)]
    for m in range(cfg.n_classes):
        idx = np.where(y == m)[0]
        rng.shuffle(idx)
        if cfg.iid:
            p = np.full(cfg.q_edges, 1.0 / cfg.q_edges)
        else:
            p = rng.dirichlet(np.full(cfg.q_edges, cfg.alpha))
        counts = cluster.largest_remainder(p, len(idx))
        start = 0
        for q in range(cfg.q_edges):
            edge_cls[q].append(idx[start:start + counts[q]])
            start += counts[q]

    client_iid = (cfg.alpha_client is None
                  or not np.isfinite(cfg.alpha_client))
    device_data = []
    for q in range(cfg.q_edges):
        if client_iid:
            idx = np.concatenate(edge_cls[q])
            rng.shuffle(idx)                    # devices IID within edge
            splits = np.array_split(idx, cfg.devices_per_edge)
        else:
            # intra-edge skew: per class present in the edge, a second
            # Dirichlet draw splits that class across the edge's devices
            per_dev: list[list[np.ndarray]] = [
                [] for _ in range(cfg.devices_per_edge)]
            for cls in edge_cls[q]:
                if not len(cls):
                    continue
                pk = rng.dirichlet(
                    np.full(cfg.devices_per_edge, cfg.alpha_client))
                ck = cluster.largest_remainder(pk, len(cls))
                start = 0
                for k in range(cfg.devices_per_edge):
                    per_dev[k].append(cls[start:start + ck[k]])
                    start += ck[k]
            splits = []
            for k in range(cfg.devices_per_edge):
                s = (np.concatenate(per_dev[k]) if per_dev[k]
                     else np.zeros(0, int))
                rng.shuffle(s)
                splits.append(s)
        device_data.append([{"x": x[s], "y": y[s]} for s in splits])

    if cfg.edge_assign != "fixed":
        # server-side regrouping: permute clients across edges keeping
        # devices_per_edge slots per edge.  Only label HISTOGRAMS feed
        # the clustered mode -- raw (x, y) rows stay on the client.
        flat = [d for edge in device_data for d in edge]
        if cfg.edge_assign == "random":
            assign = cluster.random_assignment(len(flat), cfg.q_edges,
                                               cfg.seed)
        else:
            sigs = cluster.label_histogram_signatures(device_data,
                                                      cfg.n_classes)
            assign = cluster.cluster_edges(sigs, cfg.q_edges)
        order = cluster.assignment_order(assign, cfg.q_edges)
        device_data = [
            [flat[i] for i in order[q * cfg.devices_per_edge:
                                    (q + 1) * cfg.devices_per_edge]]
            for q in range(cfg.q_edges)]

    edge_sizes, device_weights = [], []
    for edge in device_data:
        dq = sum(len(d["y"]) for d in edge)
        edge_sizes.append(dq)
        device_weights.append([len(d["y"]) / max(dq, 1) for d in edge])
    n = sum(edge_sizes)
    edge_weights = [s / n for s in edge_sizes]
    return device_data, {"x": xt, "y": yt}, edge_weights, device_weights


def device_batches(device_data, q, k, batch_size, rng: np.random.Generator):
    """One minibatch sampler for device (q, k) (with-replacement, paper's
    stochastic-gradient setting)."""
    d = device_data[q][k]
    n = len(d["y"])
    idx = rng.integers(0, n, size=min(batch_size, n)) if n else np.zeros(
        0, int)
    return {"x": d["x"][idx], "y": d["y"][idx]}
