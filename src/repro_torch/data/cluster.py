"""Cluster-aware edge assignment from client data signatures (FLT-style).

The paper's bias term is *inter-cluster* drift, so WHERE a client is
attached matters as much as what correction runs: regrouping clients
into edges by data similarity attacks the same heterogeneity the DC /
SCAFFOLD / MTGC corrections cancel algorithmically.  This module is the
server-side half of that scenario axis:

  * **signatures** -- the only per-client statistic that crosses the
    device->server tier boundary: a normalized label histogram
    (classification) or an aggregate mean-embedding / unigram sketch
    (LM streams).  Raw samples, features and tokens NEVER leave the
    client (property-tested in ``tests/test_data_hetero.py``).
  * **balanced deterministic clustering** -- ``cluster_edges`` groups
    the signatures into ``n_edges`` clusters of exactly
    ``n_clients / n_edges`` members (edges have fixed fan-in: every
    physical slot must be occupied), via average-linkage agglomerative
    merging followed by a capacity-constrained greedy transport onto
    the cluster centroids.

Determinism contract (mirrors the splitmix32 participation scheme of
``core.clients``: reproducible across process restarts, partitioning
and client arrival order): the assignment is a pure function of the
signature MULTISET -- clients are canonically ordered by lexicographic
signature sort before any distance is computed, cluster labels are
fixed by each cluster's lexicographically-leading member, and every
tie breaks by canonical rank.  No RNG is consumed at all, so the same
fleet re-clustered on any server, any seed, in any client order lands
in the same edges.
"""
from __future__ import annotations

import numpy as np

EDGE_ASSIGN_MODES = ("fixed", "random", "clustered")


def largest_remainder(p, n: int) -> np.ndarray:
    """Apportion ``n`` items proportionally to ``p`` (largest-remainder
    method): ``floor(p*n)`` each, then the leftover items go to the
    largest fractional remainders (ties break by index).  Replaces the
    floor-based split ``counts[-1] = n - counts[:-1].sum()`` that dumped
    ALL rounding residue on the last bucket (under small Dirichlet
    alpha the residue is almost one item per bucket, a systematic size
    bias).  Always returns nonnegative ints summing exactly to ``n``."""
    p = np.asarray(p, np.float64)
    if p.ndim != 1 or len(p) == 0 or np.any(p < 0):
        raise ValueError(f"proportions must be a nonnegative vector: {p!r}")
    tot = p.sum()
    quota = (p / tot) * n if tot > 0 else np.full(len(p), n / len(p))
    counts = np.floor(quota).astype(int)
    rem = int(n - counts.sum())
    if rem > 0:
        frac = quota - counts
        counts[np.argsort(-frac, kind="stable")[:rem]] += 1
    return counts


def label_histogram_signatures(device_data, n_classes: int) -> np.ndarray:
    """[n_clients, C] row-normalized label histograms, edge-major
    ``(q, k)`` client order.  The histogram is the ONLY thing computed
    from the client's data -- no feature rows are touched."""
    sigs = []
    for edge in device_data:
        for d in edge:
            h = np.bincount(np.asarray(d["y"]).astype(int).ravel(),
                            minlength=n_classes).astype(np.float64)
            sigs.append(h / max(h.sum(), 1.0))
    return np.stack(sigs)


def sketch_signatures(vectors) -> np.ndarray:
    """[n_clients, F] mean-embedding / unigram sketches, L2-normalized
    per client.  Callers pass ALREADY-AGGREGATED per-client vectors (a
    mean embedding, a unigram distribution): the per-row reduction
    happens client-side, so only the F-dim aggregate crosses tiers."""
    v = np.asarray(vectors, np.float64)
    if v.ndim != 2:
        raise ValueError(f"sketches must be [n_clients, F]: {v.shape}")
    return v / np.maximum(np.linalg.norm(v, axis=1, keepdims=True), 1e-12)


def _avg_linkage(s: np.ndarray, n_edges: int) -> list[list[int]]:
    """Average-linkage agglomerative merge of the canonically-sorted
    signatures ``s`` down to ``n_edges`` clusters (squared-L2 linkage;
    ties keep the earliest pair in canonical order)."""
    d2 = np.sum((s[:, None, :] - s[None, :, :]) ** 2, axis=-1)
    clusters = [[i] for i in range(len(s))]
    while len(clusters) > n_edges:
        best = None
        for i in range(len(clusters)):
            for j in range(i + 1, len(clusters)):
                link = float(np.mean(d2[np.ix_(clusters[i], clusters[j])]))
                if best is None or link < best[0] - 1e-12:
                    best = (link, i, j)
        _, i, j = best
        clusters[i] = clusters[i] + clusters[j]
        del clusters[j]
    return clusters


def cluster_edges(signatures, n_edges: int,
                  capacity: int | None = None) -> np.ndarray:
    """Group clients into ``n_edges`` equal-size edges by signature
    similarity.  Returns ``assignment[i]`` = edge id of original client
    ``i`` with exactly ``capacity`` (= n/n_edges) members per edge.

    Deterministic and invariant to the clients' arrival order: the
    partition (and the edge LABELS, pinned to each cluster's
    lexicographically-leading signature) depends only on the signature
    multiset -- see the module docstring for the full contract."""
    sig = np.asarray(signatures, np.float64)
    n = len(sig)
    if n_edges < 1 or n % n_edges:
        raise ValueError(
            f"{n} clients do not fill {n_edges} equal edges")
    cap = n // n_edges
    if capacity is not None and capacity != cap:
        raise ValueError(
            f"capacity {capacity} != {n} clients / {n_edges} edges")
    order = np.lexsort(sig.T[::-1])        # canonical client order
    s = sig[order]
    clusters = _avg_linkage(s, n_edges)
    clusters.sort(key=min)                 # stable edge labels
    cents = np.stack([s[c].mean(axis=0) for c in clusters])
    # capacity-constrained greedy transport onto the centroids: claim
    # (client, edge) pairs by ascending distance; full edges and placed
    # clients drop out.  Ties break by (canonical rank, edge id).
    d2 = np.sum((s[:, None, :] - cents[None, :, :]) ** 2, axis=-1)
    placed = np.full(n, -1, int)
    load = np.zeros(n_edges, int)
    for _, i, e in sorted((float(d2[i, e]), i, e)
                          for i in range(n) for e in range(n_edges)):
        if placed[i] < 0 and load[e] < cap:
            placed[i] = e
            load[e] += 1
    assignment = np.empty(n, int)
    assignment[order] = placed
    return assignment


def assignment_order(assignment, n_edges: int) -> np.ndarray:
    """Flatten an assignment into slot order: ``out[q*cap + j]`` = the
    original (edge-major) client index occupying slot ``j`` of new edge
    ``q`` (members keep ascending original order within an edge).  This
    is the permutation ``core.clients.regroup_clients`` and
    ``ref_fed.regroup_client_data`` consume."""
    a = np.asarray(assignment, int)
    cap = len(a) // n_edges
    slots = [np.flatnonzero(a == q) for q in range(n_edges)]
    if any(len(s) != cap for s in slots):
        raise ValueError(
            f"assignment is not balanced to {cap} clients/edge: "
            f"{[len(s) for s in slots]}")
    return np.concatenate(slots)


def random_assignment(n_clients: int, n_edges: int,
                      seed: int = 0) -> np.ndarray:
    """Seeded uniform client->edge scatter (the 'random' baseline of the
    bias study: every edge sees an exchangeable mix, so inter-edge drift
    collapses while intra-edge heterogeneity is maximal).  Balanced to
    capacity; deterministic in ``seed`` only."""
    if n_clients % n_edges:
        raise ValueError(
            f"{n_clients} clients do not fill {n_edges} equal edges")
    rng = np.random.default_rng((seed, 0x51C))
    perm = rng.permutation(n_clients)
    assignment = np.empty(n_clients, int)
    assignment[perm] = np.arange(n_clients) // (n_clients // n_edges)
    return assignment
