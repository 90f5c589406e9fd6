"""Virtual clients: K federated clients per device of the hierarchy.

The counterpart of the JAX package's ``core/clients.py``, function for
function.  Each of the D devices of an edge hosts K virtual clients
with unequal data shares |D_qk| and intermittent participation:

  * **batch carving** -- a device batch ``[P, D, b, ...]`` is carved
    into K per-client shards of b/K rows and the client dim merges into
    the voter axis: ``[P, D*K, b/K, ...]``.  Client c of device d is
    voter ``d*K + c`` and owns rows ``[c*b/K, (c+1)*b/K)``
    (:func:`carve_batch`); the streamed sweep takes the same rows one
    client at a time (:func:`client_slice`).
  * **participation** -- a per-round [P, D, K] mask, ``full``,
    ``bernoulli`` at ``rate`` or ``fixed`` (exactly
    ``max(1, round(rate*D*K))`` clients per edge), a pure function of
    ``(seed, round)`` through a splitmix32 counter hash:

        word(q, d, c) = splitmix32(index ^ splitmix32(seed ^ splitmix32(t)))

    PyTorch's CPU build has no uint32 shifts, so the words are computed
    in numpy uint32 on the host (a [P, D, K] array, once per round) and
    the mask is copied to the device; the bits are the reference's.
  * **weights** -- integer |D_qk| weigh the majority vote (a weighted
    popcount whose range is ``sum(w)``, see ``core.votes``), and the
    anchor mean reweights to the participating shares
    (:func:`participating_shares`).

``ClientConfig()`` (the default) is *inactive*: ``core.hier`` then runs
the path without virtual clients, bitwise the single-client trajectory.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.core import pytree

PARTICIPATION_MODES = ("full", "bernoulli", "fixed")
CLIENT_MODES = ("merged", "stream")


@dataclasses.dataclass(frozen=True)
class ClientConfig:
    """count: K clients per device; participation: full | bernoulli |
    fixed at ``rate``; seed: the sampling key; weights: integer |D_qk|
    as nested tuples [pods][devices][count] or None (unit weights);
    mode: ``merged`` (the client dim joins the voter axis, every
    client's gradient live at once) or ``stream`` (the step loops over
    the clients and folds each one's signs into an integer tally) --
    bitwise identical trajectories."""
    count: int = 1
    participation: str = "full"
    rate: float = 1.0
    seed: int = 0
    weights: tuple | None = None
    mode: str = "merged"

    def __post_init__(self):
        if self.count < 1:
            raise ValueError(f"clients per device must be >= 1: {self.count}")
        if self.participation not in PARTICIPATION_MODES:
            raise ValueError(f"unknown participation {self.participation!r}")
        if self.mode not in CLIENT_MODES:
            raise ValueError(f"unknown client mode {self.mode!r}")
        if not 0.0 < self.rate <= 1.0:
            raise ValueError(f"participation rate must be in (0, 1]: "
                             f"{self.rate}")
        if self.weights is not None:
            flat = [w for q in self.weights for d in q for w in d]
            if not flat or any(int(w) != w or w < 0 for w in flat):
                raise ValueError("client weights must be nonnegative "
                                 f"integers |D_qk|: {self.weights!r}")

    @property
    def active(self) -> bool:
        """Whether the virtual-client machinery engages at all."""
        return (self.count > 1 or self.participation != "full"
                or self.weights is not None)

    def weight_array(self, pods: int, devices: int) -> np.ndarray:
        """[P, D, K] int32 data shares (ones when ``weights is None``)."""
        if self.weights is None:
            return np.ones((pods, devices, self.count), np.int32)
        w = np.asarray(self.weights, np.int32)
        if w.shape != (pods, devices, self.count):
            raise ValueError(
                f"client weights shape {w.shape} != "
                f"{(pods, devices, self.count)} (pods, devices, count)")
        return w

    def weight_bound(self, pods: int, devices: int) -> int:
        """Static per-edge tally range ``max_q sum_k |D_qk|`` (picks the
        integer tally dtype, ``core.votes.tally_dtype``)."""
        return int(self.weight_array(pods, devices).sum(axis=(1, 2)).max())


def _splitmix32(x) -> np.ndarray:
    """Elementwise uint32 avalanche (the splitmix32 finalizer)."""
    x = np.asarray(x, np.uint32)
    x = (x ^ (x >> np.uint32(16))) * np.uint32(0x7FEB352D)
    x = (x ^ (x >> np.uint32(15))) * np.uint32(0x846CA68B)
    return x ^ (x >> np.uint32(16))


def _client_words(cfg: ClientConfig, pods: int, devices: int,
                  round_index: int) -> np.ndarray:
    """[P, D, K] uint32 hash words of round ``t``."""
    idx = np.arange(pods * devices * cfg.count, dtype=np.uint32).reshape(
        pods, devices, cfg.count)
    # one-element arrays, not scalars: numpy wraps uint32 arrays silently
    base = _splitmix32(np.array([cfg.seed], np.uint32)
                       ^ _splitmix32(np.array([round_index], np.uint32)))
    return _splitmix32(idx ^ base)


def participation_mask(cfg: ClientConfig, pods: int, devices: int,
                       round_index: int) -> np.ndarray:
    """[P, D, K] float32 {0,1} participation mask of global round ``t``
    (numpy, on the host): a pure function of ``(cfg.seed, t)``."""
    shape = (pods, devices, cfg.count)
    if cfg.participation == "full":
        return np.ones(shape, np.float32)
    words = _client_words(cfg, pods, devices, round_index)
    if cfg.participation == "bernoulli":
        # top 24 hash bits as a uniform in [0, 2^24): an exact threshold
        thresh = np.uint32(int(round(cfg.rate * (1 << 24))))
        return ((words >> np.uint32(8)) < thresh).astype(np.float32)
    # fixed size: the m smallest hash words of each edge vote (a stable
    # argsort, as jnp.argsort is: collisions break by client index)
    n = devices * cfg.count
    m = max(1, int(round(cfg.rate * n)))
    w = words.reshape(pods, n)
    ranks = np.argsort(np.argsort(w, axis=1, kind="stable"), axis=1,
                       kind="stable")
    return (ranks < m).astype(np.float32).reshape(shape)


def _rows(x: torch.Tensor, count: int) -> int:
    b = x.shape[2]
    if b % count:
        raise ValueError(f"per-device batch {b} does not divide into "
                         f"{count} virtual clients")
    return b // count


def carve_batch(batch: Any, count: int) -> Any:
    """[P, D, b, ...] device batches -> [P, D*K, b/K, ...]: client c of
    device d (voter ``d*K + c``) owns rows ``[c*b/K, (c+1)*b/K)``.  A
    view (no copy); ``count=1`` is the identity."""
    if count == 1:
        return batch

    def carve(x):
        p, d = x.shape[:2]
        return x.reshape((p, d * count, _rows(x, count)) + x.shape[3:])

    return pytree.tree_map(carve, batch)


def client_slice(batch: Any, count: int, c: int) -> Any:
    """Client ``c``'s [P, D, b/K, ...] shard of an uncarved batch: the
    rows voter ``d*K + c`` sees after :func:`carve_batch` (a view)."""
    if count == 1:
        return batch

    def take(x):
        rows = _rows(x, count)
        return x[:, :, c * rows:(c + 1) * rows]

    return pytree.tree_map(take, batch)


def regroup_clients(batch: Any, assignment, count: int) -> Any:
    """Apply a server-side edge assignment (``data.cluster``) to
    [P, D, b, ...] batches by permuting the per-client row blocks.

    ``assignment[s]`` is the original flat client index (voter order:
    client c of device d of pod q is ``(q*D + d)*K + c``) that occupies
    flat slot ``s`` after regrouping; None is the identity."""
    if assignment is None:
        return batch
    idx = np.asarray(assignment, int)

    def move(x):
        p, d = x.shape[:2]
        rows = _rows(x, count)
        if len(idx) != p * d * count:
            raise ValueError(f"assignment permutes {len(idx)} clients; "
                             f"batch has {p * d * count}")
        flat = x.reshape((p * d * count, rows) + x.shape[3:])
        return flat[torch.as_tensor(idx, device=x.device)].reshape(x.shape)

    return pytree.tree_map(move, batch)


def validate_batch_carve(batch_per_device: int, count: int,
                         flag: str = "clients_per_device") -> None:
    """Reject a per-device batch that K does not divide, before any
    step runs."""
    if count > 1 and batch_per_device % count:
        raise ValueError(
            f"per-device batch {batch_per_device} does not divide into "
            f"{count} virtual clients (--{flag})")


def participating_shares(dev_weights: torch.Tensor, weights: torch.Tensor,
                         maskf: torch.Tensor) -> torch.Tensor:
    """[P, D*K] aggregation shares ``w_qk m_qk / sum_j w_qj m_qj`` of the
    participating clients (zero where a whole edge abstains).

    dev_weights: [P, D] per-device factor; weights: [P, D, K] float data
    shares; maskf: [P, D, K] float {0,1} participation."""
    p, d, k = maskf.shape
    raw = (dev_weights[:, :, None] * weights * maskf).reshape(p, d * k)
    tot = torch.sum(raw, dim=1, keepdim=True)
    safe = torch.where(tot > 0, tot, torch.ones_like(tot))
    return torch.where(tot > 0, raw / safe, torch.zeros_like(raw))
