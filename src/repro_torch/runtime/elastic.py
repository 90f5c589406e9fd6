"""Elastic membership on the virtual-client vocabulary.

The JAX package's ``runtime/elastic.py`` (numpy throughout), with the
port's ``ClientConfig``.  The step it feeds is ``repro_torch.core.hier``'s,
which takes the same three arrays.

The paper's aggregation rules are natively elastic, and this module turns
that into runtime policy *in the same language the compiled step already
speaks*: ``core.hier``'s train step takes ``(edge_weights [P],
dev_weights [P, D], dev_mask)`` as runtime inputs, and with an active
``ClientConfig`` the mask may be client-granular (``[P, D, K]`` -- voter
``d*K + c`` of edge ``q``).  ``Membership`` tracks liveness at exactly
that granularity and emits exactly those arrays:

  * Cloud tier: ``w = sum_q (D_q/N) v_q`` -- a lost pod's weight is
    renormalized over the survivors (``edge_weights``); ``D_q`` is the
    LIVE data under edge ``q`` (physical slice sizes x the client
    ``|D_qk|`` shares of the ``ClientConfig``).
  * Edge tier: the weighted-popcount majority vote takes the membership
    mask as one more factor on the per-round participation mask; a dead
    or demoted client simply abstains (Theorem 3's MAP argument holds
    for the reduced quorum), and an edge whose whole quorum abstains
    leaves ``v_q`` unchanged -- the empty-quorum / EF carry-forward
    contract, which the SCAFFOLD/MTGC/DC correction states follow too.
  * ``quorum`` decides whether an edge has enough live clients to
    contribute at all (a sub-quorum pod abstains wholesale).

Membership changes are value changes of fixed-shape arrays: the step's
shapes never change on churn.

Fail-open invariant: if NO pod meets quorum, the emitted arrays keep
every voter counted (all-ones mask, uniform weights) -- real deployments
alert here but must never zero the model state.

Liveness comes from heartbeats (``heartbeat``/``sweep``), direct failure
marks (``mark_failed``/``restore``) and straggler demotion (``demote``).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np

from repro_torch.core.clients import ClientConfig


class MembershipArrays(NamedTuple):
    """The train step's membership inputs (plain float32 numpy arrays;
    fixed shapes).

    ``mask`` is client-granular ``[P, D, K]`` when the ``ClientConfig``
    is active (the virtual path multiplies it into the per-round
    participation mask), and the legacy ``[P, D]`` device mask
    otherwise."""
    edge_weights: np.ndarray     # [P]    D_q / N over the LIVE data
    dev_weights: np.ndarray      # [P, D] per-slice aggregation shares
    mask: np.ndarray             # [P, D, K] (active cc) or [P, D]


@dataclasses.dataclass
class Membership:
    pods: int
    devices_per_pod: int
    clients: ClientConfig = dataclasses.field(default_factory=ClientConfig)
    data_sizes: np.ndarray | None = None      # [P, D] slice sizes
                                              # (None = equal)
    quorum: float = 0.5                       # min live-client fraction/edge
    heartbeat_timeout: float = 3.0

    def __post_init__(self):
        if self.data_sizes is None:
            self.data_sizes = np.ones((self.pods, self.devices_per_pod))
        self.data_sizes = np.asarray(self.data_sizes, np.float64)
        if self.data_sizes.shape != (self.pods, self.devices_per_pod):
            raise ValueError(
                f"data_sizes {self.data_sizes.shape} != "
                f"[pods, devices_per_pod] = "
                f"({self.pods}, {self.devices_per_pod})")
        k = self.clients.count
        shape = (self.pods, self.devices_per_pod, k)
        # per-client data sizes: physical slice size x |D_qk| share
        self.client_sizes = (
            self.data_sizes[:, :, None]
            * self.clients.weight_array(self.pods, self.devices_per_pod))
        self.live = np.ones(shape, bool)
        self.last_seen = np.zeros(shape)

    # -- liveness -----------------------------------------------------------
    def _idx(self, pod: int, dev: int | None, client: int | None):
        if dev is None:
            return np.s_[pod, :, :]
        if client is None:
            return np.s_[pod, dev, :]
        return np.s_[pod, dev, client]

    def heartbeat(self, pod: int, dev: int, now: float,
                  client: int | None = None):
        idx = self._idx(pod, dev, client)
        self.last_seen[idx] = now
        self.live[idx] = True

    def mark_failed(self, pod: int, dev: int | None = None,
                    client: int | None = None):
        """Kill a whole pod (dev=None), a device slice (client=None) or
        one virtual client."""
        self.live[self._idx(pod, dev, client)] = False

    # straggler escalation lands here: a demoted client is
    # indistinguishable from a sampled-out one (same abstention path)
    demote = mark_failed

    def restore(self, pod: int, dev: int | None = None,
                client: int | None = None, now: float | None = None):
        idx = self._idx(pod, dev, client)
        self.live[idx] = True
        if now is not None:
            self.last_seen[idx] = now

    def sweep(self, now: float):
        """Heartbeat-timeout sweep: silent clients lose their vote."""
        self.live &= (now - self.last_seen) <= self.heartbeat_timeout

    # -- weights ------------------------------------------------------------
    def pod_live(self) -> np.ndarray:
        """[P] -- a pod participates if its live-client fraction meets
        the vote quorum."""
        return self.live.mean(axis=(1, 2)) >= self.quorum

    def weights(self) -> MembershipArrays:
        """Emit the step's ``(edge_weights, dev_weights, mask)``.

        A failed client loses its vote AND its data share; a sub-quorum
        pod abstains wholesale (mask zeroed ONCE via ``pod_ok``, cloud
        weight zero).  Fail-open: if no pod meets quorum, every voter
        stays counted rather than zeroing the model state.
        """
        live = self.live.astype(np.float64)               # [P, D, K]
        pod_ok = self.pod_live().astype(np.float64)       # [P]
        if float((pod_ok * live.sum(axis=(1, 2))).sum()) == 0.0:
            live = np.ones_like(live)
            pod_ok = np.ones_like(pod_ok)
        mask3 = live * pod_ok[:, None, None]   # single pod_ok application
        sizes = self.client_sizes * mask3
        pod_sizes = sizes.sum(axis=(1, 2))
        edge_w = pod_sizes / max(pod_sizes.sum(), 1e-9)
        if self.clients.active:
            # client-granular mask; the |D_qk| shares already ride in
            # the step's vote weights / participating shares, so
            # dev_weights stays the STATIC physical-slice share (shares
            # renormalize per pod against the mask inside the step)
            dq = self.data_sizes.sum(axis=1, keepdims=True)
            dev_w = self.data_sizes / np.maximum(dq, 1e-9)
            mask = mask3
        else:
            # legacy [P, D] path: dev_weights ARE the aggregation
            # shares, renormalized over the live devices
            d_eff = sizes.sum(axis=2)                     # [P, D]
            dq = d_eff.sum(axis=1)
            dev_w = np.where(dq[:, None] > 0,
                             d_eff / np.maximum(dq[:, None], 1e-9), 0.0)
            mask = mask3[:, :, 0]
        return MembershipArrays(edge_w.astype(np.float32),
                                dev_w.astype(np.float32),
                                mask.astype(np.float32))

    # -- lifecycle ----------------------------------------------------------
    def fresh(self) -> "Membership":
        """A new all-live Membership with this one's configuration --
        the baseline for deterministic schedule replay."""
        return Membership(self.pods, self.devices_per_pod,
                          clients=self.clients,
                          data_sizes=self.data_sizes.copy(),
                          quorum=self.quorum,
                          heartbeat_timeout=self.heartbeat_timeout)
