"""Deterministic chaos engine: seeded fault schedules -> membership arrays.

The JAX package's ``runtime/chaos.py`` (numpy throughout) on the port's
``runtime.elastic.Membership``: the same seed draws the same events from
``np.random.default_rng`` in the same order, and the compiled arrays are
the same bits.

A ``ChaosSchedule`` is a set of :class:`ChaosEvent`\\ s pinned to step
indices.  :class:`FaultInjector` holds one (built explicitly, from the
legacy ``{step: (kind, pod, dev)}`` dict form, or generated from a seed
-- same seed, same schedule, property-tested) and the same schedule
drives three consumers with identical semantics:

  * the live trainer (``launch/train.py --arch NAME --chaos
    SEED``) applies the events to its
    :class:`~repro_torch.runtime.elastic.Membership` step by step (and
    simulates nan-loss -> restore-and-replay through
    ``checkpoint/store.py``);
  * :func:`compile_schedule` replays the events against a fresh copy of
    the membership and emits the per-step ``(edge_weights, dev_weights,
    mask)`` arrays -- the pure-function form used by the parity tests;
  * the ``ref_fed`` oracle consumes the SAME compiled arrays as
    per-round / per-tau masks and weights (``device_mask_steps`` /
    ``edge_weights_agg``), so chaos cells are bitwise-comparable.

Event kinds:
  ``client``     kill one virtual client (pod, dev, client)
  ``device``     kill a device slice -- all K clients of (pod, dev)
  ``pod``        kill a whole pod
  ``heartbeat``  heartbeat loss: the target goes silent and is swept
                 out by the timeout (exercises ``Membership.sweep``)
  ``straggler``  straggler escalation demotes the target to abstention
                 (``Membership.demote``; bitwise a sampled-out client)
  ``recover``    the target re-joins (live again, fresh heartbeat)
  ``nan``        simulated numeric blow-up: the trainer treats the step's
                 loss as non-finite and restores the newest checkpoint,
                 then replays (cursor-addressable batches + compiled
                 membership arrays make the replay deterministic).
                 Fires ONCE per scheduled step (otherwise replay would
                 re-trigger it forever); ignored by the compiler.

Events at step ``s`` apply BEFORE step ``s`` runs.  All schedules are
plain data: injectors with equal schedules compare equal.
"""
from __future__ import annotations

import copy
import dataclasses

import numpy as np

from repro_torch.runtime.elastic import Membership, MembershipArrays

EVENT_KINDS = ("client", "device", "pod", "heartbeat", "straggler",
               "recover", "nan")


@dataclasses.dataclass(frozen=True)
class ChaosEvent:
    step: int
    kind: str
    pod: int = 0
    dev: int | None = None
    client: int | None = None

    def __post_init__(self):
        if self.kind not in EVENT_KINDS:
            raise ValueError(f"unknown chaos event kind {self.kind!r}; "
                             f"one of {EVENT_KINDS}")


class FaultInjector:
    """A deterministic chaos schedule, addressable by step.

    ``schedule`` is an iterable of :class:`ChaosEvent`, or the legacy
    ``{step: (kind, pod, dev)}`` dict (one event per step, device
    granularity) that the pre-chaos trainer spoke.
    """

    def __init__(self, schedule):
        if isinstance(schedule, dict):
            events = [ChaosEvent(int(s), kind, pod, dev)
                      for s, (kind, pod, dev) in schedule.items()]
        else:
            events = list(schedule)
        self.events: tuple[ChaosEvent, ...] = tuple(
            sorted(events, key=lambda e: e.step))
        self._by_step: dict[int, tuple[ChaosEvent, ...]] = {}
        for ev in self.events:
            self._by_step[ev.step] = self._by_step.get(ev.step, ()) + (ev,)
        self._nan_fired: set[int] = set()

    def __eq__(self, other):
        return (isinstance(other, FaultInjector)
                and self.events == other.events)

    def __repr__(self):
        return f"FaultInjector({len(self.events)} events)"

    @property
    def horizon(self) -> int:
        """First step index past the last scheduled event."""
        return self.events[-1].step + 1 if self.events else 0

    def at(self, step: int) -> tuple[ChaosEvent, ...]:
        """All events scheduled for ``step`` (possibly empty)."""
        return self._by_step.get(step, ())

    def nan_due(self, step: int) -> bool:
        """True exactly ONCE per scheduled nan step: the first pass
        blows up, the post-restore replay of the same step does not."""
        if step in self._nan_fired:
            return False
        if any(ev.kind == "nan" for ev in self.at(step)):
            self._nan_fired.add(step)
            return True
        return False

    @classmethod
    def seeded(cls, seed: int, steps: int, pods: int, devices: int,
               clients: int = 1, *, client_rate: float = 0.08,
               pod_rate: float = 0.01, heartbeat_rate: float = 0.02,
               straggler_rate: float = 0.03, nan_rate: float = 0.0,
               recover_after: int = 3) -> "FaultInjector":
        """Generate a schedule from a seed -- a pure function of the
        arguments (``np.random.default_rng(seed)``; same seed => same
        schedule, different seeds diverge)."""
        rng = np.random.default_rng(seed)
        events: list[ChaosEvent] = []

        def target():
            return (int(rng.integers(pods)), int(rng.integers(devices)),
                    int(rng.integers(clients)))

        for s in range(steps):
            u = rng.random(5)
            if u[4] < nan_rate:
                events.append(ChaosEvent(s, "nan"))
            if u[0] < client_rate:
                p, d, c = target()
                events.append(ChaosEvent(s, "client", p, d, c))
                if s + recover_after < steps:
                    events.append(
                        ChaosEvent(s + recover_after, "recover", p, d, c))
            if u[1] < pod_rate and pods > 1:
                p = int(rng.integers(pods))
                events.append(ChaosEvent(s, "pod", p))
                if s + recover_after < steps:
                    events.append(ChaosEvent(s + recover_after, "recover", p))
            if u[2] < heartbeat_rate:
                p, d, _ = target()
                events.append(ChaosEvent(s, "heartbeat", p, d))
                if s + recover_after < steps:
                    events.append(
                        ChaosEvent(s + recover_after, "recover", p, d))
            if u[3] < straggler_rate:
                p, d, c = target()
                events.append(ChaosEvent(s, "straggler", p, d, c))
                if s + 2 * recover_after < steps:
                    events.append(ChaosEvent(s + 2 * recover_after,
                                             "recover", p, d, c))
        return cls(events)


def apply_event(member: Membership, ev: ChaosEvent, now: float = 0.0):
    """Apply one event to a live Membership (``nan`` is a trainer-level
    signal and leaves membership untouched)."""
    if ev.kind in ("client", "device", "pod"):
        member.mark_failed(ev.pod, ev.dev, ev.client)
    elif ev.kind == "straggler":
        member.demote(ev.pod, ev.dev, ev.client)
    elif ev.kind == "heartbeat":
        # the target went silent while its live peers kept beating: age
        # the target's last heartbeat past the timeout and let the
        # sweep remove it (exercises the timeout path, target-local)
        member.last_seen[member.live] = now
        member.last_seen[member._idx(ev.pod, ev.dev, ev.client)] = (
            now - member.heartbeat_timeout - 1.0)
        member.sweep(now)
    elif ev.kind == "recover":
        member.restore(ev.pod, ev.dev, ev.client, now=now)
    elif ev.kind != "nan":
        raise ValueError(ev.kind)


def apply_events(member: Membership, events, now: float = 0.0):
    for ev in events:
        apply_event(member, ev, now)


def compile_schedule(injector: FaultInjector, member: Membership,
                     steps: int) -> list[MembershipArrays]:
    """ChaosSchedule -> per-step membership arrays.

    Replays the schedule against a deep copy of ``member`` (the caller's
    state is untouched) and returns ``arrays`` with ``arrays[s]`` =
    the ``(edge_weights, dev_weights, mask)`` the step function sees at
    step ``s`` -- i.e. after every event with ``ev.step <= s``.  A pure
    function of (schedule, membership config), so the oracle-side parity
    runner and a post-restore replay read identical arrays.
    """
    m = copy.deepcopy(member)
    arrays = []
    for s in range(steps):
        apply_events(m, injector.at(s), now=float(s))
        arrays.append(m.weights())
    return arrays


def replay_membership(injector: FaultInjector, member: Membership,
                      upto: int) -> Membership:
    """Membership state as of the START of step ``upto``: a fresh
    all-live copy with every event at steps ``< upto`` re-applied.  The
    trainer calls this after a checkpoint restore so the replayed steps
    see the same membership arrays as the first pass."""
    m = member.fresh()
    for s in range(upto):
        apply_events(m, injector.at(s), now=float(s))
    return m
