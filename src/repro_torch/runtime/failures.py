"""Failure detection + recovery policy for the trainer.

The JAX package's ``runtime/failures.py``, with its ``FaultInjector``
re-export from the port's ``runtime.chaos``.

Detection signals:
  * non-finite loss (desync / data corruption / numeric blow-up),
  * step-time outliers (straggler escalation: after ``patience``
    consecutive slow steps a client is demoted to abstention via the
    membership mask; the paper's majority vote makes this loss-free),
  * injected faults (``runtime.chaos`` -- deterministic seeded
    schedules for tests / chaos engineering).

Recovery: restore the newest intact checkpoint (``checkpoint.store``)
and replay.  The token stream is cursor-addressable (batch = f(seed,
step)) and the membership arrays replay from the chaos schedule, so the
replay is deterministic (``launch/train.py::run_training``).

``may_restore()`` is a PURE query of the restore budget; the trainer
calls ``record_restore()`` only when a restore actually happens.
"""
from __future__ import annotations

import collections
import dataclasses
import math


@dataclasses.dataclass
class FailurePolicy:
    straggler_factor: float = 3.0    # x median step time
    patience: int = 3
    max_restores: int = 5
    window: int = 256                # step-time history length


class FailureDetector:
    def __init__(self, policy: FailurePolicy | None = None):
        self.policy = policy or FailurePolicy()
        # bounded deque: appends evict the oldest entry in O(1) (the
        # old list.pop(0) window was O(n) per step)
        self.step_times: collections.deque[float] = collections.deque(
            maxlen=self.policy.window)
        self.slow_counts: dict[tuple, int] = {}
        self.restores = 0

    def check_loss(self, loss: float) -> bool:
        """True -> healthy; False -> restore required."""
        return math.isfinite(loss)

    def record_step(self, dt: float):
        self.step_times.append(dt)

    def median_step(self) -> float:
        if not self.step_times:
            return 0.0
        s = sorted(self.step_times)
        return s[len(s) // 2]

    def device_slow(self, pod: int, dev: int, dt: float,
                    client: int | None = None) -> bool:
        """Per-client straggler accounting; True -> demote to abstention
        (``Membership.demote`` -- the demoted client is then
        indistinguishable from a sampled-out one)."""
        med = self.median_step()
        key = (pod, dev, client)
        if med and dt > self.policy.straggler_factor * med:
            self.slow_counts[key] = self.slow_counts.get(key, 0) + 1
        else:
            self.slow_counts[key] = 0
        return self.slow_counts[key] >= self.policy.patience

    def may_restore(self) -> bool:
        """Pure budget query: would one more restore stay within
        ``max_restores``?  Does NOT consume budget -- call
        :meth:`record_restore` when the restore actually happens."""
        return self.restores < self.policy.max_restores

    def record_restore(self):
        """Consume one unit of restore budget (an actual restore ran)."""
        self.restores += 1



# the chaos engine's injector, importable from here as in the JAX
# package (the legacy ``{step: (kind, pod, dev)}`` schedule form works)
from repro_torch.runtime.chaos import FaultInjector  # noqa: E402,F401
