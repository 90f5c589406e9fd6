"""Cloud sync schedule: WHEN a cloud aggregate is issued vs committed.

The port's copy of the JAX package's ``core/schedule.py`` (pure Python).
A round boundary splits into an *issue* phase (the cross-pod mean of the
edge models) and a *commit* phase (the edges adopt an aggregate that has
finished its flight); ``CloudSchedule.lag`` is the number of boundaries
between the two:

  * ``lag=0`` (``mode="sync"``) -- issue and commit at the same
    boundary: the paper's barrier.  No staged state.
  * ``lag=1`` (``mode="overlap"``) -- the aggregate issued at boundary t
    is committed at boundary t+1: edges run round t's local steps from
    the committed (one-round-stale) model while the mean is in flight,
    and the DC ``delta`` / SCAFFOLD and MTGC ``corr_*`` anchors refresh
    at that committed model.  The in-flight aggregate lives in the
    staged slot ``TrainState.agg_next``.

``commit`` only swaps references, so trees and ``flatbuf.FlatState``
buffers ride through unchanged.
"""
from __future__ import annotations

import dataclasses

CLOUD_OVERLAP_MODES = ("sync", "overlap")


@dataclasses.dataclass(frozen=True)
class CloudSchedule:
    """The cloud tier's issue->commit latency, in round boundaries:
    ``lag=0`` is the synchronous barrier, ``lag=1`` overlaps one round of
    local stepping with the aggregate's flight.  A zero-latency commit
    routed through the overlap machinery is the sync trajectory."""
    lag: int = 0

    def __post_init__(self):
        if self.lag not in (0, 1):
            raise ValueError(
                f"CloudSchedule lag must be 0 (sync) or 1 (overlap), "
                f"got {self.lag}")

    @classmethod
    def from_mode(cls, mode: str) -> "CloudSchedule":
        if mode not in CLOUD_OVERLAP_MODES:
            raise ValueError(
                f"unknown cloud_overlap mode {mode!r} (choose from "
                f"{', '.join(CLOUD_OVERLAP_MODES)})")
        return cls(lag=0 if mode == "sync" else 1)

    @property
    def mode(self) -> str:
        return "sync" if self.lag == 0 else "overlap"

    @property
    def staged(self) -> bool:
        """Whether a staged (in-flight) aggregate slot exists at all."""
        return self.lag > 0

    def commit(self, issued, staged):
        """One round boundary: ``(model_to_run_on, new_staged)``.

        ``issued`` is the aggregate computed at this boundary; ``staged``
        the slot holding the one issued ``lag`` boundaries ago (``None``
        when nothing is staged).  Sync commits ``issued`` and leaves the
        slot as it is; overlap commits the staged aggregate and stages
        ``issued`` in its place."""
        if self.lag == 0:
            return issued, staged
        return staged, issued
