"""Virtual-client configuration (the inactive default only, for now).

The counterpart of ``ClientConfig`` in the JAX package's
``core/clients.py``: the same fields and the same validation, so a
config that the JAX package accepts is accepted here.  The port's step
runs only the inactive default (one client per device, full
participation, unit weights); an active config raises
``NotImplementedError`` until ROADMAP queue 1 item 10 ports K > 1,
sampled participation and integer |D_qk| weights.
"""
from __future__ import annotations

import dataclasses

PARTICIPATION_MODES = ("full", "bernoulli", "fixed")
CLIENT_MODES = ("merged", "stream")


@dataclasses.dataclass(frozen=True)
class ClientConfig:
    """count: K clients per device; participation: full | bernoulli |
    fixed at ``rate``; seed: the sampling key; weights: integer |D_qk|
    as nested tuples [pods][devices][count] or None; mode: merged |
    stream (see the JAX package for the semantics)."""
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
        """Whether the virtual-client machinery would engage at all."""
        return (self.count > 1 or self.participation != "full"
                or self.weights is not None)


def require_inactive(cfg: ClientConfig) -> None:
    """Refuse an active config: the port's step runs the legacy path."""
    if cfg.active:
        raise NotImplementedError(
            "active virtual clients (count > 1, sampled participation or "
            "|D_qk| weights) are not ported yet: ROADMAP queue 1 item 10")
