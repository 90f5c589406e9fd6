"""Counter-based generator seeds: one integer per (seed, keys...) tuple.

The token stream (``data.synthetic``) and the QSGD uniforms
(``core.hier``) both seed a ``torch.Generator`` per stream from
:func:`key_seed`, so each stream can be drawn alone, in any order.
"""
from __future__ import annotations

_MASK64 = (1 << 64) - 1


def _splitmix64(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return x ^ (x >> 31)


def key_seed(seed: int, *keys: int) -> int:
    """A generator seed below 2^63 from a seed and integer keys, mixed by
    splitmix64: a counter-based key, so each stream it seeds can be drawn
    alone, in any order."""
    h = seed & _MASK64
    for key in keys:
        h = _splitmix64(h ^ (key & _MASK64))
    return h >> 1
