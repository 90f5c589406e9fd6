"""Plain PyTorch versions of the port's CUDA kernels.

Each function computes exactly what its kernel computes, with the
reference arithmetic of the JAX package (``kernels/ref.py`` and the
Pallas kernel bodies): the wrappers in ``sign_pack.py``,
``vote_update.py``, ``tally_acc.py`` and ``ternary_quant.py`` run these
on CPU tensors, the CPU tests hold them
bitwise against the JAX kernels, and ``chip_smoke.py`` holds the CUDA
kernels bitwise against them on the card.  They are not yardsticks of
speed.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import signs


def f32(x: float) -> float:
    """``x`` rounded to float32, as JAX rounds a Python scalar that meets
    an f32 array (and as the kernels receive it)."""
    return float(np.float32(x))


def sign_pack_ref(u: torch.Tensor, delta: torch.Tensor | None,
                  rho: float) -> torch.Tensor:
    """u: [P, D, n] float; delta: [P, n] or None -> words [P, D, n/32]
    int32 of ``f32(u) + rho * f32(delta) >= 0`` (n % 32 == 0).

    The correction is one [P, n] buffer shared by the D voters of a pod
    (broadcast, never copied), added as a separate f32 multiply and add;
    ``rho == 0`` drops it."""
    x = u.to(torch.float32)
    if delta is not None and rho:
        x = x + f32(rho) * delta.to(torch.float32)[:, None]
    return signs.pack_signs(signs.sgn(x))


def vote_update_ref(words: torch.Tensor, v: torch.Tensor | None, mu: float,
                    weights: torch.Tensor | None = None) -> torch.Tensor:
    """words: [P, D, n/32] int32; v: [P, n] f32 or None; weights: [P, D]
    bool or integer voter weights, or None.

    Per pod the weighted popcount ``pos = sum_k w_k bit_k`` (int32) votes
    +1 when ``2 pos >= sum_k w_k`` (D without weights) and -1 otherwise;
    with weights an empty quorum votes 0.  Returns ``v - mu * vote`` (a
    new tensor, subnormals flushed to signed zeros by ``signs.descend``)
    or, with ``v=None``, the [P, n] int8 vote."""
    p, d, w = words.shape
    bits = signs.unpack_bits(words)                           # [P, D, n]
    if weights is None:
        pos = torch.sum(bits, dim=1, dtype=torch.int32)
        n_eff = d
    else:
        wt = weights.to(torch.int32)
        pos = torch.sum(bits * wt[:, :, None], dim=1, dtype=torch.int32)
        n_eff = torch.sum(wt, dim=1, keepdim=True, dtype=torch.int32)
    one = torch.ones((), dtype=torch.int8, device=words.device)
    vote = torch.where(2 * pos >= n_eff, one, -one)
    if weights is not None:
        vote = torch.where(n_eff > 0, vote, torch.zeros_like(vote))
    if v is None:
        return vote
    return signs.descend(v, f32(mu), vote)


def tally_acc_ref(u: torch.Tensor, delta: torch.Tensor | None, rho: float,
                  weights: torch.Tensor, tally: torch.Tensor) -> torch.Tensor:
    """u: [P, D, n] float pre-sign directions of ONE client; delta: [P, n]
    or None; weights: [P, D] integer vote weights; tally: [P, D, n]
    int8/int16/int32 signed tally.

    Returns a new tally ``t + w * sgn(f32(u) + rho*f32(delta))``: the sign
    as in :func:`sign_pack_ref` (product rounded before the add, 0 and
    subnormals -> +1, NaN -> -1), the product ``w * s`` and the add in
    int32, the sum narrowed back to the tally's dtype."""
    x = u.to(torch.float32)
    if delta is not None and rho:
        x = x + f32(rho) * delta.to(torch.float32)[:, None]
    s = signs.sgn(x).to(torch.int32)
    add = weights.to(torch.int32)[:, :, None] * s
    return (tally.to(torch.int32) + add).to(tally.dtype)


def ternary_quant_ref(x: torch.Tensor, u: torch.Tensor,
                      norm: torch.Tensor) -> torch.Tensor:
    """x: float32/bfloat16 holding R rows of C coordinates; u: float32
    uniforms of x's shape; norm: [R] float32, the l2 norm of each row (a
    0-dim norm is one row).  Returns, in x's dtype, ``norm[r] * sign(x)``
    where ``u < |x| / max(norm[r], 1e-30)`` and 0 elsewhere; all zeros on
    a row whose norm is <= 0.  ``sign(0) = 0`` (unlike ``signs.sgn``).
    Subnormal |x|, norms and probabilities count as 0, as in the reference
    (so with u = 0 a subnormal x quantizes to 0): the arithmetic of
    ``signs.ternary_quantize`` with the norms given."""
    rows = 1 if norm.dim() == 0 else norm.shape[0]
    q = signs.ternary_apply(x.reshape(rows, -1), u.reshape(rows, -1),
                            norm.reshape(rows, 1))
    return q.reshape(x.shape)
