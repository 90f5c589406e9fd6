"""Streamed-client tally accumulate: t <- t + w * sgn(u + rho*delta).

The wrapper of the CUDA kernel ``csrc/tally_acc.cu``, which replaces the
TPU kernel ``src/repro/kernels/tally_acc.py::tally_acc``.  One launch
folds one client's DC-corrected sign plane, weighted by each voter's
integer vote weight, into the [P, D, n] signed tally of all P*D voter
rows; the per-pod correction is read as (p, i), never broadcast.  The
kernel moves u, delta and the tally by 16-byte bulk copies: on CUDA all
three must be 16-byte aligned, with n a multiple of 128 (a whole 16-byte
run of an int8 tally; ``check_kernel_inputs``); the plain version takes
any n.

**``tally`` is updated in place**, as the TPU kernel's
``input_output_aliases`` updates it, and returned; callers that need the
old values must clone first.

CPU tensors take the plain version (``ref.tally_acc_ref``, whose result
is copied into ``tally``); CUDA tensors launch the kernel or raise --
there is no fallback.  ``tally_acc.launches`` counts kernel launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build, ref

BLOCK = 128     # coordinates: the kernel copies whole 16-byte int8 runs
DTYPES = (torch.float32, torch.bfloat16)
TALLY_DTYPES = (torch.int8, torch.int16, torch.int32)


def _check(u: torch.Tensor, delta: torch.Tensor | None,
           weights: torch.Tensor, tally: torch.Tensor) -> None:
    if u.dim() != 3 or u.dtype not in DTYPES:
        raise ValueError(f"tally_acc: u must be [P, D, n] in {DTYPES}, got "
                         f"{tuple(u.shape)} {u.dtype}")
    p, d, n = u.shape
    if tuple(tally.shape) != (p, d, n) or tally.dtype not in TALLY_DTYPES:
        raise ValueError(f"tally_acc: tally must be [P, D, n] = {(p, d, n)} "
                         f"in {TALLY_DTYPES}, got {tuple(tally.shape)} "
                         f"{tally.dtype}")
    if tuple(weights.shape) != (p, d) or (weights.is_floating_point()
                                          or weights.dtype == torch.bool):
        raise ValueError(f"tally_acc: weights must be [P, D] = {(p, d)} "
                         f"integers, got {tuple(weights.shape)} "
                         f"{weights.dtype}")
    tensors = [u, tally]
    if delta is not None:
        if tuple(delta.shape) != (p, n) or delta.dtype != u.dtype:
            raise ValueError(f"tally_acc: delta must be [P, n] = {(p, n)} "
                             f"{u.dtype}, got {tuple(delta.shape)} "
                             f"{delta.dtype}")
        tensors.append(delta)
    if any(t.device != u.device for t in tensors + [weights]):
        raise ValueError("tally_acc: inputs lie on different devices")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("tally_acc: u, delta and tally must be contiguous")


def check_kernel_inputs(u: torch.Tensor, delta: torch.Tensor | None,
                        tally: torch.Tensor) -> None:
    """What the CUDA kernel needs beyond ``_check``: n % 128 == 0 and
    16-byte aligned u, delta and tally, which it reads (and the tally
    writes back) by bulk async copies.  Raises ``ValueError``; there is no
    fallback."""
    if u.shape[-1] % BLOCK:
        raise ValueError(f"tally_acc: n={u.shape[-1]} is not a multiple of "
                         f"{BLOCK}")
    build.require_aligned("tally_acc", u=u, delta=delta, tally=tally)


def tally_acc(u: torch.Tensor, delta: torch.Tensor | None, rho: float,
              weights: torch.Tensor, tally: torch.Tensor) -> torch.Tensor:
    """u: [P, D, n] f32/bf16; delta: [P, n] of u's dtype or None;
    weights: [P, D] integer vote weights; tally: [P, D, n] int8/int16/
    int32, **updated in place** to ``tally + w * sgn(f32(u) +
    rho*f32(delta))`` and returned (on CUDA also
    ``check_kernel_inputs``).  ``rho == 0`` drops delta."""
    _check(u, delta, weights, tally)
    if not rho:
        delta = None
    if u.device.type == "cpu":
        return tally.copy_(ref.tally_acc_ref(u, delta, rho, weights, tally))
    if u.device.type != "cuda":
        raise ValueError(f"tally_acc: unsupported device {u.device}")
    check_kernel_inputs(u, delta, tally)
    p, d, n = u.shape
    w = weights.to(torch.int32).contiguous()
    lib = build.load()
    with torch.cuda.device(u.device):
        status = lib.repro_tally_acc(
            u.data_ptr(), None if delta is None else delta.data_ptr(),
            ref.f32(rho), w.data_ptr(), tally.data_ptr(),
            int(u.dtype == torch.bfloat16), tally.element_size(), p, d, n,
            torch.cuda.current_stream(u.device).cuda_stream)
    build.check(status, "tally_acc")
    tally_acc.launches += 1
    return tally


tally_acc.launches = 0
