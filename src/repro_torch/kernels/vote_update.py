"""Fused edge-side vote + model update: v <- v - mu * MajorityVote(words).

The wrapper of the CUDA kernel ``csrc/vote_update.cu``, which replaces
the TPU kernel ``src/repro/kernels/vote_update.py::vote_update``.  One
launch covers all P pods: the weighted popcount vote over each pod's D
packed voter rows, then one read-modify-write of the pod's model row.
The kernel moves words and v by 16-byte bulk copies: on CUDA both must
be 16-byte aligned, with n a multiple of 128 (``check_kernel_inputs``).
Both routes take any number of voters D >= 1: past 512 a pod the kernel
counts them group by group.

**``v`` is updated in place**, as the TPU kernel's
``input_output_aliases={1: 0}`` updates it, and returned; callers that
need the old values must clone first.  With ``v=None`` the kernel
writes the [P, n] int8 vote instead (the vote-only form).

CPU tensors take the plain version (``ref.vote_update_ref``); CUDA
tensors launch the kernel or raise -- there is no fallback.
``vote_update.launches`` counts kernel launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build, ref

PACK = 32
BLOCK_WORDS = 4        # words: the kernel copies whole 16-byte runs


def _check(words: torch.Tensor, v: torch.Tensor | None,
           weights: torch.Tensor | None) -> None:
    if words.dim() != 3 or words.dtype != torch.int32:
        raise ValueError(f"vote_update: words must be [P, D, W] int32, got "
                         f"{tuple(words.shape)} {words.dtype}")
    if not words.is_contiguous():
        raise ValueError("vote_update: words must be contiguous")
    p, d, w = words.shape
    if v is not None:
        if tuple(v.shape) != (p, w * PACK) or v.dtype != torch.float32:
            raise ValueError(f"vote_update: v must be [P, n] = "
                             f"{(p, w * PACK)} float32, got "
                             f"{tuple(v.shape)} {v.dtype}")
        if not v.is_contiguous():
            raise ValueError("vote_update: v must be contiguous")
        if v.device != words.device:
            raise ValueError("vote_update: words and v lie on different "
                             "devices")
    if weights is not None:
        if tuple(weights.shape) != (p, d):
            raise ValueError(f"vote_update: weights must be [P, D] = "
                             f"{(p, d)}, got {tuple(weights.shape)}")
        if weights.is_floating_point() or weights.is_complex():
            raise ValueError(f"vote_update: weights must be bool or "
                             f"integer, got {weights.dtype}")
        if weights.device != words.device:
            raise ValueError("vote_update: words and weights lie on "
                             "different devices")


def check_kernel_inputs(words: torch.Tensor, v: torch.Tensor | None) -> None:
    """What the CUDA kernel needs beyond ``_check``: whole 16-byte runs of
    words (n % 128 == 0), at least one voter, and 16-byte aligned words
    and v, which it reads by bulk async copies.  Raises ``ValueError``;
    there is no fallback."""
    _, d, w = words.shape
    if w % BLOCK_WORDS:
        raise ValueError(f"vote_update: n={w * PACK} is not a multiple of "
                         f"{BLOCK_WORDS * PACK}")
    if d < 1:
        raise ValueError(f"vote_update: D={d} voters, want at least 1")
    build.require_aligned("vote_update", words=words, v=v)


def vote_update(words: torch.Tensor, v: torch.Tensor | None, mu: float,
                weights: torch.Tensor | None = None) -> torch.Tensor:
    """words: [P, D, n/32] int32; v: [P, n] float32 (updated in place) or
    None; weights: [P, D] bool/integer voter weights or None.

    Returns ``v`` after ``v <- v - mu * vote`` (``signs.descend``: a
    subnormal result is a zero of its sign, as in the reference), or the
    [P, n] int8 vote when ``v`` is None.  Ties vote +1; with weights an
    empty quorum votes 0, which leaves its row of v unchanged but for
    subnormal coordinates."""
    _check(words, v, weights)
    if words.device.type == "cpu":
        out = ref.vote_update_ref(words, v, mu, weights)
        return out if v is None else v.copy_(out)
    if words.device.type != "cuda":
        raise ValueError(f"vote_update: unsupported device {words.device}")
    check_kernel_inputs(words, v)
    p, d, w = words.shape
    wt, as_bool = None, False
    if weights is not None:
        as_bool = weights.dtype == torch.bool     # read as bytes, no cast
        wt = (weights if as_bool else weights.to(torch.int32)).contiguous()
    out = v
    if v is None:
        out = torch.empty((p, w * PACK), dtype=torch.int8,
                          device=words.device)
    lib = build.load()
    with torch.cuda.device(words.device):
        status = lib.repro_vote_update(
            words.data_ptr(), None if wt is None else wt.data_ptr(),
            int(as_bool), None if v is None else v.data_ptr(),
            out.data_ptr() if v is None else None,
            ref.f32(mu), p, d, w,
            torch.cuda.current_stream(words.device).cuda_stream)
    build.check(status, "vote_update")
    vote_update.launches += 1
    return out


vote_update.launches = 0
