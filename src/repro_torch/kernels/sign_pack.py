"""Fused device-side compressor: sgn(u + rho*delta) -> 1-bit pack.

The wrapper of the CUDA kernel ``csrc/sign_pack.cu``, which replaces the
TPU kernel ``src/repro/kernels/sign_pack.py::sign_pack``.  One launch
packs all P*D voter rows of the flat buffer; a block reads a tile of its
pod's correction once for the pod's D rows, so no [P, D, n] copy of it
exists.  The kernel moves u and delta by 16-byte bulk copies: on CUDA
both must be 16-byte aligned, with n a multiple of 128
(``check_kernel_inputs``); the plain version takes any n % 32 == 0.

CPU tensors take the plain version (``ref.sign_pack_ref``); CUDA tensors
launch the kernel or raise -- there is no fallback.  ``sign_pack.launches``
counts kernel launches (plain-version calls are not counted).  A fake
tensor (a dry run's, ``build.is_fake``) gets the words' shape and dtype
on either device, no launch, and a count in ``build.fake_call``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build, ref

PACK = 32
BLOCK = 128     # coordinates: the kernel copies whole 16-byte runs of words
DTYPES = (torch.float32, torch.bfloat16)


def _check(u: torch.Tensor, delta: torch.Tensor | None) -> None:
    if u.dim() != 3:
        raise ValueError(f"sign_pack: u must be [P, D, n], got "
                         f"{tuple(u.shape)}")
    if u.dtype not in DTYPES:
        raise ValueError(f"sign_pack: u dtype {u.dtype} not in {DTYPES}")
    if u.shape[-1] % PACK:
        raise ValueError(f"sign_pack: n={u.shape[-1]} is not a multiple of 32")
    if not u.is_contiguous():
        raise ValueError("sign_pack: u must be contiguous")
    if delta is None:
        return
    p, _, n = u.shape
    if tuple(delta.shape) != (p, n):
        raise ValueError(f"sign_pack: delta must be [P, n] = {(p, n)}, "
                         f"got {tuple(delta.shape)}")
    if delta.dtype != u.dtype:
        raise ValueError(f"sign_pack: delta dtype {delta.dtype} != u dtype "
                         f"{u.dtype}")
    if delta.device != u.device:
        raise ValueError("sign_pack: u and delta lie on different devices")
    if not delta.is_contiguous():
        raise ValueError("sign_pack: delta must be contiguous")


def check_kernel_inputs(u: torch.Tensor, delta: torch.Tensor | None) -> None:
    """What the CUDA kernel needs beyond ``_check``: whole 16-byte runs of
    words (n % 128 == 0) and 16-byte aligned u and delta, which it reads
    by bulk async copies.  Raises ``ValueError``; there is no fallback."""
    if u.shape[-1] % BLOCK:
        raise ValueError(f"sign_pack: n={u.shape[-1]} is not a multiple of "
                         f"{BLOCK}")
    build.require_aligned("sign_pack", u=u, delta=delta)


def sign_pack(u: torch.Tensor, delta: torch.Tensor | None = None,
              rho: float = 0.0) -> torch.Tensor:
    """u: [P, D, n] f32/bf16 (n % 32 == 0); delta: [P, n] of u's dtype or
    None (on CUDA also ``check_kernel_inputs``).  Returns the packed signs
    of ``f32(u) + rho*f32(delta)`` as [P, D, n/32] int32 words (uint32 bit
    pattern).  ``rho == 0`` drops delta."""
    _check(u, delta)
    if not rho:
        delta = None
    p, d, n = u.shape
    if build.is_fake(u):
        words = torch.empty((p, d, n // PACK), dtype=torch.int32,
                            device=u.device)
        build.fake_call("sign_pack", (u, delta), (words,))
        return words
    if u.device.type == "cpu":
        return ref.sign_pack_ref(u, delta, rho)
    if u.device.type != "cuda":
        raise ValueError(f"sign_pack: unsupported device {u.device}")
    check_kernel_inputs(u, delta)
    words = torch.empty((p, d, n // PACK), dtype=torch.int32, device=u.device)
    lib = build.load()
    fn = (lib.repro_sign_pack_f32 if u.dtype == torch.float32
          else lib.repro_sign_pack_bf16)
    with torch.cuda.device(u.device):
        status = fn(u.data_ptr(), None if delta is None else delta.data_ptr(),
                    ref.f32(rho), words.data_ptr(), p, d, n // PACK,
                    torch.cuda.current_stream(u.device).cuda_stream)
    build.check(status, "sign_pack")
    sign_pack.launches += 1
    return words


sign_pack.launches = 0
