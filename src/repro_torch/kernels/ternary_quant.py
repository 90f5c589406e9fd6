"""Stochastic ternary quantizer: norm * sign(x) with probability |x|/norm.

The wrapper of the CUDA kernel ``csrc/ternary_quant.cu``, which replaces
the TPU kernel ``src/repro/kernels/ternary_quant.py::ternary_quant``:
the unbiased compressor of the Hier-Local-QSGD baseline, given the
uniforms ``u`` and the l2 norms of x's rows (device tensors, so nothing
waits for them).  x holds R rows of C coordinates and row r is scaled by
``norm[r]``; a 0-dim norm is one row.  The QSGD step
(``core.hier``, through ``ops.ternary_quant_rows``) makes one launch per
gradient leaf; ``ops.ternary_quant_nd`` quantizes any tensor as one row.
The kernel reads x and u as 16-byte vectors: on CUDA both must be
16-byte aligned (``check_kernel_inputs``); any R and C are taken, up to
``MAX_NUMEL`` coordinates a launch (``ops.ternary_quant_rows`` splits
more rows over several launches).

CPU tensors take the plain version (``ref.ternary_quant_ref``); CUDA
tensors launch the kernel or raise -- there is no fallback.
``ternary_quant.launches`` counts kernel launches.  Fake tensors (a dry
run's, ``build.is_fake``) get ``out``, or a new tensor of x's shape and
dtype, on either device, with no launch and a count in
``build.fake_call``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build, ref

DTYPES = (torch.float32, torch.bfloat16)
# coordinates one launch takes: the kernel indexes them in 32 bits;
# ops.ternary_quant_rows splits larger calls by rows, each row whole
MAX_NUMEL = (1 << 31) - 1


def _check(x: torch.Tensor, u: torch.Tensor, norm: torch.Tensor) -> int:
    """The input checks of both routes; returns the row count R."""
    if x.dtype not in DTYPES:
        raise ValueError(f"ternary_quant: x dtype {x.dtype} not in {DTYPES}")
    if u.shape != x.shape or u.dtype != torch.float32:
        raise ValueError(f"ternary_quant: u must be float32 of x's shape "
                         f"{tuple(x.shape)}, got {tuple(u.shape)} {u.dtype}")
    if norm.dim() > 1 or norm.dtype != torch.float32:
        raise ValueError(f"ternary_quant: norm must be a 0-dim or [R] "
                         f"float32 tensor, got {tuple(norm.shape)} "
                         f"{norm.dtype}")
    rows = 1 if norm.dim() == 0 else norm.shape[0]
    if rows < 1 or x.numel() % rows:
        raise ValueError(f"ternary_quant: {rows} norms do not split x's "
                         f"{x.numel()} coordinates into equal rows")
    if u.device != x.device or norm.device != x.device:
        raise ValueError("ternary_quant: inputs lie on different devices")
    if not (x.is_contiguous() and u.is_contiguous() and
            norm.is_contiguous()):
        raise ValueError("ternary_quant: x, u and norm must be contiguous")
    return rows


def check_kernel_inputs(x: torch.Tensor, u: torch.Tensor) -> None:
    """What the CUDA kernel needs beyond ``_check``: 16-byte aligned x
    and u, which it reads as 16-byte vectors, and fewer than 2^31
    coordinates.  Raises ``ValueError``; there is no fallback."""
    build.require_aligned("ternary_quant", x=x, u=u)
    if x.numel() > MAX_NUMEL:
        raise ValueError(f"ternary_quant: {x.numel()} coordinates, one "
                         f"launch takes at most {MAX_NUMEL}: split the rows "
                         f"over launches (ops.ternary_quant_rows does)")


def ternary_quant(x: torch.Tensor, u: torch.Tensor,
                  norm: torch.Tensor,
                  out: torch.Tensor | None = None) -> torch.Tensor:
    """x: float32/bfloat16 (any shape) of R rows of C contiguous
    coordinates; u: float32 uniforms of x's shape; norm: [R] float32, the
    l2 norm of each row (a 0-dim norm is R = 1).  Returns a tensor of
    x's dtype: ``norm[r] * sign(x)`` where ``u < |x| / max(norm[r],
    1e-30)``, else 0, and all zeros on a row whose norm is <= 0 -- new,
    or ``out`` (contiguous, x's shape and dtype; 16-byte aligned on CUDA)
    written and returned.  On CUDA also ``check_kernel_inputs``."""
    rows = _check(x, u, norm)
    if out is not None and (out.shape != x.shape or out.dtype != x.dtype
                            or out.device != x.device
                            or not out.is_contiguous()):
        raise ValueError(f"ternary_quant: out must be a contiguous "
                         f"{tuple(x.shape)} {x.dtype} tensor on {x.device}")
    if build.is_fake(x):
        out = torch.empty_like(x) if out is None else out
        build.fake_call("ternary_quant", (x, u, norm), (out,))
        return out
    if x.device.type == "cpu":
        q = ref.ternary_quant_ref(x, u, norm)
        return q if out is None else out.copy_(q)
    if x.device.type != "cuda":
        raise ValueError(f"ternary_quant: unsupported device {x.device}")
    check_kernel_inputs(x, u)
    if out is None:
        out = torch.empty_like(x)
    build.require_aligned("ternary_quant", out=out)
    lib = build.load()
    with torch.cuda.device(x.device):
        status = lib.repro_ternary_quant(
            x.data_ptr(), u.data_ptr(), norm.data_ptr(), out.data_ptr(),
            int(x.dtype == torch.bfloat16), rows, x.numel() // rows,
            torch.cuda.current_stream(x.device).cuda_stream)
    build.check(status, "ternary_quant")
    ternary_quant.launches += 1
    return out


ternary_quant.launches = 0
