"""The fused transport's local compute on a flat buffer (kernel route).

The counterparts of the JAX package's ``kernels/ops.py:172-331``.  On one
card the P (edge) and D (device) tiers are the leading dims of one
``[P, D, n_pad]`` buffer from ``core.flatbuf`` (``n_pad % 4096 == 0``),
so each function is at most two launches, whatever P is:

  * :func:`fused_pack_flat` -- ONE ``sign_pack`` over all P*D voter rows;
  * :func:`fused_vote_update_words` -- ONE ``vote_update`` over all pods
    (the TPU version loops one call per pod);
  * :func:`fused_sign_vote_flat` -- the two, vote-only ([P, n] int8);
  * :func:`fused_vote_update_flat` -- the two, updating ``v`` in place;
  * :func:`fused_tally_acc_flat` -- ONE ``tally_acc`` over all P*D rows,
    the streamed client sweep's per-client fold into the tally;

and the two entry points of the ``ternary_quant`` kernel:
:func:`ternary_quant_rows` (R rows, each with its own norm: one launch
per gradient leaf of the QSGD step, or one per run of rows under 2^31
coordinates) and :func:`ternary_quant_nd` (any shape as one row).

Padding contract: coordinates between leaves and at the buffer tail are
zero floats, so they pack to +1 bits and are updated like any other
coordinate; no view ever reads them back.

On CPU tensors the kernels' plain versions run (see the wrappers); on
CUDA tensors the kernels launch.
"""
from __future__ import annotations

import torch

import math

from repro_torch.core import signs
from repro_torch.kernels import build
from repro_torch.kernels import ternary_quant as ternary_quant_module
from repro_torch.kernels.sign_pack import sign_pack
from repro_torch.kernels.tally_acc import tally_acc
from repro_torch.kernels.ternary_quant import ternary_quant
from repro_torch.kernels.vote_update import vote_update

TILE = 4096


def _check_buf(u_buf: torch.Tensor) -> None:
    if u_buf.dim() != 3 or u_buf.shape[-1] % TILE:
        raise ValueError(f"flat buffers are [P, D, n_pad] with n_pad % "
                         f"{TILE} == 0, got {tuple(u_buf.shape)}")


def fused_pack_flat(u_buf: torch.Tensor, d_buf: torch.Tensor | None,
                    rho: float) -> torch.Tensor:
    """Device-side half: [P, D, n_pad] float (+ [P, n_pad] correction,
    cast to u's dtype) -> the 1-bit payload [P, D, n_pad/32] int32.

    The caller folds the correction here only for all-f32 trees: the
    kernel adds ``rho * delta`` in f32."""
    _check_buf(u_buf)
    d2 = None
    if d_buf is not None and rho:
        d2 = d_buf.to(u_buf.dtype).contiguous()
    return sign_pack(u_buf.contiguous(), d2, rho)


def fused_vote_update_words(words: torch.Tensor, v_buf: torch.Tensor | None,
                            mask: torch.Tensor | None,
                            mu: float) -> torch.Tensor:
    """Edge-side half: [P, D, n_words] voter words -> vote (+ update).

    v_buf: [P, n_pad] f32 master buffer, **updated in place** and
    returned, or None for the [P, n_pad] int8 vote; mask: [P, D] voter
    mask, integer vote weights (empty quorum abstains) or None."""
    return vote_update(words, v_buf, mu, mask)


def fused_sign_vote_flat(u_buf: torch.Tensor, d_buf: torch.Tensor | None,
                         rho: float,
                         mask: torch.Tensor | None) -> torch.Tensor:
    """Kernel route of the fused transport, vote only: [P, n_pad] int8."""
    words = fused_pack_flat(u_buf, d_buf, rho)
    return fused_vote_update_words(words, None, mask, 0.0)


def fused_vote_update_flat(u_buf: torch.Tensor, d_buf: torch.Tensor | None,
                           rho: float, mask: torch.Tensor | None,
                           v_buf: torch.Tensor, mu: float) -> torch.Tensor:
    """Flat-state fused local step: ``v <- v - mu * vote`` in place.

    One ``sign_pack`` sweep over all P*D rows, then one ``vote_update``
    read-modify-write of the [P, n_pad] master buffer: the vote never
    reaches device memory."""
    p, _, n = u_buf.shape
    if tuple(v_buf.shape) != (p, n):
        raise ValueError(f"v_buf must be [P, n_pad] = {(p, n)}, got "
                         f"{tuple(v_buf.shape)}")
    words = fused_pack_flat(u_buf, d_buf, rho)
    return fused_vote_update_words(words, v_buf, mask, mu)


def fused_tally_acc_flat(u_buf: torch.Tensor, d_buf: torch.Tensor | None,
                         rho: float, weights: torch.Tensor,
                         tally: torch.Tensor) -> torch.Tensor:
    """Streamed-client local step: fold ONE client's signs into the tally.

    u_buf: [P, D, n_pad] float pre-sign directions of the current client
    (the device axis D, not the merged D*K); d_buf: [P, n_pad] correction
    or None (cast to u's dtype; the same fold rule as
    :func:`fused_pack_flat`); weights: [P, D] integer vote weights of
    this client; tally: [P, D, n_pad] signed tally, **updated in place**
    and returned."""
    _check_buf(u_buf)
    d2 = None
    if d_buf is not None and rho:
        d2 = d_buf.to(u_buf.dtype).contiguous()
    return tally_acc(u_buf.contiguous(), d2, rho, weights, tally)


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous and starting on a 16-byte boundary (copied if
    not): the kernel reads it as 16-byte vectors."""
    t = t.contiguous()
    if build.is_fake(t):       # a dry run's: no address, taken as aligned
        return t
    return t.clone() if t.data_ptr() % build.ALIGN else t


def ternary_quant_nd(x: torch.Tensor,
                     generator: torch.Generator) -> torch.Tensor:
    """Any-shape unbiased ternary quantization (the QSGD baseline's
    compressor): ``||x||_2 * sign(x_i)`` with probability
    ``|x_i| / ||x||_2``, else 0, in x's dtype.

    The norm is one PyTorch reduction in float32, kept on the device;
    the uniforms come from ``generator`` (on x's device), so a seeded
    generator repeats the draw.  The reference draws them from
    ``jax.random``, which no torch generator reproduces: tests hand both
    sides the same uniforms at the kernel (``kernels.ternary_quant``).

    A flat view that does not start on a 16-byte boundary (a slice of a
    larger buffer) is copied first, as ``.contiguous()`` copies a strided
    one: the kernel reads x as 16-byte vectors."""
    flat = _aligned(x.reshape(-1))
    norm = torch.linalg.vector_norm(flat.to(torch.float32))
    u = torch.rand(flat.shape, generator=generator, dtype=torch.float32,
                   device=x.device)
    return ternary_quant(flat, u, norm).reshape(x.shape)


def rows_per_launch(cols: int) -> int:
    """How many rows of ``cols`` coordinates one ``ternary_quant`` launch
    of :func:`ternary_quant_rows` takes: as many as stay within the
    kernel's ``MAX_NUMEL``, rounded down so that every run of rows starts
    on a 16-byte boundary of the float32 buffers (a multiple of
    ``4 / gcd(cols, 4)`` rows)."""
    step = 4 // math.gcd(cols, 4)
    rows = ternary_quant_module.MAX_NUMEL // max(cols, 1)
    rows -= rows % step
    if rows < 1:
        raise ValueError(
            f"ternary_quant_rows: a row of {cols} coordinates does not fit "
            f"one launch on 16-byte boundaries (at most "
            f"{ternary_quant_module.MAX_NUMEL} coordinates a launch)")
    return rows


def ternary_quant_rows(x: torch.Tensor, u: torch.Tensor,
                       norms: torch.Tensor | None = None) -> torch.Tensor:
    """Row-wise unbiased ternary quantization (the QSGD step's
    compressor): x [R, C] float, u [R, C] float32 uniforms -> [R, C]
    float32, row r quantized with its own l2 norm.  One ``ternary_quant``
    launch on CUDA, the plain version on the CPU; bitwise
    ``signs.ternary_quantize(x, u, rows=R)`` either way.

    The norms come from ``signs.row_norms``, a reduction in one fixed
    order, so a row's norm -- and its quantization -- does not depend on
    how many rows the call holds (merged voters or one streamed client).
    So rows that hold ``MAX_NUMEL`` coordinates or more are split into
    runs of :func:`rows_per_launch` whole rows, one launch (and one cast
    to float32 and one norm pass) a run, each writing its rows of the
    output: bitwise the one call (``tests/test_torch_kernels.py``).

    ``norms`` [R] float32, when given, are the rows' norms and none is
    computed here: a row that is one model rank's block of a leaf takes
    the norm of the whole leaf's row (``core.hier``'s tensor-parallel
    QSGD)."""
    rows, cols = x.shape
    out = torch.empty((rows, cols), dtype=torch.float32, device=x.device)
    per = rows_per_launch(cols)
    for r0 in range(0, rows, per):
        xf = _aligned(x[r0:r0 + per].to(torch.float32))
        norm = (signs.row_norms(xf) if norms is None
                else norms[r0:r0 + per].contiguous())
        ternary_quant(xf, _aligned(u[r0:r0 + per]), norm,
                      out=out[r0:r0 + per])
    return out
