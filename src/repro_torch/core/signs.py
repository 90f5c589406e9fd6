"""Sign-compression primitives (plain PyTorch).

The coordinate-wise building blocks of HierSignSGD / DC-HierSignSGD,
bit for bit the functions of the JAX package's ``core/signs.py``:

  * ``sgn``           -- the paper's element-wise sign into {-1, +1}.
  * ``descend``       -- the update ``v - mu * vote``, flushed like XLA.
  * ``pack_signs``    -- 1 bit/coordinate wire format, 32 signs a word.
  * ``unpack_signs``  -- inverse of ``pack_signs``.
  * ``majority_vote`` -- s_q = sgn(sum_k w_k sgn(g_k)), optional weights.
  * ``majority_vote_packed`` -- the same vote from packed words.
  * ``ternary_quantize`` -- the Hier-Local-QSGD compressor, uniforms given.
  * ``row_sums`` / ``row_norms`` -- per-row reductions in one fixed order.
  * ``uplink_bits``   -- Table II wire cost.

Conventions
-----------
``sgn(0) = +1`` (``torch.sign(0)`` is 0, so it is not used), ``-0.0``
and negative subnormals map to +1 (the reference flushes subnormals) and
NaN to -1.  Vote ties resolve to +1.  Weights are {0,1}
masks or nonnegative integer data shares; an edge whose whole quorum
has weight 0 votes 0.

Wire words are carried as **int32 with the uint32 bit pattern**: bit j
of word w is the sign of coordinate 32w + j (set = +1), and the padding
bits of a ragged tail are 1.  PyTorch's uint32 has no shifts or sums on
the CPU; ``np.uint32`` words compare through ``.view(np.int32)``.
"""
from __future__ import annotations

import torch

PACK_WIDTH = 32  # sign bits per word


def nonneg(x: torch.Tensor) -> torch.Tensor:
    """``x >= 0`` as the reference evaluates it: a float compare that
    treats subnormals as zero (the JAX package runs on XLA's CPU backend,
    which flushes subnormals, and on the TPU, which has none), so a
    negative subnormal counts as 0 -> +1.  NaN is never >= 0."""
    if x.dtype.is_floating_point:
        return x > -torch.finfo(x.dtype).tiny
    return x >= 0


def ftz(x: torch.Tensor) -> torch.Tensor:
    """Subnormal floats -> the zero of their sign (``-1e-40 -> -0.0``),
    others (NaN and infinities included) unchanged: how XLA's CPU backend
    (and the TPU) treat a subnormal operand or result of the reference's
    arithmetic.  Two elementwise passes: ``hardshrink`` zeroes every |x|
    up to the largest subnormal (as +0.0), ``copysign`` gives the zeros
    back the sign of x and leaves every other value as it was."""
    fin = torch.finfo(x.dtype)
    largest_subnormal = fin.tiny * (1.0 - fin.eps)      # exact in x's dtype
    return torch.copysign(
        torch.nn.functional.hardshrink(x, largest_subnormal), x)


def ftz_(x: torch.Tensor) -> torch.Tensor:
    """:func:`ftz` in place, for a tensor the caller owns: ``x * (|x| >=
    tiny)`` gives a subnormal the zero of its sign and leaves every other
    value (NaN and infinities included) as it is, without ``ftz``'s two
    full-size temporaries."""
    return x.mul_(x.abs() >= torch.finfo(x.dtype).tiny)


def descend(v: torch.Tensor, mu, vote: torch.Tensor) -> torch.Tensor:
    """The sign-method update ``v - mu * vote`` (``vote`` in {-1, 0, +1})
    as the reference computes it: subnormal operands count as zeros of
    their sign and a subnormal result flushes to one, so an abstaining
    edge's (vote 0) subnormal coordinates become signed zeros.  Every
    sign-method update of the port goes through here or through the
    ``vote_update`` kernel, which does the same.

    ``mu`` is a float, flushed here, or a 0-dim tensor the caller has
    flushed with ``ftz`` (the train step flushes its step size once, not
    once per leaf).  ``mu * vote`` is exact, so ``addcmul`` (one pass, in
    v's dtype, also where it fuses the multiply and add) gives the
    reference's separate multiply and subtract bit for bit: five
    elementwise passes in all, two more than the unflushed update."""
    if not isinstance(mu, torch.Tensor):
        mu = ftz(torch.tensor(mu, dtype=torch.float32)).to(v.device)
    return ftz(torch.addcmul(ftz(v), mu, vote, value=-1))


def descend_mean(v: torch.Tensor, mu: torch.Tensor,
                 direction: torch.Tensor) -> torch.Tensor:
    """The mean methods' update ``v - mu * direction`` (a float direction
    in any dtype, cast to v's) as the eager reference computes it: the
    multiply and the subtract as two separate roundings (never one fused
    multiply-add, which a one-pass ``addcmul`` may compile to), subnormal
    operands counted as zeros of their sign and subnormal results flushed
    -- XLA's CPU backend does both (``v = 1e-40`` with ``direction = 0``
    gives 0.0 there).  ``mu`` is a flushed 0-dim tensor, as for
    :func:`descend`."""
    step = ftz(mu * ftz(direction.to(v.dtype)))
    return ftz(ftz(v) - step)


def row_sums(x: torch.Tensor) -> torch.Tensor:
    """[R, C] -> [R]: each row summed in one fixed order, whatever R is.

    The row is padded with zeros to a power of two W and halved until one
    column is left (``x[:, :W/2] + x[:, W/2:]``, log2 W elementwise
    adds).  ``torch.sum`` may reduce a row in an order that depends on
    how many rows the call holds (the CUDA reduction splits rows over
    blocks when they are few), so the merged voter axis (R = P*D*K rows)
    and the streamed sweep (R = P*D a client) could differ in a last bit;
    elementwise adds cannot.  The padding is never formed: the first
    halving adds the columns the upper half has and adds 0.0 to the rest,
    the padded arithmetic bit for bit (``-0.0 + 0.0`` is ``+0.0``)
    without the padded copy; every later halving is one add."""
    cols = x.shape[1]
    if cols == 0:
        return torch.zeros(x.shape[0], dtype=x.dtype, device=x.device)
    width = 1 << (cols - 1).bit_length()
    if width > cols:
        width //= 2                        # width < cols < 2 * width
        out = torch.empty((x.shape[0], width), dtype=x.dtype,
                          device=x.device)
        torch.add(x[:, :cols - width], x[:, width:], out=out[:, :cols - width])
        torch.add(x[:, cols - width:width], 0.0, out=out[:, cols - width:])
        x = out
    while width > 1:
        width //= 2
        x = x[:, :width] + x[:, width:]
    return x[:, 0]


def row_norms(x: torch.Tensor) -> torch.Tensor:
    """[R, C] -> [R] float32 l2 norms, in :func:`row_sums`' fixed order.
    Squares that are subnormal count as 0 (XLA's CPU flush: the norm of a
    row of 1e-20s is 0 in the reference)."""
    xf = x.to(torch.float32)
    return torch.sqrt(row_sums(ftz_(xf * xf)))


def ternary_apply(x: torch.Tensor, u: torch.Tensor,
                  norm: torch.Tensor) -> torch.Tensor:
    """The quantizer's elementwise arithmetic given the norms: ``norm *
    sign(x)`` where ``u < |x| / max(norm, 1e-30)``, else 0, and 0 where
    ``norm <= 0``, in x's dtype; ``norm`` broadcasts against x.  A
    subnormal |x|, norm or probability counts as 0 (XLA's CPU flush).
    ``sign(0) = 0`` here (``torch.sign``, as ``jnp.sign``)."""
    xf = x.to(torch.float32)
    nrm = ftz(norm.to(torch.float32))
    p = ftz(ftz(xf.abs()) / torch.clamp_min(nrm, 1e-30))
    q = torch.where(u < p, nrm * torch.sign(xf), torch.zeros_like(xf))
    return torch.where(nrm > 0, q, torch.zeros_like(q)).to(x.dtype)


def ternary_quantize(x: torch.Tensor, u: torch.Tensor,
                     rows: int = 1) -> torch.Tensor:
    """The unbiased stochastic ternary quantizer of the reference's
    ``signs.ternary_quantize`` (paper Sec. V-B), with its uniforms ``u``
    given (the reference draws them from a ``jax.random`` key):
    ``Q(x)_i = ||x||_2 sign(x_i)`` with probability ``|x_i| / ||x||_2``,
    else 0; ``Q(0) = 0``.  ``rows`` splits x into that many rows of equal
    length, each quantized with its own norm (one row per voter of a
    gradient leaf).  The norms come from :func:`row_norms`; the
    ``ternary_quant`` kernel computes the rest."""
    x2 = x.reshape(rows, -1)
    q = ternary_apply(x2, u.reshape(rows, -1), row_norms(x2)[:, None])
    return q.reshape(x.shape)


def sgn(x: torch.Tensor) -> torch.Tensor:
    """Element-wise sign into {-1, +1} (int8); sgn(0) = +1."""
    one = torch.ones((), dtype=torch.int8, device=x.device)
    return torch.where(nonneg(x), one, -one)


def packed_size(n: int) -> int:
    """Number of 32-bit words used to carry ``n`` sign bits."""
    return (n + PACK_WIDTH - 1) // PACK_WIDTH


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """(..., 32*w) bool -> (..., w) int32; bit j of word w = bits[32w+j].

    The 32 distinct powers of two sum in int32 without a carry (bit 31
    is ``1 << 31`` = -2^31), so the sum is the word's bit pattern."""
    b = bits.to(torch.int32).reshape(bits.shape[:-1] + (-1, PACK_WIDTH))
    shifts = torch.arange(PACK_WIDTH, dtype=torch.int32, device=bits.device)
    return torch.sum(b << shifts, dim=-1, dtype=torch.int32)


def unpack_bits(words: torch.Tensor) -> torch.Tensor:
    """(..., w) int32 -> (..., 32*w) int32 bits in {0, 1}."""
    shifts = torch.arange(PACK_WIDTH, dtype=torch.int32, device=words.device)
    bits = (words[..., None] >> shifts) & 1
    return bits.reshape(words.shape[:-1] + (-1,))


def pack_signs(signs: torch.Tensor) -> torch.Tensor:
    """(..., n) int8 {-1, +1} -> (..., ceil(n/32)) int32 words.

    Positive sign -> bit 1; padding bits are 1 (+1 sign)."""
    pad = (-signs.shape[-1]) % PACK_WIDTH
    bits = signs > 0
    if pad:
        bits = torch.cat([bits, bits.new_ones(bits.shape[:-1] + (pad,))], -1)
    return pack_bits(bits)


def unpack_signs(words: torch.Tensor, n: int) -> torch.Tensor:
    """Inverse of :func:`pack_signs`; returns (..., n) int8 in {-1, +1}."""
    bits = unpack_bits(words)[..., :n]
    return (2 * bits - 1).to(torch.int8)


def majority_vote(signs: torch.Tensor, mask: torch.Tensor | None = None,
                  axis: int = 0) -> torch.Tensor:
    """Edge vote ``s = sgn(sum_k w_k sgn_k)`` over ``axis``.

    mask: optional per-voter weights broadcastable to ``signs`` ({0,1}
    or nonnegative integer shares; a [K] vector broadcasts over the
    leaf).  Ties -> +1; an empty quorum (all weights 0) votes 0."""
    tally = signs.to(torch.int32)
    if mask is None:
        return sgn(torch.sum(tally, dim=axis))
    m = torch.as_tensor(mask, device=signs.device)
    if m.dim() < tally.dim():
        m = m.reshape(m.shape + (1,) * (tally.dim() - m.dim()))
    m = m.to(torch.int32)
    vote = sgn(torch.sum(tally * m, dim=axis))
    n_eff = torch.sum(m, dim=axis)
    return torch.where(n_eff > 0, vote, torch.zeros_like(vote))


def majority_vote_packed(words: torch.Tensor, n: int,
                         mask: torch.Tensor | None = None) -> torch.Tensor:
    """Majority vote from packed per-voter words.

    words: (K, ceil(n/32)) int32, one packed sign row per voter; mask:
    optional (K,) {0,1} mask or integer weights.  Returns (n,) int8,
    equal to ``majority_vote(unpack_signs(words, n), mask, axis=0)``."""
    bits = unpack_bits(words)[:, :n]                          # (K, n)
    if mask is not None:
        m = torch.as_tensor(mask, device=words.device).to(torch.int32)
        pos = torch.sum(bits * m.reshape(-1, 1), dim=0, dtype=torch.int32)
        k_eff = torch.sum(m)
    else:
        pos = torch.sum(bits, dim=0, dtype=torch.int32)
        k_eff = words.shape[0]
    one = torch.ones((), dtype=torch.int8, device=words.device)
    vote = torch.where(2 * pos >= k_eff, one, -one)
    if mask is not None:
        vote = torch.where(k_eff > 0, vote, torch.zeros_like(vote))
    return vote


def uplink_bits(method: str, d: int, t_e: int, clients: int = 1,
                participation_rate: float = 1.0) -> int | float:
    """Device->edge uplink bits per device per global round (Table II).

    With K virtual clients per slice the expectation is
    ``clients * participation_rate * base``; the single-client call
    returns the exact integer Table II entry."""
    if method == "hier_sgd":
        base = 32 * t_e * d
    elif method == "hier_local_qsgd":        # sign+support bits + scale
        base = t_e * (2 * d + 32)
    elif method == "hier_signsgd":
        base = t_e * d
    elif method == "dc_hier_signsgd":        # + one full-precision anchor
        base = t_e * d + 32 * d
    elif method in ("scaffold_hier_signsgd", "mtgc_hier_signsgd"):
        base = t_e * d + 32 * d
    else:
        raise ValueError(f"unknown method {method!r}")
    if clients == 1 and participation_rate >= 1.0:
        return base
    return clients * participation_rate * base
