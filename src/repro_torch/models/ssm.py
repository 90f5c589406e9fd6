"""Recurrent blocks of the xLSTM family: mLSTM and sLSTM, in train mode.

The JAX package's ``models/ssm.py`` for xlstm: ``_causal_conv`` (no
decode state), ``init_mlstm``, ``mlstm_block`` with the parallel
(decay-matrix) form ``_mlstm_parallel``, ``init_slstm`` and
``slstm_block``, whose ``lax.scan`` over time is a Python loop in the
same order.  Activations are ``[*lead, b, t, d]`` and parameter leaves
``[*lead, *leaf]`` (``layers``' leading replica dims).

Dtypes land where JAX's promotion puts them: ``torch.matmul`` refuses
the mixed bf16 x f32 operands that ``jnp.einsum`` promotes, so the
compute-dtype operand is cast to float32 at exactly those products
(q, k and v in ``mlstm_parallel``, ``wr`` in the sLSTM recurrence).
Gradients split at ties as JAX's do: ``torch.amax`` and
``torch.maximum`` halve them, as ``jnp.max`` and ``jnp.maximum`` do.

Not ported: mamba2 and its SSD scan (the hybrid family, ROADMAP item
15) and the recurrent decode states (serving, item 21).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models import layers
from repro_torch.models.layers import F32, bcast, he_init, linear, scalar


def causal_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Depthwise causal convolution then SiLU: x [*lead, b, t, c], w
    [*lead, k, c] -> [*lead, b, t, c]; tap i reads x at t - (k - 1) + i,
    zeros before the start.  The taps add in order in x's dtype (JAX's
    ``sum`` of the products)."""
    k, t = w.shape[-2], x.shape[-2]
    pad = x.new_zeros(x.shape[:-2] + (k - 1, x.shape[-1]))
    xp = torch.cat([pad, x], dim=-2)
    out = sum(xp[..., i:i + t, :] * bcast(w[..., i, :], x) for i in range(k))
    return F.silu(out)


def init_mlstm(gen, cfg, device) -> dict:
    xc = cfg.xlstm
    d = cfg.d_model
    d_in = int(xc.proj_factor * d)
    heads = cfg.n_heads
    return {
        "up": he_init(gen, (d, 2 * d_in), device),
        "conv": he_init(gen, (xc.conv_kernel, d_in), device, xc.conv_kernel),
        "wq": he_init(gen, (d_in, d_in), device),
        "wk": he_init(gen, (d_in, d_in), device),
        "wv": he_init(gen, (d_in, d_in), device),
        "wi": he_init(gen, (d_in, heads), device),
        "wf": he_init(gen, (d_in, heads), device),
        "fb": torch.full((heads,), 3.0, dtype=F32, device=device),
        "norm": layers.init_rms(d_in, device),
        "down": he_init(gen, (d_in, d), device, d_in),
    }


def _heads(x: torch.Tensor, heads: int) -> torch.Tensor:
    """[..., h * hd] -> [..., h, hd]."""
    return x.reshape(x.shape[:-1] + (heads, x.shape[-1] // heads))


def mlstm_block(p, x, cfg) -> torch.Tensor:
    """The mLSTM mixer in train mode: x [*lead, b, t, d] -> [*lead, b, t,
    d] (up-projection, causal conv, q/k/v and the scalar gates, the
    parallel form, the norm, the SiLU gate and the down-projection)."""
    d = x.shape[-1]
    d_in = int(cfg.xlstm.proj_factor * d)
    heads = cfg.n_heads
    hd = d_in // heads
    up = linear(x, p["up"])
    u, z = up[..., :d_in], up[..., d_in:]
    uc = causal_conv(u, p["conv"])
    q = _heads(linear(uc, p["wq"]), heads)
    k = _heads(linear(uc, p["wk"]), heads)
    k = k / scalar(k, math.sqrt(hd))
    v = _heads(linear(u, p["wv"]), heads)
    i_pre = linear(uc, p["wi"]).to(F32)                       # [*, b, t, H]
    f_pre = linear(uc, p["wf"]).to(F32)
    f_pre = f_pre + bcast(p["fb"], f_pre)
    y = mlstm_parallel(q, k, v, i_pre, f_pre)
    y = y.reshape(y.shape[:-2] + (d_in,))
    y = layers.rms_norm(p["norm"], y, cfg.norm_eps)
    y = y * F.silu(z)
    return linear(y, p["down"])


def mlstm_parallel(q, k, v, i_pre, f_pre) -> torch.Tensor:
    """The parallel (decay-matrix) mLSTM, quadratic in t: q, k, v [*, b,
    t, H, hd], the gate pre-activations [*, b, t, H] float32 -> [*, b, t,
    H, hd] in q's dtype.  Worked head-major ([*, b, H, i, j]), the JAX
    package's [b, i, j, H] transposed: D[i, j] = exp(cf_i - cf_j + i_j
    - m_i) for j <= i, 0 above the diagonal."""
    t = q.shape[-3]
    cf = torch.cumsum(F.logsigmoid(f_pre), dim=-2).transpose(-1, -2)
    ig = i_pre.transpose(-1, -2)                              # [*, b, H, t]
    rel = cf[..., :, None] - cf[..., None, :] + ig[..., None, :]
    mask = torch.ones((t, t), dtype=torch.bool, device=q.device).tril()
    rel = torch.where(mask, rel, scalar(rel, -math.inf))
    m = torch.maximum(torch.amax(rel, dim=-1, keepdim=True),
                      scalar(rel, 0.0))                       # stabilizer
    dmat = torch.exp(rel - m)
    qf, kf, vf = (a.to(F32).transpose(-3, -2) for a in (q, k, v))
    scores = (qf @ kf.transpose(-1, -2)) * dmat
    norm = torch.maximum(torch.abs(torch.sum(scores, dim=-1)),
                         torch.exp(-m[..., 0]))               # [*, b, H, i]
    y = scores @ vf
    return (y / norm[..., None]).transpose(-3, -2).to(q.dtype)


def init_slstm(gen, cfg, device) -> dict:
    d = cfg.d_model
    heads = cfg.n_heads
    hd = d // heads
    ff = int(4 * d / 3)
    return {
        "wx": he_init(gen, (d, 4 * d), device),                  # i, f, z, o
        "wr": he_init(gen, (heads, hd, 4 * hd), device, hd),     # recurrent
        "fb": torch.full((heads,), 3.0, dtype=F32, device=device),
        "norm": layers.init_rms(d, device),
        "up": he_init(gen, (d, ff * 2), device),
        "down": he_init(gen, (ff, d), device, ff),
    }


def slstm_block(p, x, cfg) -> torch.Tensor:
    """The sLSTM recurrence and its gated FFN: x [*lead, b, t, d] ->
    [*lead, b, t, d].  One step a position, in order (the JAX package's
    ``lax.scan``); the carry (c, n, h, m) in float32 from c = h = m = 0,
    n = 1."""
    d = x.shape[-1]
    heads = cfg.n_heads
    hd = d // heads
    xg = linear(x, p["wx"])
    xg = xg.reshape(xg.shape[:-1] + (heads, 4 * hd)).to(F32)  # [.., t, H, 4hd]
    # the loop's operands laid out once: wr [*lead, 1, H, hd, 4hd] for a
    # batched [1, hd] @ [hd, 4hd] product a head; the gates' per-head
    # scalars kept as [..., H, 1] so they broadcast over hd unsqueezed
    wr = p["wr"].to(F32).unsqueeze(-4)
    fb = p["fb"].to(F32)
    fb = fb.reshape(fb.shape[:-1] + (1,) * (xg.dim() - 2 - fb.dim())
                    + (heads, 1))
    carry_shape = xg.shape[:-3] + (heads,)                    # [*lead, b, H]
    c = torch.zeros(carry_shape + (hd,), dtype=F32, device=x.device)
    h = torch.zeros_like(c)
    n = torch.ones_like(c)
    m = torch.zeros(carry_shape + (1,), dtype=F32, device=x.device)
    one = scalar(n, 1.0)
    hs = []
    for xt in xg.unbind(-3):
        g = xt + torch.matmul(h.unsqueeze(-2), wr).squeeze(-2)
        ih, fh, zh, oh = torch.split(g, hd, dim=-1)
        i_pre = torch.mean(ih, dim=-1, keepdim=True)          # a gate a head
        f_pre = torch.mean(fh, dim=-1, keepdim=True) + fb
        lf = F.logsigmoid(f_pre) + m
        m = torch.maximum(lf, i_pre)
        fg = torch.exp(lf - m)
        ig = torch.exp(i_pre - m)
        c = fg * c + ig * torch.tanh(zh)
        n = fg * n + ig
        h = torch.sigmoid(oh) * (c / torch.maximum(n, one))
        hs.append(h)
    y = torch.stack(hs, dim=-3)                             # [*, b, t, H, hd]
    y = y.reshape(y.shape[:-2] + (d,)).to(x.dtype)
    y = layers.rms_norm(p["norm"], y, cfg.norm_eps)
    ff = int(4 * d / 3)
    uv = linear(y, p["up"])
    return linear(F.silu(uv[..., :ff]) * uv[..., ff:], p["down"])
