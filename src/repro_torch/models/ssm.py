"""Recurrent blocks: Mamba2 (the hybrid family, zamba2) and mLSTM /
sLSTM (the xLSTM family), in train mode and with their recurrent states
for serving.

The JAX package's ``models/ssm.py``: ``_causal_conv`` (with or without
its decode state); ``init_mamba2``, ``mamba2_block`` with the chunkwise
SSD scan ``ssd_chunked`` (train and prefill, which also gives the final
state) and the recurrent decode step, ``mamba2_state_init``;
``init_mlstm``, ``mlstm_block`` with the parallel (decay-matrix) form
``_mlstm_parallel`` (train and prefill, which also forms the final
state in closed form) and the recurrent decode step,
``mlstm_state_init``, ``init_slstm``, ``slstm_block``, whose
``lax.scan`` over time is a Python loop in the same order, from zeros
or from a given state, and ``slstm_state_init``.  Activations are
``[*lead, b, t, d]`` and parameter leaves ``[*lead, *leaf]``
(``layers``' leading replica dims).

Dtypes land where JAX's promotion puts them: ``torch.matmul`` refuses
the mixed bf16 x f32 operands that ``jnp.einsum`` promotes, so the
compute-dtype operand is cast to float32 at exactly those products
(q, k and v in ``mlstm_parallel``, ``wr`` in the sLSTM recurrence, x,
B and C in the SSD scan and the Mamba2 decode step).
Gradients split at ties as JAX's do: ``torch.amax`` and
``torch.maximum`` halve them, as ``jnp.max`` and ``jnp.maximum`` do.

The serving quirks are the JAX package's: prefill (t > 1) uses the
incoming mLSTM or Mamba2 state only as a flag (the parallel form and
the SSD scan start from zeros; the conv state is prepended), a
one-token prompt takes the recurrent step from that state, and the
mLSTM's recurrent step's denominator is ``max(|n . q|, 1)``, where the
parallel form's is ``max(|sum_j scores|, exp(-m))``.

So are the SSD scan's non-finite gradients (ROADMAP queue 3): the scan
forms ``exp(seg_i - seg_j)`` over the whole chunk and masks the upper
triangle after the ``exp``; where that overflows, autograd's ``0 *
inf`` gives NaN, as ``where``'s VJP does in JAX.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models import layers
from repro_torch.models.layers import F32, bcast, he_init, linear, scalar


def causal_conv(x: torch.Tensor, w: torch.Tensor, state=None):
    """Depthwise causal convolution then SiLU: x [*lead, b, t, c], w
    [*lead, k, c] -> [*lead, b, t, c]; tap i reads x at t - (k - 1) + i,
    zeros before the start.  The taps add in order in x's dtype (JAX's
    ``sum`` of the products).  With a decode ``state`` [*lead, b, k - 1,
    c], the inputs before x, prepended in x's dtype in place of the
    zeros: (out, new_state), the last k - 1 rows of the two."""
    k, t = w.shape[-2], x.shape[-2]
    prev = (x.new_zeros(x.shape[:-2] + (k - 1, x.shape[-1]))
            if state is None else state.to(x.dtype))
    xp = torch.cat([prev, x], dim=-2)
    out = F.silu(sum(xp[..., i:i + t, :] * bcast(w[..., i, :], x)
                     for i in range(k)))
    return out if state is None else (out, xp[..., -(k - 1):, :])


def init_mamba2(gen, cfg, device) -> dict:
    s = cfg.ssm
    d = cfg.d_model
    d_in = s.expand * d
    heads = d_in // 64                      # mamba2 convention: headdim 64
    return {
        "in_x": he_init(gen, (d, d_in), device),
        "in_z": he_init(gen, (d, d_in), device),
        "in_b": he_init(gen, (d, s.n_groups * s.d_state), device),
        "in_c": he_init(gen, (d, s.n_groups * s.d_state), device),
        "in_dt": he_init(gen, (d, heads), device),
        "dt_bias": torch.zeros((heads,), dtype=F32, device=device),
        "a_log": torch.log(torch.linspace(1.0, 16.0, heads, dtype=F32,
                                          device=device)),
        "d_skip": torch.ones((heads,), dtype=F32, device=device),
        "conv": he_init(gen, (s.d_conv, d_in), device, s.d_conv),
        "norm": layers.init_rms(d_in, device),
        "out": he_init(gen, (d_in, d), device, d_in),
    }


def mamba2_block(p, x, cfg, state=None):
    """The Mamba2 mixer: x [*lead, b, t, d] -> [*lead, b, t, d] (the z, x,
    B, C and dt projections, the causal conv on x, the SSD, the D skip,
    the SiLU gate, the norm and the out-projection), 64-wide heads, B and
    C repeated over each group's heads.  dt is float32, ``softplus(x @
    in_dt + dt_bias)``, and the log-decay ``dt * -exp(a_log)``.

    With a ``state`` (``mamba2_state_init``'s keys) it returns (y,
    new_state): for t > 1 the chunked scan from zeros and its final
    state (float32 [*, b, H, 64, d_state]), else the float32 recurrence
    from ``state["ssm"]``; the conv state comes back in x's dtype."""
    s = cfg.ssm
    d = x.shape[-1]
    d_in = s.expand * d
    heads = d_in // 64
    lead_bt = x.shape[:-1]
    z = linear(x, p["in_z"])
    xc = linear(x, p["in_x"])
    if state is None:
        xc = causal_conv(xc, p["conv"])
    else:
        xc, new_conv = causal_conv(xc, p["conv"], state["conv"])
    xh = xc.reshape(lead_bt + (heads, 64))
    bm = linear(x, p["in_b"]).reshape(lead_bt + (s.n_groups, s.d_state))
    cm = linear(x, p["in_c"]).reshape(lead_bt + (s.n_groups, s.d_state))
    bm = torch.repeat_interleave(bm, heads // s.n_groups, dim=-2)
    cm = torch.repeat_interleave(cm, heads // s.n_groups, dim=-2)
    dt = linear(x, p["in_dt"]).to(F32)
    dt = dt + bcast(p["dt_bias"], dt)
    dt = torch.logaddexp(dt, torch.zeros_like(dt))            # softplus
    a = -torch.exp(p["a_log"])                                # [*lead, H]
    decay = dt * bcast(a, dt)                                 # log-decay
    if state is None or x.shape[-2] > 1:
        y, final = ssd_chunked(xh, bm, cm, dt, decay, s.chunk)
        if state is not None:
            new_state = {"ssm": final, "conv": new_conv}
    else:
        y, st = mamba2_step(xh, bm, cm, dt, decay, state["ssm"])
        new_state = {"ssm": st, "conv": new_conv}
    y = y + xh * bcast(p["d_skip"].to(x.dtype), dt)[..., None]
    y = y.reshape(lead_bt + (d_in,)) * F.silu(z)
    y = layers.rms_norm(p["norm"], y, cfg.norm_eps)
    y = linear(y, p["out"])
    if state is None:
        return y
    return y, new_state


def mamba2_step(xh, bm, cm, dt, decay, ssm_state):
    """The float32 recurrence over t positions (one, at decode) from
    ``ssm_state`` [*, b, H, 64, n]: s' = exp(decay) s + dt x B^T, y = s'
    C.  Returns (y [*, b, t, H, 64] in xh's dtype, the state)."""
    st = ssm_state.to(F32)
    ys = []
    for i in range(xh.shape[-3]):
        g = torch.exp(decay[..., i, :])[..., None, None]      # [*, b, H, 1, 1]
        upd = (dt[..., i, :, None, None] * xh[..., i, :, :, None].to(F32)
               * bm[..., i, :, None, :].to(F32))
        st = g * st + upd
        ys.append((st @ cm[..., i, :, :, None].to(F32)).squeeze(-1))
    return torch.stack(ys, dim=-3).to(xh.dtype), st


def _pad_time(a: torch.Tensor, dim: int, pad: int) -> torch.Tensor:
    shape = list(a.shape)
    shape[dim] = pad
    return torch.cat([a, a.new_zeros(shape)], dim=dim)


def ssd_chunked(xh, bm, cm, dt, decay, chunk: int):
    """The chunkwise SSD scan: xh [*, t, H, p], B and C [*, t, H, n], dt and
    the log-decay [*, t, H] float32 -> (y [*, t, H, p] in xh's dtype,
    the final state [*, H, p, n] float32, the decode layout).

    Chunks of ``min(chunk, t)`` positions, a ragged tail zero-padded (dt
    = 0: an identity transition, no contribution) and the outputs sliced
    back.  Within a chunk the quadratic form, ``(C B^T * gamma) (dt x)``
    with gamma[i, j] = exp(seg_i - seg_j) below the diagonal (seg the
    chunk's cumulative log-decay, float32, ``torch.cumsum`` over the
    chunk's positions); across chunks the carried state, each chunk's
    summary ``(B exp(seg_end - seg))^T (dt x)`` added after the carry
    decays by exp(seg_end).  Worked head-major ([*, nc, H, c, c]), the
    JAX package's [b, nc, c, c, H] transposed."""
    t = xh.shape[-3]
    c = min(chunk, t)
    if t % c:
        pad = c - t % c
        y, final = ssd_chunked(
            *(_pad_time(a, -3, pad) for a in (xh, bm, cm)),
            *(_pad_time(a, -2, pad) for a in (dt, decay)), chunk)
        return y[..., :t, :, :], final
    nc = t // c
    lead = xh.shape[:-3]

    def heads_major(a):             # [*, t, H, f] -> [*, nc, H, c, f]
        return a.reshape(lead + (nc, c) + a.shape[-2:]).transpose(-3, -2)

    xf = heads_major(xh.to(F32) * dt[..., None])              # dt-weighted
    bf, cf = heads_major(bm.to(F32)), heads_major(cm.to(F32))
    seg = torch.cumsum(decay.reshape(lead + (nc, c, decay.shape[-1])),
                       dim=-2).transpose(-1, -2)              # [*, nc, H, c]
    rel = seg[..., :, None] - seg[..., None, :]               # [*, nc, H, i, j]
    mask = torch.ones((c, c), dtype=torch.bool, device=xh.device).tril()
    gamma = torch.where(mask, torch.exp(rel), scalar(rel, 0.0))
    scores = (cf @ bf.transpose(-1, -2)) * gamma
    y_intra = scores @ xf                                     # [*, nc, H, c, p]
    tail = seg[..., -1:] - seg                                # decay to end
    s_chunk = (bf * torch.exp(tail)[..., None]).transpose(-1, -2) @ xf
    g_chunk = torch.exp(seg[..., -1])                         # [*, nc, H]
    carry = xf.new_zeros(lead + s_chunk.shape[-3:])           # [*, H, n, p]
    prev = []
    for g in range(nc):
        prev.append(carry)
        carry = (carry * g_chunk[..., g, :, None, None]
                 + s_chunk[..., g, :, :, :])
    y_inter = (cf * torch.exp(seg)[..., None]) @ torch.stack(prev, dim=-4)
    y = (y_intra + y_inter).transpose(-3, -2).reshape(xh.shape)
    return y.to(xh.dtype), carry.transpose(-1, -2)


def mamba2_state_init(cfg, b: int) -> dict:
    """The shapes of one layer's Mamba2 state."""
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    return {"ssm": (b, d_in // 64, 64, s.d_state),
            "conv": (b, s.d_conv - 1, d_in)}


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


def mlstm_block(p, x, cfg, state=None):
    """The mLSTM mixer: x [*lead, b, t, d] -> [*lead, b, t, d]
    (up-projection, causal conv, q/k/v and the scalar gates, the
    parallel form, the norm, the SiLU gate and the down-projection).
    With a ``state`` (``mlstm_state_init``'s keys) it returns (y,
    new_state): for t > 1 the parallel form and ``mlstm_final_state``,
    else ``mlstm_step`` from the state; C, n and m come back float32,
    the conv state in x's dtype."""
    d = x.shape[-1]
    d_in = int(cfg.xlstm.proj_factor * d)
    heads = cfg.n_heads
    hd = d_in // heads
    up = linear(x, p["up"])
    u, z = up[..., :d_in], up[..., d_in:]
    if state is None:
        uc = causal_conv(u, p["conv"])
    else:
        uc, conv = causal_conv(u, p["conv"], state["conv"])
    q = _heads(linear(uc, p["wq"]), heads)
    k = _heads(linear(uc, p["wk"]), heads)
    k = k / scalar(k, math.sqrt(hd))
    v = _heads(linear(u, p["wv"]), heads)
    i_pre = linear(uc, p["wi"]).to(F32)                       # [*, b, t, H]
    f_pre = linear(uc, p["wf"]).to(F32)
    f_pre = f_pre + bcast(p["fb"], f_pre)
    if state is None or x.shape[-2] > 1:
        y = mlstm_parallel(q, k, v, i_pre, f_pre)
        if state is not None:
            new_state = mlstm_final_state(k, v, i_pre, f_pre)
    else:
        y, new_state = mlstm_step(q, k, v, i_pre, f_pre, state)
    y = y.reshape(y.shape[:-2] + (d_in,))
    y = layers.rms_norm(p["norm"], y, cfg.norm_eps)
    y = y * F.silu(z)
    y = linear(y, p["down"])
    if state is None:
        return y
    return y, {**new_state, "conv": conv}


def mlstm_final_state(k, v, i_pre, f_pre) -> dict:
    """The state after a prompt, in closed form, float32: with w_t =
    exp(cf_T - cf_t + i_t - m), m = max_t (cf_T - cf_t + i_t), C = sum_t
    w_t k_t v_t^T [*, b, H, hd, hd] and n = sum_t w_t k_t [*, b, H,
    hd]."""
    cf = torch.cumsum(F.logsigmoid(f_pre), dim=-2)            # [*, b, t, H]
    w_log = cf[..., -1:, :] - cf + i_pre
    m = torch.amax(w_log, dim=-2)                             # [*, b, H]
    w = torch.exp(w_log - m.unsqueeze(-2))
    wk = (w[..., None] * k.to(F32)).transpose(-3, -2)   # [*, b, H, t, hd]
    c = wk.transpose(-1, -2) @ v.to(F32).transpose(-3, -2)
    return {"C": c, "n": wk.sum(dim=-2), "m": m}


def mlstm_step(q, k, v, i_pre, f_pre, state):
    """The recurrent mLSTM over t positions (one, at decode) from
    ``state``'s C, n and m (cast to float32): m' = max(logsig(f) + m, i),
    C' = exp(logsig(f) + m - m') C + exp(i - m') k v^T, n' likewise with
    k, y = (C'^T q) / max(|n' . q|, 1) in q's dtype.  Returns (y [*, b,
    t, H, hd], {"C", "n", "m"})."""
    c, n, m = (state[key].to(F32) for key in ("C", "n", "m"))
    one = scalar(n, 1.0)
    ys = []
    for s_ in range(q.shape[-3]):
        logf = F.logsigmoid(f_pre[..., s_, :])                # [*, b, H]
        m_new = torch.maximum(logf + m, i_pre[..., s_, :])
        fg = torch.exp(logf + m - m_new)[..., None]
        ig = torch.exp(i_pre[..., s_, :] - m_new)[..., None]
        ks, vs, qs = (a[..., s_, :, :].to(F32) for a in (k, v, q))
        c = fg[..., None] * c + ig[..., None] * (ks[..., :, None]
                                                 * vs[..., None, :])
        n = fg * n + ig * ks
        m = m_new
        num = (qs.unsqueeze(-2) @ c).squeeze(-2)              # [*, b, H, hd]
        den = torch.maximum(torch.abs((n * qs).sum(dim=-1)), one)
        ys.append((num / den[..., None]).to(q.dtype))
    return torch.stack(ys, dim=-3), {"C": c, "n": n, "m": m}


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


def mlstm_state_init(cfg, b: int) -> dict:
    """The shapes of one layer's mLSTM state."""
    d_in = int(cfg.xlstm.proj_factor * cfg.d_model)
    heads = cfg.n_heads
    hd = d_in // heads
    return {"C": (b, heads, hd, hd), "n": (b, heads, hd), "m": (b, heads),
            "conv": (b, cfg.xlstm.conv_kernel - 1, d_in)}


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


def slstm_block(p, x, cfg, state=None):
    """The sLSTM recurrence and its gated FFN: x [*lead, b, t, d] ->
    [*lead, b, t, d].  One step a position, in order (the JAX package's
    ``lax.scan``); the carry (c, n, h, m) in float32 from c = h = m = 0,
    n = 1, or from a ``state`` (``slstm_state_init``'s keys, cast to
    float32), and then (y, the final carry)."""
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
    if state is None:
        carry_shape = xg.shape[:-3] + (heads,)                # [*lead, b, H]
        c = torch.zeros(carry_shape + (hd,), dtype=F32, device=x.device)
        h = torch.zeros_like(c)
        n = torch.ones_like(c)
        m = torch.zeros(carry_shape + (1,), dtype=F32, device=x.device)
    else:
        c, n, h = (state[key].to(F32) for key in ("c", "n", "h"))
        m = state["m"].to(F32).unsqueeze(-1)
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
    y = linear(F.silu(uv[..., :ff]) * uv[..., ff:], p["down"])
    if state is None:
        return y
    return y, {"c": c, "n": n, "h": h, "m": m.squeeze(-1)}


def slstm_state_init(cfg, b: int) -> dict:
    """The shapes of one layer's sLSTM state."""
    heads = cfg.n_heads
    shape = (b, heads, cfg.d_model // heads)
    return {"c": shape, "n": shape, "h": shape, "m": (b, heads)}
