"""Grouped-query attention (sliding window, qk-norm) and cross-attention
in train mode.

The JAX package's ``models/attention.py`` for training: ``init_gqa``,
``_repeat_kv``, ``_attend`` (with a mask or none: whisper's
bidirectional encoder), ``attend_causal`` (the full-mask path and the
q-block scan with its window key slice), ``gqa_attn`` without a cache,
and whisper's ``init_cross``, ``cross_kv`` and ``cross_attn``.
Activations are ``[*lead, b, t, h, hd]`` (``layers``' leading replica
dims).

The arithmetic is the JAX package's, which computes attention in plain
jnp: the scores are a product in the compute dtype, THEN cast to
float32, divided by sqrt(hd), masked with the finite ``NEG_INF`` and
softmaxed in float32, and the weights cast back to v's dtype before
their product with v.  (``scaled_dot_product_attention`` would fuse
these with other roundings.)

Not ported yet: the prefill and decode modes with their KV caches
(ROADMAP item 21) and MLA (item 15, with the moe family).
"""
from __future__ import annotations

import math

import torch

from repro_torch.models import layers

NEG_INF = -2.0**30
Q_CHUNK = 1024  # query-block size for the exact chunked path


def init_gqa(gen, cfg, device) -> dict:
    d, hd, h, hkv = cfg.d_model, cfg.hd, cfg.n_heads, cfg.n_kv_heads
    p = {
        "wq": layers.he_init(gen, (d, h * hd), device).reshape(d, h, hd),
        "wk": layers.he_init(gen, (d, hkv * hd), device).reshape(d, hkv, hd),
        "wv": layers.he_init(gen, (d, hkv * hd), device).reshape(d, hkv, hd),
        "wo": layers.he_init(gen, (h * hd, d), device,
                             h * hd).reshape(h, hd, d),
    }
    if cfg.qk_norm:
        p["qn"] = layers.init_rms(hd, device)
        p["kn"] = layers.init_rms(hd, device)
    return p


def _repeat_kv(k: torch.Tensor, n_rep: int) -> torch.Tensor:
    """Each kv head n_rep times in a row on the heads axis (``jnp.repeat``,
    i.e. ``repeat_interleave``)."""
    if n_rep == 1:
        return k
    return torch.repeat_interleave(k, n_rep, dim=-2)


def _attend(q, k, v, mask):
    """q: [*, b, tq, h, hd]; k, v: [*, b, tk, h, hd]; mask: [tq, tk] bool
    (shared by every replica and row) or None."""
    scores = torch.matmul(q.transpose(-3, -2), k.permute(
        *range(k.dim() - 4), -4, -2, -1, -3)).to(torch.float32)
    scores = scores / layers.scalar(scores, math.sqrt(q.shape[-1]))
    if mask is not None:
        scores = torch.where(mask, scores, layers.scalar(scores, NEG_INF))
    w = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.matmul(w, v.transpose(-3, -2)).transpose(-3, -2)


def causal_mask(tq: int, tk: int, window: int = 0,
                device=None) -> torch.Tensor:
    """[tq, tk] bool; query i attends key j iff j <= i (& in window)."""
    qi = torch.arange(tq, device=device)[:, None]
    kj = torch.arange(tk, device=device)[None, :]
    m = kj <= qi
    if window:
        m &= kj > qi - window
    return m


def attend_causal(q, k, v, window: int = 0, mask_extra=None,
                  q_chunk: int = Q_CHUNK):
    """Exact causal (optionally sliding-window) attention.

    The full [t, t] mask when t <= q_chunk, t % q_chunk != 0 or there is
    a ``mask_extra``; otherwise a loop over query blocks of q_chunk that,
    for window layers, slices in only the window + q_chunk keys a block
    can see (the JAX package's ``lax.scan``, in the same order)."""
    t = q.shape[-3]
    if t <= q_chunk or t % q_chunk != 0 or mask_extra is not None:
        mask = causal_mask(t, t, window, device=q.device)
        if mask_extra is not None:
            mask = mask & mask_extra
        return _attend(q, k, v, mask)
    use_window = bool(window) and (window + q_chunk) <= t
    blocks = []
    for qs in range(0, t, q_chunk):
        qb = q[..., qs:qs + q_chunk, :, :]
        if use_window:
            ks = max(qs - window, 0)
            kb = k[..., ks:ks + window + q_chunk, :, :]
            vb = v[..., ks:ks + window + q_chunk, :, :]
            kj = ks + torch.arange(window + q_chunk, device=q.device)[None]
        else:
            kb, vb = k, v
            kj = torch.arange(t, device=q.device)[None, :]
        qi = qs + torch.arange(q_chunk, device=q.device)[:, None]
        m = kj <= qi
        if window:
            m &= kj > qi - window
        blocks.append(_attend(qb, kb, vb, m))
    return torch.cat(blocks, dim=-3)


def _proj_heads(x, w):
    """x [*, b, t, d] @ w [*, d, h, k] -> [*, b, t, h, k]."""
    y = layers.linear(x, w.reshape(w.shape[:-2] + (-1,)))
    return y.reshape(y.shape[:-1] + tuple(w.shape[-2:]))


def _merge_heads(out, wo):
    """out [*, b, t, h, k] @ wo [*, h, k, d] -> [*, b, t, d]."""
    return layers.linear(out.reshape(out.shape[:-2] + (-1,)),
                         wo.reshape(wo.shape[:-3] + (-1, wo.shape[-1])))


def gqa_attn(p, x, positions, cfg, *, theta: float, window: int = 0,
             mask_extra=None):
    """Train-mode GQA: x [*, b, t, d] -> [*, b, t, d] (causal, no cache)."""
    h, hkv = cfg.n_heads, cfg.n_kv_heads
    q = _proj_heads(x, p["wq"])
    k = _proj_heads(x, p["wk"])
    v = _proj_heads(x, p["wv"])
    if cfg.qk_norm:
        q = layers.rms_norm(p["qn"], q, cfg.norm_eps)
        k = layers.rms_norm(p["kn"], k, cfg.norm_eps)
    q = layers.rope(q, positions, theta)
    k = layers.rope(k, positions, theta)
    out = attend_causal(q, _repeat_kv(k, h // hkv), _repeat_kv(v, h // hkv),
                        window, mask_extra)
    return _merge_heads(out, p["wo"])


def bidir_attn(p, x, cfg):
    """Bidirectional self-attention (whisper's encoder): no mask, no
    rope, no qk-norm; x [*, b, t, d] -> [*, b, t, d]."""
    rep = cfg.n_heads // cfg.n_kv_heads
    q = _proj_heads(x, p["wq"])
    k = _proj_heads(x, p["wk"])
    v = _proj_heads(x, p["wv"])
    out = _attend(q, _repeat_kv(k, rep), _repeat_kv(v, rep), None)
    return _merge_heads(out, p["wo"])


def init_cross(gen, cfg, device) -> dict:
    d, hd, h, hkv = cfg.d_model, cfg.hd, cfg.n_heads, cfg.n_kv_heads
    return {
        "wq": layers.he_init(gen, (d, h * hd), device).reshape(d, h, hd),
        "wk": layers.he_init(gen, (d, hkv * hd), device).reshape(d, hkv, hd),
        "wv": layers.he_init(gen, (d, hkv * hd), device).reshape(d, hkv, hd),
        "wo": layers.he_init(gen, (h * hd, d), device,
                             h * hd).reshape(h, hd, d),
    }


def cross_kv(p, enc_out, cfg) -> dict:
    """The encoder's keys and values, enc_out [*, b, f, d] -> [*, b, f,
    hkv, hd] each."""
    return {"k": _proj_heads(enc_out, p["wk"]),
            "v": _proj_heads(enc_out, p["wv"])}


def cross_attn(p, x, enc_kv, cfg):
    """The decoder's queries x [*, b, t, d] over every encoder frame (no
    mask, no rope) -> [*, b, t, d]."""
    rep = cfg.n_heads // cfg.n_kv_heads
    q = _proj_heads(x, p["wq"])
    out = _attend(q, _repeat_kv(enc_kv["k"].to(q.dtype), rep),
                  _repeat_kv(enc_kv["v"].to(q.dtype), rep), None)
    return _merge_heads(out, p["wo"])
