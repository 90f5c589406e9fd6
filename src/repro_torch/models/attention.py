"""Grouped-query attention (sliding window, qk-norm) and cross-attention,
in train mode and with a KV cache for serving.

The JAX package's ``models/attention.py``: ``init_gqa``, ``_repeat_kv``,
``_attend`` (with a mask or none: whisper's bidirectional encoder),
``attend_causal`` (the full-mask path and the q-block scan with its
window key slice), ``gqa_attn`` in its three modes (train; prefill,
which fills the cache; decode over the cache: the rolled window cache or
the offset cache), ``gqa_cache_init``, and whisper's ``init_cross``,
``cross_kv`` and ``cross_attn``.  Activations are ``[*lead, b, t, h,
hd]`` (``layers``' leading replica dims; none when serving).

The arithmetic is the JAX package's, which computes attention in plain
jnp: the scores are a product in the compute dtype, THEN cast to
float32, divided by sqrt(hd), masked with the finite ``NEG_INF`` and
softmaxed in float32, and the weights cast back to v's dtype before
their product with v.  (``scaled_dot_product_attention`` would fuse
these with other roundings.)  Mixed operands promote as ``jnp.einsum``
promotes them: float32 queries meet a bfloat16 cache in float32, the
softmax weights are cast to the cache's bfloat16 for their product with
v, and that product meets ``wo`` in float32.

MLA (deepseek-v3's multi-head latent attention): ``init_mla``,
``mla_attn`` in its three forms -- train; prefill, which attends as
training does and writes the latent ``ckv`` and the shared rope key
``kr`` from slot 0; and the absorbed decode, which scores ``q_nope
W_uk^T`` against the latent cache, so a step reads the [L, r] cache
and never recomputes H keys -- and ``mla_cache_init``.  The absorbed
decode rounds as the reference does: the absorbed query in the compute
dtype meets the cache cast to it, the two score products are summed
and only then cast to float32 and scaled by 1/sqrt(nope + rope), and
the softmax weights are cast back to x's dtype for their product with
the cache.

Sharding specs (``gqa_specs``, ``_heads_spec``): the heads axis of
``wq``/``wo`` (and of ``wk``/``wv``) splits over the model axis where
the head count divides it.  ``gqa_attn``'s train mode runs tensor-
parallel with ``tp`` (``models.layers``): a rank projects its own query
heads (column-parallel, the input marked ``comm.copy_to_model``), and
``wo`` is row-parallel, the product summed over the model group.  A kv
head count that does not divide (gemma3-1b's single head) keeps
``wk``/``wv``/``kn`` whole on every rank: the keys and values are
formed whole, then marked ``copy_to_model`` so that their gradient --
each rank's heads' part -- is summed, and every rank's copy of those
leaves gets the whole gradient; ``qn``, read by the rank's heads only,
is marked the same way.

Not ported yet: the caches' sharding specs (item 17d).
"""
from __future__ import annotations

import math

import torch

from repro_torch.core import comm
from repro_torch.models import layers

NEG_INF = -2.0**30
Q_CHUNK = 1024  # query-block size for the exact chunked path


def _heads_spec(n_heads: int, model_shards: int):
    return (layers.MODEL if (model_shards and n_heads % model_shards == 0)
            else None)


def gqa_specs(cfg, model_shards: int) -> dict:
    hs = _heads_spec(cfg.n_heads, model_shards)
    hks = _heads_spec(cfg.n_kv_heads, model_shards)
    s = {"wq": (None, hs, None), "wk": (None, hks, None),
         "wv": (None, hks, None), "wo": (hs, None, None)}
    if cfg.qk_norm:
        s["qn"] = (None,)
        s["kn"] = (None,)
    return s


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
    (shared by every replica and row) or None.  q and k meet in their
    promoted dtype."""
    dt = torch.promote_types(q.dtype, k.dtype)
    q, k = q.to(dt), k.to(dt)
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
    """out [*, b, t, h, k] @ wo [*, h, k, d] -> [*, b, t, d], in their
    promoted dtype."""
    out = out.to(torch.promote_types(out.dtype, wo.dtype))
    return layers.linear(out.reshape(out.shape[:-2] + (-1,)),
                         wo.reshape(wo.shape[:-3] + (-1, wo.shape[-1])))


def _gqa_train_tp(p, x, positions, cfg, theta, window, mask_extra, tp):
    """Train-mode GQA on a rank's heads (``gqa_attn``'s ``tp``)."""
    m = tp.model_shards
    split_q = cfg.n_heads % m == 0
    split_kv = cfg.n_kv_heads % m == 0
    if not split_q:             # nothing splits: every rank the whole
        return gqa_attn(p, x, positions, cfg, theta=theta, window=window,
                        mask_extra=mask_extra)
    h_loc = cfg.n_heads // m
    xq = comm.copy_to_model(tp, x)
    q = _proj_heads(xq, p["wq"])
    k = _proj_heads(xq if split_kv else x, p["wk"])
    v = _proj_heads(xq if split_kv else x, p["wv"])
    if cfg.qk_norm:
        q = layers.rms_norm(comm.copy_to_model(tp, p["qn"]), q,
                            cfg.norm_eps)
        k = layers.rms_norm(p["kn"] if not split_kv
                            else comm.copy_to_model(tp, p["kn"]), k,
                            cfg.norm_eps)
    q = layers.rope(q, positions, theta)
    k = layers.rope(k, positions, theta)
    rep = cfg.n_heads // cfg.n_kv_heads
    k, v = _repeat_kv(k, rep), _repeat_kv(v, rep)
    if not split_kv:            # whole kv heads: the rank's heads' share
        lo = tp.model_rank * h_loc
        k = comm.copy_to_model(tp, k)[..., lo:lo + h_loc, :]
        v = comm.copy_to_model(tp, v)[..., lo:lo + h_loc, :]
    out = attend_causal(q, k, v, window, mask_extra)
    return comm.sum_model(tp, _merge_heads(out, p["wo"]))


def gqa_attn(p, x, positions, cfg, *, theta: float, window: int = 0,
             mask_extra=None, cache=None, pos: int = 0,
             prefill: bool = False, tp=None):
    """Causal GQA: x [*, b, t, d] -> [*, b, t, d] without a cache (train
    mode); with one, (out, new_cache).

    ``cache`` is ``{"k", "v": [b, L, hkv, hd]}`` (``gqa_cache_init``); k
    and v enter it in its dtype.  A cache of length ``window`` is the
    rolled window cache, whose last slot holds the newest position; any
    other is written at offsets.  ``prefill`` attends causally over the
    fresh tokens, as training does, and fills the cache: the rolled one
    keeps the last ``window`` of (cache, k), the other takes k at offset
    0.  Decode (not ``prefill``) takes t tokens from position ``pos`` (a
    host int): the rolled cache rolls left by t, appends them, and masks
    the slots before position 0 (``slot >= window - 1 - pos``); the
    offset cache writes them at ``pos`` and masks ``kj <= pos`` (and ``kj
    > pos - window`` with a window), the same mask for each of the t
    queries, as the JAX package's is.  An offset write past the cache's
    end raises ``ValueError`` (the JAX package's ``dynamic_update_slice``
    would clamp it into the last slots).  ``tp`` (train mode): the
    rank's heads, see the module docstring."""
    if tp is not None:
        if cache is not None:
            raise NotImplementedError(
                "serving over a model axis (the caches' specs): ROADMAP "
                "item 17d")
        return _gqa_train_tp(p, x, positions, cfg, theta, window,
                             mask_extra, tp)
    rep = cfg.n_heads // cfg.n_kv_heads
    q = _proj_heads(x, p["wq"])
    k = _proj_heads(x, p["wk"])
    v = _proj_heads(x, p["wv"])
    if cfg.qk_norm:
        q = layers.rms_norm(p["qn"], q, cfg.norm_eps)
        k = layers.rms_norm(p["kn"], k, cfg.norm_eps)
    q = layers.rope(q, positions, theta)
    k = layers.rope(k, positions, theta)
    if cache is None or prefill:
        out = attend_causal(q, _repeat_kv(k, rep), _repeat_kv(v, rep),
                            window, mask_extra)
        if cache is None:
            return _merge_heads(out, p["wo"])
    ck, cv = cache["k"], cache["v"]
    kc, vc = k.to(ck.dtype), v.to(cv.dtype)
    t, length = x.shape[-2], ck.shape[-3]
    rolled = length == window
    if prefill and rolled:
        ck = torch.cat([ck, kc], dim=-3)[..., -window:, :, :]
        cv = torch.cat([cv, vc], dim=-3)[..., -window:, :, :]
    elif rolled:
        ck = torch.cat([ck[..., t:, :, :], kc], dim=-3)
        cv = torch.cat([cv[..., t:, :, :], vc], dim=-3)
        valid = torch.arange(window, device=x.device) >= window - 1 - pos
        out = _attend(q, _repeat_kv(ck, rep), _repeat_kv(cv, rep),
                      valid.expand(t, window))
    else:
        at = 0 if prefill else pos
        if at + t > length:
            raise ValueError(
                f"writing {t} positions at {at} overruns the cache's "
                f"{length} (max_len)")
        ck = torch.cat([ck[..., :at, :, :], kc, ck[..., at + t:, :, :]],
                       dim=-3)
        cv = torch.cat([cv[..., :at, :, :], vc, cv[..., at + t:, :, :]],
                       dim=-3)
        if not prefill:
            kj = torch.arange(length, device=x.device)
            valid = kj <= pos
            if window:
                valid &= kj > pos - window
            out = _attend(q, _repeat_kv(ck, rep), _repeat_kv(cv, rep),
                          valid.expand(t, length))
    return _merge_heads(out, p["wo"]), {"k": ck, "v": cv}


def gqa_cache_init(cfg, b: int, max_len: int) -> dict:
    """The shapes of one layer's k and v cache."""
    shape = (b, max_len, cfg.n_kv_heads, cfg.hd)
    return {"k": shape, "v": shape}


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


# -- MLA (deepseek-v3) --------------------------------------------------------

def init_mla(gen, cfg, device) -> dict:
    m = cfg.mla
    d, h = cfg.d_model, cfg.n_heads
    qk = m.qk_nope_head_dim + m.qk_rope_head_dim
    r, kr = m.q_lora_rank, m.kv_lora_rank
    return {
        "wdq": layers.he_init(gen, (d, r), device),
        "qn": layers.init_rms(r, device),
        "wuq": layers.he_init(gen, (r, h * qk), device, r).reshape(r, h, qk),
        "wdkv": layers.he_init(gen, (d, kr), device),
        "kvn": layers.init_rms(kr, device),
        "wkr": layers.he_init(gen, (d, m.qk_rope_head_dim), device),
        "wuk": layers.he_init(gen, (kr, h * m.qk_nope_head_dim), device,
                              kr).reshape(kr, h, m.qk_nope_head_dim),
        "wuv": layers.he_init(gen, (kr, h * m.v_head_dim), device,
                              kr).reshape(kr, h, m.v_head_dim),
        "wo": layers.he_init(gen, (h * m.v_head_dim, d), device,
                             h * m.v_head_dim).reshape(h, m.v_head_dim, d),
    }


def _write(cache: torch.Tensor, new: torch.Tensor, at: int) -> torch.Tensor:
    """cache [b, L, f] with new [b, t, f] (cast to the cache's dtype) at
    offset ``at``; past the cache's end raises ``ValueError``."""
    t, length = new.shape[-2], cache.shape[-2]
    if at + t > length:
        raise ValueError(f"writing {t} positions at {at} overruns the "
                         f"cache's {length} (max_len)")
    return torch.cat([cache[..., :at, :], new.to(cache.dtype),
                      cache[..., at + t:, :]], dim=-2)


def mla_attn(p, x, positions, cfg, *, cache=None, pos: int = 0,
             prefill: bool = False):
    """MLA: x [*, b, t, d] -> [*, b, t, d] without a cache (train mode);
    with one (``{"ckv": [b, L, r], "kr": [b, L, rope]}``,
    ``mla_cache_init``), (out, new_cache): ``prefill`` attends causally
    over the fresh tokens and writes their latents from slot 0, decode
    writes t tokens at ``pos`` (a host int) and attends over the cache
    through the absorbed keys, masking ``kj <= pos``."""
    m = cfg.mla
    nope, rdim = m.qk_nope_head_dim, m.qk_rope_head_dim
    ql = layers.rms_norm(p["qn"], layers.linear(x, p["wdq"]), cfg.norm_eps)
    q = _proj_heads(ql, p["wuq"])
    q_nope = q[..., :nope]
    q_rope = layers.rope(q[..., nope:], positions, cfg.rope_theta)
    ckv = layers.rms_norm(p["kvn"], layers.linear(x, p["wdkv"]),
                          cfg.norm_eps)                          # [*, b,t,r]
    k_rope = layers.rope(layers.linear(x, p["wkr"])[..., None, :],
                         positions, cfg.rope_theta)[..., 0, :]   # [*,b,t,rd]
    if cache is None or prefill:
        k_nope = _proj_heads(ckv, p["wuk"])
        v = _proj_heads(ckv, p["wuv"])
        k = torch.cat([k_nope, k_rope[..., None, :].expand(
            k_rope.shape[:-1] + (cfg.n_heads, rdim))], dim=-1)
        out = attend_causal(torch.cat([q_nope, q_rope], dim=-1), k, v)
        if cache is None:
            return _merge_heads(out, p["wo"])
        new_cache = {"ckv": _write(cache["ckv"], ckv, 0),
                     "kr": _write(cache["kr"], k_rope, 0)}
        return _merge_heads(out, p["wo"]), new_cache
    cc = _write(cache["ckv"], ckv, pos)
    cr = _write(cache["kr"], k_rope, pos)
    q_abs = torch.einsum("bthk,rhk->bthr", q_nope, p["wuk"])
    scores = (torch.einsum("bthr,bsr->bhts", q_abs, cc.to(q_abs.dtype))
              + torch.einsum("bthk,bsk->bhts", q_rope,
                             cr.to(q_rope.dtype))).to(torch.float32)
    scores = scores / layers.scalar(scores, math.sqrt(nope + rdim))
    valid = torch.arange(cc.shape[-2], device=x.device) <= pos
    scores = torch.where(valid, scores, layers.scalar(scores, NEG_INF))
    w = torch.softmax(scores, dim=-1).to(x.dtype)
    o_lat = torch.einsum("bhts,bsr->bthr", w, cc.to(x.dtype))
    out = torch.einsum("bthr,rhk->bthk", o_lat, p["wuv"])
    return _merge_heads(out, p["wo"]), {"ckv": cc, "kr": cr}


def mla_cache_init(cfg, b: int, max_len: int) -> dict:
    """The shapes of one layer's latent cache and rope-key cache."""
    m = cfg.mla
    return {"ckv": (b, max_len, m.kv_lora_rank),
            "kr": (b, max_len, m.qk_rope_head_dim)}
