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
the head count divides it.  ``gqa_attn`` runs tensor-parallel with
``tp`` (``models.layers``): a rank projects its own query
heads (column-parallel, the input marked ``comm.copy_to_model``), and
``wo`` is row-parallel, the product summed over the model group.  A kv
head count that does not divide (gemma3-1b's single head) keeps
``wk``/``wv``/``kn`` whole on every rank: the keys and values are
formed whole, then marked ``copy_to_model`` so that their gradient --
each rank's heads' part -- is summed, and every rank's copy of those
leaves gets the whole gradient; ``qn``, read by the rank's heads only,
is marked the same way.  whisper's ``bidir_attn`` and its
cross-attention (``cross_kv``, ``cross_attn``) take the rank's heads
the same way; the encoder's output, whole on every rank, reaches the
rank's cross keys and values through ``copy_to_model``.
``mla_attn`` runs
tensor-parallel the same way (``mla_specs``): ``wuq``, ``wuk`` and
``wuv`` column-parallel over the heads, ``wo`` row-parallel and summed;
the replicated ``wdq``/``qn``, ``wdkv``/``kvn`` and ``wkr`` form the
query latent, the kv latent and the shared rope key whole, each marked
``copy_to_model`` before the rank's heads read it.  Heads that do not
divide the axis run whole on every rank, for both mixers.

Serving runs the same split (``tp`` with a cache): the caches' specs
(``gqa_cache_specs``, ``mla_cache_specs``, the JAX functions' tuples)
give a rank its block -- the batch rows of its pod and data ranks, and
GQA's kv heads where they divide the model axis, else all of them,
formed whole as in training and cut to the rank's heads after the
cache; MLA's latent ``ckv`` and rope key ``kr`` are whole on every
model rank, and the rank's heads take their absorbed ``wuk`` and
``wuv`` columns over it.  ``wo``'s row-parallel product is summed over
the model group at prefill and at every decode step.

A cache split by length (``seq``: the topology whose data ranks each
hold a block of it, long_500k's layout, ``build.make_cache(...,
len_axis="data")``): data rank r holds global positions ``[r*Lb,
(r+1)*Lb)`` of GQA's offset cache and of MLA's latent caches.  A write
(prefill's ``[0, t)``, a decode step's ``[pos, pos+t)``) lands on the
rank or ranks that own its positions, checked against the global
length; a decode step scores the rank's block under the global mask and
combines the ranks' partial softmaxes over the data group
(``comm.combine_softmax``: flash-decoding's combine, in float32).  A
window layer's cache, and the recurrent states, stay whole.
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


def mla_specs(cfg, model_shards: int) -> dict:
    """MLA's leaf specs (the JAX ``mla_specs``): the heads split."""
    hs = _heads_spec(cfg.n_heads, model_shards)
    return {"wdq": (None, None), "qn": (None,), "wuq": (None, hs, None),
            "wdkv": (None, None), "kvn": (None,), "wkr": (None, None),
            "wuk": (None, hs, None), "wuv": (None, hs, None),
            "wo": (hs, None, None)}


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


def _attend(q, k, v, mask, seq=None):
    """q: [*, b, tq, h, hd]; k, v: [*, b, tk, h, hd]; mask: [tq, tk] bool
    (shared by every replica and row) or None.  q and k meet in their
    promoted dtype.  ``seq``: k and v are the rank's block of a length
    split over its data ranks (:func:`_split_softmax`)."""
    dt = torch.promote_types(q.dtype, k.dtype)
    q, k = q.to(dt), k.to(dt)
    scores = torch.matmul(q.transpose(-3, -2), k.permute(
        *range(k.dim() - 4), -4, -2, -1, -3)).to(torch.float32)
    scores = scores / layers.scalar(scores, math.sqrt(q.shape[-1]))
    if mask is not None:
        scores = torch.where(mask, scores, layers.scalar(scores, NEG_INF))
    if seq is not None:
        out = _split_softmax(scores, v.transpose(-3, -2), seq)
        return out.to(v.dtype).transpose(-3, -2)
    w = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.matmul(w, v.transpose(-3, -2)).transpose(-3, -2)


def _split_softmax(scores, values, seq):
    """softmax(scores) @ values over a length split across ``seq``'s data
    ranks: scores [..., tq, s] float32, masked with ``NEG_INF``, and
    values [..., s, e] the rank's block of the slots; float32 [..., tq,
    e].  The rank's row max, sum and weighted values, in float32, are
    combined over the data group (``comm.combine_softmax``); a row whose
    slots are all masked on this rank hands in zeros."""
    m_r = scores.amax(dim=-1, keepdim=True)
    p = torch.exp(scores - m_r)
    live = m_r > NEG_INF
    l_r = torch.where(live, p.sum(dim=-1, keepdim=True), 0.0)
    o_r = torch.where(live, torch.matmul(p, values.to(torch.float32)), 0.0)
    return comm.combine_softmax(seq, m_r, l_r, o_r)


def _length_block(seq, length: int) -> tuple[int, int]:
    """(the first global slot of the rank's block, the global length) of
    a cache of ``length`` slots on the rank; without ``seq`` the cache is
    whole, (0, length)."""
    if seq is None:
        return 0, length
    return seq.mesh.data_rank * length, seq.mesh.data * length


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


def _tp_heads(cfg, tp):
    """``tp`` where the query heads divide the model axis, else None:
    every rank runs the heads whole."""
    return tp if tp is not None and cfg.n_heads % tp.model_shards == 0 \
        else None


def _kv_split(cfg, tp) -> bool:
    return tp is not None and cfg.n_kv_heads % tp.model_shards == 0


def _rank_kv(k, v, cfg, tp):
    """Keys and values repeated to the query heads, with ``tp`` the
    rank's share: where the kv heads do not split they were formed
    whole, so they are marked ``copy_to_model`` (each rank's heads'
    part of their gradient is summed) and cut to the rank's heads."""
    rep = cfg.n_heads // cfg.n_kv_heads
    k, v = _repeat_kv(k, rep), _repeat_kv(v, rep)
    if tp is not None and not _kv_split(cfg, tp):
        h_loc = cfg.n_heads // tp.model_shards
        lo = tp.model_rank * h_loc
        k = comm.copy_to_model(tp, k)[..., lo:lo + h_loc, :]
        v = comm.copy_to_model(tp, v)[..., lo:lo + h_loc, :]
    return k, v


def gqa_attn(p, x, positions, cfg, *, theta: float, window: int = 0,
             mask_extra=None, cache=None, pos: int = 0,
             prefill: bool = False, tp=None, seq=None):
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
    would clamp it into the last slots).  ``tp``: the rank's heads, see
    the module docstring; with a cache, the rank's block of it
    (``gqa_cache_specs``: its kv heads, or all of them where they do not
    split).  ``seq``: the offset cache is the rank's block of a length
    split over its data ranks (the module docstring); positions, the
    overrun check and the mask are global."""
    tp = _tp_heads(cfg, tp)
    split_kv = _kv_split(cfg, tp)
    xq = comm.copy_to_model(tp, x)
    xkv = xq if split_kv else x
    q = _proj_heads(xq, p["wq"])
    k = _proj_heads(xkv, p["wk"])
    v = _proj_heads(xkv, p["wv"])
    if cfg.qk_norm:
        q = layers.rms_norm(comm.copy_to_model(tp, p["qn"]), q,
                            cfg.norm_eps)
        k = layers.rms_norm(comm.copy_to_model(tp, p["kn"]) if split_kv
                            else p["kn"], k, cfg.norm_eps)
    q = layers.rope(q, positions, theta)
    k = layers.rope(k, positions, theta)
    if cache is None or prefill:
        out = attend_causal(q, *_rank_kv(k, v, cfg, tp), window, mask_extra)
        if cache is None:
            return comm.sum_model(tp, _merge_heads(out, p["wo"]))
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
        out = _attend(q, *_rank_kv(ck, cv, cfg, tp),
                      valid.expand(t, window))
    else:
        at = 0 if prefill else pos
        lo, total = _length_block(seq, length)
        ck = _write(ck, kc, at, -3, lo, total)
        cv = _write(cv, vc, at, -3, lo, total)
        if not prefill:
            kj = lo + torch.arange(length, device=x.device)
            valid = kj <= pos
            if window:
                valid &= kj > pos - window
            out = _attend(q, *_rank_kv(ck, cv, cfg, tp),
                          valid.expand(t, length), seq)
    return comm.sum_model(tp, _merge_heads(out, p["wo"])), {"k": ck, "v": cv}


def gqa_cache_init(cfg, b: int, max_len: int) -> dict:
    """The shapes of one layer's k and v cache."""
    shape = (b, max_len, cfg.n_kv_heads, cfg.hd)
    return {"k": shape, "v": shape}


def gqa_cache_specs(cfg, model_shards: int, batch_axes,
                    len_axis=None) -> dict:
    """The k and v cache's spec (the JAX ``gqa_cache_specs``): the batch
    over ``batch_axes``, the length over ``len_axis`` (the length-sharded
    layout), the kv heads over the model axis where they divide it."""
    hks = _heads_spec(cfg.n_kv_heads, model_shards)
    return {"k": (batch_axes, len_axis, hks, None),
            "v": (batch_axes, len_axis, hks, None)}


def bidir_attn(p, x, cfg, tp=None):
    """Bidirectional self-attention (whisper's encoder): no mask, no
    rope, no qk-norm; x [*, b, t, d] -> [*, b, t, d].  ``tp``: the
    rank's heads, as ``gqa_attn``'s train mode takes them."""
    tp = _tp_heads(cfg, tp)
    xq = comm.copy_to_model(tp, x)
    xkv = xq if _kv_split(cfg, tp) else x
    q = _proj_heads(xq, p["wq"])
    k, v = _rank_kv(_proj_heads(xkv, p["wk"]), _proj_heads(xkv, p["wv"]),
                    cfg, tp)
    out = _attend(q, k, v, None)
    return comm.sum_model(tp, _merge_heads(out, p["wo"]))


def init_cross(gen, cfg, device) -> dict:
    d, hd, h, hkv = cfg.d_model, cfg.hd, cfg.n_heads, cfg.n_kv_heads
    return {
        "wq": layers.he_init(gen, (d, h * hd), device).reshape(d, h, hd),
        "wk": layers.he_init(gen, (d, hkv * hd), device).reshape(d, hkv, hd),
        "wv": layers.he_init(gen, (d, hkv * hd), device).reshape(d, hkv, hd),
        "wo": layers.he_init(gen, (h * hd, d), device,
                             h * hd).reshape(h, hd, d),
    }


def cross_kv(p, enc_out, cfg, tp=None) -> dict:
    """The encoder's keys and values, enc_out [*, b, f, d] -> [*, b, f,
    hkv, hd] each; with ``tp`` and split kv heads the rank's, from the
    encoder output marked ``copy_to_model`` (every rank holds it whole),
    else whole (``cross_attn`` then takes the rank's share)."""
    src = (comm.copy_to_model(tp, enc_out)
           if _kv_split(cfg, _tp_heads(cfg, tp)) else enc_out)
    return {"k": _proj_heads(src, p["wk"]),
            "v": _proj_heads(src, p["wv"])}


def cross_attn(p, x, enc_kv, cfg, tp=None):
    """The decoder's queries x [*, b, t, d] over every encoder frame (no
    mask, no rope) -> [*, b, t, d]; ``tp``: the rank's heads
    (``cross_kv``'s with the same ``tp``), ``wo`` row-parallel and
    summed."""
    tp = _tp_heads(cfg, tp)
    q = _proj_heads(comm.copy_to_model(tp, x), p["wq"])
    k, v = _rank_kv(enc_kv["k"].to(q.dtype), enc_kv["v"].to(q.dtype), cfg,
                    tp)
    out = _attend(q, k, v, None)
    return comm.sum_model(tp, _merge_heads(out, p["wo"]))


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


def _write(cache: torch.Tensor, new: torch.Tensor, at: int, dim: int = -2,
           lo: int = 0, total: int | None = None) -> torch.Tensor:
    """cache with new (cast to the cache's dtype) at offset ``at`` along
    the length dim ``dim``; past the end raises ``ValueError``.  Where
    the cache is a rank's block of a split length (``lo`` its first
    global slot, ``total`` the global length) only the positions that
    fall in the block are written (the cache itself where none do)."""
    t, length = new.shape[dim], cache.shape[dim]
    total = length if total is None else total
    if at + t > total:
        raise ValueError(f"writing {t} positions at {at} overruns the "
                         f"cache's {total} (max_len)")
    a, b = max(at, lo), min(at + t, lo + length)
    if a >= b:
        return cache
    return torch.cat([cache.narrow(dim, 0, a - lo),
                      new.narrow(dim, a - at, b - a).to(cache.dtype),
                      cache.narrow(dim, b - lo, lo + length - b)], dim=dim)


def mla_attn(p, x, positions, cfg, *, cache=None, pos: int = 0,
             prefill: bool = False, tp=None, seq=None):
    """MLA: x [*, b, t, d] -> [*, b, t, d] without a cache (train mode);
    with one (``{"ckv": [b, L, r], "kr": [b, L, rope]}``,
    ``mla_cache_init``), (out, new_cache): ``prefill`` attends causally
    over the fresh tokens and writes their latents from slot 0, decode
    writes t tokens at ``pos`` (a host int) and attends over the cache
    through the absorbed keys, masking ``kj <= pos``.  ``tp``: the
    rank's heads, see the module docstring; the latent cache is whole on
    every model rank (``mla_cache_specs``).  ``seq``: the latent caches
    are the rank's blocks of a length split over its data ranks (the
    module docstring), the absorbed scores combined over them."""
    if tp is not None and cfg.n_heads % tp.model_shards:
        tp = None                           # the heads whole on every rank
    m = cfg.mla
    nope, rdim = m.qk_nope_head_dim, m.qk_rope_head_dim
    ql = comm.copy_to_model(tp, layers.rms_norm(
        p["qn"], layers.linear(x, p["wdq"]), cfg.norm_eps))
    q = _proj_heads(ql, p["wuq"])
    q_nope = q[..., :nope]
    q_rope = layers.rope(q[..., nope:], positions, cfg.rope_theta)
    ckv = comm.copy_to_model(tp, layers.rms_norm(
        p["kvn"], layers.linear(x, p["wdkv"]), cfg.norm_eps))   # [*, b,t,r]
    k_rope = comm.copy_to_model(tp, layers.rope(
        layers.linear(x, p["wkr"])[..., None, :], positions,
        cfg.rope_theta)[..., 0, :])                              # [*,b,t,rd]
    if cache is None or prefill:
        k_nope = _proj_heads(ckv, p["wuk"])
        v = _proj_heads(ckv, p["wuv"])
        k = torch.cat([k_nope, k_rope[..., None, :].expand(
            k_nope.shape[:-1] + (rdim,))], dim=-1)
        out = attend_causal(torch.cat([q_nope, q_rope], dim=-1), k, v)
        if cache is None:
            return comm.sum_model(tp, _merge_heads(out, p["wo"]))
    lo, total = _length_block(seq, cache["ckv"].shape[-2])
    if prefill:
        new_cache = {"ckv": _write(cache["ckv"], ckv, 0, -2, lo, total),
                     "kr": _write(cache["kr"], k_rope, 0, -2, lo, total)}
        return comm.sum_model(tp, _merge_heads(out, p["wo"])), new_cache
    cc = _write(cache["ckv"], ckv, pos, -2, lo, total)
    cr = _write(cache["kr"], k_rope, pos, -2, lo, total)
    q_abs = torch.einsum("bthk,rhk->bthr", q_nope, p["wuk"])
    scores = (torch.einsum("bthr,bsr->bhts", q_abs, cc.to(q_abs.dtype))
              + torch.einsum("bthk,bsk->bhts", q_rope,
                             cr.to(q_rope.dtype))).to(torch.float32)
    scores = scores / layers.scalar(scores, math.sqrt(nope + rdim))
    valid = lo + torch.arange(cc.shape[-2], device=x.device) <= pos
    scores = torch.where(valid, scores, layers.scalar(scores, NEG_INF))
    if seq is not None:
        o_lat = _split_softmax(scores, cc[:, None], seq).to(
            x.dtype).transpose(1, 2)
    else:
        w = torch.softmax(scores, dim=-1).to(x.dtype)
        o_lat = torch.einsum("bhts,bsr->bthr", w, cc.to(x.dtype))
    out = torch.einsum("bthr,rhk->bthk", o_lat, p["wuv"])
    return (comm.sum_model(tp, _merge_heads(out, p["wo"])),
            {"ckv": cc, "kr": cr})


def mla_cache_init(cfg, b: int, max_len: int) -> dict:
    """The shapes of one layer's latent cache and rope-key cache."""
    m = cfg.mla
    return {"ckv": (b, max_len, m.kv_lora_rank),
            "kr": (b, max_len, m.qk_rope_head_dim)}


def mla_cache_specs(cfg, model_shards: int, batch_axes,
                    len_axis=None) -> dict:
    """The latent cache's spec (the JAX ``mla_cache_specs``): split by
    the batch (and a length axis) only, whole on every model rank."""
    return {"ckv": (batch_axes, len_axis, None),
            "kr": (batch_axes, len_axis, None)}
