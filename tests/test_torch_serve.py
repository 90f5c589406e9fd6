"""Serving -- prefill and KV-cache decode -- against the JAX package, on
the CPU.

Both packages serve the JAX package's parameters (numpy, converted with
``params_from_numpy``) on the same prompts (numpy, from a seed); the JAX
side runs ``built.prefill`` and ``built.decode_step`` under ``jax.jit``,
as its example runs decode.  For every arch the port's ``models.build``
builds (the dense, vlm, moe, ssm and encdec smoke configs -- the hybrid
one's in ``tests/test_torch_hybrid.py``; a vlm's
requests carry patches and its ``max_len`` their slots):

  * prefill: the last position's logits within 1e-5 of the largest
    (float32 compute), and the cache: each float32 leaf (the xLSTM
    states) within 1e-4 of its largest (they come out of every earlier
    block's recurrence, position by position: the sLSTM's c and h, fed
    by the mLSTM blocks before it, carry 1.3e-5 after a 10-token prompt
    where the logits carry 6e-6), each bfloat16 leaf (k/v,
    whisper's ek/ev) within one bfloat16 ulp of JAX's (2^-7 of the
    value: a float32 value that differs in its last bits can round to
    the next bfloat16) plus that 1e-5 of the largest (the float32
    difference before the rounding, which near-cancelling small values
    carry); the dtypes and ``pos`` equal;
  * 3 decode steps, each from JAX's own cache (``cache_from_numpy``):
    bfloat16 caches turn float32 rounding differences into whole
    bfloat16 ulps, and xLSTM's trajectory is ill-conditioned, so no
    step inherits the port's earlier rounding.  The step runs twice:
    on the cache as JAX's prefill left it, where the attention rounds
    its softmax weights and output to the cache's bfloat16 (one rounding
    that differs moves the logits by up to about one bfloat16 ulp of the
    largest, 2^-8 of it), and on the same cache widened to float32,
    where the whole step is float32 and the logits must agree within
    1e-5.  The next caches as above.

Then the rolled window cache (gemma3's smoke window of 8) with
``max_len`` below, at and above it and prompts shorter and longer than
it; one case served in bfloat16; the port's own prefill/decode
consistency at the JAX test's 2e-2 (``tests/test_arch_smoke.py``); the
zero-copy views of ``launch.specs``; serving the flat state a
``run_training`` run leaves; the ``ValueError`` past ``max_len`` (where
JAX would clamp the write); the gather layout and a cache split by
length on one process; the serving requests; and the example, in a
subprocess.
"""
import dataclasses
import functools
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro_torch import configs, convert
from repro_torch.core import flatbuf, hier, pytree
from repro_torch.core.topology import Topology
from repro_torch.data import synthetic
from repro_torch.launch import specs
from repro_torch.launch.train import RunCfg, run_training
from repro_torch.models import build
from test_torch_lm import jax_params

ROOT = pathlib.Path(__file__).resolve().parents[1]
ARCHS = ("gemma3_1b", "gemma3_12b", "stablelm_3b", "mistral_large_123b",
         "xlstm_350m", "whisper_base", "internvl2_76b", "arctic_480b",
         "deepseek_v3_671b")
B = 2                          # requests
LOGITS_TOL = 1e-5              # of the largest |logit|: float32 serving
BF16_CACHE_LOGITS_TOL = 2.0 ** -8     # decode on the bfloat16 cache
BF16_SERVED_TOL = 2.0 ** -4    # bfloat16 weights and compute
BF16_ULP = 2.0 ** -7           # one bfloat16 ulp, relative, at most
STATE_TOL = 1e-4               # float32 cache leaves, of the largest
CPU = Topology(1, 1, "cpu")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for this module's small tensors (the suite
    runs several pytest workers on the machine's cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def models(arch):
    """(cfg, JAX params as numpy, jitted JAX prefill and decode_step, the
    port's built model) for an arch's smoke config."""
    jbuilt, p = jax_params(jconfigs.get_smoke(arch))
    cfg = configs.get_smoke(arch)
    return (cfg, p, jax.jit(jbuilt.prefill, static_argnums=2),
            jax.jit(jbuilt.decode_step), build.build_model(cfg, CPU))


def requests(cfg, n_tokens: int, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab,
                                    (B, n_tokens)).astype(np.int32)}
    if cfg.encoder_layers:
        batch["frames"] = (0.1 * rng.standard_normal(
            (B, cfg.encoder_frames, cfg.frontend_dim))).astype(np.float32)
    if cfg.n_patches:
        batch["patches"] = (0.02 * rng.standard_normal(
            (B, cfg.n_patches, cfg.d_model))).astype(np.float32)
    return batch


def torch_batch(batch: dict) -> dict:
    out = {k: torch.from_numpy(v) for k, v in batch.items()}
    out["tokens"] = out["tokens"].long()
    return out


def close(got: torch.Tensor, want, tol: float, what: str):
    """|got - want| <= tol * max |want|."""
    want = np.asarray(want, np.float32)
    err = float(np.abs(got.float().numpy() - want).max())
    assert err <= tol * float(np.abs(want).max()), (what, err)


def check_cache(got: dict, want, what: str, tol: float | None = None):
    """The port's cache against JAX's: pos, the tree, the dtypes; float32
    leaves within STATE_TOL of their largest, bfloat16 leaves within one
    bfloat16 ulp and LOGITS_TOL of their largest (with ``tol``, every
    leaf within it of its largest)."""
    assert got["pos"] == int(want["pos"]), what
    g_leaves, g_td = pytree.tree_flatten(got["stacks"])
    w_leaves, w_td = jax.tree.flatten(want["stacks"])
    assert len(g_leaves) == len(w_leaves), what
    for g, w in zip(g_leaves, w_leaves):
        assert str(g.dtype).split(".")[-1] == w.dtype.name, (what, g.dtype)
        assert tuple(g.shape) == w.shape, (what, g.shape, w.shape)
        w = np.asarray(w, np.float32)
        if tol is not None:
            close(g, w, tol, what)
        elif g.dtype == torch.bfloat16:
            np.testing.assert_allclose(
                g.float().numpy(), w, rtol=BF16_ULP,
                atol=LOGITS_TOL * float(np.abs(w).max()), err_msg=what)
        else:
            close(g, w, STATE_TOL, what)


def widened(cache):
    """A JAX cache with its floating leaves cast to float32."""
    return jax.tree.map(
        lambda a: a.astype(jnp.float32)
        if jnp.issubdtype(a.dtype, jnp.floating) else a, cache)


def serve_both(arch: str, prompt: int, max_len: int, steps: int = 3,
               dtype=None, seed: int = 1):
    """Prefill a prompt of B x ``prompt`` tokens and decode ``steps``
    more in both packages, each step from JAX's cache, checking as the
    module docstring says (``dtype``: serve the weights in it)."""
    cfg, p, jprefill, jdecode, built = models(arch)
    if dtype is not None:
        p = jax.tree.map(lambda a: np.asarray(jnp.asarray(a).astype(
            jnp.bfloat16)), p)
    tp = convert.params_from_numpy(p)
    batch = requests(cfg, prompt + steps, seed)
    tokens = batch["tokens"]
    batch["tokens"] = tokens[:, :prompt]
    jl, jc = jprefill(p, jax.tree.map(jnp.asarray, batch), max_len)
    tl, tc = built.prefill(tp, torch_batch(batch), max_len)
    assert tl.shape == (B, 1, cfg.vocab) and tl.dtype == tp["embed"][
        "table"].dtype
    served = BF16_SERVED_TOL if dtype is not None else None
    close(tl, jl, served or LOGITS_TOL, f"{arch} prefill logits")
    check_cache(tc, jc, f"{arch} prefill cache", served)
    for s in range(steps):
        tok = tokens[:, prompt + s:prompt + s + 1]
        has_bf16 = any(a.dtype == jnp.bfloat16
                       for a in jax.tree.leaves(jc["stacks"]))
        runs = [(jc, BF16_CACHE_LOGITS_TOL if has_bf16 else LOGITS_TOL)]
        if has_bf16 and dtype is None:
            runs.append((widened(jc), LOGITS_TOL))
        for k, (src, ltol) in enumerate(runs):
            jl, jnext = jdecode(p, src, jnp.asarray(tok))
            tl, tnext = built.decode_step(
                tp, convert.cache_from_numpy(jax.tree.map(np.asarray, src)),
                torch.from_numpy(tok).long())
            what = f"{arch} decode {s} ({'float32' if k else 'as served'})"
            close(tl, jl, served or ltol, what + " logits")
            assert bool(torch.isfinite(tl).all()), what
            check_cache(tnext, jnext, what + " cache", served)
            if k == 0:
                jc = jnext
    return tc


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_matches_jax(arch):
    """max_len 16 and a vlm's patch slots."""
    serve_both(arch, prompt=10, max_len=16 + configs.get_smoke(
        arch).n_patches)


@pytest.mark.parametrize("max_len,prompt", [
    (6, 3),      # cache below the window: offsets, window mask
    (8, 5),      # at the window: rolled, prompt shorter
    (16, 5),     # above: local layers rolled, global at offsets
    (12, 8),     # prompt as long as the window
    (16, 12),    # prompt longer than the window: the last 8 kept
])
def test_rolled_window_cache(max_len, prompt):
    serve_both("gemma3_1b", prompt=prompt, max_len=max_len)


def test_xlstm_one_token_prompt_takes_the_recurrent_step():
    """A one-token prompt: the mLSTM's recurrent step from the zero
    state (m = 0), not the parallel form."""
    serve_both("xlstm_350m", prompt=1, max_len=4)


def test_bf16_served_matches_jax():
    serve_both("gemma3_1b", prompt=10, max_len=16, dtype=jnp.bfloat16)


def test_prefill_decode_consistency():
    """The port alone: decoding token 16 after a prefill of 15 gives the
    logits of a prefill of all 16 (the JAX package's test and its
    2e-2), through the window layers' caches."""
    cfg, p, _, _, built = models("gemma3_1b")
    tp = convert.params_from_numpy(p)
    toks = torch.from_numpy(np.random.default_rng(9).integers(
        0, cfg.vocab, (1, 16)))
    _, cache = built.prefill(tp, {"tokens": toks[:, :15]}, max_len=20)
    dec, cache = built.decode_step(tp, cache, toks[:, 15:16])
    full, _ = built.prefill(tp, {"tokens": toks}, max_len=20)
    assert cache["pos"] == 16
    np.testing.assert_allclose(dec[:, -1].numpy(), full[:, -1].numpy(),
                               rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("arch", ["arctic_480b", "deepseek_v3_671b"])
def test_moe_decode_is_not_prefill_consistent_in_both_packages(arch):
    """The MoE's capacity is reckoned from the tokens of the call, in both
    packages.  Two identical requests decoded together (2 tokens, a
    capacity of 1 an expert) share their experts, so the second's routed
    pairs drop and its logits leave the first's by more than 2e-2 of the
    largest; and the decode step is not the one-longer prefill (whose
    capacity comes from 22 tokens) within the dense family's 2e-2 --
    the reference's behaviour (ROADMAP queue 3); the port's numbers are
    JAX's (``test_serve_matches_jax``)."""
    cfg, p, jprefill, jdecode, built = models(arch)
    tp = convert.params_from_numpy(p)
    row = np.random.default_rng(1).integers(0, cfg.vocab, (1, 11))
    toks = np.repeat(row, B, axis=0).astype(np.int32)
    for prefill, decode, params, wrap, to_np in (
            (jprefill, jdecode, p, jnp.asarray, np.asarray),
            (built.prefill, built.decode_step, tp, torch.from_numpy,
             lambda x: x.float().numpy())):
        _, cache = prefill(params, {"tokens": wrap(toks[:, :10])}, 16)
        dec, _ = decode(params, cache, wrap(toks[:, 10:11]))
        full, _ = prefill(params, {"tokens": wrap(toks)}, 16)
        dec, full = to_np(dec)[:, 0], to_np(full)[:, 0]
        scale = float(np.abs(full).max())
        assert float(np.abs(dec[1] - dec[0]).max()) > 2e-2 * scale
        assert float(np.abs(dec - full).max()) > 2e-2 * scale


def test_decode_past_max_len_raises():
    """The offset cache refuses a write past its end (JAX's
    ``dynamic_update_slice`` clamps it into the last slot)."""
    cfg, p, _, _, built = models("gemma3_1b")
    tp = convert.params_from_numpy(p)
    toks = torch.from_numpy(requests(cfg, 6, 3)["tokens"]).long()
    _, cache = built.prefill(tp, {"tokens": toks[:, :5]}, max_len=6)
    _, cache = built.decode_step(tp, cache, toks[:, 5:6])      # slot 5: ok
    with pytest.raises(ValueError, match="max_len"):
        built.decode_step(tp, cache, toks[:, 5:6])
    with pytest.raises(ValueError, match="max_len"):
        built.prefill(tp, {"tokens": toks}, max_len=4)


def test_cache_round_trips_through_numpy():
    cfg, p, jprefill, _, built = models("whisper_base")
    _, jc = jprefill(p, jax.tree.map(jnp.asarray, requests(cfg, 4, 2)), 8)
    c = convert.cache_from_numpy(jax.tree.map(np.asarray, jc))
    assert isinstance(c["pos"], int) and c["pos"] == 4
    assert c["stacks"]["dec"]["ek"].dtype == torch.bfloat16
    back = convert.cache_to_numpy(c)
    assert back["pos"].dtype == np.int32 and int(back["pos"]) == 4
    empty = pytree.tree_flatten(built.make_cache(B, 8)["stacks"])[0]
    for a, b, e in zip(jax.tree.leaves(jc["stacks"]),
                       jax.tree.leaves(back["stacks"]), empty):
        np.testing.assert_array_equal(np.asarray(a, np.float32), b)
        assert a.shape == tuple(e.shape) and e.dtype == torch.bfloat16


def test_make_cache_is_zeros_like_jax():
    """Every leaf zero, the sLSTM's n too (JAX's make_cache takes the
    slices' shapes alone), in bfloat16."""
    cfg, _, _, _, built = models("xlstm_350m")
    cache = built.make_cache(3, 5)
    assert cache["pos"] == 0
    for leaf in pytree.tree_flatten(cache["stacks"])[0]:
        assert leaf.dtype == torch.bfloat16 and not bool(leaf.any())
    assert cache["stacks"]["slstm"]["n"].shape == (
        2, 3, cfg.n_heads, cfg.d_model // cfg.n_heads)


def test_serve_params_from_flat_is_zero_copy():
    cfg = configs.get_smoke("gemma3_1b")
    built = build.build_model(cfg, CPU)
    tree = built.init_params(torch.Generator().manual_seed(0))
    fs = flatbuf.from_tree(pytree.tree_map(
        lambda v: torch.stack([v, v + 1.0]), tree), batch_dims=1)
    assert fs.buf.shape == (2, fs.layout.n_pad)
    ptr = fs.buf.untyped_storage().data_ptr()
    views = specs.serve_params_from_flat(built, fs)
    for got, want in zip(pytree.tree_flatten(views)[0],
                         pytree.tree_flatten(tree)[0]):
        assert got.untyped_storage().data_ptr() == ptr
        assert torch.equal(got, want)                        # edge 0
    first = pytree.tree_flatten(views)[0][0]
    fs.buf[0, 0] += 1.0                                      # aliased
    assert first.reshape(-1)[0] == fs.buf[0, 0]
    fs.buf[0, 0] -= 1.0
    cast = specs.serve_params_from_flat(built, fs, dtype=torch.bfloat16)
    for got, want in zip(pytree.tree_flatten(cast)[0],
                         pytree.tree_flatten(tree)[0]):
        assert got.dtype == torch.bfloat16
        assert got.untyped_storage().data_ptr() != ptr
        assert torch.equal(got, want.to(torch.bfloat16))
    meta = specs.serve_params_abstract(built)
    for got, want in zip(pytree.tree_flatten(meta)[0],
                         pytree.tree_flatten(tree)[0]):
        assert got.device.type == "meta" and got.dtype == torch.bfloat16
        assert got.shape == want.shape
    other = flatbuf.from_tree({"w": torch.zeros(3)})
    with pytest.raises(ValueError, match="layout"):
        specs.serve_params_from_flat(built, other)


def test_serving_the_flat_state_a_training_run_leaves():
    """run_training on fused/flat at P=2 edges, then edge 0 of its [P,
    n_pad] master served as views: finite logits, bitwise those of its
    unflattened tree."""
    cfg = configs.get_smoke("gemma3_1b")
    topo = Topology(2, 1, "cpu")
    algo = hier.AlgoConfig(method="dc_hier_signsgd", mu=1e-3, rho=0.2,
                           t_e=2, transport="fused", state_layout="flat",
                           compute_dtype=torch.float32)
    state, _ = run_training(cfg, topo, algo,
                            RunCfg(steps=4, batch_per_device=2, seq_len=16,
                                   log_every=100), log=lambda _: None)
    assert isinstance(state.params, flatbuf.FlatState)
    built = build.build_model(cfg, topo)
    views = specs.serve_params_from_flat(built, state.params)
    tree = pytree.tree_map(lambda a: a[0].clone(), hier.edge_params(state))
    batch = torch_batch(requests(cfg, 12, 4))
    lv, cv = built.prefill(views, batch, max_len=16)
    lt, ct = built.prefill(tree, batch, max_len=16)
    assert bool(torch.isfinite(lv).all())
    assert torch.equal(lv, lt)
    tok = torch.argmax(lv, dim=-1)
    assert torch.equal(built.decode_step(views, cv, tok)[0],
                       built.decode_step(tree, ct, tok)[0])


def test_unported_serving_raises():
    """What item 17d, part two refused now serves.  gemma3-12b whole
    passes the budget at M = 1, so it builds in the gather layout; its
    smoke config set to FSDP serves in that layout (one process: the
    gather is the identity) bitwise its resident serve, and one request
    on a cache split by length (``len_axis="data"``: whole on one
    process) bitwise the unsplit one; the caches' specs are JAX's.  What
    still raises is a ``ValueError``: a split length with more than one
    request, or the replicated rows with more."""
    gemma12 = build.build_model(configs.get_config("gemma3_12b"), CPU)
    n = build.param_count(gemma12.abstract_params())
    assert build.serve_layout(gemma12.cfg, CPU, n) == "gather" \
        == gemma12.serve_layout
    from repro.models import build as jbuild
    jarch = jbuild.make_archdef(jconfigs.get_config("gemma3_12b"), 1)
    want = jax.tree.map(tuple, jbuild.cache_specs(jarch, "data", "data"),
                        is_leaf=lambda v: isinstance(v, jax.sharding
                                                     .PartitionSpec))
    assert build.cache_specs(gemma12.arch, "data", "data") == want
    cfg = dataclasses.replace(configs.get_smoke("gemma3_12b"),
                              param_mode="fsdp")
    gather = build.build_model(cfg, CPU, layout="gather")
    resident = build.build_model(cfg, CPU, layout="resident")
    assert gather.serve_layout == "gather"
    assert isinstance(build.ServeGatherPlan(cfg, CPU, {}),
                      build.ServeGatherPlan)
    params = gather.init_params(torch.Generator().manual_seed(0))
    batch = torch_batch(requests(cfg, 6, 2))
    lg, cg = gather.prefill(params, batch, 10)
    lr, cr = resident.prefill(params, batch, 10)
    assert torch.equal(lg, lr)
    tok = torch.argmax(lg, dim=-1)
    assert torch.equal(gather.decode_step(params, cg, tok)[0],
                       resident.decode_step(params, cr, tok)[0])
    one = {k: v[:1] for k, v in batch.items()}
    prefill, decode = build.make_serve_fns(gather.arch, CPU, "gather",
                                           rows="replicated",
                                           len_axis="data")
    ls, cs = prefill(params, one, 10)
    lr, cr = resident.prefill(params, one, 10)
    assert torch.equal(ls, lr)
    for a, b in zip(pytree.tree_flatten(cs["stacks"])[0],
                    pytree.tree_flatten(cr["stacks"])[0]):
        assert torch.equal(a, b)
    assert torch.equal(decode(params, cs, tok[:1])[0],
                       resident.decode_step(params, cr, tok[:1])[0])
    split = gather.make_cache(1, 8, len_axis="data")
    assert split["stacks"]["global"]["self"]["k"].shape[2] == 8
    with pytest.raises(ValueError, match="one request"):
        gemma12.make_cache(2, 8, len_axis="data")
    with pytest.raises(ValueError, match="one request"):
        prefill(params, batch, 10)
    cfg1 = configs.get_config("gemma3_1b")
    assert build.serve_layout(cfg1, CPU, 10**12) == "resident"


def test_serve_request_batch():
    cfg = configs.get_smoke("whisper_base")
    scfg = synthetic.LMStreamCfg(vocab=cfg.vocab, seq_len=4,
                                 batch_per_device=1, pods=1,
                                 devices_per_pod=1,
                                 frames=cfg.encoder_frames,
                                 frontend_dim=cfg.frontend_dim)
    a = synthetic.serve_request_batch(scfg, 3, 7)
    b = synthetic.serve_request_batch(scfg, 3, 7)
    c = synthetic.serve_request_batch(scfg, 3, 7, seed=18)
    assert a["tokens"].shape == (3, 7) and a["tokens"].dtype == torch.long
    assert int(a["tokens"].min()) >= 0 and int(a["tokens"].max()) < cfg.vocab
    assert a["frames"].shape == (3, cfg.encoder_frames, cfg.frontend_dim)
    assert torch.equal(a["tokens"], b["tokens"])
    assert torch.equal(a["frames"], b["frames"])
    assert not torch.equal(a["tokens"], c["tokens"])
    plain = dataclasses.replace(scfg, frames=0)
    assert set(synthetic.serve_request_batch(plain, 2, 3)) == {"tokens"}


def test_serve_decode_example_prints_ok():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.examples.serve_decode",
         "--device", "cpu"], env=env, capture_output=True, text=True,
        timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.rstrip().endswith("OK"), out.stdout
