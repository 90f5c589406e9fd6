"""The hybrid family (zamba2: Mamba2 blocks, the chunked SSD scan and the
tied shared-attention block) against the JAX package, on the CPU.

The modules on the same float32 inputs (numpy, from a seed) and the same
parameters (the JAX package's initialisers, converted, the norm gains
made nonzero): ``ssm.ssd_chunked`` and its final state with t a multiple
of the chunk, ragged and shorter than one chunk; ``mamba2_block`` in
train, prefill (from make_cache's bfloat16 zeros) and decode (from a
float32 state); ``blocks.mamba_block`` with [2, 3] leading replica dims,
each replica equal to its own JAX call; all within 1e-5 of the largest
output (the products and the cumulative sums summed in other orders).
In bfloat16 the block keeps the compute dtype within a few bfloat16
ulps of JAX's (2e-2 of the largest).

The model on zamba2's smoke config (6 layers, d 64, chunk 16, the
shared block every 3 layers, so twice): the loss and gradients against
JAX ``make_loss_single``.  Its SSD scan overflows ``exp(seg_i -
seg_j)`` above the diagonal, and ``where``'s VJP gives NaN there (ROADMAP
queue 3): the NaN positions must equal JAX's leaf for leaf and the
finite values agree within 1e-5.  With ``a_log`` lowered so that no
chunk overflows, every gradient is finite and agrees, and the shared
block's gradient is the sum of what its two occurrences give as
separate layers.  Then 4 steps against JAX ``make_hier_step`` (the rule
of ``tests/test_torch_lm_step.py``), fused/flat bitwise ag_packed/tree
at P=2 x D=3, the FSDP regime against JAX's and bitwise the replicated
regime with the shared block's leaves voted once a step, serving
against JAX's ``prefill``/``decode_step`` (caches and their dtypes
included) and against the port's own longer prefill, and the
conversions of the tree with its unstacked tied leaves.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core import hier as jhier
from repro.core.topology import single_device_topology
from repro.models import blocks as jblocks
from repro.models import build as jbuild
from repro.models import ssm as jssm
from repro_torch import configs, convert
from repro_torch.convert import params_from_numpy
from repro_torch.core import device_axis, flatbuf, hier, pytree
from repro_torch.core.topology import Topology
from repro_torch.launch import specs
from repro_torch.launch.train import RunCfg, run_training
from repro_torch.models import blocks, build, engine, ssm
from test_torch_lm_families import (assert_near_jax, close, jparams,
                                    per_replica)
from test_torch_lm_layers import rand, t
from test_torch_serve import models, serve_both

ARCH = "zamba2_2p7b"
CFG, JCFG = configs.get_smoke(ARCH), jconfigs.get_smoke(ARCH)
CPU = Topology(1, 1, "cpu")
MU, RHO = 1e-3, 0.2
SHARED = "shared_attn"


def jax_tree():
    """The JAX package's smoke parameters (seed 0) as numpy -- the serving
    tests' (``test_torch_serve.models``), made once -- in a fresh copy of
    the dicts (the leaves are shared, never written)."""
    return jax.tree.map(lambda a: a, models(ARCH)[1])


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for this module's small tensors (the suite runs
    several pytest workers on the machine's cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -- the modules --------------------------------------------------------------

def ssd_args(t_len, seed, heads=3, p=8, n=4):
    """xh, B, C, dt (softplus of normals) and the log-decay dt * a, a
    from -1 to -16 as zamba2's heads have it."""
    rng = np.random.default_rng(seed)
    dt = np.log1p(np.exp(rng.standard_normal((2, t_len, heads)))
                  ).astype(np.float32)
    a = -np.linspace(1.0, 16.0, heads).astype(np.float32)
    return (rand((2, t_len, heads, p), seed + 1),
            rand((2, t_len, heads, n), seed + 2),
            rand((2, t_len, heads, n), seed + 3), dt, dt * a)


@pytest.mark.parametrize("t_len", [16, 21, 5],
                         ids=["chunk-multiple", "ragged", "short"])
def test_ssd_chunked_matches_jax(t_len):
    """Chunk 8: y and the final state [b, H, p, n] (the decode layout)
    within 1e-5 of JAX's largest; with [2, 3] replica dims, each replica
    its own JAX call."""
    a = ssd_args(t_len, t_len)
    y, final = ssm.ssd_chunked(*map(t, a), 8)
    jssd = jax.jit(lambda *xs: jssm._ssd_chunked(*xs, 8))
    jy, jfinal = jssd(*a)
    assert y.shape == jy.shape and final.shape == jfinal.shape == (
        2, 3, 8, 4)
    close(y, jy, 1e-5)
    close(final, jfinal, 1e-5)
    per_replica(lambda *xs: jssd(*xs)[0],
                lambda *xs: ssm.ssd_chunked(*xs, 8)[0],
                lambda i: ssd_args(t_len, 100 + i), 1e-5)


def mamba_params(seed=0):
    return jparams(lambda key: jssm.init_mamba2(key, JCFG), seed)


@pytest.mark.parametrize("mode", ["train", "prefill", "decode"])
def test_mamba2_block_matches_jax(mode):
    """x [2, 24, 64] (a chunk and a ragged half) in train and prefill mode
    (prefill from make_cache's bfloat16 zeros: the final SSM state
    float32, the conv state in x's dtype), x [2, 1, 64] at decode from a
    float32 state: y and the state within 1e-5 of JAX's largest."""
    p = mamba_params()
    x = rand((2, 1 if mode == "decode" else 24, CFG.d_model), 3)
    shapes = ssm.mamba2_state_init(CFG, 2)
    jblock = jax.jit(lambda pp, xx, st: jssm.mamba2_block(pp, xx, JCFG,
                                                          state=st))
    if mode == "train":
        close(ssm.mamba2_block(params_from_numpy(p), t(x), CFG),
              jblock(p, x, None)[0], 1e-5)
        return
    if mode == "prefill":
        state = {k: np.zeros(s, np.float32) for k, s in shapes.items()}
        jstate = {k: jnp.zeros(s, jnp.bfloat16) for k, s in shapes.items()}
        tstate = {k: torch.zeros(s, dtype=torch.bfloat16)
                  for k, s in shapes.items()}
    else:
        state = {k: rand(s, 5 + i, 0.5)
                 for i, (k, s) in enumerate(shapes.items())}
        jstate, tstate = state, {k: t(v) for k, v in state.items()}
    jy, jnew = jblock(p, x, jstate)
    y, new = ssm.mamba2_block(params_from_numpy(p), t(x), CFG, state=tstate)
    close(y, jy, 1e-5)
    for k in ("ssm", "conv"):
        assert new[k].dtype == torch.float32 and jnew[k].dtype == jnp.float32
        assert new[k].shape == jnew[k].shape
        close(new[k], jnew[k], 1e-5)


def test_mamba_block_per_replica():
    """The mamba block (norm, mixer, residual) on [2, 3] replicas, each
    with its own parameters and input, against JAX's block on each."""
    jb, tb = jblocks.mamba_block(JCFG, 0), blocks.mamba_block(CFG)
    pos = np.arange(24, dtype=np.int32)

    @jax.jit
    def jfn(pp, x):
        ctx = jblocks.Ctx(JCFG, "train", positions=jnp.asarray(pos))
        return jb.apply(pp, x, ctx, None)[0]

    def tfn(pp, x):
        return tb.apply(pp, x, blocks.Ctx(CFG, positions=t(pos)))[0]

    per_replica(jfn, tfn, lambda i: (jparams(jb.init, i),
                                     rand((2, 24, CFG.d_model), 40 + i)),
                1e-5)


def test_bf16_mamba_block_keeps_the_compute_dtype():
    """Parameters and input in bfloat16: bfloat16 out, within 2e-2 of
    JAX's largest (dt, the scan and the decode state stay float32)."""
    jb, tb = jblocks.mamba_block(JCFG, 0), blocks.mamba_block(CFG)
    bf = jnp.bfloat16
    p, x = jparams(jb.init, 3), rand((2, 24, CFG.d_model), 4)
    pos = np.arange(24, dtype=np.int32)
    want = jax.jit(lambda pp, xx: jb.apply(
        pp, xx, jblocks.Ctx(JCFG, "train", positions=jnp.asarray(pos)),
        None)[0])(jax.tree.map(lambda a: jnp.asarray(a, bf), p),
                  jnp.asarray(x, bf))
    got = tb.apply(pytree.tree_map(lambda a: a.to(torch.bfloat16),
                                   params_from_numpy(p)),
                   t(x).to(torch.bfloat16),
                   blocks.Ctx(CFG, positions=t(pos)))[0]
    assert want.dtype == bf and got.dtype == torch.bfloat16
    close(got.float(), np.asarray(want.astype(jnp.float32)), 2e-2)


# -- the model ----------------------------------------------------------------

def test_archdef_and_tree():
    """Two periods of 3 Mamba2 blocks and the tied block; the tied leaves
    unstacked; the JAX tree converts leaf for leaf, bitwise; every
    config of the hybrid family builds."""
    arch = build.make_archdef(CFG)
    assert [(s.layout, s.repeats, s.tied) for s in arch.segments] == [
        ((("mamba", 3), (SHARED, 1)), 2, frozenset({SHARED}))]
    assert build.occurrence_counts(arch.segments) == {"mamba": 6, SHARED: 2}
    assert engine.stack_counts(arch.segments) == {"mamba": 6, SHARED: 0}
    p = jax_tree()
    got = params_from_numpy(p)
    want = build.build_model(CFG, CPU).abstract_params()
    leaves, td = pytree.tree_flatten(got)
    assert td == pytree.tree_flatten(want)[1]
    for a, w, (path, j) in zip(leaves, pytree.tree_flatten(want)[0],
                               jax.tree_util.tree_leaves_with_path(p)):
        assert a.shape == w.shape and np.array_equal(a.numpy(), j), path
    assert got["stacks"][SHARED]["attn"]["wq"].shape == (
        CFG.d_model, CFG.n_heads, CFG.hd)
    full = build.make_archdef(configs.get_config(ARCH))
    assert [(s.repeats, s.layout) for s in full.segments] == [
        (9, (("mamba", 6), (SHARED, 1)))]
    assert build.occurrence_counts(full.segments) == {"mamba": 54,
                                                      SHARED: 9}


def loss_and_grads(cfg, jcfg, p, tokens):
    """(JAX loss, JAX gradient leaves, port loss, port gradient leaves)
    at [1, 1] copies, float32."""
    jbuilt = jbuild.build_model(jcfg, single_device_topology())
    loss_fn = jbuild.make_loss_single(jbuilt.arch)
    want, jg = jax.jit(jax.value_and_grad(
        lambda pp: loss_fn(pp, {"tokens": jnp.asarray(tokens)}, None)))(p)
    built = build.build_model(cfg, CPU)
    leaves, td = pytree.tree_flatten(params_from_numpy(p))
    copies = [a[None, None].clone().requires_grad_(True) for a in leaves]
    loss = built.bundle.loss(pytree.tree_unflatten(td, copies),
                             {"tokens": t(tokens).long()[None, None]})
    grads = torch.autograd.grad(loss.sum(), copies)
    return (float(want), [np.asarray(g) for g in jax.tree.leaves(jg)],
            float(loss.detach()[0, 0]), [g[0, 0] for g in grads])


@pytest.fixture(scope="module")
def smoke_grads():
    p = jax_tree()
    tokens = np.random.default_rng(1).integers(
        0, CFG.vocab, (2, 64)).astype(np.int32)
    return loss_and_grads(CFG, JCFG, p, tokens)


def test_loss_and_nan_gradients_match_jax(smoke_grads):
    """2 x 64 tokens (4 chunks): the loss within 1e-5; every gradient
    leaf's NaN positions those of JAX's, which leave only the head's
    finite (the overflow is there), and the finite values within 1e-5."""
    want, jgrads, got, grads = smoke_grads
    np.testing.assert_allclose(got, want, atol=1e-5)
    assert np.isfinite(got)
    names = [jax.tree_util.keystr(k) for k, _ in
             jax.tree_util.tree_leaves_with_path(jax_tree())]
    nan_leaves = []
    for name, g, jg in zip(names, grads, jgrads):
        nan = np.isnan(jg)
        assert np.array_equal(np.isnan(g.numpy()), nan), name
        assert not np.isinf(jg).any() and not torch.isinf(g).any()
        np.testing.assert_allclose(g.numpy()[~nan], jg[~nan], rtol=0,
                                   atol=1e-5, err_msg=name)
        if nan.any():
            nan_leaves.append(name)
    assert len(nan_leaves) == len(names) - 2
    assert not any("head" in n for n in nan_leaves)


def calm(p):
    """The tree with every Mamba2 block's a_log lowered by 3 (a from
    -0.05 to -0.8 in place of -1 to -16): |seg_i - seg_j| stays far below
    exp's overflow in a chunk of 16."""
    out = jax.tree.map(lambda x: x, p)
    mixer = out["stacks"]["mamba"]["mamba"]
    mixer["a_log"] = mixer["a_log"] - np.float32(3.0)
    return out


def untied(cfg):
    """zamba2's schedule with the shared block as two layers of their
    own (the stack of two copies of the tied tree)."""
    arch = build.make_archdef(cfg)
    seg = arch.segments[0]
    return dataclasses.replace(arch, segments=[
        engine.Segment(seg.layout, seg.repeats)])


def test_overflow_free_gradients_match_jax_and_sum_the_occurrences():
    """a_log lowered (:func:`calm`): every gradient leaf finite and within
    3e-5 of max(1, its largest |gradient|) of JAX's.  With slow decay
    the state sums most of the 64 positions and the gradients reach 15
    (the embedding's); on this input JAX's own op-by-op gradients
    (``jax.disable_jit``) differ from its jitted ones by up to 6e-6 of
    that scale, and the port's by up to 1.1e-5 from either.  The tied
    block's gradient is the sum of the gradients its two occurrences get
    when they are separate layers with the same parameters."""
    p = calm(jax_tree())
    tokens = np.random.default_rng(1).integers(
        0, CFG.vocab, (2, 64)).astype(np.int32)
    want, jgrads, got, grads = loss_and_grads(CFG, JCFG, p, tokens)
    np.testing.assert_allclose(got, want, atol=1e-5)
    for g, jg in zip(grads, jgrads):
        assert np.isfinite(jg).all() and bool(torch.isfinite(g).all())
        np.testing.assert_allclose(
            g.numpy(), jg, rtol=0,
            atol=3e-5 * max(1.0, float(np.abs(jg).max())))
    tp = params_from_numpy(p)
    tp["stacks"][SHARED] = pytree.tree_map(
        lambda a: torch.stack([a, a]), tp["stacks"][SHARED])
    leaves, td = pytree.tree_flatten(tp)
    copies = [a[None, None].clone().requires_grad_(True) for a in leaves]
    loss = build.make_loss(untied(CFG))(
        pytree.tree_unflatten(td, copies),
        {"tokens": t(tokens).long()[None, None]})
    assert float(loss.detach()[0, 0]) == got
    sep = pytree.tree_unflatten(td, [g[0, 0] for g in torch.autograd.grad(
        loss.sum(), copies)])
    tied = pytree.tree_unflatten(pytree.tree_flatten(
        params_from_numpy(p))[1], grads)
    for a, b in zip(pytree.tree_flatten(tied["stacks"][SHARED])[0],
                    pytree.tree_flatten(sep["stacks"][SHARED])[0]):
        assert float(b[0].abs().max()) > 0 and float(b[1].abs().max()) > 0
        torch.testing.assert_close(a, b[0] + b[1], rtol=0, atol=1e-7)


# -- the step -----------------------------------------------------------------

def jax_trajectory(jcfg, p, tokens):
    """JAX's 4 steps (2 rounds of T_E=2) of DC at P = D = 1, float32: the
    final edge models as numpy leaves."""
    jbuilt = jbuild.build_model(jcfg, single_device_topology())
    algo = jhier.AlgoConfig(method="dc_hier_signsgd", mu=MU, rho=RHO, t_e=2,
                            compute_dtype=jnp.float32,
                            delta_dtype=jnp.float32)
    init_fn, step = jhier.make_hier_step(single_device_topology(), algo,
                                         jbuilt.bundle)
    state = jax.jit(init_fn)(p, jax.random.PRNGKey(1))
    jstep = jax.jit(step)
    ones = jnp.ones((1, 1))
    for s in range(4):
        state, _ = jstep(state, {"train": {"tokens": tokens[s]}},
                         jnp.ones(1), ones, ones)
    return jax.tree.leaves(jax.tree.map(np.asarray, state.params))


def port_trajectory(cfg, p, tokens, transport, layout="tree"):
    built = build.build_model(cfg, CPU)
    algo = hier.AlgoConfig(method="dc_hier_signsgd", mu=MU, rho=RHO, t_e=2,
                           transport=transport, state_layout=layout,
                           compute_dtype=torch.float32,
                           delta_dtype=torch.float32)
    init_fn, step = hier.make_hier_step(CPU, algo, built.bundle)
    state = init_fn(params_from_numpy(p))
    for s in range(4):
        state, metrics = step(state, {"train": {"tokens": t(
            tokens[s]).long()}}, torch.ones(1), torch.ones(1, 1),
            torch.ones(1, 1))
        assert bool(torch.isfinite(metrics["loss"]))
    return [x.clone() for x in pytree.tree_flatten(
        hier.edge_params(state))[0]]


def step_tokens():
    return np.random.default_rng(2).integers(
        0, CFG.vocab, (4, 1, 1, 2, 16)).astype(np.int32)


@pytest.mark.parametrize("mode", ["replicated", "fsdp"])
def test_step_matches_jax_make_hier_step(mode):
    """4 steps at P = D = 1 on the smoke config, the NaN gradients voting
    -1 in both packages: within 2*mu of JAX's edge models, at most 0.1 %
    of the coordinates past 1e-6; replicated fused/flat bitwise
    ag_packed/tree, FSDP fused bitwise ag_packed."""
    cfg = dataclasses.replace(CFG, param_mode=mode)
    jcfg = dataclasses.replace(JCFG, param_mode=mode)
    p = jax_tree()
    tokens = step_tokens()
    want = jax_trajectory(jcfg, p, tokens)
    routes = ((("fused", "flat"), ("ag_packed", "tree")) if mode ==
              "replicated" else (("fused", "tree"), ("ag_packed", "tree")))
    runs = [port_trajectory(cfg, p, tokens, *r) for r in routes]
    for a, b in zip(*runs):
        assert torch.equal(a, b)
    assert_near_jax(runs[0], want)
    moved = sum(float(np.abs(w - x).sum()) for w, x in
                zip(want, jax.tree.leaves(p)))
    assert moved > 0


def p2d3(cfg, transport, layout, compute=torch.bfloat16, steps=4):
    algo = hier.AlgoConfig(method="dc_hier_signsgd", mu=MU, rho=RHO, t_e=2,
                           transport=transport, state_layout=layout,
                           compute_dtype=compute, delta_dtype=compute)
    state, hist = run_training(
        cfg, Topology(2, 3, "cpu"), algo,
        RunCfg(steps=steps, batch_per_device=1, seq_len=32, log_every=0),
        log=lambda line: None)
    assert all(np.isfinite(h["loss"]) for h in hist)
    return [x.clone() for x in pytree.tree_flatten(
        hier.edge_params(state))[0]]


def test_layouts_and_transports_are_bitwise():
    """run_training at P=2 x D=3 in bfloat16 compute, 4 steps of 32
    tokens: fused/flat gives ag_packed/tree's edge models bitwise."""
    a = p2d3(CFG, "fused", "flat")
    b = p2d3(CFG, "ag_packed", "tree")
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_fsdp_is_bitwise_replicated_and_votes_the_shared_block_once():
    """P=2 x D=3, bfloat16 compute: FSDP on fused/tree gives the
    replicated ag_packed/tree run's edge models bitwise; a local step
    lifts (and so votes) every mamba leaf once a layer and the shared
    block's leaves once, not once an occurrence."""
    fsdp = dataclasses.replace(CFG, param_mode="fsdp")
    a = p2d3(fsdp, "fused", "tree")
    b = p2d3(CFG, "ag_packed", "tree")
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    built = build.build_model(fsdp, Topology(2, 3, "cpu"))
    params = built.init_params(torch.Generator().manual_seed(0))
    mamba = len(pytree.tree_flatten(params["stacks"]["mamba"])[0])
    shared = len(pytree.tree_flatten(params["stacks"][SHARED])[0])
    assert (mamba, shared) == (12, 9)
    per_step = 6 * mamba + shared + 3        # + table, head norm and out
    init_fn, step = hier.make_hier_step(
        Topology(2, 3, "cpu"), hier.AlgoConfig(t_e=3, transport="fused"),
        built.bundle)
    state = init_fn(params)
    tokens = torch.zeros((2, 3, 1, 16), dtype=torch.long)
    counts = []
    for _ in range(2):
        device_axis.fsdp_lift.votes = 0
        state, _ = step(state, {"train": {"tokens": tokens}},
                        torch.full((2,), 0.5), torch.full((2, 3), 1 / 3),
                        torch.ones(2, 3))
        counts.append(device_axis.fsdp_lift.votes)
    assert counts == [2 * per_step, per_step]


def test_jax_train_state_converts():
    """A JAX flat-layout TrainState of the smoke config (after a step)
    into the port's state: the tied leaves' slots bitwise."""
    p = jax_tree()
    jbuilt = jbuild.build_model(JCFG, single_device_topology())
    algo = jhier.AlgoConfig(method="dc_hier_signsgd", mu=MU, rho=RHO, t_e=2,
                            state_layout="flat", compute_dtype=jnp.float32,
                            delta_dtype=jnp.float32)
    init_fn, step = jhier.make_hier_step(single_device_topology(), algo,
                                         jbuilt.bundle)
    jstate = jax.jit(init_fn)(p, jax.random.PRNGKey(1))
    jstate = jax.tree.map(np.asarray, jstate)
    built = build.build_model(CFG, CPU)
    talgo = hier.AlgoConfig(method="dc_hier_signsgd", mu=MU, rho=RHO, t_e=2,
                            state_layout="flat", compute_dtype=torch.float32,
                            delta_dtype=torch.float32)
    init, _ = hier.make_hier_step(CPU, talgo, built.bundle)
    like = init(params_from_numpy(p))
    got = convert.train_state_from_numpy(jstate, like)
    assert torch.equal(got.params.buf, t(jstate.params.buf))
    fs = convert.flat_state_from_numpy(jstate.params.buf,
                                       like.params.layout)
    views = fs.tree()
    for a, w in zip(pytree.tree_flatten(views["stacks"][SHARED])[0],
                    jax.tree.leaves(p["stacks"][SHARED])):
        assert a.shape[1:] == w.shape
        assert np.array_equal(a[0].numpy(), w)


# -- serving ------------------------------------------------------------------

@pytest.mark.parametrize("prompt", [10, 20], ids=["short", "ragged"])
def test_serve_matches_jax(prompt):
    """A prompt shorter than a chunk of 16 and one that pads the second
    chunk: prefill (the scan from zeros, its final state float32) and 3
    decode steps (the recurrence) against JAX's jitted ``prefill`` and
    ``decode_step``, by ``tests/test_torch_serve.py``'s rule: the
    logits, and the caches with their dtypes -- the shared block's k/v a
    slice per occurrence in bfloat16, the SSM states float32."""
    cache = serve_both(ARCH, prompt=prompt, max_len=prompt + 8)
    assert cache["stacks"][SHARED]["self"]["k"].shape[0] == 2
    assert cache["stacks"]["mamba"]["ssm"].dtype == torch.float32


def test_make_cache_and_decode_against_a_longer_prefill():
    """make_cache holds a slice per occurrence (two for the shared block,
    where the stack counts none), bfloat16 zeros as JAX's; the port's
    decode step after a 20-token prefill against a 21-token prefill:
    within 2e-2 of the largest logit (the JAX test's rule), the greedy
    tokens the same."""
    cfg, p, _, _, built = models(ARCH)
    cache = built.make_cache(2, 8)
    jcache = jbuild.make_cache(jbuild.make_archdef(JCFG, 0), 2, 8)
    for a, w in zip(pytree.tree_flatten(cache["stacks"])[0],
                    jax.tree.leaves(jcache["stacks"])):
        assert a.shape == w.shape and a.dtype == torch.bfloat16
        assert w.dtype == jnp.bfloat16 and not bool(a.any())
    assert cache["stacks"][SHARED]["self"]["k"].shape[0] == 2
    tp = params_from_numpy(p)
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab, (2, 21))).long()
    _, c = built.prefill(tp, {"tokens": toks[:, :20]}, 24)
    dec, _ = built.decode_step(tp, c, toks[:, 20:])
    full, _ = built.prefill(tp, {"tokens": toks}, 24)
    assert torch.equal(dec.argmax(-1), full.argmax(-1))
    assert float((dec - full).abs().max()) <= 2e-2 * float(
        full.abs().max())


def test_serve_params_from_flat_views_the_tied_leaves():
    """The tied leaves come out of a [2, n_pad] flat master as zero-copy
    views of edge 0, unstacked, and serve as the tree does."""
    cfg, p, _, _, built = models(ARCH)
    tree = params_from_numpy(p)
    fs = flatbuf.from_tree(pytree.tree_map(
        lambda v: torch.stack([v, v + 1.0]), tree), batch_dims=1)
    views = specs.serve_params_from_flat(built, fs)
    ptr = fs.buf.untyped_storage().data_ptr()
    for got, want in zip(pytree.tree_flatten(views[
            "stacks"][SHARED])[0], pytree.tree_flatten(tree["stacks"][
                SHARED])[0]):
        assert got.untyped_storage().data_ptr() == ptr
        assert torch.equal(got, want)
    toks = {"tokens": torch.from_numpy(np.random.default_rng(4).integers(
        0, cfg.vocab, (2, 6))).long()}
    lv, cv = built.prefill(views, toks, 8)
    lt, ct = built.prefill(tree, toks, 8)
    assert torch.equal(lv, lt)
    tok = torch.argmax(lv, dim=-1)
    assert torch.equal(built.decode_step(views, cv, tok)[0],
                       built.decode_step(tree, ct, tok)[0])


# -- the card script's arithmetic ---------------------------------------------

def test_chip_smoke_hybrid_reckonings():
    """``chip_smoke.py``'s hybrid phase, checked here before the card runs
    it: the 12-layer cut and the whole model have the JAX trees' counts;
    ``vote_leaves`` gives 156 votes a step (12 layers x 12 mamba leaves,
    the shared block's 9 once, the table and the head's 2);
    ``hybrid_cache_reckon`` is the byte count of a served smoke model's
    cache after prefill (bfloat16 weights); ``reckon_peak`` of the cut
    at 1 x 1152 tokens on P=2 x D=3 is the 38.9 GB the rule gives."""
    import importlib.util
    import pathlib

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", pathlib.Path(__file__).resolve().parents[1]
        / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    full = configs.get_config(ARCH)
    cut = dataclasses.replace(full, n_layers=cs.HYB_LAYERS)
    for cfg, want in ((cut, cs.HYB_PARAMS), (full, cs.HYB_FULL_PARAMS)):
        jcfg = dataclasses.replace(jconfigs.get_config(ARCH),
                                   n_layers=cfg.n_layers)
        shapes = jax.eval_shape(jbuild.build_model(
            jcfg, single_device_topology()).init_params,
            jax.random.PRNGKey(0))
        assert sum(int(np.prod(a.shape)) for a in jax.tree.leaves(
            shapes)) == want
        built = build.build_model(cfg, CPU)
        assert build.param_count(built.abstract_params()) == want
    built = build.build_model(cut, CPU)
    assert cs.vote_leaves(built.arch, built.abstract_params()) == 156
    reckon = cs.reckon_peak(cut, cs.HYB_PARAMS, 1, 1152)
    assert abs(reckon["peak_gb"] - 38.9) < 0.05, reckon
    _, p, _, _, sbuilt = models(ARCH)
    tp = pytree.tree_map(lambda a: a.to(torch.bfloat16),
                         params_from_numpy(p))
    toks = torch.zeros((3, 20), dtype=torch.long)
    _, cache = sbuilt.prefill(tp, {"tokens": toks}, 28)
    got = sum(a.numel() * a.element_size()
              for a in pytree.tree_flatten(cache["stacks"])[0])
    assert cs.hybrid_cache_reckon(CFG, 3, 28)["bytes"] == got
