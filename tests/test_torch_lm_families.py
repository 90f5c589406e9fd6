"""The LM zoo's ssm (xlstm) and encdec/audio (whisper) families against
the JAX package, on the CPU.

Each module the two families add runs on the same float32 inputs (numpy,
from a seed) and the same parameters (the JAX package's initialisers,
converted, the norm gains made nonzero) as its JAX counterpart:
``causal_conv`` (elementwise: 1e-6), ``mlstm_parallel``, the mLSTM and
sLSTM blocks, the bidirectional dense block, ``cross_attn`` and the
decoder block with cross-attention (matmuls and cumsums summed in other
orders: 1e-5).  A tolerance is absolute where the outputs are at most 1
in size and relative to the largest output beyond that: the mLSTM
divides by ``max(|sum_j scores|, exp(-m))``, which can be small, so its
outputs reach 10-100 on random inputs and float32 rounding grows with
them.  Each module runs again with leading [2, 3] replica dims, every
replica with its own parameters and inputs, and each replica must equal
the JAX call on its own; and in bfloat16, where each block must return
bfloat16 within a few bfloat16 ulps of JAX's.

Then the families end to end: ``params_from_numpy`` carries the JAX
trees leaf for leaf; 4 steps of the port's ``make_hier_step`` against
JAX ``make_hier_step`` on the xlstm and whisper smoke configs (the rule
of ``tests/test_torch_lm_step.py``: within 2*mu, at most 0.1 % of
coordinates past 1e-6; xlstm's trajectory is chaotic, so each of its
steps starts from JAX's state), whisper with the same frames in both; and
fused/flat bitwise ag_packed/tree through ``run_training`` at P=2 x D=3
in bfloat16 compute; the stream's frames, carved with the tokens for
K=2 clients, and whisper's streamed clients bitwise its merged voter
axis.  The loss and gradients against JAX
``make_loss_single``: ``tests/test_torch_lm.py``.
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
from repro.models import attention as jattn
from repro.models import blocks as jblocks
from repro.models import ssm as jssm
from repro_torch import configs, convert
from repro_torch.convert import params_from_numpy
from repro_torch.core import hier, pytree
from repro_torch.core.topology import Topology
from repro_torch.launch.train import RunCfg, run_training
from repro_torch.models import attention, blocks, build, ssm
from test_torch_lm import jax_params, smoke
from test_torch_lm_layers import rand, t

XCFG, JXCFG = configs.get_smoke("xlstm_350m"), jconfigs.get_smoke("xlstm_350m")
WCFG, JWCFG = (configs.get_smoke("whisper_base"),
               jconfigs.get_smoke("whisper_base"))
LEAD = (2, 3)
MU, RHO = 1e-3, 0.2


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for this module's small tensors: the suite runs
    several pytest workers on the machine's cores, and PyTorch's thread
    pool in each of them would contend for the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def close(got, want, tol):
    """|got - want| <= tol * max(1, max |want|)."""
    want = np.asarray(want)
    atol = tol * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0, atol=atol)


def jparams(init_fn, seed=0):
    """A JAX parameter tree as numpy, with the norm gains made nonzero."""
    p = jax.tree.map(np.asarray, init_fn(jax.random.PRNGKey(seed)))
    return jax.tree_util.tree_map_with_path(
        lambda path, a: (rand(a.shape, seed + 7, 0.3) if str(path[-1].key)
                         in ("n1", "n2", "nx", "norm") else a), p)


def stack(trees):
    """LEAD-stacked tensors of a list of prod(LEAD) numpy trees."""
    return pytree.tree_map(
        lambda *xs: torch.stack([t(x) for x in xs]).reshape(
            LEAD + xs[0].shape), *trees)


def per_replica(jfn, tfn, make_args, tol):
    """tfn on LEAD-stacked arguments against jfn on each replica's own:
    ``make_args(i)`` gives replica i's numpy arguments (a tuple)."""
    n = int(np.prod(LEAD))
    args = [make_args(i) for i in range(n)]
    got = tfn(*(stack([a[k] for a in args]) if isinstance(args[0][k], dict)
                else t(np.stack([a[k] for a in args])).reshape(
                    LEAD + args[0][k].shape)
                for k in range(len(args[0]))))
    for i in range(n):
        close(got[np.unravel_index(i, LEAD)], jfn(*args[i]), tol)


def test_causal_conv():
    """The depthwise causal conv and SiLU on [2, 16, 32] with 4 taps: 1e-6
    (elementwise, the taps added in the same order)."""
    def args(i):
        return rand((2, 16, 32), 10 + i), rand((4, 32), 20 + i, 0.5)

    def jfn(x, w):
        return jssm._causal_conv(x, w)[0]

    x, w = args(0)
    close(ssm.causal_conv(t(x), t(w)), jfn(x, w), 1e-6)
    per_replica(jfn, ssm.causal_conv, args, 1e-6)


def test_mlstm_parallel():
    """The decay-matrix mLSTM on [2, 16, 4, 32] (k scaled by 1/sqrt(hd)
    as the block scales it), and its input gradients: 1e-5."""
    def args(i):
        q, k, v = (rand((2, 16, 4, 32), 30 + 3 * i + s) for s in range(3))
        return (q, k / np.float32(np.sqrt(32)), v, rand((2, 16, 4), 50 + i),
                rand((2, 16, 4), 60 + i, 2.0))

    a = args(0)
    close(ssm.mlstm_parallel(*map(t, a)), jssm._mlstm_parallel(*a), 1e-5)
    per_replica(jssm._mlstm_parallel, ssm.mlstm_parallel, args, 1e-5)
    ct = rand((2, 16, 4, 32), 70)
    jg = jax.grad(lambda *xs: jnp.sum(jssm._mlstm_parallel(*xs) * ct),
                  argnums=tuple(range(5)))(*a)
    ts = [t(x).requires_grad_(True) for x in a]
    g = torch.autograd.grad((ssm.mlstm_parallel(*ts) * t(ct)).sum(), ts)
    for got, want in zip(g, jg):
        close(got, want, 1e-5)


def block_case(jblock, tblock, jcfg, cfg, x_shape, enc=None):
    """A block's apply against JAX's on x [2, 16, d] (and with ``enc``
    the encoder output [2, f, d]), unbatched and per replica."""
    pos = np.arange(x_shape[1], dtype=np.int32)

    def args(i):
        a = (jparams(jblock.init, i), rand(x_shape, 80 + i))
        return a + ((rand(enc, 90 + i),) if enc else ())

    def jfn(p, x, e=None):
        ctx = jblocks.Ctx(jcfg, "train", positions=jnp.asarray(pos),
                          enc_out=e)
        return jblock.apply(p, x, ctx, None)[0]

    def tfn(p, x, e=None):
        return tblock.apply(p, x, blocks.Ctx(cfg, positions=t(pos),
                                             enc_out=e))[0]

    a = args(0)
    close(tfn(params_from_numpy(a[0]), *map(t, a[1:])), jfn(*a), 1e-5)
    per_replica(jfn, tfn, args, 1e-5)


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_xlstm_blocks(kind):
    """The mLSTM block (norm, up-projection, conv, gates, the parallel
    form, norm, gate, down-projection, residual) and the sLSTM block
    (the recurrence over 16 steps and its gated FFN) on the smoke
    config: 1e-5."""
    jb = getattr(jblocks, f"{kind}_block")(JXCFG, 0)
    tb = getattr(blocks, f"{kind}_block")(XCFG)
    block_case(jb, tb, JXCFG, XCFG, (2, 16, XCFG.d_model))


@pytest.mark.parametrize("cross", [False, True], ids=["encoder", "decoder"])
def test_whisper_blocks(cross):
    """Whisper's bidirectional encoder block (no mask, no rope) and its
    decoder block (causal, rope, cross-attention over 32 encoder
    frames): 1e-5."""
    kw = {"cross": True} if cross else {"causal": False}
    jb = jblocks.dense_block(JWCFG, 0, **kw)
    tb = blocks.dense_block(WCFG, **kw)
    block_case(jb, tb, JWCFG, WCFG, (2, 16, WCFG.d_model),
               enc=(2, WCFG.encoder_frames, WCFG.d_model) if cross else None)


def test_cross_attn():
    """cross_kv and cross_attn: 16 queries over 32 frames, 1e-5."""
    def args(i):
        return (jparams(lambda key: jattn.init_cross(key, JWCFG), i),
                rand((2, 16, WCFG.d_model), 100 + i),
                rand((2, WCFG.encoder_frames, WCFG.d_model), 110 + i))

    def jfn(p, x, e):
        return jattn.cross_attn(p, x, jattn.cross_kv(p, e, JWCFG), JWCFG)

    def tfn(p, x, e):
        return attention.cross_attn(p, x, attention.cross_kv(p, e, WCFG),
                                    WCFG)

    a = args(0)
    close(tfn(params_from_numpy(a[0]), t(a[1]), t(a[2])), jfn(*a), 1e-5)
    per_replica(jfn, tfn, args, 1e-5)


@pytest.mark.parametrize("name", ["xlstm_350m", "whisper_base"])
def test_params_from_numpy_carries_the_family_trees(name):
    """The JAX smoke tree converts leaf for leaf, bitwise, to the tree the
    port's build makes (names, order, shapes)."""
    jcfg, cfg = smoke(name)
    _, p = jax_params(jcfg)
    got = params_from_numpy(p)
    want = build.build_model(cfg, Topology(1, 1, "cpu")).abstract_params()
    leaves, td = pytree.tree_flatten(got)
    assert td == pytree.tree_flatten(want)[1]
    for a, (path, w) in zip(leaves, jax.tree_util.tree_leaves_with_path(p)):
        assert a.dtype == torch.float32
        assert np.array_equal(a.numpy(), w), path


def frames_for(cfg, lead, seed=3):
    return rand(lead + (cfg.encoder_frames, cfg.frontend_dim), seed, 0.1)


def assert_near_jax(got: list, want: list) -> None:
    """The rule of a sign step against JAX's: every coordinate within
    2*mu + 1e-6, at most 0.1 % of them more than 1e-6 apart."""
    n = far = 0
    for a, w in zip(got, want):
        diff = np.abs(a.numpy() - w)
        assert diff.max() <= 2 * MU + 1e-6
        n += diff.size
        far += int((diff > 1e-6).sum())
    assert far <= 1e-3 * n, (far, n)


@pytest.mark.parametrize("name,restart", [("xlstm_350m", True),
                                          ("whisper_base", False)],
                         ids=["xlstm-each-step", "whisper-trajectory"])
def test_step_matches_jax_make_hier_step(name, restart):
    """4 steps (2 rounds of T_E=2) of DC-HierSignSGD at P = D = 1 on the
    smoke config, the tokens (and frames) the same as the JAX step's:
    the port's fused/flat and ag_packed/tree runs bitwise each other,
    and held against JAX by :func:`assert_near_jax`.

    Whisper: the port's 4-step trajectory against JAX's.  xlstm: each
    step of the port (ag_packed/tree) from JAX's state before it
    (``convert.train_state_from_numpy``) against JAX's state after it.
    xlstm's smoke trajectory is chaotic at this mu: the few coordinates
    that the first step's float32 sums set 2*mu apart move the next
    gradients enough to flip many more signs, and a tenth or more of
    the coordinates part within four steps; from a common state each
    step stays within the rule."""
    jcfg, cfg = smoke(name)
    jbuilt, p = jax_params(jcfg)
    algo = jhier.AlgoConfig(method="dc_hier_signsgd", mu=MU, rho=RHO, t_e=2,
                            transport="ag_packed", state_layout="tree",
                            compute_dtype=jnp.float32,
                            delta_dtype=jnp.float32)
    init_fn, step = jhier.make_hier_step(single_device_topology(), algo,
                                         jbuilt.bundle)
    state = jax.jit(init_fn)(p, jax.random.PRNGKey(1))
    jstep = jax.jit(step)
    tokens = np.random.default_rng(2).integers(
        0, cfg.vocab, (4, 1, 1, 2, 16)).astype(np.int32)
    batches = [{"tokens": tokens[s]} for s in range(4)]
    if cfg.encoder_layers:
        for s, b in enumerate(batches):
            b["frames"] = frames_for(cfg, (1, 1, 2), 10 + s)
    ones = jnp.ones((1, 1))
    jstates = [jax.tree.map(np.asarray, state)]
    for b in batches:
        state, _ = jstep(state, {"train": b}, jnp.ones(1), ones, ones)
        jstates.append(jax.tree.map(np.asarray, state))
    built = build.build_model(cfg, Topology(1, 1, "cpu"))
    tbatches = [{k: t(v).long() if k == "tokens" else t(v)
                 for k, v in b.items()} for b in batches]
    args = (torch.ones(1), torch.ones(1, 1), torch.ones(1, 1))
    steps, finals = [], []
    for transport, layout in (("fused", "flat"), ("ag_packed", "tree")):
        talgo = hier.AlgoConfig(
            method="dc_hier_signsgd", mu=MU, rho=RHO, t_e=2,
            transport=transport, state_layout=layout,
            compute_dtype=torch.float32, delta_dtype=torch.float32)
        init, tstep = hier.make_hier_step(Topology(1, 1, "cpu"), talgo,
                                          built.bundle)
        tstate = init(params_from_numpy(p))
        for b in tbatches:
            tstate, _ = tstep(tstate, {"train": b}, *args)
        finals.append(pytree.tree_flatten(hier.edge_params(tstate))[0])
        steps.append((init, tstep))
    for a, b in zip(*finals):
        assert torch.equal(a, b)

    def leaves(jstate):
        return jax.tree.leaves(jstate.params)

    if not restart:
        assert_near_jax(finals[0], leaves(jstates[-1]))
    else:
        init, tstep = steps[1]
        like = init(params_from_numpy(p))
        for s, b in enumerate(tbatches):
            tstate, _ = tstep(convert.train_state_from_numpy(jstates[s],
                                                             like),
                              {"train": b}, *args)
            assert_near_jax(pytree.tree_flatten(hier.edge_params(tstate))[0],
                            leaves(jstates[s + 1]))
    moved = sum(float(np.abs(w - np.asarray(x)).sum()) for w, x in
                zip(leaves(jstates[-1]), jax.tree.leaves(p)))
    assert moved > 0


@pytest.mark.parametrize("name", ["xlstm_350m", "whisper_base"])
def test_layouts_and_transports_are_bitwise(name):
    """run_training at P=2 x D=3 in bfloat16 compute, 4 steps (whisper
    with the stream's frames): fused/flat, the kernels' route, gives
    the edge models of ag_packed/tree bitwise."""
    cfg = dataclasses.replace(configs.get_smoke(name), n_layers=6) \
        if name == "xlstm_350m" else configs.get_smoke(name)
    runs = []
    for transport, layout in (("fused", "flat"), ("ag_packed", "tree")):
        algo = hier.AlgoConfig(
            method="dc_hier_signsgd", mu=MU, rho=RHO, t_e=2,
            transport=transport, state_layout=layout,
            compute_dtype=torch.bfloat16, delta_dtype=torch.bfloat16)
        state, hist = run_training(
            cfg, Topology(2, 3, "cpu"), algo,
            RunCfg(steps=4, batch_per_device=1, seq_len=16, log_every=0),
            log=lambda line: None)
        assert all(np.isfinite(h["loss"]) for h in hist)
        runs.append(pytree.tree_flatten(hier.edge_params(state))[0])
    for a, b in zip(*runs):
        assert torch.equal(a, b)


@pytest.mark.parametrize("kind", ["mlstm", "slstm", "encoder", "decoder"])
def test_bf16_blocks_keep_the_compute_dtype(kind):
    """In bfloat16 (parameters and input rounded alike), each block
    returns bfloat16 as JAX's does, within bfloat16 rounding of JAX's
    output (2e-2 of its largest, a few bfloat16 ulps): the float32
    islands (the gates, the decay matrix, the recurrence, the softmax)
    sit where JAX's promotion puts them."""
    if kind in ("mlstm", "slstm"):
        jb = getattr(jblocks, f"{kind}_block")(JXCFG, 0)
        tb = getattr(blocks, f"{kind}_block")(XCFG)
        jcfg, cfg, enc = JXCFG, XCFG, None
    else:
        kw = {"cross": True} if kind == "decoder" else {"causal": False}
        jb = jblocks.dense_block(JWCFG, 0, **kw)
        tb = blocks.dense_block(WCFG, **kw)
        jcfg, cfg = JWCFG, WCFG
        enc = (rand((2, WCFG.encoder_frames, WCFG.d_model), 5)
               if kind == "decoder" else None)
    bf = jnp.bfloat16
    p = jparams(jb.init, 3)
    x = rand((2, 16, cfg.d_model), 4)
    pos = np.arange(16, dtype=np.int32)
    want = jb.apply(jax.tree.map(lambda a: jnp.asarray(a, bf), p),
                    jnp.asarray(x, bf),
                    jblocks.Ctx(jcfg, "train", positions=jnp.asarray(pos),
                                enc_out=None if enc is None
                                else jnp.asarray(enc, bf)), None)[0]
    got = tb.apply(pytree.tree_map(lambda a: a.to(torch.bfloat16),
                                   params_from_numpy(p)),
                   t(x).to(torch.bfloat16),
                   blocks.Ctx(cfg, positions=t(pos),
                              enc_out=None if enc is None
                              else t(enc).to(torch.bfloat16)))[0]
    assert want.dtype == bf and got.dtype == torch.bfloat16
    close(got.float(), np.asarray(want.astype(jnp.float32)), 2e-2)


def test_stream_frames_and_their_carve():
    """``batch_at`` gives whisper's frames [P, D, b, f, frontend_dim],
    0.1 x standard normals, the same on two streams and calls and other
    at another step; ``carve_batch`` hands client c of device d the
    rows [c*b/K, (c+1)*b/K) of its frames, as of its tokens."""
    from repro_torch.core import clients
    from repro_torch.data import synthetic

    cfg = synthetic.LMStreamCfg(vocab=64, seq_len=8, batch_per_device=4,
                                pods=2, devices_per_pod=3, seed=5,
                                frames=32, frontend_dim=16)
    a, b = synthetic.make_stream(cfg), synthetic.make_stream(cfg)
    f0 = a(0)["frames"]
    assert f0.shape == (2, 3, 4, 32, 16) and f0.dtype == torch.float32
    assert torch.equal(f0, b(0)["frames"]) and torch.equal(f0, a(0)["frames"])
    assert not torch.equal(f0, a(1)["frames"])
    assert 0.08 < float(f0.std()) < 0.12
    assert "frames" not in synthetic.make_stream(
        dataclasses.replace(cfg, frames=0))(0)
    batch = a(0)
    carved = clients.carve_batch(batch, 2)
    assert carved["frames"].shape == (2, 6, 2, 32, 16)
    for d in range(3):
        for c in range(2):
            rows = slice(2 * c, 2 * c + 2)
            assert torch.equal(carved["frames"][:, 2 * d + c],
                               batch["frames"][:, d, rows])
            assert torch.equal(carved["tokens"][:, 2 * d + c],
                               batch["tokens"][:, d, rows])


def test_whisper_clients_stream_equals_merged():
    """K=2 virtual clients a device on whisper's smoke config (frames
    carved with the tokens): the streamed sweep gives the merged voter
    axis's edge models bitwise, 4 steps at P=2 x D=3 in bfloat16."""
    from repro_torch.core.clients import ClientConfig

    runs = []
    for mode in ("stream", "merged"):
        algo = hier.AlgoConfig(
            method="dc_hier_signsgd", mu=MU, rho=RHO, t_e=2,
            transport="fused", state_layout="flat",
            compute_dtype=torch.bfloat16, delta_dtype=torch.bfloat16,
            clients=ClientConfig(count=2, mode=mode))
        state, _ = run_training(
            WCFG, Topology(2, 3, "cpu"), algo,
            RunCfg(steps=4, batch_per_device=2, seq_len=16, log_every=0),
            log=lambda line: None)
        runs.append(pytree.tree_flatten(hier.edge_params(state))[0])
    for a, b in zip(*runs):
        assert torch.equal(a, b)
