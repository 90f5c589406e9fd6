"""The moe family's modules against the JAX package, on the CPU.

Each module runs on the same inputs (numpy, from a seed) and the same
parameters (the JAX package's initialisers, converted, the norm gains
made nonzero) as its JAX counterpart, on the arctic and deepseek-v3
smoke configs:

  * ``moe._route``: the dispatch one-hot and the capacity bitwise (the
    top-k by a stable sort, the queue positions a float32 cumsum of
    zeros and ones), the combine weights and the aux loss within 1e-6
    (a softmax and a mean summed in other orders); also with forced
    ties -- experts with equal router columns, and an all-zero router
    whose uniform probabilities send every token to experts 0 and 1 and
    drop the pairs past the capacity -- where ``jax.lax.top_k`` keeps
    the lower expert first;
  * ``moe.moe_block`` in both dispatch forms, with the shared experts
    (deepseek) and the dense residual MLP (arctic), one group and four:
    float32 within 1e-5 (matmuls summed in other orders), bfloat16
    within 2e-2 of max(1, the largest |y|) (the families tests' bound);
    with [2, 3] replicas, each with its own parameters and tokens, each
    equal to the JAX call on its own (its groups and its aux loss its
    own), and the two dispatch forms bitwise each other (the same slots:
    a product with a one-hot of one nonzero a slot, or a row gather);
  * ``chip_smoke.moe_oracle``, the card's loop oracle, against JAX's
    ``moe_block`` within 1e-5, with pairs dropped past the capacity; and
    the card's bookkeeping from each card config's tree:
    ``reckon_fsdp_peak``, ``lift_rows`` (one row a leaf and layer) and
    ``moe_route_shapes`` (each distinct leaf shape once);
  * ``attention.mla_attn``: the train form (and its [2, 3] replicas)
    within 1e-5; prefill within 1e-5 and its bfloat16 latent caches
    within one bfloat16 ulp; the absorbed decode from JAX's cache within
    2^-8 of the largest output (the attention rounds its weights to the
    bfloat16 cache, as ``tests/test_torch_serve.py`` says) and within
    1e-5 on that cache widened to float32;
  * the blocks ``moe_block`` (GQA and MLA) and ``mla_dense_block``
    within 1e-5, their aux losses within 1e-6, with [2, 3] replicas;
  * the structure: the full and smoke configs of internvl2, arctic,
    deepseek-v3 and zamba2 build without importing JAX, ``serve_layout`` gives the reference's answer for every config
    in both regimes, and ``--arch`` of the three full configs reaches
    the FSDP regime.
"""
import dataclasses
import functools
import importlib.util
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
from repro.core.topology import single_device_topology
from repro.models import attention as jattn
from repro.models import blocks as jblocks
from repro.models import build as jbuild
from repro.models import moe as jmoe
from repro_torch import configs, convert
from repro_torch.convert import params_from_numpy
from repro_torch.core import pytree
from repro_torch.core.topology import Topology
from repro_torch.core.votes import LEAF_PAD
from repro_torch.models import attention, blocks, build, moe
from test_torch_lm_families import LEAD, per_replica, stack
from test_torch_lm_layers import rand, t

ROOT = pathlib.Path(__file__).resolve().parents[1]
ACFG, JACFG = configs.get_smoke("arctic_480b"), jconfigs.get_smoke(
    "arctic_480b")
DCFG, JDCFG = (configs.get_smoke("deepseek_v3_671b"),
               jconfigs.get_smoke("deepseek_v3_671b"))
NORMS = ("n1", "n2", "qn", "kn", "kvn")
CPU = Topology(1, 1, "cpu")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread (see tests/test_torch_lm_layers.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def close(got, want, tol):
    """|got - want| <= tol * max(1, max |want|)."""
    want = np.asarray(want, np.float32)
    atol = tol * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got.detach().float().numpy(), want, rtol=0,
                               atol=atol)


def jparams(init_fn, seed=0):
    """A JAX parameter tree as numpy, with the norm gains made nonzero."""
    p = jax.tree.map(np.asarray, init_fn(jax.random.PRNGKey(seed)))
    return jax.tree_util.tree_map_with_path(
        lambda path, a: (rand(a.shape, seed + 7, 0.3) if str(path[-1].key)
                         in NORMS else a), p)


def with_moe(jcfg, cfg, **kw):
    return (dataclasses.replace(jcfg, moe=dataclasses.replace(jcfg.moe,
                                                              **kw)),
            dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, **kw)))


# -- routing ------------------------------------------------------------------

def route_case(case):
    """(router [d, E], xg [G, S, d]) of a routing case, float32."""
    d, e = DCFG.d_model, DCFG.moe.n_experts
    router = rand((d, e), 3, 1 / np.sqrt(d))
    if case == "equal columns":          # experts 2 = 5 and 4 = 6 = 7
        router[:, 5] = router[:, 2]
        router[:, 6] = router[:, 7] = router[:, 4]
    elif case == "zero router":          # every probability 1/E
        router[:] = 0.0
    return router, rand((2, 24, d), 4)


@pytest.mark.parametrize("case", ["random", "equal columns", "zero router"])
def test_route_matches_jax(case):
    router, xg = route_case(case)
    e = DCFG.moe
    jcomb, jdisp, jaux, jcap = jmoe._route({"router": jnp.asarray(router)},
                                           jnp.asarray(xg), JDCFG.moe)
    comb, disp, aux, cap = moe._route({"router": t(router)}, t(xg), e)
    assert cap == jcap == moe.capacity(24, e)
    assert disp.dtype == comb.dtype == torch.float32
    np.testing.assert_array_equal(disp.numpy(), np.asarray(jdisp))
    close(comb, jcomb, 1e-6)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=0, atol=1e-6)
    if case == "zero router":            # experts 0 and 1, cap each
        kept = disp.sum(dim=(1, 3))
        assert torch.equal(kept[:, :2], torch.full((2, 2), float(cap)))
        assert float(kept[:, 2:].sum()) == 0.0


def test_route_capacity_is_the_reference_expression():
    for s_len in (1, 2, 7, 24, 512, 1000, 1024):
        for cfg in (DCFG, ACFG, configs.get_config("arctic_480b"),
                    configs.get_config("deepseek_v3_671b")):
            e = cfg.moe
            assert moe.capacity(s_len, e) == max(1, int(
                s_len * e.top_k / e.n_experts * e.capacity_factor))


# -- the MoE FFN --------------------------------------------------------------

BLOCK_CASES = {
    "arctic": (JACFG, ACFG, {}),
    "deepseek": (JDCFG, DCFG, {}),
    "deepseek 4 groups": (JDCFG, DCFG, {"group_tokens": 8}),
    "arctic tight capacity": (JACFG, ACFG, {"capacity_factor": 0.5}),
}


def moe_fns(jcfg, cfg, dtype=None):
    def jfn(p, x):
        if dtype is not None:
            p = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), p)
            x = jnp.asarray(x, jnp.bfloat16)
        y, aux = jmoe.moe_block(p, x, jcfg)
        return np.asarray(jnp.asarray(y, jnp.float32)), float(aux)

    def tfn(p, x):
        if dtype is not None:
            p = pytree.tree_map(lambda a: a.to(dtype), p)
            x = x.to(dtype)
        return moe.moe_block(p, x, cfg)

    return jfn, tfn


@pytest.mark.parametrize("dispatch", ["einsum", "gather"])
@pytest.mark.parametrize("case", list(BLOCK_CASES))
def test_moe_block_matches_jax(case, dispatch):
    jcfg, cfg, kw = BLOCK_CASES[case]
    jcfg, cfg = with_moe(jcfg, cfg, dispatch=dispatch, **kw)
    p = jparams(lambda k: jmoe.init_moe(k, jcfg), 1)
    x = rand((2, 16, cfg.d_model), 5)
    jfn, tfn = moe_fns(jcfg, cfg)
    want, jaux = jfn(p, x)
    got, aux = tfn(params_from_numpy(p), t(x))
    close(got, want, 1e-5)
    assert aux.shape == () and aux.dtype == torch.float32
    np.testing.assert_allclose(float(aux), jaux, rtol=0, atol=1e-6)


@pytest.mark.parametrize("dispatch", ["einsum", "gather"])
@pytest.mark.parametrize("arch", ["arctic", "deepseek"])
def test_moe_block_bf16_matches_jax(arch, dispatch):
    jcfg, cfg, _ = BLOCK_CASES[arch]
    jcfg, cfg = with_moe(jcfg, cfg, dispatch=dispatch)
    p = jparams(lambda k: jmoe.init_moe(k, jcfg), 2)
    x = rand((2, 16, cfg.d_model), 6)
    jfn, tfn = moe_fns(jcfg, cfg, torch.bfloat16)
    want, _ = jfn(p, x)
    got, aux = tfn(params_from_numpy(p), t(x))
    assert got.dtype == torch.bfloat16 and aux.dtype == torch.float32
    close(got, want, 2e-2)


@pytest.mark.parametrize("arch", ["arctic", "deepseek 4 groups"])
def test_moe_block_per_replica(arch):
    """[2, 3] replicas, each with its own parameters and tokens: each
    replica's output and aux loss are JAX's on its own; the gather
    dispatch bitwise the einsum one."""
    jcfg, cfg, kw = BLOCK_CASES[arch]
    jcfg, cfg = with_moe(jcfg, cfg, **kw)

    def args(i):
        return (jparams(lambda k: jmoe.init_moe(k, jcfg), 10 + i),
                rand((2, 16, cfg.d_model), 20 + i))

    jfn, tfn = moe_fns(jcfg, cfg)
    per_replica(lambda p, x: jfn(p, x)[0], lambda p, x: tfn(p, x)[0], args,
                1e-5)
    reps = [args(i) for i in range(6)]
    p, x = stack([a[0] for a in reps]), t(np.stack([a[1] for a in reps]))
    x = x.reshape(LEAD + x.shape[1:])
    y, aux = moe.moe_block(p, x, cfg)
    assert aux.shape == LEAD
    for i in range(6):
        np.testing.assert_allclose(float(aux[np.unravel_index(i, LEAD)]),
                                   jfn(*reps[i])[1], rtol=0, atol=1e-6)
    gcfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, dispatch="gather"))
    yg, auxg = moe.moe_block(p, x, gcfg)
    assert torch.equal(y, yg) and torch.equal(aux, auxg)


def chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("case", ["arctic tight capacity",
                                  "deepseek 4 groups"])
def test_loop_oracle_matches_jax(case):
    """The card's loop oracle (``chip_smoke.moe_oracle``) against JAX's
    ``moe_block`` within 1e-5 of the largest |y|, on [2, 3] replicas with
    their own parameters, pairs dropped past the capacity."""
    jcfg, cfg, kw = BLOCK_CASES[case]
    jcfg, cfg = with_moe(jcfg, cfg, **kw)
    oracle = chip_smoke().moe_oracle

    def args(i):
        return (jparams(lambda k: jmoe.init_moe(k, jcfg), 30 + i),
                rand((2, 16, cfg.d_model), 40 + i))

    jfn, _ = moe_fns(jcfg, cfg)
    per_replica(lambda p, x: jfn(p, x)[0],
                lambda p, x: oracle(torch, p, x, cfg), args, 1e-5)


@functools.cache
def card_trees() -> dict:
    """The moe phase's configs (``chip_smoke.moe_cells``) and the fsdp
    phase's gemma3-12b (6 layers): name -> (arch, abstract parameters)."""
    cells = chip_smoke().moe_cells()
    cells["gemma3-12b"] = dataclasses.replace(
        configs.get_config("gemma3_12b"), n_layers=6, param_mode="fsdp")
    out = {}
    for name, cfg in cells.items():
        b = build.build_model(cfg, Topology(2, 2, "cpu"))
        out[name] = (b.arch, b.abstract_params())
    return out


@pytest.mark.parametrize("name,want", [
    ("deepseek-v3", 60.874285056), ("arctic", 65.021616128),
    ("internvl2", 50.552832), ("check", 38.149349376),
    ("gemma3-12b", 57.448129536)])
def test_fsdp_reckoning_from_the_tree(name, want):
    """``chip_smoke.reckon_fsdp_peak`` at 1 x 512 tokens a device from
    each card config's tree: untied tables and MTP's reused ones for the
    moe phase's, and gemma3-12b (one tied table, no MTP), whose peak is
    the table's vote: since each direction goes into its master as soon
    as it is known, none of the others waits beside it."""
    arch, abstract = card_trees()[name]
    got = chip_smoke().reckon_fsdp_peak(arch, abstract, 1, 512)["peak_gb"]
    assert got == pytest.approx(want, rel=1e-12, abs=0)


@pytest.mark.parametrize("name,want", [
    ("deepseek-v3", 52), ("arctic", 29), ("internvl2", 21), ("check", 38),
    ("gemma3-12b", 62)])
def test_lift_rows_are_one_a_leaf_and_layer(name, want):
    """``chip_smoke.lift_rows``: one [2, 2, padded numel] row a leaf and
    layer of each card config's tree (the launches a step that its
    phase requires of each kernel), each bound positive."""
    cs = chip_smoke()
    _, abstract = card_trees()[name]
    rows = cs.lift_rows(abstract)
    assert len(rows) == want
    assert all(r[:2] == (2, 2) and r[2] % LEAF_PAD == 0 for r in rows)
    assert min(cs.lift_bounds(rows)) > 0


def test_route_shapes_cover_every_leaf_shape_once():
    """``chip_smoke.moe_route_shapes``: each distinct leaf shape of the
    moe phase's trees once (a stacked leaf's one layer), the routed
    expert stacks, MTP's dense FFN and the untied head among them."""
    cs = chip_smoke()
    abstracts = {name: a for name, (_, a) in card_trees().items()
                 if name != "gemma3-12b"}
    shapes = [s for _, s in cs.moe_route_shapes(abstracts)]
    assert len(set(shapes)) == len(shapes)
    assert set(shapes) == {
        tuple(leaf.shape[1:] if name.startswith("stacks.") else leaf.shape)
        for a in abstracts.values() for name, leaf in cs.pytree_items(a)}
    assert {(16, 2048, 7168), (8, 4864, 7168), (18432, 7168),
            (7168, 16160)} <= set(shapes)


# -- MLA ----------------------------------------------------------------------

def mla_params(seed):
    return jparams(lambda k: jattn.init_mla(k, JDCFG), seed)


def test_mla_train_matches_jax():
    pos = np.arange(16, dtype=np.int32)

    def args(i):
        return mla_params(50 + i), rand((2, 16, DCFG.d_model), 60 + i)

    def jfn(p, x):
        return jattn.mla_attn(p, x, jnp.asarray(pos), JDCFG)[0]

    def tfn(p, x):
        return attention.mla_attn(p, x, t(pos), DCFG)

    a = args(0)
    close(tfn(params_from_numpy(a[0]), t(a[1])), jfn(*a), 1e-5)
    per_replica(jfn, tfn, args, 1e-5)


def check_latents(got, want):
    """bfloat16 latent caches within one bfloat16 ulp of JAX's plus 1e-5
    of the largest (``tests/test_torch_serve.py``'s rule)."""
    for k in ("ckv", "kr"):
        assert got[k].dtype == torch.bfloat16
        w = np.asarray(want[k], np.float32)
        np.testing.assert_allclose(got[k].float().numpy(), w,
                                   rtol=2.0 ** -7,
                                   atol=1e-5 * float(np.abs(w).max()))


def test_mla_prefill_and_absorbed_decode_match_jax():
    """Prefill 10 positions into max_len 16, then 3 decode steps each from
    JAX's cache: as the module docstring says."""
    p = mla_params(70)
    tp = params_from_numpy(p)
    x = rand((2, 13, DCFG.d_model), 71)
    jcache = jattn.mla_cache_init(JDCFG, 2, 16)
    pos = np.arange(10, dtype=np.int32)
    want, jcache = jattn.mla_attn(p, jnp.asarray(x[:, :10]),
                                  jnp.asarray(pos), JDCFG, cache=jcache,
                                  pos=0, prefill=True)
    shapes = attention.mla_cache_init(DCFG, 2, 16)
    cache = {k: torch.zeros(v, dtype=torch.bfloat16)
             for k, v in shapes.items()}
    got, cache = attention.mla_attn(tp, t(x[:, :10]), t(pos), DCFG,
                                    cache=cache, pos=0, prefill=True)
    close(got, want, 1e-5)
    check_latents(cache, jcache)
    for s in range(10, 13):
        xs, ps = x[:, s:s + 1], np.array([s], np.int32)
        for widen, tol in ((False, 2.0 ** -8), (True, 1e-5)):
            src = jax.tree.map(lambda a: a.astype(jnp.float32), jcache) \
                if widen else jcache
            want, jnext = jattn.mla_attn(p, jnp.asarray(xs),
                                         jnp.asarray(ps), JDCFG, cache=src,
                                         pos=s)
            got, nxt = attention.mla_attn(
                tp, t(xs), t(ps), DCFG,
                cache={k: convert.tensor_from_numpy(np.asarray(v))
                       for k, v in src.items()}, pos=s)
            w = np.asarray(want)
            err = float(np.abs(got.numpy() - w).max())
            assert err <= tol * float(np.abs(w).max()), (s, widen, err)
            if not widen:
                check_latents(nxt, jnext)
                jcache = jnext
    with pytest.raises(ValueError, match="max_len"):
        attention.mla_attn(tp, t(x[:, :1]), t(np.array([16], np.int32)),
                           DCFG, cache=cache, pos=16)


# -- blocks -------------------------------------------------------------------

BLOCKS = {
    "moe gqa": (lambda: jblocks.moe_block(JACFG, 0),
                lambda: blocks.moe_block(ACFG), JACFG, ACFG),
    "moe mla": (lambda: jblocks.moe_block(JDCFG, 0, use_mla=True),
                lambda: blocks.moe_block(DCFG, use_mla=True), JDCFG, DCFG),
    "mla dense": (lambda: jblocks.mla_dense_block(JDCFG, 0, 128),
                  lambda: blocks.mla_dense_block(DCFG, 128), JDCFG, DCFG),
}


@pytest.mark.parametrize("kind", list(BLOCKS))
def test_blocks_match_jax(kind):
    jmk, tmk, jcfg, cfg = BLOCKS[kind]
    jb, tb = jmk(), tmk()
    pos = np.arange(16, dtype=np.int32)

    def jfn(p, x):
        y, aux, _ = jb.apply(p, x, jblocks.Ctx(jcfg, "train",
                                               positions=jnp.asarray(pos)),
                             None)
        return y, float(aux)

    def tfn(p, x):
        return tb.apply(p, x, blocks.Ctx(cfg, positions=t(pos)))

    def args(i):
        return jparams(jb.init, 80 + i), rand((2, 16, cfg.d_model), 90 + i)

    per_replica(lambda p, x: jfn(p, x)[0], lambda p, x: tfn(p, x)[0], args,
                1e-5)
    reps = [args(i) for i in range(6)]
    x = t(np.stack([a[1] for a in reps])).reshape(LEAD + (2, 16, -1))
    _, aux = tfn(stack([a[0] for a in reps]), x)
    assert aux.shape == LEAD and aux.dtype == torch.float32
    for i in range(6):
        np.testing.assert_allclose(float(aux[np.unravel_index(i, LEAD)]),
                                   jfn(*reps[i])[1], rtol=0, atol=1e-6)
    if kind == "mla dense":
        assert not bool(aux.any())


# -- structure ----------------------------------------------------------------

NEW = ("internvl2_76b", "arctic_480b", "deepseek_v3_671b")


def test_new_families_build_without_jax():
    """The full and smoke configs of the three archs and of zamba2 (the
    hybrid family) build (and their parameter shapes come out) in a
    process that never imports JAX."""
    code = (
        "import sys\n"
        "from repro_torch import configs\n"
        "from repro_torch.core.topology import Topology\n"
        "from repro_torch.models import build\n"
        f"for name in {NEW + ('zamba2_2p7b',)!r}:\n"
        "    for get in (configs.get_config, configs.get_smoke):\n"
        "        b = build.build_model(get(name), Topology(1, 1, 'cpu'))\n"
        "        assert build.param_count(b.abstract_params()) > 0\n"
        "assert 'jax' not in sys.modules\n"
        "print('OK')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "OK"


@pytest.mark.parametrize("name", configs.ARCH_NAMES)
def test_serve_layout_is_the_reference_rule(name):
    """Every buildable config, full and smoke, replicated and FSDP (an
    encoder-decoder trains replicated only): the port's layout is JAX's
    ``serve_layout`` on one device; a ``gather`` layout's prefill and a
    decode step run at the full config's shapes (meta tensors: no
    memory), the logits [1, 1, V]."""
    encdec = configs.get_config(name).family in ("encdec", "audio")
    for getter, jgetter in ((configs.get_config, jconfigs.get_config),
                            (configs.get_smoke, jconfigs.get_smoke)):
        for mode in ("replicated",) if encdec else ("replicated", "fsdp"):
            cfg = dataclasses.replace(getter(name), param_mode=mode)
            jcfg = dataclasses.replace(jgetter(name), param_mode=mode)
            built = build.build_model(cfg, CPU)
            n = build.param_count(built.abstract_params())
            want = jbuild.serve_layout(jcfg, single_device_topology(), n)
            assert build.serve_layout(cfg, CPU, n) == want \
                == built.serve_layout
            if want == "gather":
                params = built.abstract_params()
                batch = {"tokens": torch.zeros((1, 2), dtype=torch.long,
                                               device="meta")}
                if cfg.n_patches:
                    batch["patches"] = torch.zeros(
                        (1, cfg.n_patches, cfg.d_model), device="meta")
                logits, cache = built.prefill(params, batch,
                                              4 + cfg.n_patches)
                assert logits.shape == (1, 1, cfg.vocab)
                logits, _ = built.decode_step(params, cache, torch.zeros(
                    (1, 1), dtype=torch.long, device="meta"))
                assert logits.shape == (1, 1, cfg.vocab)


@pytest.mark.parametrize("name", NEW)
def test_cli_reaches_the_fsdp_regime(name):
    """``--arch`` of a full config (FSDP) reaches the FSDP regime: the
    flat layout is its step's ``ValueError``, raised before any parameter
    is made; the ``--smoke`` configs train replicated
    (``tests/test_torch_lm_runtime.py``)."""
    from repro_torch.launch import train

    assert configs.get_config(name).param_mode == "fsdp"
    assert configs.get_smoke(name).param_mode == "replicated"
    with pytest.raises(ValueError, match="replicated"):
        train.main(["--device", "cpu", "--arch", name, "--state_layout",
                    "flat"])
