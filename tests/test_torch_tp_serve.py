"""Serving over a process mesh: the caches' specs, tensor-parallel prefill
and decode for every family, the request batch split over the pod and
data ranks; on gloo CPU ranks, against one process and against JAX.

  * the specs (no ranks): ``build.cache_specs`` of all ten published
    configs at M = 1, 2 and 16, with ``batch_ax`` None, ``"data"`` and
    ``("pod", "data")`` and ``len_axis`` None and ``"data"``, tuple for
    tuple JAX's ``build.cache_specs`` (``make_archdef(cfg, m)`` needs no
    mesh); ``serve_layout`` JAX's rule at those M (JAX's reads only
    ``topo.model_shards``, so a stand-in serves it);
  * one spawn of a 2 x 2 x 2 mesh (each rank one model shard and a
    quarter of the rows: 8 requests, 2 a batch rank) serving every
    family's smoke config -- gemma3's (one kv head, whole on every
    model rank; the window of 8 with ``max_len`` below, at and above
    it), deepseek-v3's (MLA's whole latent cache, the MoE's groups
    across the batch ranks), arctic's, internvl2's (patches), xlstm's,
    zamba2's (the tied attention) and whisper's (the encoder, the cross
    keys), and for xlstm and zamba2 a config whose heads do not divide
    M = 2 while the inner dim does (the heads' states whole, the conv
    state split) -- prefill and 3 decode steps, teacher-forced.  Each is
    held against the one-process port serve of the same parameters and
    requests (``torch_tp_serve_worker.serve_case`` without a mesh) and,
    for the published smoke configs, against JAX's jitted one-device
    ``built.prefill`` and ``built.decode_step`` on JAX's own seed-0
    parameters, as ``tests/test_torch_serve.py`` runs them:

      - prefill (float32 compute): the logits within 1e-5 of the
        largest, the cache leaf by leaf -- a float32 leaf within 1e-4 of
        its largest, a bfloat16 one within one bfloat16 ulp plus 1e-5
        of its largest (``test_torch_serve.py``'s rule);
      - each decode step from a given cache (JAX's after the step
        before), the rank's block of it as it is and widened to float32:
        on the float32 cache the logits within 1e-5 of the largest, on
        the bfloat16 one within one bfloat16 ulp of it, 2^-8 (one
        rounding that differs moves them so); the next caches by the
        leaf rule, on the bfloat16 cache with 2^-8 of the largest in
        place of its 1e-5 (every activation of that step carries such
        roundings, and the split sums them in another order);
      - on its own cache chain (bfloat16, where a rounding that differs
        moves the logits by up to 2^-8 of the largest) the logits within
        that of one process's, and the greedy token of every row equal,
        except where one process's two largest logits are closer than
        twice the step's largest difference (2 of the 352 positions
        here);
      - the bytes of the rank's cache after every call equal to
        ``build.cache_bytes``, to the byte;

    a bfloat16-served case (weights and compute in bfloat16: the logits
    within 2^-4 of the largest, ``test_torch_serve.py``'s bound);
    deepseek-v3 with two identical requests on two data ranks, decoded
    together at capacity 1, which must drop the second's routed pairs as
    one process does (a rank routing its rows alone keeps them); and
    the flat state a 1-step ``run_training`` over the mesh leaves,
    served through ``launch.specs.serve_params_from_flat``: edge 0 on
    every pod (pod 0's views in its bucket's storage, the other pod's in
    the row it received), the logits within 1e-5 of one process's on
    edge 0's gathered parameters.
"""
import dataclasses
import functools
import pathlib
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, str(pathlib.Path(__file__).parent / "helpers"))
import torch_tp_serve_worker as SW  # noqa: E402
import torch_tp_worker as W  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import build as jbuild  # noqa: E402
from repro_torch import configs, convert  # noqa: E402
from repro_torch.core import pytree  # noqa: E402
from repro_torch.core.topology import ProcessMesh, Topology  # noqa: E402
from repro_torch.models import build  # noqa: E402
from test_torch_lm import jax_params  # noqa: E402

B = 8                          # requests: 2 a batch rank of 2 x 2
STEPS = 3
LOGITS_TOL = 1e-5              # of the largest |logit|: float32 serving
BF16_CACHE_LOGITS_TOL = 2.0 ** -8    # decode on the bfloat16 cache
BF16_SERVED_TOL = 2.0 ** -4    # bfloat16 weights and compute
BF16_ULP = 2.0 ** -7
STATE_TOL = 1e-4               # float32 cache leaves, of the largest
CASES = {      # name -> (arch, overridden fields, prompt, max_len, JAX too)
    "gemma3-below-window": ("gemma3_1b", {}, 3, 6, True),
    "gemma3-at-window": ("gemma3_1b", {}, 5, 8, True),
    "gemma3-above-window": ("gemma3_1b", {}, 9, 12, True),
    "deepseek-v3": ("deepseek_v3_671b", {}, 10, 13, True),
    "arctic": ("arctic_480b", {}, 10, 13, True),
    "internvl2": ("internvl2_76b", {}, 6, 9, True),
    "xlstm": ("xlstm_350m", {}, 10, 13, True),
    "zamba2": ("zamba2_2p7b", {}, 10, 13, True),
    "whisper": ("whisper_base", {}, 4, 8, True),
    "xlstm-3-heads": ("xlstm_350m", {"d_model": 48, "n_heads": 3,
                                     "n_kv_heads": 3}, 8, 11, False),
    "zamba2-3-heads": ("zamba2_2p7b", {"d_model": 96}, 8, 11, False),
}
BF16_CASE = "gemma3-bf16"      # gemma3 at-window, bfloat16-served
DROP_CASE = "deepseek-v3-drops"
MESH = (2, 2, 2)
ONE = Topology(1, 1, "cpu")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -- the specs and the serve layout ---------------------------------------------

def jax_tuples(tree):
    return jax.tree.map(tuple, tree, is_leaf=lambda v: isinstance(
        v, jax.sharding.PartitionSpec))


@pytest.mark.parametrize("name", configs.ARCH_NAMES)
def test_cache_specs_are_jax_s(name):
    cfg, jcfg = configs.get_config(name), jconfigs.get_config(name)
    for m in (1, 2, 16):
        arch, jarch = build.make_archdef(cfg, m), jbuild.make_archdef(jcfg, m)
        for ba in (None, "data", ("pod", "data")):
            for la in (None, "data"):
                got = build.cache_specs(arch, ba, la)
                assert got == jax_tuples(jbuild.cache_specs(jarch, ba, la)), \
                    (name, m, ba, la)
    # the model axis reaches the caches: gemma3-12b's 8 kv heads split
    # at M = 2, whole at M = 16; MLA's latent cache is never split
    if name == "gemma3_12b":
        st = build.cache_specs(build.make_archdef(cfg, 2), "data")["stacks"]
        assert st["global"]["self"]["k"] == (None, "data", None, "model",
                                             None)
        st = build.cache_specs(build.make_archdef(cfg, 16), "data", "data")
        assert st["stacks"]["local"]["self"]["k"] == (None, "data", None,
                                                      None, None)
        assert st["stacks"]["global"]["self"]["k"][2] == "data"


def fake_mesh(model: int) -> ProcessMesh:
    return ProcessMesh(pods=1, data=1, pod_rank=0, data_rank=0,
                       pod_group=None, data_group=None, backend="gloo",
                       model=model, model_rank=0)


@pytest.mark.parametrize("name", configs.ARCH_NAMES)
def test_serve_layout_reads_the_model_axis(name):
    """JAX's rule at M = 1, 2 and 16, in each regime the config trains
    in (an encoder-decoder replicated only); gemma3-12b and internvl2
    gather at M = 1 and serve resident at 16."""
    modes = (("replicated",) if configs.get_config(name).family
             in ("encdec", "audio") else ("replicated", "fsdp"))
    answers = {}
    for mode in modes:
        cfg = dataclasses.replace(configs.get_config(name), param_mode=mode)
        jcfg = dataclasses.replace(jconfigs.get_config(name),
                                   param_mode=mode)
        n = build.param_count(build.init_params(build.make_archdef(cfg),
                                                None, "meta"))
        for m in (1, 2, 16):
            topo = Topology(1, 1, "cpu", mesh=fake_mesh(m) if m > 1
                            else None)
            want = jbuild.serve_layout(
                jcfg, types.SimpleNamespace(model_shards=m), n)
            assert build.serve_layout(cfg, topo, n) == want, (name, mode, m)
            answers[mode, m] = want
    if name in ("gemma3_12b", "internvl2_76b"):
        assert answers["fsdp", 1] == "gather"
        assert answers["fsdp", 16] == "resident"
    assert all(answers["replicated", m] == "resident" for m in (1, 2, 16))


def test_the_rank_s_serve_tree():
    """At M = 2 (model rank 0): ``serve_params_abstract`` gives each leaf
    the rank's block, ``serve_param_specs`` the compute specs (resident),
    and ``serve_params_from_tree`` takes edge 0 of a tree state's [P_loc,
    *block] blocks as views."""
    from repro_torch.core import shardflat
    from repro_torch.launch import specs

    cfg = configs.get_smoke("deepseek_v3_671b")
    topo = Topology(2, 2, "cpu", mesh=fake_mesh(2))
    built = build.build_model(cfg, topo)
    whole = build.build_model(cfg, ONE).init_params(
        torch.Generator().manual_seed(0))
    layout = shardflat.param_layout(topo, built.bundle.specs, whole)
    local = shardflat.logical(topo, layout, shardflat.local_block(
        topo, layout, whole))
    meta = specs.serve_params_abstract(built)
    for got, want in zip(pytree.tree_flatten(meta)[0],
                         pytree.tree_flatten(local)[0]):
        assert got.device.type == "meta" and got.dtype == torch.bfloat16
        assert got.shape == want.shape
    assert meta["stacks"]["moe"]["moe"]["w_up"].shape[1] == \
        cfg.moe.n_experts // 2
    assert specs.serve_param_specs(built) is built.bundle.specs
    edges = pytree.tree_map(lambda x: torch.stack([x, x + 1.0]), local)
    served = specs.serve_params_from_tree(edges, built=built)
    for got, want, src in zip(pytree.tree_flatten(served)[0],
                              pytree.tree_flatten(local)[0],
                              pytree.tree_flatten(edges)[0]):
        assert torch.equal(got, want)
        assert got.untyped_storage().data_ptr() == \
            src.untyped_storage().data_ptr()


# -- over the ranks -----------------------------------------------------------------

def requests(cfg, n_tokens: int, seed: int, rows: int = B) -> dict:
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab,
                                    (rows, n_tokens)).astype(np.int64)}
    if cfg.encoder_layers:
        batch["frames"] = (0.1 * rng.standard_normal(
            (rows, cfg.encoder_frames, cfg.frontend_dim))).astype(np.float32)
    if cfg.n_patches:
        batch["patches"] = (0.02 * rng.standard_normal(
            (rows, cfg.n_patches, cfg.d_model))).astype(np.float32)
    return batch


def jax_batch(batch: dict) -> dict:
    return {k: jnp.asarray(v.astype(np.int32) if k == "tokens" else v)
            for k, v in batch.items()}


@functools.lru_cache(maxsize=None)
def jax_model(arch: str):
    jbuilt, p = jax_params(jconfigs.get_smoke(arch))
    return (p, jax.jit(jbuilt.prefill, static_argnums=2),
            jax.jit(jbuilt.decode_step))


def jax_run(arch: str, batch: dict, max_len: int, steps: list) -> dict:
    """JAX's prefill and each decode step from its own cache, both
    variants of each step (the cache as it is, and widened)."""
    p, jprefill, jdecode = jax_model(arch)
    logits, cache = jprefill(p, jax_batch(batch), max_len)
    out = {"logits": np.asarray(logits, np.float32),
           "caches": [jax.tree.map(np.asarray, cache)], "given": []}
    for tok in steps:
        step = {}
        for name, src in (("bf16", cache), ("f32", jax.tree.map(
                lambda a: a.astype(jnp.float32)
                if jnp.issubdtype(a.dtype, jnp.floating) else a, cache))):
            lg, nxt = jdecode(p, src, jnp.asarray(tok.astype(np.int32)))
            step[name] = {"logits": np.asarray(lg, np.float32),
                          "cache": jax.tree.map(np.asarray, nxt)}
        out["given"].append(step)
        cache = jax.tree.map(jnp.asarray, step["bf16"]["cache"])
        out["caches"].append(jax.tree.map(np.asarray, cache))
    return out


@functools.lru_cache(maxsize=None)
def specs_and_jax() -> tuple:
    """The mesh job's cases and JAX's runs of the published ones."""
    cases, jax_out = {}, {}
    for name, (arch, over, prompt, max_len, with_jax) in CASES.items():
        cfg = W.smoke_config(configs, arch, over)
        if with_jax:
            params = jax_model(arch)[0]
        else:
            params = convert.params_to_numpy(build.build_model(
                cfg, ONE).init_params(torch.Generator().manual_seed(0)))
        batch = requests(cfg, prompt + STEPS, 1)
        tokens = batch["tokens"]
        batch["tokens"] = tokens[:, :prompt]
        steps = [tokens[:, prompt + s:prompt + s + 1] for s in range(STEPS)]
        max_len += cfg.n_patches
        spec = {"arch": arch, "overrides": over, "params": params,
                "requests": batch, "max_len": max_len, "steps": steps}
        if with_jax:
            jax_out[name] = jax_run(arch, batch, max_len, steps)
            spec.update(given=jax_out[name]["caches"][:STEPS],
                        given_tokens=steps)
        cases[name] = spec
    cases[BF16_CASE] = dict(cases["gemma3-at-window"], dtype="bfloat16",
                            given=(), given_tokens=())
    cases[DROP_CASE] = drop_case()
    return cases, jax_out


def drop_case() -> dict:
    """deepseek-v3's smoke config on 4 requests (one a batch rank), the
    first two the same prompt and token: at a decode step the call's 4
    tokens are one group of capacity max(1, int(4 * 2 / 8 * 1.5)) = 1,
    so the second request's routed pairs drop behind the first's."""
    cfg = configs.get_smoke("deepseek_v3_671b")
    batch = requests(cfg, 9, 5, rows=4)
    batch["tokens"][1] = batch["tokens"][0]
    steps = [batch["tokens"][:, 8:9]]
    batch["tokens"] = batch["tokens"][:, :8]
    return {"arch": "deepseek_v3_671b", "params": jax_model(
        "deepseek_v3_671b")[0], "requests": batch, "max_len": 12,
        "steps": steps}


def flat_spec() -> dict:
    cfg = configs.get_smoke("gemma3_1b")
    return {"arch": "gemma3_1b", "steps": 1, "max_len": 8,
            "requests": requests(cfg, 6, 3)}


CHIP = {   # chip_smoke.py's serve part at the smoke configs: name ->
           # (arch, overridden fields, served from a trained master)
    "gemma3-1b": ("gemma3_1b", {}, False),
    "deepseek-v3": ("deepseek_v3_671b", {}, False),
    "internvl2": ("internvl2_76b", {}, False),
    "xlstm-350m": ("xlstm_350m", {}, True),
    "zamba2-2.7b": ("zamba2_2p7b", {}, True),
    "whisper-base": ("whisper_base", {}, True),
}


@functools.lru_cache(maxsize=None)
def mesh_run() -> dict:
    cases, _ = specs_and_jax()
    return SW.run(*MESH, {"cases": cases, "flat": flat_spec(),
                          "chip": CHIP})


@functools.lru_cache(maxsize=None)
def one_process(name: str) -> dict:
    return SW.serve_case(ONE, specs_and_jax()[0][name])


def close(got, want, tol: float, what: str) -> None:
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.abs(got - want).max())
    assert err <= tol * float(np.abs(want).max()), (what, err)


def check_cache(got: dict, want: dict, what: str, want_dtypes=None,
                bf16_tol: float = LOGITS_TOL) -> None:
    """A gathered cache against a reference (``want_dtypes``: its leaves'
    dtype names, else the arrays' own): pos, the tree, the dtypes;
    float32 leaves within STATE_TOL of their largest, bfloat16 leaves
    within one bfloat16 ulp and ``bf16_tol`` of their largest."""
    assert got["pos"] == int(np.asarray(want["pos"])), what
    g, g_td = pytree.tree_flatten(got["stacks"])
    dt = pytree.tree_flatten(got["dtypes"])[0]
    w = jax.tree.leaves(want["stacks"])
    wdt = (pytree.tree_flatten(want_dtypes)[0] if want_dtypes is not None
           else [a.dtype.name for a in w])
    assert len(g) == len(w) == len(wdt), what
    for a, b, da, db in zip(g, w, dt, wdt):
        assert da == db and a.shape == b.shape, (what, da, db, a.shape,
                                                 b.shape)
        b = np.asarray(b, np.float32)
        if da == "bfloat16":
            np.testing.assert_allclose(
                a, b, rtol=BF16_ULP,
                atol=bf16_tol * float(np.abs(b).max()), err_msg=what)
        else:
            close(a, b, STATE_TOL, what)


def greedy_agrees(got: list, want: list) -> int:
    """Every step's greedy token of every row equal, except where the
    reference's two largest logits are closer than twice the step's
    largest |difference| (where that difference could swap them);
    returns the positions skipped."""
    skipped = 0
    for g, w in zip(got, want):
        g, w = g[:, -1], w[:, -1]
        top2 = np.sort(w, axis=-1)[:, -2:]
        clear = (top2[:, 1] - top2[:, 0]) > 2 * np.abs(g - w).max()
        assert np.array_equal(g.argmax(-1)[clear], w.argmax(-1)[clear])
        skipped += int((~clear).sum())
    return skipped


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_serve_matches_one_process(name):
    got, one = mesh_run()["cases"][name], one_process(name)
    assert got["shards"] == 2 and got["rows"] == B // 4
    close(got["own"]["logits"][0], one["own"]["logits"][0], LOGITS_TOL,
          f"{name} prefill logits")
    check_cache(got["own"]["caches"][0], one["own"]["caches"][0],
                f"{name} prefill cache", one["own"]["caches"][0]["dtypes"])
    for s, (g, w) in enumerate(zip(got["given"], one["given"])):
        close(g["f32"]["logits"], w["f32"]["logits"], LOGITS_TOL,
              f"{name} decode {s} on the float32 cache")
        close(g["bf16"]["logits"], w["bf16"]["logits"],
              BF16_CACHE_LOGITS_TOL, f"{name} decode {s} on the bf16 cache")
        for k, tol in (("f32", LOGITS_TOL), ("bf16", BF16_CACHE_LOGITS_TOL)):
            check_cache(g[k]["cache"], w[k]["cache"],
                        f"{name} decode {s} {k} cache",
                        w[k]["cache"]["dtypes"], tol)
    assert len(got["own"]["logits"]) == STEPS + 1
    for s, (g, w) in enumerate(zip(got["own"]["logits"],
                                   one["own"]["logits"])):
        assert np.isfinite(g).all(), (name, s)
        close(g, w, BF16_CACHE_LOGITS_TOL, f"{name} own chain, step {s}")
    # two of the 11 x 8 x 4 positions skipped: a step each of gemma3 at
    # and above its window
    assert greedy_agrees(got["own"]["logits"], one["own"]["logits"]) <= 1


@pytest.mark.parametrize("name", [n for n, c in CASES.items() if c[4]])
def test_sharded_serve_matches_jax(name):
    got, want = mesh_run()["cases"][name], specs_and_jax()[1][name]
    close(got["own"]["logits"][0], want["logits"], LOGITS_TOL,
          f"{name} prefill logits")
    check_cache(got["own"]["caches"][0], want["caches"][0],
                f"{name} prefill cache")
    assert len(got["given"]) == STEPS
    for s, (g, w) in enumerate(zip(got["given"], want["given"])):
        close(g["f32"]["logits"], w["f32"]["logits"], LOGITS_TOL,
              f"{name} decode {s} on the float32 cache")
        close(g["bf16"]["logits"], w["bf16"]["logits"],
              BF16_CACHE_LOGITS_TOL, f"{name} decode {s} on the bf16 cache")
        for k, tol in (("f32", LOGITS_TOL), ("bf16", BF16_CACHE_LOGITS_TOL)):
            check_cache(g[k]["cache"], w[k]["cache"],
                        f"{name} decode {s} {k} cache", bf16_tol=tol)


@pytest.mark.parametrize("name", [*CASES, BF16_CASE, DROP_CASE])
def test_rank_cache_bytes_are_the_reckoning(name):
    own = mesh_run()["cases"][name]["own"]
    assert own["bytes"] == [own["reckoned"]] * len(own["bytes"])
    spec = specs_and_jax()[0][name]
    cfg = W.smoke_config(configs, spec["arch"], spec.get("overrides"))
    whole = build.cache_bytes(build.make_archdef(cfg, 2),
                              spec["requests"]["tokens"].shape[0],
                              spec["max_len"], None,
                              getattr(torch, spec.get("dtype", "float32")))
    # a quarter of the rows, and at most the whole of the rest
    assert whole / 8 <= own["reckoned"] <= whole / 4


def test_bfloat16_served_over_the_mesh():
    got, one = mesh_run()["cases"][BF16_CASE], one_process(BF16_CASE)
    for s, (g, w) in enumerate(zip(got["own"]["logits"],
                                   one["own"]["logits"])):
        assert np.isfinite(g).all()
        close(g, w, BF16_SERVED_TOL, f"bf16 served, step {s}")


def test_moe_drops_the_pairs_one_process_drops():
    """The two identical requests sit on batch ranks 0 and 1 (pod 0, data
    ranks 0 and 1).  In one process the second's routed pairs drop
    behind the first's, so its logits differ from the first's at the
    decode step; the mesh drops the same pairs: every row within 1e-5 of
    one process, at prefill (one group of 32 tokens straddling the four
    batch ranks, capacity 12) and at the decode step."""
    got, one = mesh_run()["cases"][DROP_CASE], one_process(DROP_CASE)
    want = one["own"]["logits"]
    assert not np.allclose(want[1][0], want[1][1], rtol=0, atol=1e-3)
    for s, (g, w) in enumerate(zip(got["own"]["logits"], want)):
        close(g, w, LOGITS_TOL, f"drops, step {s}")


def test_serving_the_flat_state_of_a_mesh_run():
    """Every pod's ranks serve edge 0 of a state taken mid-round (after
    one step of a round of two the pods' first edges differ), as the
    JAX package does: pod 0's as views of its bucket, pod 1's as views
    of the row it received; every row of every batch rank within 1e-5
    of one process serving edge 0's gathered parameters."""
    flat = mesh_run()["flat"]
    assert flat["shared_storage"] and flat["bucket"][0] == 1
    assert flat["edges_differ"]
    for a in pytree.tree_flatten(flat["params"])[0]:
        assert np.array_equal(a[0], a[1])
    spec = flat_spec()
    built = build.build_model(configs.get_smoke("gemma3_1b"), ONE)
    params = convert.params_from_numpy(pytree.tree_map(
        lambda a: a[0], flat["params"]))
    logits, _ = built.prefill(params, SW._rows(ONE, spec["requests"]),
                              spec["max_len"])
    close(flat["logits"], logits.numpy(), LOGITS_TOL, "flat state")


def test_the_mesh_moved_bytes_on_every_group():
    """The cases' serving crossed the model group (the row-parallel sums,
    the head's gather), the data and pod groups (the MoE's expert ids, and
    the tests' own gathers of the rows and caches)."""
    traffic = mesh_run()["traffic"]
    assert all(traffic[g]["sent"] > 0 for g in ("data", "pod", "model"))


def test_chip_smoke_serve_part_rehearsed_on_the_cpu():
    """``chip_smoke.py``'s serve part (``tp_serve``) ran on these ranks at
    the smoke configs, and its report's checks pass as on the card: the
    reference, the cache bytes, no kernel launched, the trained
    masters' edge 0 served zero-copy (one buffer a rank, on pod 0 its
    bucket), and each group's bytes a rank sends
    in the prefill and a decode step those ``reckon_tp_serve_bytes``
    reckons, to the byte."""
    cs = SW._chip_smoke()
    cells = {name: W.smoke_config(configs, arch, over)
             for name, (arch, over, _) in CHIP.items()}
    ranks = mesh_run()["chip"]
    assert len(ranks) == 8
    cs.tp_serve_report(torch, "cpu", ranks, cells)
    for name, (_, _, trained) in CHIP.items():
        per = [r["serve_tp"][name] for r in ranks]
        assert len([x for x in per if "rel_err" in x]) == 1
        if trained:
            assert all(x["views_zero_copy"] for x in per)
        bytes_ = per[0]["decode_bytes"][0]
        assert bytes_["model"]["sent"] > 0
        if name == "deepseek-v3":     # one group over the 4 batch ranks
            assert bytes_["data"]["sent"] > 0 and bytes_["pod"]["sent"] > 0
