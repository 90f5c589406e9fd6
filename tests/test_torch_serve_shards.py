"""Serving from the data ranks' shards: the gather layout of FSDP-stored
weights, one request replicated over the batch ranks, and a cache split
by length over the data ranks (long_500k's layout), on the CPU.

  * one process, the gather layout (the gather the identity): the
    gemma3-12b, deepseek-v3 and internvl2 smoke configs set to FSDP,
    prefill and 3 decode steps against JAX's one-device
    ``make_serve_fns(jarch, topo, "gather")`` on JAX's seed-0
    parameters, as ``tests/test_torch_tp_serve.py`` holds the resident
    serve: prefill logits within 1e-5 of the largest, the caches by its
    leaf rule, each step from JAX's cache -- on the float32-widened
    cache within 1e-5, on the bfloat16 one within 2^-8;
  * one spawn of a 2 x 2 x 2 gloo mesh
    (``helpers/torch_serve_shards_worker.py``):

      - (a) the same FSDP configs and arctic's, trained one step by
        ``run_training`` in the FSDP regime over the mesh, served in the
        gather layout from each rank's shards
        (``specs.serve_params_from_tree``): bitwise the resident serve
        of edge 0 of the gathered state (``convert.gather_train_state``)
        cut to the rank's compute blocks, on every rank, and within 1e-5
        (prefill) and 2^-8 (the steps on the bfloat16 cache) of one
        process's serve of edge 0;
      - (b) one request (b = 1) served replicated over the batch ranks,
        resident and gathered, deepseek-v3's routing included: every
        batch rank's logits the same bits, within the same tolerances
        of one process's;
      - (c) ``len_axis="data"`` at b = 1: gemma3-1b with ``max_len`` 16
        (blocks of 8: a 6-token prompt, then steps of 1, 2 -- across the
        boundary -- and 1 token; and a 10-token prompt longer than a
        block), zamba2 (the tied attention), deepseek-v3 (MLA's latent
        cache) and xlstm (nothing split: its cache the unsplit one),
        each against one process (logits, the caches by the leaf rule)
        and each step from JAX's cache against JAX's;
      - (d) every rank's cache bytes ``build.cache_bytes``'s, and the
        data group's bytes of every call -- the layers' shards gathered,
        the split attention's combines -- ``chip_smoke.py``'s
        reckonings, to the byte;
      - (e) a planted fault: the combine replaced by each rank's own
        block reads more than 100x the float32 limit on the straddling
        case;
      - the straddling case served with bfloat16 weights against one
        process's bfloat16 serve, within 2^-4 of the largest logit.
"""
import dataclasses
import functools
import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, str(pathlib.Path(__file__).parent / "helpers"))
import torch_serve_shards_worker as SH  # noqa: E402
import torch_tp_serve_worker as SW  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import build as jbuild  # noqa: E402
from repro_torch import configs, convert  # noqa: E402
from repro_torch.core import pytree  # noqa: E402
from repro_torch.core.topology import Topology  # noqa: E402
from repro_torch.models import build  # noqa: E402
from test_torch_lm import jax_params  # noqa: E402
from test_torch_tp_serve import (BF16_CACHE_LOGITS_TOL,  # noqa: E402
                                 BF16_SERVED_TOL, BF16_ULP, LOGITS_TOL,
                                 check_cache, close, jax_batch, jax_run,
                                 requests)

MESH = (2, 2, 2)
ONE = Topology(1, 1, "cpu")
B = 8                          # requests of the split rows: 2 a batch rank
PROMPT, STEPS = 6, 3
GATHER_ARCHS = ("gemma3_12b", "deepseek_v3_671b", "internvl2_76b")
MESH_FSDP = GATHER_ARCHS + ("arctic_480b",)
SPLIT_MAX_LEN = 16             # two blocks of 8 over the data ranks
SPLIT = {      # name -> (arch, prompt, tokens a decode step)
    "gemma3-straddle": ("gemma3_1b", 6, (1, 2, 1)),
    "gemma3-long-prompt": ("gemma3_1b", 10, (1, 1)),
    "zamba2": ("zamba2_2p7b", 10, (1, 1)),
    "deepseek-v3": ("deepseek_v3_671b", 6, (1, 2, 1)),
    "xlstm": ("xlstm_350m", 6, (1, 1)),
}
FAULT = "gemma3-straddle-fault"   # the straddling case, the combine gone
FAULT_FACTOR = 100
BF16 = "gemma3-straddle-bf16"     # the straddling case, bfloat16 weights


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def fsdp(configs_, arch: str):
    return dataclasses.replace(configs_.get_smoke(arch), param_mode="fsdp")


# -- one process, against JAX's gather serve ------------------------------------

@functools.lru_cache(maxsize=None)
def jax_gather(arch: str):
    jbuilt, p = jax_params(fsdp(jconfigs, arch))
    prefill, decode = jbuild.make_serve_fns(jbuilt.arch, jbuilt.topo,
                                            "gather")
    return p, jax.jit(prefill, static_argnums=2), jax.jit(decode)


def port_cache(cache: dict) -> dict:
    return {"stacks": SH._numpy(cache["stacks"]), "pos": cache["pos"],
            "dtypes": pytree.tree_map(lambda x: str(x.dtype).split(".")[-1],
                                      cache["stacks"])}


@pytest.mark.parametrize("arch", GATHER_ARCHS)
def test_gather_layout_matches_jax(arch):
    p, jprefill, jdecode = jax_gather(arch)
    cfg = fsdp(configs, arch)
    batch = requests(cfg, PROMPT + STEPS, 1, rows=2)
    tokens = batch["tokens"]
    batch["tokens"] = tokens[:, :PROMPT]
    steps = [tokens[:, PROMPT + s:PROMPT + s + 1] for s in range(STEPS)]
    max_len = PROMPT + STEPS + cfg.n_patches
    built = build.build_model(cfg, ONE, layout="gather")
    assert built.serve_layout == "gather"
    params = convert.params_from_numpy(p)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    tb["tokens"] = tb["tokens"].long()
    logits, cache = built.prefill(params, tb, max_len)
    jl, jc = jprefill(p, jax_batch(batch), max_len)
    close(logits, jl, LOGITS_TOL, f"{arch} prefill logits")
    check_cache(port_cache(cache), jax.tree.map(np.asarray, jc),
                f"{arch} prefill cache")
    for s, tok in enumerate(steps):
        jtok = jnp.asarray(tok.astype(np.int32))
        for name, dt, tol in (("bf16", None, BF16_CACHE_LOGITS_TOL),
                              ("f32", torch.float32, LOGITS_TOL)):
            src = convert.cache_from_numpy(jax.tree.map(np.asarray, jc))
            jsrc = jc
            if dt is not None:
                src["stacks"] = pytree.tree_map(lambda x: x.to(dt),
                                                src["stacks"])
                jsrc = jax.tree.map(
                    lambda a: a.astype(jnp.float32)
                    if jnp.issubdtype(a.dtype, jnp.floating) else a, jc)
            lg, nc = built.decode_step(params, src,
                                       torch.from_numpy(tok).long())
            jlg, jnc = jdecode(p, jsrc, jtok)
            close(lg, jlg, tol, f"{arch} decode {s} on the {name} cache")
            check_cache(port_cache(nc), jax.tree.map(np.asarray, jnc),
                        f"{arch} decode {s} {name} cache", bf16_tol=tol)
        jc = jdecode(p, jc, jtok)[1]


# -- over the ranks ---------------------------------------------------------------

def fsdp_spec(arch: str) -> dict:
    cfg = fsdp(configs, arch)
    batch = requests(cfg, PROMPT + STEPS, 2)
    tokens = batch["tokens"]
    batch["tokens"] = tokens[:, :PROMPT]
    return {"arch": arch, "requests": batch,
            "steps": [tokens[:, PROMPT + s:PROMPT + s + 1]
                      for s in range(STEPS)],
            "max_len": PROMPT + STEPS + cfg.n_patches}


def split_spec(name: str) -> dict:
    base = name.removesuffix("-fault").removesuffix("-bf16")
    arch, prompt, sizes = SPLIT[base]
    cfg = configs.get_smoke(arch)
    batch = requests(cfg, prompt + sum(sizes), 3, rows=1)
    tokens = batch["tokens"]
    batch["tokens"] = tokens[:, :prompt]
    steps, at = [], prompt
    for n in sizes:
        steps.append(tokens[:, at:at + n])
        at += n
    spec = {"arch": arch, "params": jax_model_params(arch),
            "requests": batch, "steps": steps, "max_len": SPLIT_MAX_LEN}
    if name.endswith("-bf16"):
        spec.update(dtype="bfloat16", given=(), given_tokens=())
        return spec
    jax_out = jax_split(base)
    spec.update(given=jax_out["caches"][:len(steps)], given_tokens=steps,
                fault=name.endswith("-fault"))
    return spec


def jax_model_params(arch: str):
    from test_torch_tp_serve import jax_model
    return jax_model(arch)[0]


@functools.lru_cache(maxsize=None)
def jax_split(name: str) -> dict:
    """JAX's one-device serve of the case's one request on its unsplit
    cache: the prefill and each step from its own cache."""
    arch, prompt, sizes = SPLIT[name]
    cfg = configs.get_smoke(arch)
    batch = requests(cfg, prompt + sum(sizes), 3, rows=1)
    tokens = batch["tokens"]
    batch["tokens"] = tokens[:, :prompt]
    steps, at = [], prompt
    for n in sizes:
        steps.append(tokens[:, at:at + n])
        at += n
    return jax_run(arch, batch, SPLIT_MAX_LEN, steps)


@functools.lru_cache(maxsize=None)
def mesh_run() -> list:
    job = {"fsdp": {a: fsdp_spec(a) for a in MESH_FSDP},
           "split": {n: split_spec(n) for n in [*SPLIT, FAULT, BF16]}}
    return SH.run(*MESH, job)


@functools.lru_cache(maxsize=None)
def one_split(name: str) -> dict:
    return SH.split_case(ONE, split_spec(name))


@functools.lru_cache(maxsize=None)
def one_fsdp(arch: str) -> dict:
    """One process's serve of edge 0 of the mesh run's trained state: the
    split rows' 8 requests, and the first alone."""
    spec = fsdp_spec(arch)
    edge0 = mesh_run()[0]["fsdp"][arch]["edge0"]
    cfg = fsdp(configs, arch)
    built = build.build_model(cfg, ONE, layout="resident")
    params = convert.params_from_numpy(edge0)
    out = {}
    for rows, sl in (("split", slice(None)), ("replicated", slice(0, 1))):
        batch = {k: torch.from_numpy(np.ascontiguousarray(v[sl]))
                 for k, v in spec["requests"].items()}
        batch["tokens"] = batch["tokens"].long()
        logits, cache = built.prefill(params, batch, spec["max_len"])
        got = [logits.numpy()]
        for tok in spec["steps"]:
            logits, cache = built.decode_step(params, cache,
                                              torch.from_numpy(tok[sl]).long())
            got.append(logits.numpy())
        out[rows] = got
    return out


@pytest.mark.parametrize("rows", ["split", "replicated"])
@pytest.mark.parametrize("arch", MESH_FSDP)
def test_gather_layout_over_the_mesh(arch, rows):
    """(a), (b): bitwise the resident serve on every rank; against one
    process; one request's logits the same on every batch rank."""
    ranks = [r["fsdp"][arch][rows] for r in mesh_run()]
    assert all(x["bitwise"] for x in ranks)
    got, want = ranks[0]["logits"], one_fsdp(arch)[rows]
    if rows == "replicated":
        for g in got:       # [batch ranks, 1, V]: the same bits on each
            assert all(np.array_equal(g[0], g[i]) for i in range(len(g)))
        got = [g[:1] for g in got]
    close(got[0], want[0], LOGITS_TOL, f"{arch} {rows} prefill")
    for s, (g, w) in enumerate(zip(got[1:], want[1:])):
        close(g, w, BF16_CACHE_LOGITS_TOL, f"{arch} {rows} step {s}")
    for x in ranks:
        assert x["cache_bytes"] == [x["reckoned"]] * (STEPS + 1)


def chain_cache(got: dict, want: dict, what: str) -> None:
    """A cache after decode steps on the bfloat16 caches against one
    process's: the dtypes and ``pos``, every leaf within 2^-8 of its
    largest -- the float32 states too, which every step's roundings in
    another order reach (zamba2's after its shared attention) -- and
    a bfloat16 leaf one ulp besides."""
    assert got["pos"] == int(np.asarray(want["pos"])), what
    wants = pytree.tree_flatten(want["stacks"])[0]
    dts = pytree.tree_flatten(got["dtypes"])[0]
    assert dts == (pytree.tree_flatten(want["dtypes"])[0] if "dtypes" in want
                   else [np.asarray(b).dtype.name for b in wants]), what
    for a, b, dt in zip(pytree.tree_flatten(got["stacks"])[0], wants, dts):
        b = np.asarray(b, np.float32)
        np.testing.assert_allclose(
            a, b, rtol=BF16_ULP if dt == "bfloat16" else 0,
            atol=BF16_CACHE_LOGITS_TOL * float(np.abs(b).max()),
            err_msg=what)


@pytest.mark.parametrize("name", list(SPLIT))
def test_split_length_matches_one_process_and_jax(name):
    """(c): the logits and caches against one process's unsplit serve and
    each step from JAX's cache against JAX's."""
    got, one = mesh_run()[0]["split"][name], one_split(name)
    want = jax_split(name)
    close(got["logits"][0], one["logits"][0], LOGITS_TOL, f"{name} prefill")
    close(got["logits"][0], want["logits"], LOGITS_TOL,
          f"{name} prefill vs JAX")
    check_cache(got["caches"][0], one["caches"][0], f"{name} prefill cache",
                one["caches"][0]["dtypes"])
    for s in range(1, len(got["logits"])):
        close(got["logits"][s], one["logits"][s], BF16_CACHE_LOGITS_TOL,
              f"{name} step {s}")
        chain_cache(got["caches"][s], one["caches"][s], f"{name} cache {s}")
    for s, (g, w) in enumerate(zip(got["given"], want["given"])):
        close(g["f32"]["logits"], w["f32"]["logits"], LOGITS_TOL,
              f"{name} given step {s} on the float32 cache")
        check_cache(g["f32"]["cache"], w["f32"]["cache"],
                    f"{name} given step {s} float32 cache")
        # on the bfloat16 cache the combine's float32 weights meet values
        # that JAX's softmax rounds to bfloat16 first: the logits and
        # every state downstream move by up to such a rounding
        close(g["bf16"]["logits"], w["bf16"]["logits"],
              BF16_CACHE_LOGITS_TOL, f"{name} given step {s} on the bf16 "
              "cache")
        chain_cache(g["bf16"]["cache"], w["bf16"]["cache"],
                    f"{name} given step {s} bf16 cache")
    # every data rank ends with the same logits
    for r in mesh_run():
        for a, b in zip(r["split"][name]["logits"], got["logits"]):
            assert np.array_equal(a, b)


def test_split_length_served_in_bfloat16():
    """(c) with bfloat16 weights and compute: the straddling case's
    logits finite and within 2^-4 of the largest of one process's
    bfloat16 serve on the whole cache, the same bits on every rank, and
    each rank's cache bytes ``cache_bytes``' in bfloat16."""
    got, one = mesh_run()[0]["split"][BF16], one_split(BF16)
    assert len(got["logits"]) == len(SPLIT["gemma3-straddle"][2]) + 1
    for s, (g, w) in enumerate(zip(got["logits"], one["logits"])):
        assert np.isfinite(g).all()
        close(g, w, BF16_SERVED_TOL, f"bf16 served, step {s}")
    for r in mesh_run():
        x = r["split"][BF16]
        assert x["cache_bytes"] == [x["reckoned"]] * len(x["cache_bytes"])
        for a, b in zip(x["logits"], got["logits"]):
            assert np.array_equal(a, b)
    arch_def = build.make_archdef(configs.get_smoke("gemma3_1b"), MESH[2])
    assert got["reckoned"] == build.cache_bytes(
        arch_def, 1, SPLIT_MAX_LEN, rank_topo(), torch.bfloat16,
        len_axis="data")


def rank_topo() -> Topology:
    """A rank of the 2 x 2 x 2 mesh, for the reckonings (no groups)."""
    from repro_torch.core.topology import ProcessMesh

    return Topology(2, 2, "cpu", mesh=ProcessMesh(
        pods=2, data=2, pod_rank=0, data_rank=0, pod_group=None,
        data_group=None, backend="gloo", model=2, model_rank=0))


def test_split_caches_and_bytes_are_the_reckoning():
    """(d): each rank's cache bytes after every call ``cache_bytes``'s
    (xlstm's, split nothing, the unsplit cache's); the data group's
    bytes of each call: the combine of every split attention layer at a
    decode step, the shards of every layer at every gather call, to the
    byte (``chip_smoke.reckon_combine_bytes``,
    ``reckon_serve_gather_bytes``)."""
    cs = SW._chip_smoke()
    for name, (arch, _, sizes) in SPLIT.items():
        cfg = configs.get_smoke(arch)
        arch_def = build.make_archdef(cfg, MESH[2])
        for r in mesh_run():
            x = r["split"][name]
            assert x["cache_bytes"] == [x["reckoned"]] * len(x["cache_bytes"])
            assert [t["combine_data"]["sent"] for t in x["traffic"]] == [0] + [
                cs.reckon_combine_bytes(cfg, arch_def, n, MESH[2])
                for n in sizes]
            assert all(t["combine_data"]["received"] ==
                       t["combine_data"]["sent"] * (MESH[1] - 1)
                       for t in x["traffic"])
        whole = build.cache_bytes(arch_def, 1, SPLIT_MAX_LEN, rank_topo(),
                                  torch.float32)
        if name == "xlstm":
            assert x["reckoned"] == whole
        else:
            assert x["reckoned"] < whole
    for arch in MESH_FSDP:
        cfg = fsdp(configs, arch)
        want = cs.reckon_serve_gather_bytes(cfg, MESH[1], MESH[1], MESH[2], 4)
        assert want > 0
        for r in mesh_run():
            for rows in ("split", "replicated"):
                x = r["fsdp"][arch][rows]
                for t, res in zip(x["traffic"], x["resident_traffic"]):
                    assert t["gather_serve"]["sent"] == want
                    assert t["gather_serve"]["received"] == want * (
                        MESH[1] - 1)
                    assert t["gather_serve"]["calls"] > 0
                    for op in t:
                        if op != "gather_serve":
                            assert t[op] == res[op], (arch, rows, op)
                    if rows == "replicated":
                        assert t["gather_batch_data"]["calls"] == 0


def test_a_skipped_combine_reads_far_past_the_limit():
    """(e): with each rank's own block in place of the combine, data rank
    0's float32 step at position 9 (positions 8-9 on data rank 1) reads
    more than 100x LOGITS_TOL of JAX's; the sound run reads under it."""
    want = jax_split("gemma3-straddle")["given"]
    ranks = [r for r in mesh_run() if r["coords"][1] == 0]
    for r in ranks:
        bad = r["split"][FAULT]["given"][-1]["f32"]["logits"]
        sound = r["split"]["gemma3-straddle"]["given"][-1]["f32"]["logits"]
        w = np.asarray(want[-1]["f32"]["logits"], np.float32)
        scale = float(np.abs(w).max())
        assert float(np.abs(sound - w).max()) <= LOGITS_TOL * scale
        assert float(np.abs(bad - w).max()) > FAULT_FACTOR * LOGITS_TOL \
            * scale
