"""The moe and vlm families tensor-parallel over a model axis, on gloo CPU
ranks, float32.

The smoke configs: deepseek-v3's (MLA, the MTP head, a shared expert, a
leading dense MLA layer), arctic's (GQA and the dense residual MLP) and
internvl2's (the patches before the tokens), and cases with a field
replaced: deepseek's with the ``"gather"`` dispatch, with 3 MLA heads
(which do not divide M=2, so every rank runs them whole), and arctic's
with 3 experts (which do not divide M=2: spec None, run whole).  One
spawn a world:

  * a 1 x 1 x 2 mesh (each rank the whole P=2 x D=2 block and one model
    shard): the [P, D] losses -- MTP's included -- within atol 1e-5 and
    every gradient leaf, gathered over the model group, within 1e-5 of
    its scale (``assert_close``) of the one-process port; for the three
    configs as published, the same at
    JAX's own seed-0 parameters against ``jax.grad`` of JAX's
    ``make_loss_single`` on each device's tokens (JAX's sharded math is
    its unsharded math, so no JAX mesh); the copies' gradients bitwise
    the same on each model rank; 6 steps of ``run_training`` of
    deepseek's smoke config over the mesh whose loss falls;
  * a 2 x 2 x 2 mesh (blocks 1 x 1): deepseek's and internvl2's smoke
    configs in the FSDP regime, 3 steps (DC, fused), bitwise the
    replicated regime (ag_packed) over the same ranks, their bytes on
    the model group those ``chip_smoke.py`` reckons for the card.
"""
import concurrent.futures
import functools
import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, str(pathlib.Path(__file__).parent / "helpers"))
import torch_fsdp_worker as FW  # noqa: E402
import torch_mesh_worker as MW  # noqa: E402
import torch_tp_worker as W  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.core.topology import single_device_topology  # noqa: E402
from repro.models import build as jbuild  # noqa: E402
from repro_torch import configs, convert  # noqa: E402
from repro_torch.core import pytree  # noqa: E402
from repro_torch.core.topology import Topology  # noqa: E402
from repro_torch.models import build  # noqa: E402

CASES = {     # name -> (arch, overridden fields)
    "deepseek": ("deepseek_v3_671b", {}),
    "deepseek-gather": ("deepseek_v3_671b", {"moe": {"dispatch": "gather"}}),
    "deepseek-3-heads": ("deepseek_v3_671b", {"n_heads": 3,
                                              "n_kv_heads": 3}),
    "arctic": ("arctic_480b", {}),
    "arctic-3-experts": ("arctic_480b", {"moe": {"n_experts": 3}}),
    "internvl2": ("internvl2_76b", {}),
}
JAX_CASES = ("deepseek", "arctic", "internvl2")
P, D, B, SEQ = 2, 2, 2, 16
LM = {"arch": "deepseek_v3_671b", "steps": 6, "t_e": 3, "seq": 16,
      "batch": 2}
FSDP_ARCHS = ("deepseek_v3_671b", "internvl2_76b")
FSDP_STEPS = 3


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def inputs(cfg, seed: int = 0) -> dict:
    """[P, D, B, SEQ] tokens (and a vlm's [P, D, B, n_patches, d_model]
    patches, 0.02 x standard normal), numpy."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab, (P, D, B, SEQ))
           .astype(np.int64)}
    if cfg.n_patches:
        out["patches"] = (0.02 * rng.standard_normal(
            (P, D, B, cfg.n_patches, cfg.d_model))).astype(np.float32)
    return out


@functools.lru_cache(maxsize=None)
def port_spec(case: str) -> dict:
    arch, over = CASES[case]
    cfg = W.smoke_config(configs, arch, over)
    built = build.build_model(cfg, Topology(1, 1, "cpu"))
    params = convert.params_to_numpy(built.init_params(
        torch.Generator().manual_seed(0)))
    return {"arch": arch, "overrides": over, "params": params,
            **inputs(cfg)}


@functools.lru_cache(maxsize=None)
def jax_built(case: str):
    arch, over = CASES[case]
    jbuilt = jbuild.build_model(W.smoke_config(jconfigs, arch, over),
                                single_device_topology())
    params = jax.tree.map(np.asarray,
                          jbuilt.init_params(jax.random.PRNGKey(0)))
    return jbuilt, dict(port_spec(case), params=params)


@functools.lru_cache(maxsize=None)
def jax_grads(case: str) -> dict:
    """JAX's [P, D] losses and per-device gradients at its seed-0
    parameters on port_spec's tokens (and patches)."""
    jbuilt, spec = jax_built(case)
    loss_fn = jbuild.make_loss_single(jbuilt.arch)
    value_grad = jax.jit(jax.value_and_grad(
        lambda pp, b: loss_fn(pp, b, None)))

    def batch(p, d):
        b = {"tokens": jnp.asarray(spec["tokens"][p, d], jnp.int32)}
        if "patches" in spec:
            b["patches"] = jnp.asarray(spec["patches"][p, d])
        return b

    per = [[value_grad(spec["params"], batch(p, d)) for d in range(D)]
           for p in range(P)]
    losses = np.array([[float(v) for v, _ in row] for row in per])
    leaves = [[jax.tree.leaves(g) for _, g in row] for row in per]
    grads = [np.stack([np.stack([np.asarray(dev[i]) for dev in row])
                       for row in leaves])
             for i in range(len(jax.tree.leaves(spec["params"])))]
    return {"losses": losses, "grads": grads}


def fsdp_cells() -> dict:
    """deepseek's and internvl2's smoke configs, FSDP and replicated, from
    the port's seed-0 parameters on seeded [P, D] batches."""
    out = {}
    for arch in FSDP_ARCHS:
        cfg = configs.get_smoke(arch)
        w0 = convert.params_to_numpy(build.build_model(
            cfg, Topology(1, 1, "cpu")).init_params(
                torch.Generator().manual_seed(0)))
        base = {"kind": arch, "w0": w0,
                "batches": [inputs(cfg, 100 + s) for s in range(FSDP_STEPS)],
                "ew": np.full(P, 0.5, np.float32),
                "dw": np.full((P, D), 0.5, np.float32),
                "mask": np.ones((P, D), np.float32),
                "method": "dc_hier_signsgd", "t_e": 2, "mu": 1e-3,
                "mu_sgd": 0.1, "rho": 1.0, "steps": FSDP_STEPS}
        out[f"{arch}/fsdp"] = dict(base, fsdp=True, transport="fused")
        out[f"{arch}/replicated"] = dict(base, fsdp=False,
                                         transport="ag_packed")
    return out


@functools.lru_cache(maxsize=None)
def runs() -> dict:
    """Both meshes' results; JAX's gradients are taken while the ranks
    run."""
    job = {"dense": {**{case: port_spec(case) for case in CASES},
                     **{f"{case}/jax": jax_built(case)[1]
                        for case in JAX_CASES}},
           "lm": LM}
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        small = pool.submit(W.run_mesh, 1, 1, 2, (P, D), job)
        big = pool.submit(FW.run, 2, 2, 2, (1, 1), {"cells": fsdp_cells()})
        for case in JAX_CASES:
            jax_grads(case)
        return {"1x1x2": small.result(), "2x2x2": big.result()}


@functools.lru_cache(maxsize=None)
def one_process(case: str) -> dict:
    return W.dense_grads(Topology(P, D, "cpu"), port_spec(case))


def leaf_names(tree, prefix="") -> list:
    if not isinstance(tree, dict):
        return [prefix]
    return [n for k in sorted(tree)
            for n in leaf_names(tree[k], f"{prefix}.{k}" if prefix else k)]


def assert_close(got: dict, losses, grads) -> None:
    """The losses within atol 1e-5; each gradient leaf within 1e-5 of its
    scale, max(1, its largest |value|) -- atol 1e-5 for every leaf but
    the embedding table, whose gradient reaches 8-10 in deepseek's smoke
    config (no embedding scale, the table read twice with MTP), where
    float32's reordered model-group sums move it by 1.4-2.0e-5."""
    np.testing.assert_allclose(got["losses"], losses, rtol=0, atol=1e-5)
    gl = pytree.tree_flatten(got["grads"])[0]
    assert len(gl) == len(grads)
    for g, w in zip(gl, grads):
        assert g.shape == w.shape
        np.testing.assert_allclose(
            g, w, rtol=0, atol=1e-5 * max(1.0, float(np.abs(w).max())))


@pytest.mark.parametrize("case", list(CASES))
def test_tp_gradients_match_one_process(case):
    got, want = runs()["1x1x2"]["dense"][case], one_process(case)
    assert got["shards"] == 2
    # a rank holds its block of the experts and of the heads where their
    # count divides M, and the routed experts whole where it does not
    names = leaf_names(port_spec(case)["params"])
    sharded = dict(zip(names, got["sharded"]))
    cfg = W.smoke_config(configs, *CASES[case])
    assert sharded["embed.table"]
    if cfg.moe is not None:
        assert sharded["stacks.moe.moe.w_gate"] == (
            cfg.moe.n_experts % 2 == 0)
        assert sharded["stacks.moe.attn.wo"] == (cfg.n_heads % 2 == 0)
        assert not sharded["stacks.moe.moe.router"]
    else:
        assert sharded["stacks.dense.attn.wq"] and sharded[
            "stacks.dense.mlp.up"]
    assert_close(got, want["losses"], pytree.tree_flatten(want["grads"])[0])


@pytest.mark.parametrize("case", JAX_CASES)
def test_tp_gradients_match_jax(case):
    got, want = runs()["1x1x2"]["dense"][f"{case}/jax"], jax_grads(case)
    assert_close(got, want["losses"], want["grads"])


@pytest.mark.parametrize("case", list(CASES))
def test_tp_copies_get_the_whole_gradient_on_every_model_rank(case):
    dense = runs()["1x1x2"]["dense"]
    assert dense[case]["copies_agree"]
    if case in JAX_CASES:
        assert dense[f"{case}/jax"]["copies_agree"]


def test_run_training_tensor_parallel_lowers_deepseek_s_loss():
    losses = runs()["1x1x2"]["lm"]["losses"]
    assert len(losses) == LM["steps"]
    assert all(np.isfinite(losses))
    assert np.mean(losses[LM["t_e"]:]) < losses[0]
    want = MW.lm_run(Topology(P, D, "cpu"), LM)["losses"]
    np.testing.assert_allclose(losses[0], want[0], rtol=1e-5)


@pytest.mark.parametrize("arch", FSDP_ARCHS)
def test_fsdp_over_a_model_axis_is_bitwise_replicated(arch):
    """Over 2 x 2 x 2 ranks the FSDP regime (each layer's model block
    gathered over the data group, experts and heads split over the
    model group) trains bitwise the replicated regime's run."""
    cells = runs()["2x2x2"]["cells"]
    fsdp, repl = cells[f"{arch}/fsdp"], cells[f"{arch}/replicated"]
    assert fsdp["losses"] == repl["losses"]
    assert all(np.isfinite(fsdp["losses"]))
    fl, rl = (pytree.tree_flatten(c["params"])[0] for c in (fsdp, repl))
    assert len(fl) == len(rl)
    for a, b in zip(fl, rl):
        np.testing.assert_array_equal(np.asarray(a, np.float32).view(np.int32),
                                      np.asarray(b, np.float32).view(np.int32))
    # the model sums crossed the model group, and a rank holds less of
    # every FSDP master than of the replicated one where the leaf shards
    assert fsdp["traffic"]["model"]["sent"] > 0
    fs, rs = fsdp["shapes"]["params"], repl["shapes"]["params"]
    assert sum(np.prod(s) for s in fs) < sum(np.prod(s) for s in rs)


def test_chip_smoke_reckons_the_model_group_s_sums():
    """``chip_smoke.py``'s reckoning of the bytes a rank sends on the
    model group (``reckon_tp_model_bytes``, which it prints beside the
    card's deepseek-v3 and internvl2 runs) is the 2 x 2 x 2 FSDP cells'
    ``comm.traffic`` to the byte: 3 steps at T_E=2 are two prologue
    steps and a local one, with float32 activations."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", pathlib.Path(__file__).resolve().parents[1]
        / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    for arch in FSDP_ARCHS:
        cfg = configs.get_smoke(arch)
        want = cs.reckon_tp_model_bytes(cfg, build.make_archdef(cfg, 2), B,
                                        SEQ, 2, elt=4)
        got = runs()["2x2x2"]["cells"][f"{arch}/fsdp"]["traffic"]
        assert got["model"]["sent"] == (2 * want["prologue_step"]
                                        + want["local_step"]), arch
