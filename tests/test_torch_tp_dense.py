"""The dense family tensor-parallel over a model axis, on gloo CPU ranks.

gemma3-1b's smoke config in float32 (one kv head, so ``wk``/``wv``/
``kn`` are copies inside the split attention; ``qn`` read by each
rank's heads; the vocab-sharded tied table) on a 1 x 1 x 2 mesh (each
rank the whole P=2 x D=2 block) and a 2 x 2 x 2 mesh (blocks 1 x 1):

  * the [P, D] losses and every gradient leaf, gathered over the model
    group with the zero tails dropped, within atol 1e-5 of the
    one-process port (the forward's sums run in another order), and the
    copies' gradients bitwise the same on each model rank;
  * the same at JAX's own seed-0 parameters, against ``jax.grad`` of
    JAX's ``make_loss_single`` on each device's tokens, within atol
    1e-5 (JAX's sharded math is its unsharded math, so no JAX mesh);
  * 6 steps of ``run_training`` (DC, fused/flat) over the mesh whose
    loss falls;
  * ``launch.mesh.make_topology`` on the 8-rank world raises, naming the
    256 or 512 ranks the production grid needs.
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
import torch_mesh_worker as MW  # noqa: E402
import torch_tp_worker as W  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.core.topology import single_device_topology  # noqa: E402
from repro.models import build as jbuild  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.convert import params_to_numpy  # noqa: E402
from repro_torch.core import pytree  # noqa: E402
from repro_torch.core.topology import Topology  # noqa: E402
from repro_torch.models import build  # noqa: E402

MESHES = {"1x1x2": ((1, 1, 2), (2, 2)), "2x2x2": ((2, 2, 2), (1, 1))}
LM = {"arch": "gemma3_1b", "steps": 6, "t_e": 3, "seq": 16, "batch": 2}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def dense_spec() -> dict:
    cfg = configs.get_smoke("gemma3_1b")
    built = build.build_model(cfg, Topology(1, 1, "cpu"))
    params = params_to_numpy(built.init_params(
        torch.Generator().manual_seed(0)))
    tokens = np.random.default_rng(0).integers(
        0, cfg.vocab, (2, 2, 2, 16)).astype(np.int64)
    return {"arch": "gemma3_1b", "params": params, "tokens": tokens}


@functools.lru_cache(maxsize=None)
def jax_spec() -> dict:
    """dense_spec's tokens at JAX's seed-0 smoke parameters, and JAX's
    [P, D] losses and per-device gradients there."""
    jbuilt = jbuild.build_model(jconfigs.get_smoke("gemma3_1b"),
                                single_device_topology())
    params = jax.tree.map(np.asarray,
                          jbuilt.init_params(jax.random.PRNGKey(0)))
    tokens = dense_spec()["tokens"]
    loss_fn = jbuild.make_loss_single(jbuilt.arch)
    value_grad = jax.jit(jax.value_and_grad(
        lambda pp, t: loss_fn(pp, {"tokens": t}, None)))
    per = [[value_grad(params, jnp.asarray(tokens[p, d], jnp.int32))
            for d in range(tokens.shape[1])] for p in range(tokens.shape[0])]
    losses = np.array([[float(v) for v, _ in row] for row in per])
    leaves = [[jax.tree.leaves(g) for _, g in row] for row in per]
    grads = [np.stack([np.stack([np.asarray(dev[i]) for dev in row])
                       for row in leaves])
             for i in range(len(jax.tree.leaves(params)))]
    return {"spec": {"arch": "gemma3_1b", "params": params,
                     "tokens": tokens},
            "losses": losses, "grads": grads}


@functools.lru_cache(maxsize=None)
def runs() -> dict:
    job = {"dense": {"port": dense_spec(), "jax": jax_spec()["spec"]},
           "lm": LM}
    with concurrent.futures.ThreadPoolExecutor(len(MESHES)) as pool:
        futs = {name: pool.submit(
            W.run_mesh, *grid, block,
            dict(job, production=(False, True)) if name == "2x2x2" else job)
            for name, (grid, block) in MESHES.items()}
        return {name: fut.result() for name, fut in futs.items()}


@functools.lru_cache(maxsize=None)
def one_process() -> dict:
    return W.dense_grads(Topology(2, 2, "cpu"), dense_spec())


@pytest.mark.parametrize("mesh", list(MESHES))
def test_dense_tp_gradients_match_one_process(mesh):
    got, want = runs()[mesh]["dense"]["port"], one_process()
    assert got["shards"] == 2
    # the table, wq, wo, up, down split; the rest (one kv head) copies
    assert 0 < sum(got["sharded"]) < len(got["sharded"])
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=0,
                               atol=1e-5)
    gl = pytree.tree_flatten(got["grads"])[0]
    wl = pytree.tree_flatten(want["grads"])[0]
    assert len(gl) == len(wl)
    for g, w in zip(gl, wl):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-5)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_dense_tp_gradients_match_jax(mesh):
    got, want = runs()[mesh]["dense"]["jax"], jax_spec()
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=0,
                               atol=1e-5)
    gl = pytree.tree_flatten(got["grads"])[0]
    assert len(gl) == len(want["grads"])
    for g, w in zip(gl, want["grads"]):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-5)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_dense_tp_copies_get_the_whole_gradient_on_every_model_rank(mesh):
    dense = runs()[mesh]["dense"]
    assert dense["port"]["copies_agree"] and dense["jax"]["copies_agree"]


@pytest.mark.parametrize("mesh", list(MESHES))
def test_run_training_tensor_parallel_lowers_the_loss(mesh):
    losses = runs()[mesh]["lm"]["losses"]
    assert len(losses) == LM["steps"]
    assert all(np.isfinite(losses))
    assert np.mean(losses[LM["t_e"]:]) < losses[0]
    want = MW.lm_run(Topology(2, 2, "cpu"), LM)["losses"]
    np.testing.assert_allclose(losses[0], want[0], rtol=1e-5)


@pytest.mark.parametrize("multi_pod,need", [(False, 256), (True, 512)])
def test_make_topology_names_the_ranks_it_needs(multi_pod, need):
    msg = runs()["2x2x2"]["production"][multi_pod]
    assert msg is not None and f"needs {need} ranks" in msg
    assert "has 8" in msg
