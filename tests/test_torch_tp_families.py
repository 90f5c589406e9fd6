"""The ssm, hybrid and encdec/audio families tensor-parallel over a model
axis, on gloo CPU ranks, float32.

The smoke configs: xlstm's (mLSTM and sLSTM heads split), zamba2's
(Mamba2's heads and inner dim split, the tied shared attention) and
whisper's (the encoder, the cross-attention, a vocabulary of 256 that
divides M=2), and for each family a case whose heads do not divide M=2
while its inner dim does: xlstm at d_model 48 with 3 heads (the mLSTM's
mixed layout: q, k and v cut by d_in, the heads whole; the sLSTM whole),
zamba2 at d_model 96 (3 Mamba2 heads over a d_in of 192) and whisper
with 3 heads (the attention whole, the MLP split) and a vocabulary of
255 (the embedding, head and cross-entropy whole, as whisper-base's
51865).  zamba2's SSD scan overflows on its published ``a_log`` and its
gradients are NaN (ROADMAP queue 3); here every Mamba2 block's ``a_log``
is lowered by 3, as ``tests/test_torch_hybrid.py::calm`` lowers it, so
that every gradient is finite and compared.  One spawn a world:

  * a 1 x 1 x 2 mesh (each rank the whole P=2 x D=2 block and one model
    shard): the [P, D] losses within atol 1e-5 and every gradient leaf,
    gathered over the model group, within ``TOL`` of max(1, its largest
    |value|) (``assert_close``) of the one-process port; for the three
    configs as published, the same at JAX's own seed-0 parameters
    against ``jax.grad`` of JAX's ``make_loss_single`` on each device's
    tokens (and frames); the copies' gradients bitwise the same on each
    model rank;
  * a 2 x 2 x 2 mesh (blocks 1 x 1): zamba2's and xlstm's smoke configs
    in the FSDP regime, 3 steps (DC, fused), bitwise the replicated
    regime (ag_packed) over the same ranks, zamba2's shared block's
    leaves included (whisper's encoder-decoder trains replicated only,
    as in the JAX package); and the bytes each family's runs send on the
    model group (zamba2 and xlstm in both regimes, whisper replicated,
    the three mixed cases -- xlstm's in bfloat16) those
    ``chip_smoke.py`` reckons for the card.

``TOL``: 1e-5 for whisper.  xlstm's and zamba2's gradients move far more
than float32 rounding under any reordering of their sums: scaling every
parameter by ``1 + 2e-7 z`` (a rounding's worth) moves the one-process
gradients by 4.3e-5 to 1.3e-4 of a leaf's largest |value|, where the
tensor-parallel run lies 1.0e-5 to 9.1e-5 from them, and dropping
``copy_to_model`` or ``sum_model`` moves them by 1.05 and more
(``tests/helpers/torch_tp_step0_bound.py``); so they are held at 2e-4.
"""
import concurrent.futures
import functools
import importlib.util
import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, str(pathlib.Path(__file__).parent / "helpers"))
import torch_fsdp_worker as FW  # noqa: E402
import torch_tp_worker as W  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.core.topology import single_device_topology  # noqa: E402
from repro.models import build as jbuild  # noqa: E402
from repro_torch import configs, convert  # noqa: E402
from repro_torch.core import pytree  # noqa: E402
from repro_torch.core.topology import Topology  # noqa: E402
from repro_torch.models import build  # noqa: E402

CASES = {     # name -> (arch, overridden fields)
    "xlstm": ("xlstm_350m", {}),
    "xlstm-3-heads": ("xlstm_350m", {"d_model": 48, "n_heads": 3,
                                     "n_kv_heads": 3}),
    "zamba2": ("zamba2_2p7b", {}),
    "zamba2-3-heads": ("zamba2_2p7b", {"d_model": 96}),
    "whisper": ("whisper_base", {}),
    "whisper-3-heads": ("whisper_base", {"n_heads": 3, "n_kv_heads": 3,
                                         "vocab": 255}),
}
JAX_CASES = ("xlstm", "zamba2", "whisper")
TOL = {"xlstm_350m": 2e-4, "zamba2_2p7b": 2e-4, "whisper_base": 1e-5}
P, D, B, SEQ = 2, 2, 2, 16
STEPS = 3          # the FSDP runs and their replicated twins: the
                   # prologue, a local step and the next prologue
                   # (T_E=2); each other cell the first two
FSDP_CASES = ("zamba2", "xlstm")
BYTES_CELLS = {    # name -> (case, FSDP, compute dtype)
    "zamba2/fsdp": ("zamba2", True, "f32"),
    "zamba2/replicated": ("zamba2", False, "f32"),
    "xlstm/fsdp": ("xlstm", True, "f32"),
    "xlstm/replicated": ("xlstm", False, "f32"),
    "whisper/replicated": ("whisper", False, "f32"),
    "xlstm-3-heads/replicated-bf16": ("xlstm-3-heads", False, "bf16"),
    "zamba2-3-heads/replicated": ("zamba2-3-heads", False, "f32"),
    "whisper-3-heads/replicated": ("whisper-3-heads", False, "f32"),
}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def inputs(cfg, seed: int = 0) -> dict:
    """[P, D, B, SEQ] tokens (and whisper's [P, D, B, frames,
    frontend_dim] frames, 0.1 x standard normal), numpy."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab, (P, D, B, SEQ))
           .astype(np.int64)}
    if cfg.encoder_layers:
        out["frames"] = (0.1 * rng.standard_normal(
            (P, D, B, cfg.encoder_frames, cfg.frontend_dim))).astype(
                np.float32)
    return out


def calm(params: dict) -> dict:
    """zamba2's tree with every Mamba2 block's ``a_log`` lowered by 3 (no
    chunk overflows); other trees as they are."""
    if "mamba" in params["stacks"]:
        mixer = params["stacks"]["mamba"]["mamba"]
        mixer["a_log"] = mixer["a_log"] - np.float32(3.0)
    return params


def config(case: str):
    arch, over = CASES[case]
    return W.smoke_config(configs, arch, over)


@functools.lru_cache(maxsize=None)
def port_spec(case: str) -> dict:
    arch, over = CASES[case]
    cfg = config(case)
    params = convert.params_to_numpy(build.build_model(
        cfg, Topology(1, 1, "cpu")).init_params(
            torch.Generator().manual_seed(0)))
    return {"arch": arch, "overrides": over, "params": calm(params),
            **inputs(cfg)}


@functools.lru_cache(maxsize=None)
def jax_built(case: str):
    arch, over = CASES[case]
    jbuilt = jbuild.build_model(W.smoke_config(jconfigs, arch, over),
                                single_device_topology())
    params = jax.tree.map(np.asarray,
                          jbuilt.init_params(jax.random.PRNGKey(0)))
    return jbuilt, dict(port_spec(case), params=calm(params))


@functools.lru_cache(maxsize=None)
def jax_grads(case: str) -> dict:
    """JAX's [P, D] losses and per-device gradients at its seed-0
    parameters on port_spec's tokens (and frames)."""
    jbuilt, spec = jax_built(case)
    loss_fn = jbuild.make_loss_single(jbuilt.arch)
    value_grad = jax.jit(jax.value_and_grad(
        lambda pp, b: loss_fn(pp, b, None)))

    def batch(p, d):
        b = {"tokens": jnp.asarray(spec["tokens"][p, d], jnp.int32)}
        if "frames" in spec:
            b["frames"] = jnp.asarray(spec["frames"][p, d])
        return b

    per = [[value_grad(spec["params"], batch(p, d)) for d in range(D)]
           for p in range(P)]
    losses = np.array([[float(v) for v, _ in row] for row in per])
    leaves = [[jax.tree.leaves(g) for _, g in row] for row in per]
    grads = [np.stack([np.stack([np.asarray(dev[i]) for dev in row])
                       for row in leaves])
             for i in range(len(jax.tree.leaves(spec["params"])))]
    return {"losses": losses, "grads": grads}


def bytes_cells() -> dict:
    """Seeded train steps of the cases BYTES_CELLS names, from the port's
    seed-0 parameters (zamba2's as published: the sign sends a NaN
    gradient to -1 in both regimes alike)."""
    out = {}
    for name, (case, fsdp, dtype) in BYTES_CELLS.items():
        steps = STEPS if case in FSDP_CASES else 2
        arch, over = CASES[case]
        cfg = config(case)
        w0 = convert.params_to_numpy(build.build_model(
            cfg, Topology(1, 1, "cpu")).init_params(
                torch.Generator().manual_seed(0)))
        out[name] = {"kind": arch, "overrides": over, "w0": w0,
                     "batches": [inputs(cfg, 100 + s) for s in range(steps)],
                     "ew": np.full(P, 0.5, np.float32),
                     "dw": np.full((P, D), 0.5, np.float32),
                     "mask": np.ones((P, D), np.float32),
                     "method": "dc_hier_signsgd", "t_e": 2, "mu": 1e-3,
                     "mu_sgd": 0.1, "rho": 1.0, "steps": steps,
                     "fsdp": fsdp, "dtype": dtype,
                     "transport": "fused" if fsdp else "ag_packed"}
    return out


@functools.lru_cache(maxsize=None)
def runs() -> dict:
    """Both meshes' results; JAX's gradients are taken while the ranks
    run."""
    job = {"dense": {**{case: port_spec(case) for case in CASES},
                     **{f"{case}/jax": jax_built(case)[1]
                        for case in JAX_CASES}}}
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        small = pool.submit(W.run_mesh, 1, 1, 2, (P, D), job)
        big = pool.submit(FW.run, 2, 2, 2, (1, 1), {"cells": bytes_cells()})
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


def assert_close(got: dict, losses, grads, tol: float) -> None:
    """The losses within atol 1e-5; each gradient leaf within ``tol`` of
    its scale, max(1, its largest |value|)."""
    np.testing.assert_allclose(got["losses"], losses, rtol=0, atol=1e-5)
    gl = pytree.tree_flatten(got["grads"])[0]
    assert len(gl) == len(grads)
    for g, w in zip(gl, grads):
        assert g.shape == w.shape
        assert np.isfinite(w).all()
        np.testing.assert_allclose(
            g, w, rtol=0, atol=tol * max(1.0, float(np.abs(w).max())))


@pytest.mark.parametrize("case", list(CASES))
def test_tp_gradients_match_one_process(case):
    got, want = runs()["1x1x2"]["dense"][case], one_process(case)
    assert got["shards"] == 2
    # a rank holds the blocks JAX's specs give it: the inner dims split,
    # the heads' leaves where the heads divide M
    cfg = config(case)
    sharded = dict(zip(leaf_names(port_spec(case)["params"]),
                       got["sharded"]))
    split_h = cfg.n_heads % 2 == 0
    assert sharded["embed.table"] == (cfg.vocab % 2 == 0)
    if cfg.family == "ssm":
        assert sharded["stacks.mlstm.mlstm.wq"]
        assert sharded["stacks.mlstm.mlstm.wi"] == split_h
        assert sharded["stacks.slstm.slstm.wr"] == split_h
        assert not sharded["stacks.slstm.slstm.wx"]
    elif cfg.family == "hybrid":
        heads = cfg.ssm.expand * cfg.d_model // 64
        assert sharded["stacks.mamba.mamba.in_x"]
        assert sharded["stacks.mamba.mamba.a_log"] == (heads % 2 == 0)
        assert not sharded["stacks.mamba.mamba.in_b"]
        assert sharded["stacks.shared_attn.attn.wq"]
    else:
        assert sharded["enc_stacks.enc.attn.wq"] == split_h
        assert sharded["stacks.dec.xattn.wk"] == split_h
        assert sharded["enc_stacks.enc.mlp.up"]
        assert not sharded["adapter.w"]
    assert_close(got, want["losses"], pytree.tree_flatten(want["grads"])[0],
                 TOL[CASES[case][0]])


@pytest.mark.parametrize("case", JAX_CASES)
def test_tp_gradients_match_jax(case):
    got, want = runs()["1x1x2"]["dense"][f"{case}/jax"], jax_grads(case)
    assert_close(got, want["losses"], want["grads"], TOL[CASES[case][0]])


@pytest.mark.parametrize("case", list(CASES))
def test_tp_copies_get_the_whole_gradient_on_every_model_rank(case):
    dense = runs()["1x1x2"]["dense"]
    assert dense[case]["copies_agree"]
    if case in JAX_CASES:
        assert dense[f"{case}/jax"]["copies_agree"]


@pytest.mark.parametrize("case", FSDP_CASES)
def test_fsdp_over_a_model_axis_is_bitwise_replicated(case):
    """Over 2 x 2 x 2 ranks the FSDP regime (each layer's model block
    gathered over the data group; zamba2's shared block lifted once)
    trains bitwise the replicated regime's run, for each family that
    runs FSDP in one process (whisper's encoder-decoder refuses it, as
    the JAX package does)."""
    cells = runs()["2x2x2"]["cells"]
    fsdp, repl = cells[f"{case}/fsdp"], cells[f"{case}/replicated"]
    assert fsdp["losses"] == repl["losses"]
    assert all(np.isfinite(fsdp["losses"]))
    fl, rl = (pytree.tree_flatten(c["params"])[0] for c in (fsdp, repl))
    assert len(fl) == len(rl)
    for a, b in zip(fl, rl):
        np.testing.assert_array_equal(np.asarray(a, np.float32).view(np.int32),
                                      np.asarray(b, np.float32).view(np.int32))
    fs, rs = fsdp["shapes"]["params"], repl["shapes"]["params"]
    assert sum(np.prod(s) for s in fs) < sum(np.prod(s) for s in rs)


@pytest.mark.parametrize("name", list(BYTES_CELLS))
def test_chip_smoke_reckons_the_model_group_s_bytes(name):
    """``chip_smoke.py``'s reckoning of the bytes a rank sends on the
    model group (``reckon_tp_model_bytes``: the split norms' sums, the
    gathers and their reduce-scatters, the cross keys' encoder output) is
    the 2 x 2 x 2 cells' ``comm.traffic`` to the byte: at T_E=2 the
    steps are a prologue, a local step and (zamba2's third) a
    prologue."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", pathlib.Path(__file__).resolve().parents[1]
        / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    case, fsdp, dtype = BYTES_CELLS[name]
    cfg = config(case)
    want = cs.reckon_tp_model_bytes(cfg, build.make_archdef(cfg, 2), B, SEQ,
                                    2, elt=4 if dtype == "f32" else 2,
                                    fsdp=fsdp)
    cell = runs()["2x2x2"]["cells"][name]
    prologues = (len(cell["losses"]) + 1) // 2
    assert cell["traffic"]["model"]["sent"] == (
        prologues * want["prologue_step"]
        + (len(cell["losses"]) - prologues) * want["local_step"]) > 0
