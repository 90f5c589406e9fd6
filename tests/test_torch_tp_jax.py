"""The port's model axis against the JAX package's sharded step on a 2 x
2 x 2 (pod, data, model) mesh.

``tests/helpers/torch_tp_jax_check.py`` runs JAX in a subprocess with 8
forced host devices (the way ``sharded_fused_check.py`` does) and writes
an npz; the port runs 8 gloo CPU ranks (``torch_tp_worker.py``) on the
same inputs, concurrently:

  * one ``votes.fused_sign_vote_update`` on the toy tree's sharded
    layout at hidden 64 and 65: the port's ranks each update their own
    bucket (words gathered over the data group only), and the global
    multi-bucket buffer they make must be bitwise JAX's;
  * the toy's real-gradient DC trajectory (``parity_harness.run_hier``,
    fused/flat and ag_packed/tree, 3 rounds of T_E=3) against the port's
    tensor-parallel toy (``w`` column-parallel, ``w2`` row-parallel, the
    product summed over the model group) at atol 1e-5.
"""
import concurrent.futures
import functools
import os
import pathlib
import subprocess
import sys
import tempfile

import numpy as np
import pytest

HELPERS = pathlib.Path(__file__).parent / "helpers"
sys.path.insert(0, str(HELPERS))
import torch_tp_worker as W  # noqa: E402

HIDS = (64, 65)
RHO, MU = 0.2, 5e-3
STEPS = 9                       # make_problem's 3 rounds of T_E = 3


def inputs() -> dict:
    rng = np.random.default_rng(3)
    inp = {"hids": np.array(HIDS), "rho": RHO, "mu": MU}
    for h in HIDS:
        for k, s in W.toy_shapes(h).items():
            inp[f"u{h}/{k}"] = rng.standard_normal((2, 2) + s).astype(
                np.float32)
            inp[f"v{h}/{k}"] = rng.standard_normal((2,) + s).astype(
                np.float32)
            inp[f"delta{h}/{k}"] = rng.standard_normal((2,) + s).astype(
                np.float32)
    return inp


def tree(f, prefix: str) -> dict:
    return {k.split("/", 1)[1]: np.asarray(f[k]) for k in f
            if k.startswith(prefix + "/")}


def run_jax(inp: dict, tmp: str) -> dict:
    src, dst = os.path.join(tmp, "in.npz"), os.path.join(tmp, "out.npz")
    np.savez(src, **inp)
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=os.pathsep.join(
        [str(HELPERS.parents[1] / "src"), os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.run([sys.executable,
                           str(HELPERS / "torch_tp_jax_check.py"), src, dst],
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    with np.load(dst) as f:
        return {k: f[k] for k in f.files}


def port_job(inp: dict, h: int, jax_out: dict) -> dict:
    xs, ys = jax_out[f"xs{h}"], jax_out[f"ys{h}"]
    prob = {"kind": "toy", "w0": tree(jax_out, f"w0{h}"),
            "batches": [{"x": xs[s], "y": ys[s]} for s in range(STEPS)],
            "ew": np.full(2, 0.5, np.float32),
            "dw": np.full((2, 2), 0.5, np.float32),
            "mask": np.ones((2, 2), np.float32)}
    cell = {"method": "dc_hier_signsgd", "transport": "fused",
            "state_layout": "flat", "t_e": 3, "mu": MU, "mu_sgd": 0.05,
            "rho": 1.0, "clients": None, "algo": {}, "problem": prob,
            "steps": STEPS}
    return {"transport": {"u": tree(inp, f"u{h}"), "v": tree(inp, f"v{h}"),
                          "delta": tree(inp, f"delta{h}"), "rho": RHO,
                          "mu": MU},
            "cells": {"toy": cell}}


@functools.lru_cache(maxsize=None)
def runs() -> dict:
    """JAX's npz, and the port's 8-rank results at each width (the JAX
    subprocess first writes the toy problems the port then trains on,
    so the two meshes run one after the other)."""
    inp = inputs()
    with tempfile.TemporaryDirectory() as tmp:
        jax_out = run_jax(inp, tmp)
    with concurrent.futures.ThreadPoolExecutor(len(HIDS)) as pool:
        futs = {h: pool.submit(W.run_mesh, 2, 2, 2, (1, 1),
                               port_job(inp, h, jax_out)) for h in HIDS}
        port = {h: fut.result() for h, fut in futs.items()}
    return {"jax": jax_out, "port": port}


@pytest.mark.parametrize("hid", HIDS)
def test_sharded_fused_vote_update_is_bitwise_jax(hid):
    r = runs()
    got = r["port"][hid]["transport"]
    want = r["jax"][f"vote{hid}"]
    assert int(r["jax"][f"shards{hid}"]) == 2
    assert got["n_pad"] == int(r["jax"][f"n_pad{hid}"])
    assert got["in_place"]
    assert got["buf"].shape == want.shape
    np.testing.assert_array_equal(got["buf"].view(np.int32),
                                  want.view(np.int32))
    # the words crossed the data group only: one gather of the rank's
    # bucket words, nothing over the model group
    t = got["traffic"]
    assert t["gather_devices"]["calls"] == 1
    assert t["gather_devices"]["sent"] == 4 * got["bucket_words"]
    assert all(t[op]["calls"] == 0 for op in ("sum_model", "copy_to_model",
                                              "max_model", "gather_model"))


@pytest.mark.parametrize("transport", ["fused", "ag_packed"])
@pytest.mark.parametrize("hid", HIDS)
def test_tp_toy_trajectory_matches_jax_run_hier(hid, transport):
    r = runs()
    cell = r["port"][hid]["cells"]["toy"]
    assert cell["shards"] == 2 and cell["copies_agree"]
    want = tree(r["jax"], f"{transport}{hid}")
    for k, w in want.items():
        np.testing.assert_allclose(cell["params"][k], w, rtol=0, atol=1e-5,
                                   err_msg=k)
