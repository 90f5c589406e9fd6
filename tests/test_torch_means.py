"""The port's float means against the eager JAX reference, to the bit.

The edge tier's anchor mean ``sum_k (|D_qk|/D_q) g_k`` (``votes.
weighted_mean_dev``) and the cloud mean ``sum_q (D_q/N) v_q``
(``votes.pod_weighted_average``) on the parity toy at P=4 edges x D=5
devices (``tests/helpers/parity_harness.py``): the per-device gradients
of its loss at w0 on the first batch, and the edge models one sign step
apart, with unequal weights that sum to 1.  Bound: at most 1 ulp per
coordinate against eager JAX (``jnp.sum`` over the product on XLA's CPU
backend), +0 and -0 counted equal.  The port folds devices and edges in
order and XLA's CPU reduction of these short axes adds in the same
order, so the bound holds with room (0 ulp on this data); a fold order
that moved a rounding would show here first.

Subnormals included: the inputs scaled to ~1e-39, where every product
and many partial sums are subnormal.  XLA's CPU backend flushes them to
the zero of their sign, and so do the port's means.
"""
import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, str(pathlib.Path(__file__).parent / "helpers"))
import parity_harness as H  # noqa: E402

from repro.core import votes as jvotes  # noqa: E402
from repro.core.topology import single_device_topology  # noqa: E402
from repro_torch.core import signs, votes  # noqa: E402

P, D = 4, 5


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for this module's small tensors: the suite runs
    several pytest workers on the machine's cores, and PyTorch's thread
    pool in each of them would contend for the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def ulps(a, b) -> int:
    """The largest distance in float32 steps between a and b (the two
    zeros equal)."""
    def key(x):
        i = np.asarray(x, np.float32).view(np.int32).astype(np.int64)
        return np.where(i < 0, -(i & 0x7FFFFFFF), i)
    return int(np.abs(key(a) - key(b)).max())


@pytest.fixture(scope="module")
def toy():
    """Per-device gradients [P, D, *leaf] of the toy's loss at w0, the edge
    models [P, *leaf] one sign step apart, and the weights."""
    prob = H.make_problem(pods=P, devs=D)
    grad = jax.jit(jax.grad(H.loss_fn))
    grads = {k: np.stack([np.stack([np.asarray(grad(
        prob["w0"], {"x": prob["xs"][0, q, d], "y": prob["ys"][0, q, d]},
        None)[k]) for d in range(D)]) for q in range(P)])
        for k in prob["w0"]}
    models = {k: np.stack([np.asarray(prob["w0"][k]) - 1e-3 * np.sign(
        g[q].sum(0)) for q in range(P)]) for k, g in grads.items()}
    rng = np.random.default_rng(3)
    dw = rng.random((P, D)).astype(np.float32)
    dw /= dw.sum(1, keepdims=True)
    ew = rng.random(P).astype(np.float32)
    ew /= ew.sum()
    return grads, models, dw, ew


@pytest.mark.parametrize("scale", [1.0, 1e-39], ids=["normal", "subnormal"])
def test_anchor_mean_within_one_ulp_of_eager_jax(toy, scale):
    grads, _, dw, _ = toy
    topo = single_device_topology()
    for k, g in grads.items():
        g = (g * np.float32(scale)).astype(np.float32)
        want = np.asarray(jvotes.weighted_mean_dev(topo, jnp.asarray(g),
                                                   jnp.asarray(dw)))
        got = votes.weighted_mean_dev(torch.from_numpy(g),
                                      torch.from_numpy(dw)).numpy()
        assert ulps(got, want) <= 1, k
        if scale != 1.0:
            tiny = np.finfo(np.float32).tiny
            assert np.any(g != 0) and not np.any((np.abs(got) < tiny)
                                                 & (got != 0)), k


@pytest.mark.parametrize("scale", [1.0, 1e-39], ids=["normal", "subnormal"])
def test_cloud_mean_within_one_ulp_of_eager_jax(toy, scale):
    _, models, _, ew = toy
    topo = single_device_topology()
    for k, v in models.items():
        v = (v * np.float32(scale)).astype(np.float32)
        want = np.asarray(jvotes.pod_weighted_average(topo, jnp.asarray(v),
                                                      jnp.asarray(ew)))
        got = votes.pod_weighted_average(torch.from_numpy(v),
                                         torch.from_numpy(ew)).numpy()
        assert got.shape == v.shape
        assert ulps(got, want) <= 1, k


def test_clients_fold_flushes_like_the_device_fold():
    """With K=2 merged clients the fold over clients then devices flushes
    its subnormal products and partial sums too: on subnormal inputs the
    mean is all zeros, as the one-client fold's."""
    g = np.full((P, D * 2, 8), 3e-39, np.float32)
    w = np.full((P, D * 2), 0.1, np.float32)
    got = votes.weighted_mean_dev(torch.from_numpy(g), torch.from_numpy(w),
                                  clients=2)
    assert not got.any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_in_place_flush_is_the_flush(dtype):
    """``signs.ftz_`` (the streamed folds' in-place flush) gives
    ``signs.ftz``'s bits on zeros, subnormals of both signs, the smallest
    normals, NaN and the infinities."""
    x = torch.tensor([0.0, -0.0, 1e-40, -1e-40, 1.1754944e-38,
                      -1.1754944e-38, 3.0, -2.5, float("inf"),
                      float("-inf"), float("nan")]).to(dtype)
    want = signs.ftz(x)
    got = signs.ftz_(x.clone())
    assert torch.equal(got.view(torch.int16 if dtype == torch.bfloat16
                                else torch.int32)[:-1],
                       want.view(torch.int16 if dtype == torch.bfloat16
                                 else torch.int32)[:-1])
    assert torch.isnan(got[-1]) and torch.isnan(want[-1])
