"""The rest of the step -- the mean baselines, SCAFFOLD/MTGC, error
feedback, sign momentum and the overlapped cloud tier -- against the JAX
package.

  * every method and option against JAX ``make_hier_step`` on the P=D=1
    parity toy (``tests/helpers/parity_harness.py``), 3 rounds of T_E=3,
    atol 1e-5 (``hier_local_qsgd`` with the JAX step's own uniforms,
    drawn with JAX from the same keys and injected through the port's
    ``uniforms`` callable); the port's fused/flat and ag_packed/tree runs
    are bitwise each other;
  * ``hier_sgd``, SCAFFOLD, MTGC and DC under ``overlap`` against the
    ``ref_fed.global_round`` oracle at P=4 x D=5 (MLP 64-16-10, unequal
    edge and device weights, 2 rounds of T_E=3), atol 1e-5;
  * the elementwise pieces that jitted JAX contracts into FMAs (momentum,
    ``u + rho*q``, the mean update) are bitwise the eager reference.

The float paths (means, norms, autograd) sum in other orders than XLA,
so only they may differ: hence atol, the oracle cells' tolerance.
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

from repro.core import ref_fed  # noqa: E402
from repro.core.topology import single_device_topology  # noqa: E402
from repro.models import mlp as jmlp  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.core import flatbuf, hier, signs  # noqa: E402
from repro_torch.core.topology import Topology  # noqa: E402
from repro_torch.models import mlp  # noqa: E402
from test_torch_hier import mlp_problem, toy_loss  # noqa: E402

MU, MU_SGD, RHO = 5e-3, 0.05, 0.2


def run_port(problem, bundle, transport, layout, ew=None, dw=None,
             anchors=True, uniforms=None, **kw):
    """The port's trajectory on a problem dict (numpy xs/ys [S, P, D,
    ...]) with the parity harness's hyper-parameters; returns the final
    [P, *leaf] edge models."""
    pods, devs, t_e = problem["pods"], problem["devs"], problem["t_e"]
    base = dict(mu=MU, mu_sgd=MU_SGD, t_e=t_e, rho=1.0, transport=transport,
                state_layout=layout, compute_dtype=torch.float32,
                master_dtype=torch.float32, delta_dtype=torch.float32)
    base.update(kw)
    init_fn, step = hier.make_hier_step(
        Topology(pods, devs, "cpu"), hier.AlgoConfig(**base), bundle,
        uniforms=uniforms)
    state = init_fn(params_from_numpy(problem["w0"]))
    ew = np.full(pods, 1.0 / pods, np.float32) if ew is None else ew
    dw = np.full((pods, devs), 1.0 / devs, np.float32) if dw is None else dw
    xs, ys = problem["xs"], problem["ys"]
    for s in range(problem["rounds"] * t_e):
        batch = {"train": {"x": torch.from_numpy(xs[s]),
                           "y": torch.from_numpy(ys[s])}}
        if anchors:
            a = s - s % t_e
            batch["anchor"] = {"x": torch.from_numpy(xs[a]),
                               "y": torch.from_numpy(ys[a])}
        state, metrics = step(state, batch, torch.from_numpy(ew),
                              torch.from_numpy(dw), torch.ones(pods, devs))
        assert torch.isfinite(metrics["loss"])
    return {k: v.clone() for k, v in hier.edge_params(state).items()}


def jax_uniforms(shapes, pods, voters, steps, key):
    """The JAX step's QSGD uniforms, step by step and leaf by leaf:
    ``uniform(fold_in(rngs_l[p, v], leaf), leaf_shape)`` with ``rngs_l =
    split(split(rng, 3)[1], P*V)`` and ``rng`` advanced by the first key
    of each step's split (``core/hier.py``'s ``train_step`` and
    ``quantize_dev``)."""
    out, rng = [], key
    for _ in range(steps):
        rng, r_local, _ = jax.random.split(rng, 3)
        keys = jax.random.split(r_local, pods * voters).reshape(
            pods, voters, -1)
        blocks = []
        for i, shape in enumerate(shapes):
            def draw(k, i=i, shape=shape):
                return jax.random.uniform(jax.random.fold_in(k, i), shape)
            blocks.append(np.asarray(jax.vmap(jax.vmap(draw))(keys)))
        out.append(blocks)
    return out


@pytest.fixture(scope="module")
def toy_problem():
    prob = H.make_problem(pods=1, devs=1)
    return dict(prob, w0=jax.tree.map(np.asarray, prob["w0"]),
                xs=np.asarray(prob["xs"]), ys=np.asarray(prob["ys"]))


TOY_CASES = [
    ("hier_sgd", {}), ("hier_local_qsgd", {}),
    ("scaffold_hier_signsgd", {}),
    ("mtgc_hier_signsgd", {"cloud_period": 1}),
    ("mtgc_hier_signsgd", {"cloud_period": 2}),
    ("dc_hier_signsgd", {"error_feedback": True}),
    ("dc_hier_signsgd", {"momentum": 0.9}),
    ("hier_signsgd", {"error_feedback": True, "momentum": 0.9}),
    ("dc_hier_signsgd", {"cloud_overlap": "overlap"}),
    ("scaffold_hier_signsgd", {"cloud_overlap": "overlap"}),
    ("mtgc_hier_signsgd", {"cloud_overlap": "overlap"})]
TOY_IDS = ["hier_sgd", "qsgd", "scaffold", "mtgc_cp1", "mtgc_cp2", "dc_ef",
           "dc_mom", "hier_ef_mom", "dc_overlap", "scaffold_overlap",
           "mtgc_overlap"]


@pytest.mark.parametrize("method,kw", TOY_CASES, ids=TOY_IDS)
def test_step_matches_jax_make_hier_step(toy_problem, method, kw):
    """P=D=1 parity toy, 3 rounds of T_E=3: the port's fused/flat and
    ag_packed/tree runs are bitwise each other and within atol 1e-5 of
    the JAX step (QSGD with the JAX step's uniforms injected)."""
    want, _ = H.run_hier(single_device_topology(), toy_problem, method,
                         "ag_packed", "tree", **kw)
    uniforms = None
    if method == "hier_local_qsgd":
        shapes = [tuple(np.shape(v)) for _, v in
                  sorted(toy_problem["w0"].items())]
        draws = jax_uniforms(shapes, 1, 1, 9, jax.random.PRNGKey(1))

        def uniforms(step, leaf, shape, voters):
            assert shape == (1, len(voters)) + shapes[leaf]
            return torch.from_numpy(draws[step][leaf][:, list(voters)])
    bundle = hier.ModelBundle(loss=toy_loss)
    runs = [run_port(toy_problem, bundle, t, lay, method=method,
                     uniforms=uniforms, **kw)
            for t, lay in (("fused", "flat"), ("ag_packed", "tree"))]
    for k in want:
        assert torch.equal(runs[0][k], runs[1][k]), k
        np.testing.assert_allclose(runs[0][k][0].numpy(), want[k][0],
                                   rtol=0, atol=1e-5, err_msg=k)
    moved = sum(float(np.abs(want[k] - toy_problem["w0"][k]).sum())
                for k in want)
    assert moved > 0


def test_qsgd_uniforms_from_the_generator_repeat_and_differ(toy_problem):
    """Without an injected callable the uniforms come from per-client
    streams keyed by the state generator's seed: one seed repeats the run
    bitwise, the trajectory moves, and it is not the run with the JAX
    draws."""
    bundle = hier.ModelBundle(loss=toy_loss)
    a, b = (run_port(toy_problem, bundle, "ag_packed", lay,
                     method="hier_local_qsgd") for lay in ("tree", "flat"))
    zero = run_port(toy_problem, bundle, "ag_packed", "tree",
                    method="hier_local_qsgd",
                    uniforms=lambda s, i, shape, voters: torch.ones(shape))
    for k in a:
        assert torch.equal(a[k], b[k]), k
    # u = 1 keeps nothing: the quantized gradient is 0 and nothing moves
    for k, v in zero.items():
        assert torch.equal(v[0], torch.as_tensor(toy_problem["w0"][k])), k
    assert any(not torch.equal(a[k], zero[k]) for k in a)
    with pytest.raises(ValueError, match="uniforms for leaf 0"):
        run_port(toy_problem, bundle, "ag_packed", "tree",
                 method="hier_local_qsgd",
                 uniforms=lambda s, i, shape, voters: torch.ones(3))


ORACLE_CASES = [("hier_sgd", {}), ("scaffold_hier_signsgd", {}),
                ("mtgc_hier_signsgd", {"cloud_period": 2}),
                ("dc_hier_signsgd", {"cloud_overlap": "overlap"})]


@pytest.mark.parametrize("method,kw", ORACLE_CASES,
                         ids=["hier_sgd", "scaffold", "mtgc", "dc_overlap"])
def test_step_matches_ref_fed_oracle(method, kw):
    """P=4 edges x D=5 devices, MLP 64-16-10, unequal edge and device
    weights, 2 rounds of T_E=3, fused/flat: the cloud aggregate of the
    port's edge models is the oracle's model within atol 1e-5 (under
    ``overlap`` the oracle's in-flight aggregate, which the port's final
    edge models issue)."""
    prob = mlp_problem(4, 5, 3, 2)
    rng = np.random.default_rng(7)
    ew = rng.random(4).astype(np.float32)
    ew /= ew.sum()
    dw = rng.random((4, 5)).astype(np.float32)
    dw /= dw.sum(1, keepdims=True)
    got = run_port(prob, mlp.make_bundle(), "fused", "flat", ew=ew, dw=dw,
                   anchors=False, method=method, rho=RHO, **kw)
    grad_fn = jax.jit(lambda p, b, r: jax.grad(jmlp.loss_fn)(p, b))
    state = ref_fed.init_state(jax.tree.map(jnp.asarray, prob["w0"]), 4)
    cfg = ref_fed.HierConfig(mu=MU, mu_sgd=MU_SGD, t_e=3, rho=RHO,
                             method=method, **kw)
    xs, ys = prob["xs"], prob["ys"]
    for t in range(2):
        batches = [[[{"x": xs[t * 3 + tau, q, k], "y": ys[t * 3 + tau, q, k]}
                     for tau in range(3)] for k in range(5)]
                   for q in range(4)]
        anchors = [[{"x": xs[t * 3, q, k], "y": ys[t * 3, q, k]}
                    for k in range(5)] for q in range(4)]
        state = ref_fed.global_round(state, cfg, grad_fn, batches, anchors,
                                     [float(x) for x in ew],
                                     [[float(x) for x in row] for row in dw],
                                     jax.random.PRNGKey(0))
    want = state.w_inflight if kw.get("cloud_overlap") else state.w
    for k, leaf in got.items():
        agg = np.tensordot(ew.astype(np.float64), leaf.numpy(), axes=1)
        np.testing.assert_allclose(agg, np.asarray(want[k]), rtol=0,
                                   atol=1e-5, err_msg=k)


def eager_and_jit(fn, *arrays):
    args = [jnp.asarray(a) for a in arrays]
    return np.asarray(fn(*args)), np.asarray(jax.jit(fn)(*args))


def test_elementwise_pieces_follow_the_eager_reference():
    """Momentum ``beta*m + (1-beta)*g``, the correction ``u + rho*q`` and
    the mean update ``v - mu*d``: the port rounds each product before the
    add, bitwise the eager JAX expressions; jitted JAX on the CPU
    contracts them into fused multiply-adds and differs in last bits
    (ROADMAP section 3)."""
    rng = np.random.default_rng(0)
    m, g, v = (rng.standard_normal(20000).astype(np.float32)
               for _ in range(3))
    tm, tg, tv = map(torch.from_numpy, (m, g, v))
    mu = np.float32(MU_SGD)
    cases = {
        "momentum": (lambda a, b: 0.9 * a + (1.0 - 0.9) * b, (m, g),
                     flatbuf.scaled(tm, 0.9) + flatbuf.scaled(tg, 1.0 - 0.9)),
        "correction": (lambda a, b: a + RHO * b, (m, g),
                       tm + flatbuf.scaled(tg, RHO)),
        "mean update": (lambda a, b: a - mu * b, (v, g),
                        signs.descend_mean(tv, torch.tensor(mu), tg)),
    }
    for name, (fn, arrays, port) in cases.items():
        eager, jitted = eager_and_jit(fn, *arrays)
        np.testing.assert_array_equal(port.numpy().view(np.int32),
                                      eager.view(np.int32), err_msg=name)
        assert not np.array_equal(eager, jitted), name


def test_mean_update_flushes_like_the_eager_reference():
    """``v - mu*d`` with subnormal operands and results: XLA's CPU backend
    counts subnormal operands as zeros and flushes subnormal results, in
    eager JAX as in the port's ``signs.descend_mean``."""
    v = np.array([1e-40, -1e-40, 1.0, 3e-39, 2e-38, -1.0], np.float32)
    d = np.array([0.0, 0.0, 1e-39, 1.0, 1e-38, 2e-38], np.float32)
    mu = np.float32(0.5)
    want = np.asarray(jnp.asarray(v) - mu * jnp.asarray(d))
    got = signs.descend_mean(torch.from_numpy(v), torch.tensor(mu),
                             torch.from_numpy(d))
    np.testing.assert_array_equal(got.numpy().view(np.int32),
                                  want.view(np.int32))
