"""The port's votes and train step against the JAX package.

  * ``votes.fused_sign_vote`` / ``fused_sign_vote_update`` are bitwise
    the JAX functions on the same numpy directions, correction, mask and
    master (P=2 edges x D=3 devices, f32 and bf16 leaves);
  * across {ag_packed, ar_int8, fused} x {tree, flat} the port's
    trajectories are bitwise identical;
  * the whole step agrees with JAX ``make_hier_step`` (P=D=1, the parity
    toy of ``tests/helpers/parity_harness.py``) and with the
    ``ref_fed.global_round`` oracle (P=4, D=5, the MLP narrowed to
    64-16-10) within atol 1e-5, the oracle cells' tolerance: autograd in
    PyTorch and XLA sum in different orders, so only the float path may
    differ;
  * with active virtual clients the streamed client sweep is bitwise the
    merged voter axis for both sign methods x 3 transports x 2 layouts x
    the parity harness's five participation regimes, the step agrees
    with JAX ``make_hier_step`` on the same ``ClientConfig`` (merged and
    stream) within atol 1e-5, and with gradients injected
    (``tests/helpers/injected_grads.py``) bitwise.
"""
import dataclasses
import functools
import pathlib
import sys

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

sys.path.insert(0, str(pathlib.Path(__file__).parent / "helpers"))
import injected_grads  # noqa: E402
import parity_harness as H  # noqa: E402

from repro.core import flatbuf as jflat  # noqa: E402
from repro.core import hier as jhier  # noqa: E402
from repro.core import ref_fed  # noqa: E402
from repro.core import votes as jvotes  # noqa: E402
from repro.core.topology import single_device_topology  # noqa: E402
from repro.models import mlp as jmlp  # noqa: E402
from repro_torch.convert import (params_from_numpy,  # noqa: E402
                                 params_to_numpy, tensor_from_numpy)
from repro_torch.core import flatbuf, hier, pytree, votes  # noqa: E402
from repro_torch.core.topology import Topology  # noqa: E402
from repro_torch.kernels.sign_pack import sign_pack  # noqa: E402
from repro_torch.models import mlp  # noqa: E402

P, D = 2, 3
RHO, MU = 0.2, 5e-3
NP_DTYPES = {"f32": np.float32, "bf16": ml_dtypes.bfloat16}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for this module's small tensors: the suite runs
    several pytest workers on the machine's cores, and PyTorch's thread
    pool in each of them would contend for the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def toy_shapes():
    return {"w": (16, 64), "b": (33,), "w2": (64, 33)}


def rand_tree(lead, dtype, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {k: (rng.standard_normal(lead + s) * scale).astype(dtype)
            for k, s in toy_shapes().items()}


def make_mask(kind):
    return {"none": None,
            "bool": np.array([[True, False, True], [True, True, True]]),
            "int": np.array([[2, 0, 1], [0, 0, 0]], np.int32)}[kind]


def jtree(tree):
    return jax.tree.map(jnp.asarray, tree)


def as_np(tree):
    return jax.tree.map(lambda a: np.asarray(a).astype(np.float32), tree)


def assert_trees_equal(got, want):
    got = params_to_numpy(got)
    for k in want:
        np.testing.assert_array_equal(
            np.asarray(got[k]).astype(np.float32).view(np.int32),
            np.asarray(want[k]).astype(np.float32).view(np.int32), err_msg=k)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("mask_kind", ["none", "bool", "int"])
def test_fused_sign_vote_matches_reference(dt, mask_kind):
    u = rand_tree((P, D), NP_DTYPES[dt], 0)
    delta = rand_tree((P,), NP_DTYPES[dt], 1, scale=2.0)
    mask = make_mask(mask_kind)
    jm = None if mask is None else jnp.asarray(mask)
    want = jvotes.fused_sign_vote(single_device_topology(), jtree(u),
                                  jtree(delta), RHO, jm)
    tm = None if mask is None else torch.from_numpy(mask)
    got = votes.fused_sign_vote(params_from_numpy(u),
                                params_from_numpy(delta), RHO, tm)
    assert_trees_equal(got, as_np(want))
    # the per-leaf route (no kernel code) agrees as well
    tl = flatbuf.make_layout(params_from_numpy(u), batch_dims=2)
    per_leaf = votes._packed_vote(tl, params_from_numpy(u),
                                  params_from_numpy(delta), RHO, tm)
    assert_trees_equal(flatbuf.unflatten_tree(tl, per_leaf, 1, cast=False),
                       as_np(want))


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("mask_kind", ["none", "bool", "int"])
@pytest.mark.parametrize("mu_static", [MU, None], ids=["kernel_mu",
                                                        "traced_mu"])
def test_fused_sign_vote_update_matches_reference(dt, mask_kind, mu_static):
    """The flat-state update: through the vote_update kernel's in-place
    read-modify-write for an f32 master with a static mu, else the
    vote-only route and ``v - mu * vote``."""
    u = rand_tree((P, D), NP_DTYPES[dt], 2)
    v = rand_tree((P,), np.float32, 3)
    delta = rand_tree((P,), np.float32, 4, scale=2.0)
    mask = make_mask(mask_kind)
    jl = jflat.make_layout(jtree(v), batch_dims=1)
    jv = jflat.flatten_tree(jl, jtree(v), batch_dims=1)
    jd = jflat.flatten_tree(jl, jtree(delta), batch_dims=1)
    want = jvotes.fused_sign_vote_update(
        single_device_topology(), jl, jtree(u), jd, RHO,
        None if mask is None else jnp.asarray(mask), jv,
        jnp.float32(MU), mu_static=mu_static)
    tl = flatbuf.make_layout(params_from_numpy(v), batch_dims=1)
    tv = tensor_from_numpy(np.asarray(jv))
    td = tensor_from_numpy(np.asarray(jd))
    got = votes.fused_sign_vote_update(
        tl, params_from_numpy(u), td, RHO,
        None if mask is None else torch.from_numpy(mask), tv,
        torch.tensor(MU, dtype=torch.float32), mu_static=mu_static)
    assert (got is tv) == (mu_static is not None)    # in place via kernel
    np.testing.assert_array_equal(got.numpy().view(np.int32),
                                  np.asarray(want).view(np.int32))


def test_vote_ar_int8_refuses_unbounded_integer_weights():
    s = torch.ones((P, D, 32), dtype=torch.int8)
    w = torch.ones((P, D), dtype=torch.int32)
    with pytest.raises(ValueError, match="weight_bound"):
        votes.vote_ar_int8(s, w)
    assert votes.vote_ar_int8(s, w, weight_bound=3).dtype == torch.int8
    assert votes._tally_acc(127) == torch.int8
    assert votes._tally_acc(128) == torch.int16
    assert votes._tally_acc(40000) == torch.int32


@pytest.mark.parametrize("mask_kind", ["none", "bool", "int"])
def test_vote_transports_match_reference(mask_kind):
    rng = np.random.default_rng(5)
    s = rng.choice([-1, 1], size=(P, D, 7, 64)).astype(np.int8)
    mask = make_mask(mask_kind)
    jm = None if mask is None else jnp.asarray(mask)
    tm = None if mask is None else torch.from_numpy(mask)
    topo = single_device_topology()
    want_ag = np.asarray(jvotes.vote_ag_packed(topo, jnp.asarray(s), jm,
                                               jax.sharding.PartitionSpec()))
    want_ar = np.asarray(jvotes.vote_ar_int8(topo, jnp.asarray(s), jm,
                                             weight_bound=3))
    np.testing.assert_array_equal(
        votes.vote_ag_packed(torch.from_numpy(s), tm).numpy(), want_ag)
    np.testing.assert_array_equal(
        votes.vote_ar_int8(torch.from_numpy(s), tm, weight_bound=3).numpy(),
        want_ar)
    np.testing.assert_array_equal(want_ag, want_ar)


def test_means_match_reference():
    rng = np.random.default_rng(6)
    g = rng.standard_normal((4, 5, 33)).astype(np.float32)
    w = rng.random((4, 5)).astype(np.float32)
    ew = rng.random(4).astype(np.float32)
    topo = single_device_topology()
    np.testing.assert_allclose(
        votes.weighted_mean_dev(torch.from_numpy(g),
                                torch.from_numpy(w)).numpy(),
        np.asarray(jvotes.weighted_mean_dev(topo, jnp.asarray(g),
                                            jnp.asarray(w))),
        rtol=0, atol=1e-6)
    np.testing.assert_allclose(
        votes.pod_weighted_average(torch.from_numpy(g[:, 0]),
                                   torch.from_numpy(ew)).numpy(),
        np.asarray(jvotes.pod_weighted_average(topo, jnp.asarray(g[:, 0]),
                                               jnp.asarray(ew))),
        rtol=0, atol=1e-6)


# -- the whole step ---------------------------------------------------------

def toy_loss(params, batch):
    """The parity toy's loss (tests/helpers/parity_harness.py) on [P, D]
    copies: mean squared error per (edge, device)."""
    pred = batch["x"] @ params["w"] @ params["w2"] + \
        params["b"].unsqueeze(-2)
    return torch.mean((pred - batch["y"]) ** 2, dim=(-2, -1))


def run_port(problem, bundle, transport, layout, steps=None, ew=None,
             dw=None, anchors=True, mask=None, **kw):
    """The port's trajectory on a problem dict (numpy xs/ys [S, P, D,
    ...]); returns the final [P, *leaf] edge models as numpy."""
    pods, devs, t_e = problem["pods"], problem["devs"], problem["t_e"]
    base = dict(method="dc_hier_signsgd", mu=MU, t_e=t_e, rho=1.0,
                transport=transport, state_layout=layout,
                compute_dtype=torch.float32, master_dtype=torch.float32,
                delta_dtype=torch.float32)
    base.update(kw)
    algo = hier.AlgoConfig(**base)
    init_fn, step = hier.make_hier_step(Topology(pods, devs, "cpu"), algo,
                                        bundle)
    state = init_fn(params_from_numpy(problem["w0"]))
    ew = np.full(pods, 1.0 / pods, np.float32) if ew is None else ew
    dw = np.full((pods, devs), 1.0 / devs, np.float32) if dw is None else dw
    xs, ys = problem["xs"], problem["ys"]
    for s in range(steps or problem["rounds"] * t_e):
        batch = {"train": {"x": torch.from_numpy(xs[s]),
                           "y": torch.from_numpy(ys[s])}}
        if anchors:
            a = s - s % t_e
            batch["anchor"] = {"x": torch.from_numpy(xs[a]),
                               "y": torch.from_numpy(ys[a])}
        state, metrics = step(state, batch, torch.from_numpy(ew),
                              torch.from_numpy(dw),
                              torch.ones(pods, devs) if mask is None
                              else mask)
        assert torch.isfinite(metrics["loss"])
    return {k: v.clone() for k, v in hier.edge_params(state).items()}


CELLS = [(t, lay) for t in ("ag_packed", "ar_int8", "fused")
         for lay in ("tree", "flat")]


@pytest.fixture(scope="module")
def toy_problem():
    prob = H.make_problem(pods=1, devs=1)
    return dict(prob, w0=jax.tree.map(np.asarray, prob["w0"]),
                xs=np.asarray(prob["xs"]), ys=np.asarray(prob["ys"]))


@pytest.mark.parametrize("method,kw", [
    ("dc_hier_signsgd", {}), ("hier_signsgd", {}),
    ("dc_hier_signsgd", {"decay": True}),
    ("dc_hier_signsgd", {"anchor_staleness": 0})],
    ids=["dc", "hier", "dc_decay", "dc_fresh"])
def test_step_matches_jax_make_hier_step(toy_problem, method, kw):
    """P=D=1 parity toy, 3 rounds of T_E=3: every port cell is bitwise the
    others and within atol 1e-5 of the JAX step."""
    want, _ = H.run_hier(single_device_topology(), toy_problem, method,
                         "ag_packed", "tree", **kw)
    bundle = hier.ModelBundle(loss=toy_loss)
    runs = {c: run_port(toy_problem, bundle, *c, method=method, **kw)
            for c in CELLS}
    ref = runs[("ag_packed", "tree")]
    for cell, got in runs.items():
        for k in ref:
            assert torch.equal(got[k], ref[k]), (cell, k)
    for k in want:
        np.testing.assert_allclose(ref[k][0].numpy(), want[k][0], rtol=0,
                                   atol=1e-5, err_msg=k)


def mlp_problem(pods, devs, t_e, rounds, b=16, seed=0):
    rng = np.random.default_rng(seed)
    steps = t_e * rounds
    w0 = jax.tree.map(np.asarray, jmlp.init_mlp(jax.random.PRNGKey(seed),
                                                dim=64, hidden=16))
    xs = rng.standard_normal((steps, pods, devs, b, 64)).astype(np.float32)
    ys = rng.integers(0, 10, size=(steps, pods, devs, b)).astype(np.int32)
    return {"w0": w0, "xs": xs, "ys": ys, "pods": pods, "devs": devs,
            "t_e": t_e, "rounds": rounds}


@pytest.mark.parametrize("method", ["dc_hier_signsgd", "hier_signsgd"])
def test_step_matches_ref_fed_oracle(method):
    """P=4 edges x D=5 devices, MLP 64-16-10, unequal edge and device
    weights, 2 rounds of T_E=3: the cloud aggregate of the port's edge
    models is the oracle's w within atol 1e-5."""
    prob = mlp_problem(4, 5, 3, 2)
    rng = np.random.default_rng(7)
    ew = rng.random(4).astype(np.float32)
    ew /= ew.sum()
    dw = rng.random((4, 5)).astype(np.float32)
    dw /= dw.sum(1, keepdims=True)
    got = run_port(prob, mlp.make_bundle(), "fused", "flat", ew=ew, dw=dw,
                   anchors=False, method=method, rho=RHO)
    grad_fn = jax.jit(lambda p, b, r: jax.grad(jmlp.loss_fn)(p, b))
    state = ref_fed.init_state(jtree(prob["w0"]), 4)
    cfg = ref_fed.HierConfig(mu=MU, t_e=3, rho=RHO, method=method)
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
    for k, leaf in got.items():
        agg = np.tensordot(ew.astype(np.float64), leaf.numpy(), axes=1)
        np.testing.assert_allclose(agg, np.asarray(state.w[k]), rtol=0,
                                   atol=1e-5, err_msg=k)


@pytest.mark.parametrize("compute", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kw", [{}, {"decay": True},
                                {"anchor_staleness": 0},
                                {"method": "hier_signsgd"}],
                         ids=["dc", "decay", "fresh", "hier"])
def test_transports_and_layouts_bitwise(compute, kw):
    """P=2 x D=3 MLP, 2 rounds: the six cells give identical bits, in f32
    and in the default bf16 compute/delta dtypes (where the correction is
    added in bf16 before the kernel, not inside it)."""
    prob = mlp_problem(P, D, 3, 2, seed=1)
    opts = dict(compute_dtype=compute, delta_dtype=compute, rho=RHO)
    opts.update(kw)
    runs = {c: run_port(prob, mlp.make_bundle(), *c, anchors=False, **opts)
            for c in CELLS}
    ref = runs[("ag_packed", "tree")]
    for cell, got in runs.items():
        for k in ref:
            assert torch.equal(got[k], ref[k]), (cell, k)
    assert sign_pack.launches == 0                    # the CPU route


def test_flat_fused_update_is_in_place():
    prob = mlp_problem(P, D, 3, 1, seed=2)
    algo = hier.AlgoConfig(method="dc_hier_signsgd", mu=MU, t_e=3,
                           transport="fused", state_layout="flat",
                           compute_dtype=torch.float32)
    init_fn, step = hier.make_hier_step(Topology(P, D, "cpu"), algo,
                                        mlp.make_bundle())
    state = init_fn(params_from_numpy(prob["w0"]))
    batch = {"train": {"x": torch.from_numpy(prob["xs"][1]),
                       "y": torch.from_numpy(prob["ys"][1])}}
    state = state._replace(step=1)                  # no prologue this step
    buf = state.params.buf
    before = buf.clone()
    new, _ = step(state, batch, torch.full((P,), 1 / P),
                  torch.full((P, D), 1 / D), torch.ones(P, D))
    assert new.params.buf is buf and not torch.equal(buf, before)


def test_algo_config_validates_like_reference():
    with pytest.raises(ValueError) as exc:
        hier.AlgoConfig(method="hier_signsg")
    for m in jhier.ALL_METHODS:
        assert m in str(exc.value)
    for bad in ({"transport": "x"}, {"state_layout": "x"},
                {"cloud_period": 0}, {"cloud_overlap": "x"}):
        with pytest.raises(ValueError):
            hier.AlgoConfig(**bad)
    assert hier.ALL_METHODS == jhier.ALL_METHODS


def test_pytree_order_is_sorted_keys():
    leaves, td = pytree.tree_flatten({"w2": 1, "b": {"z": 2, "a": 3}})
    assert leaves == [3, 2, 1]
    assert pytree.tree_unflatten(td, [3, 2, 1]) == {"w2": 1,
                                                    "b": {"z": 2, "a": 3}}


# -- virtual clients: merged and stream ---------------------------------------

PC, DC, KC = 2, 3, 2          # the client cells' fleet: P x D devices x K


def stream_of(cc):
    return hier.vclients.ClientConfig(**{**cc.__dict__, "mode": "stream"})


@functools.lru_cache(maxsize=None)
def client_run(method, transport, layout, regime, mode):
    """Final edge models (numpy) of the 64-16-10 MLP, P=2 x D=3 devices x
    K=2 clients, 2 rounds of T_E=3, under a parity-harness regime."""
    cc = H.client_cfg(PC, DC, KC, regime)
    if mode == "stream":
        cc = stream_of(cc)
    prob = mlp_problem(PC, DC, 3, 2, b=8, seed=4)
    rng = np.random.default_rng(9)
    ew = rng.random(PC).astype(np.float32)
    dw = rng.random((PC, DC)).astype(np.float32)
    got = run_port(prob, mlp.make_bundle(), transport, layout,
                   ew=ew / ew.sum(), dw=dw, anchors=False, method=method,
                   rho=RHO, clients=cc)
    return {k: v.numpy() for k, v in got.items()}


@pytest.mark.parametrize("regime", H.CLIENT_REGIMES)
@pytest.mark.parametrize("transport,layout", CELLS)
@pytest.mark.parametrize("method", ["dc_hier_signsgd", "hier_signsgd"])
def test_stream_matches_merged(method, transport, layout, regime):
    """The streamed client loop (integer tally, deferred threshold) is
    bitwise the merged [P, D*K] voter axis, and every cell is bitwise the
    merged ag_packed/tree run."""
    merged = client_run(method, transport, layout, regime, "merged")
    stream = client_run(method, transport, layout, regime, "stream")
    base = client_run(method, "ag_packed", "tree", regime, "merged")
    for k in base:
        np.testing.assert_array_equal(stream[k].view(np.int32),
                                      merged[k].view(np.int32), err_msg=k)
        np.testing.assert_array_equal(merged[k].view(np.int32),
                                      base[k].view(np.int32), err_msg=k)


@pytest.mark.parametrize("mode", ["merged", "stream"])
@pytest.mark.parametrize("regime", H.CLIENT_REGIMES)
@pytest.mark.parametrize("method", ["dc_hier_signsgd", "hier_signsgd"])
def test_step_with_clients_matches_jax_make_hier_step(toy_problem, method,
                                                      regime, mode):
    """P=D=1 parity toy with K=4 clients: the port's fused/flat and
    ag_packed/tree runs are bitwise each other and within atol 1e-5 of
    the JAX step with the same ClientConfig."""
    cc = H.client_cfg(1, 1, 4, regime)
    tc = hier.vclients.ClientConfig(**cc.__dict__)
    if mode == "stream":
        cc = dataclasses.replace(cc, mode="stream")
        tc = stream_of(tc)
    want, _ = H.run_hier(single_device_topology(), toy_problem, method,
                         "ag_packed", "tree", clients=cc)
    bundle = hier.ModelBundle(loss=toy_loss)
    runs = [run_port(toy_problem, bundle, t, lay, method=method, clients=tc)
            for t, lay in (("fused", "flat"), ("ag_packed", "tree"))]
    for k in want:
        assert torch.equal(runs[0][k], runs[1][k]), k
        np.testing.assert_allclose(runs[0][k][0].numpy(), want[k][0],
                                   rtol=0, atol=1e-5, err_msg=k)


@pytest.mark.parametrize("mode", ["merged", "stream"])
@pytest.mark.parametrize("transport,layout", [("fused", "flat"),
                                              ("ar_int8", "tree")])
def test_client_granular_mask_and_empty_quorum(mode, transport, layout):
    """A [P, D, K] dev_mask multiplies the round's participation; a pod
    whose clients all abstain votes 0 and its edge model stays put, in
    both modes alike."""
    cc = H.client_cfg(PC, DC, KC, "sampled_weighted")
    if mode == "stream":
        cc = stream_of(cc)
    prob = mlp_problem(PC, DC, 3, 1, b=8, seed=5)
    algo = hier.AlgoConfig(method="dc_hier_signsgd", mu=MU, t_e=3, rho=RHO,
                           transport=transport, state_layout=layout,
                           compute_dtype=torch.float32, clients=cc)
    init_fn, step = hier.make_hier_step(Topology(PC, DC, "cpu"), algo,
                                        mlp.make_bundle())
    state = init_fn(params_from_numpy(prob["w0"]))
    ew, dw = torch.full((PC,), 1 / PC), torch.ones(PC, DC)
    mask = torch.ones(PC, DC, KC)
    mask[1] = 0.0                                   # pod 1: empty quorum
    mask[0, 0, 1] = 0.0                             # one client of pod 0
    before = None
    finals = []
    for s in range(3):
        batch = {"train": {"x": torch.from_numpy(prob["xs"][s]),
                           "y": torch.from_numpy(prob["ys"][s])}}
        state, _ = step(state, batch, ew, dw, mask)
        now = {k: v.clone() for k, v in hier.edge_params(state).items()}
        if before is not None:
            for k in now:
                assert torch.equal(now[k][1], before[k][1]), k
                assert not torch.equal(now[k][0], before[k][0]), k
        before = now
        finals.append(now)
    other = "stream" if mode == "merged" else "merged"
    algo2 = dataclasses.replace(
        algo, clients=hier.vclients.ClientConfig(
            **{**cc.__dict__, "mode": other}))
    init2, step2 = hier.make_hier_step(Topology(PC, DC, "cpu"), algo2,
                                       mlp.make_bundle())
    state2 = init2(params_from_numpy(prob["w0"]))
    for s in range(3):
        batch = {"train": {"x": torch.from_numpy(prob["xs"][s]),
                           "y": torch.from_numpy(prob["ys"][s])}}
        state2, _ = step2(state2, batch, ew, dw, mask)
    for k, v in hier.edge_params(state2).items():
        assert torch.equal(v, finals[-1][k]), k
    with pytest.raises(ValueError, match="client dim"):
        step(state, batch, ew, dw, torch.ones(PC, DC, KC + 1))


def test_client_granular_mask_needs_active_clients():
    init_fn, step = hier.make_hier_step(
        Topology(1, 1, "cpu"), hier.AlgoConfig(compute_dtype=torch.float32),
        hier.ModelBundle(loss=toy_loss))
    state = init_fn(params_from_numpy(
        jax.tree.map(np.asarray, H.make_problem(1, 1)["w0"])))
    with pytest.raises(ValueError, match="active"):
        step(state, {"train": {}}, torch.ones(1), torch.ones(1, 1),
             torch.ones(1, 1, 2))


# -- injected gradients: bitwise against the JAX step -------------------------

def jax_injected_bundle():
    def loss(params, batch, rng):
        return sum(jnp.sum(batch["g"][k][0] * params[k]) for k in params)
    return jhier.ModelBundle(loss=loss, compute_specs=H.COMPUTE_SPECS,
                             master_specs=H.COMPUTE_SPECS)


def injected_problem(pods, devs, k, steps, seed):
    gen = torch.Generator().manual_seed(seed)
    w0 = rand_tree((), np.float32, seed)
    grads = injected_grads.make_grads(toy_shapes(), pods, devs, k, steps, gen)
    return w0, grads


def run_port_injected(w0, grads, pods, devs, cc, transport, layout, t_e=3,
                      dev_mask=None, **kw):
    algo = hier.AlgoConfig(
        mu=MU, t_e=t_e, rho=1.0, transport=transport, state_layout=layout,
        compute_dtype=torch.float32, master_dtype=torch.float32,
        delta_dtype=torch.float32, clients=cc, **kw)
    init_fn, step = hier.make_hier_step(Topology(pods, devs, "cpu"), algo,
                                        injected_grads.make_bundle())
    state = init_fn(params_from_numpy(w0))
    for s, g in enumerate(grads):
        batch = {"train": g, "anchor": grads[s - s % t_e]}
        state, _ = step(state, batch, torch.full((pods,), 1.0 / pods),
                        torch.ones(pods, devs),
                        torch.ones(pods, devs) if dev_mask is None
                        else dev_mask)
    return {k: v.clone() for k, v in hier.edge_params(state).items()}


@pytest.mark.parametrize("mode", ["merged", "stream"])
@pytest.mark.parametrize("regime", ["sampled_weighted", "fixed"])
@pytest.mark.parametrize("method", ["dc_hier_signsgd", "hier_signsgd"])
def test_injected_grads_match_jax_step_bitwise(method, regime, mode):
    """With the per-client gradients fed in, the port's step is bitwise the
    JAX step (P=D=1, K=4, 3 rounds): the votes, weights, participation,
    anchor and update see identical directions."""
    cc = H.client_cfg(1, 1, 4, regime)
    if mode == "stream":
        cc = dataclasses.replace(cc, mode="stream")
    w0, grads = injected_problem(1, 1, 4, 9, seed=12)
    algo = H._algo(method, "ag_packed", "tree", t_e=3, clients=cc)
    init_fn, step = jhier.make_hier_step(single_device_topology(), algo,
                                         jax_injected_bundle())
    state = jax.jit(init_fn)(jtree(w0), jax.random.PRNGKey(1))
    jstep = jax.jit(step)
    jgrads = [{"g": {k: jnp.asarray(v.numpy()) for k, v in g["g"].items()}}
              for g in grads]
    for s, g in enumerate(jgrads):
        batch = {"train": g, "anchor": jgrads[s - s % 3]}
        state, _ = jstep(state, batch, jnp.ones(1), jnp.ones((1, 1)),
                         jnp.ones((1, 1)))
    want = jax.tree.map(np.asarray, state.params)
    tc = hier.vclients.ClientConfig(**cc.__dict__)
    for transport, layout in (("fused", "flat"), ("ag_packed", "tree")):
        got = run_port_injected(w0, grads, 1, 1, tc, transport, layout,
                                method=method)
        for k in want:
            np.testing.assert_array_equal(got[k].numpy().view(np.int32),
                                          want[k].view(np.int32), err_msg=k)


@pytest.mark.parametrize("method", ["dc_hier_signsgd", "hier_signsgd"])
def test_abstaining_edge_flushes_subnormal_params_like_jax(method):
    """Subnormal parameters (+-1e-40, 3e-39, -1e-45) under an abstaining
    edge (mask 0), injected gradients, one step: the port is bitwise the
    jitted JAX step on fused/flat and ag_packed/tree.  The JAX step turns
    them into zeros of their sign (the round prologue's cloud mean
    multiplies them on XLA's CPU backend, which flushes subnormals); the
    port, whose mean keeps them, now flushes in the update
    (``signs.descend`` and the ``vote_update`` kernel), as the eager
    reference does -- before, it kept them."""
    w0, grads = injected_problem(1, 1, 1, 1, seed=14)
    for leaf in w0.values():
        leaf.reshape(-1)[:4] = (1e-40, -1e-40, 3e-39, -1e-45)
    algo = H._algo(method, "ag_packed", "tree", t_e=3)
    init_fn, step = jhier.make_hier_step(single_device_topology(), algo,
                                         jax_injected_bundle())
    state = jax.jit(init_fn)(jtree(w0), jax.random.PRNGKey(1))
    g = {"g": {k: jnp.asarray(v.numpy()) for k, v in grads[0]["g"].items()}}
    state, _ = jax.jit(step)(state, {"train": g, "anchor": g}, jnp.ones(1),
                             jnp.ones((1, 1)), jnp.zeros((1, 1)))
    want = jax.tree.map(np.asarray, state.params)
    for leaf in want.values():
        head = leaf.reshape(-1)[:4]
        assert not head.any() and np.signbit(head).tolist() == [
            False, True, False, True]
    for transport, layout in (("fused", "flat"), ("ag_packed", "tree")):
        got = run_port_injected(w0, grads, 1, 1,
                                hier.vclients.ClientConfig(), transport,
                                layout, dev_mask=torch.zeros(1, 1),
                                method=method)
        for k in want:
            np.testing.assert_array_equal(got[k].numpy().view(np.int32),
                                          want[k].view(np.int32), err_msg=k)


@pytest.mark.parametrize("method", ["dc_hier_signsgd", "hier_signsgd"])
def test_injected_grads_stream_merged_tree_bitwise(method):
    """P=2 x D=3 x K=2 with injected gradients: streamed fused/flat ==
    merged fused/flat == merged ag_packed/tree, bitwise (the triple that
    chip_smoke.py runs on the card)."""
    w0, grads = injected_problem(PC, DC, KC, 6, seed=13)
    cc = H.client_cfg(PC, DC, KC, "sampled_weighted")
    tc = hier.vclients.ClientConfig(**cc.__dict__)
    runs = [run_port_injected(w0, grads, PC, DC, c, t, lay, method=method)
            for c, t, lay in ((stream_of(tc), "fused", "flat"),
                              (tc, "fused", "flat"),
                              (tc, "ag_packed", "tree"))]
    for k in runs[0]:
        assert torch.equal(runs[0][k], runs[1][k]), k
        assert torch.equal(runs[1][k], runs[2][k]), k
