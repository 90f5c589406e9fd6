"""The port's cloud schedule and correction bookkeeping, and moving a
whole train state between the packages.

  * ``core.schedule`` is the reference's ``CloudSchedule``: modes, lag
    validation, commit;
  * the properties of ``tests/test_ref_fed_overlap.py`` and
    ``tests/test_ref_fed_corrections.py`` restated on the port's step: a
    zero-latency commit is the sync trajectory and leaves a pre-seeded
    staged slot untouched; the first overlap commit is w0; each commit
    is the aggregate issued one boundary before; SCAFFOLD's shared
    variate telescopes to the share-weighted mean of the client variates
    (exactly, on a dyadic grid);
  * ``convert.train_state_from_numpy`` carries a JAX ``TrainState``
    (tree and flat, every slot filled) into the port bitwise, and both
    packages then step on from it to within atol 1e-5.
"""
import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, str(pathlib.Path(__file__).parent / "helpers"))
import injected_grads  # noqa: E402
import parity_harness as H  # noqa: E402

from repro.core import hier as jhier  # noqa: E402
from repro.core import schedule as jschedule  # noqa: E402
from repro.core.topology import single_device_topology  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import flatbuf, hier, schedule  # noqa: E402
from repro_torch.core.topology import Topology  # noqa: E402
from test_torch_hier import toy_loss  # noqa: E402

P, D, K, T_E = 2, 2, 2, 3
SHAPES = {"w": (4, 64), "b": (33,)}
SIGN = ["hier_signsgd", "dc_hier_signsgd", "scaffold_hier_signsgd",
        "mtgc_hier_signsgd"]


def test_schedule_matches_reference():
    assert schedule.CLOUD_OVERLAP_MODES == jschedule.CLOUD_OVERLAP_MODES
    assert hier.CLOUD_OVERLAP_MODES == schedule.CLOUD_OVERLAP_MODES
    for mode in schedule.CLOUD_OVERLAP_MODES:
        got, want = (schedule.CloudSchedule.from_mode(mode),
                     jschedule.CloudSchedule.from_mode(mode))
        assert (got.lag, got.mode, got.staged) == (want.lag, want.mode,
                                                   want.staged)
        assert hier.AlgoConfig(cloud_overlap=mode).cloud_schedule == got
        issued, staged = object(), object()
        assert got.commit(issued, staged) == want.commit(issued, staged)
    with pytest.raises(ValueError):
        schedule.CloudSchedule(lag=2)
    with pytest.raises(ValueError):
        schedule.CloudSchedule.from_mode("later")
    algo = hier.AlgoConfig(method="mtgc_hier_signsgd",
                           cloud_overlap="overlap")
    assert (algo.is_sign, algo.is_mtgc, algo.is_scaffold,
            algo.has_client_correction, algo.is_overlap) == (
        True, True, False, True, True)
    assert not hier.AlgoConfig(method="hier_sgd").is_sign


def dyadic(gen, shape):
    """Values on a grid of 1/8 in [-4, 4): every sum and dyadic-weighted
    mean below is exact."""
    return torch.randint(-32, 32, shape, generator=gen).to(torch.float32) / 8


def make_run(method, layout="flat", transport="fused", mode="merged",
             **kw):
    """(init state, step, gradients) of P=2 x D=2 x K=2 clients with unit
    weights, injected dyadic gradients and w0, T_E=3."""
    cc = hier.vclients.ClientConfig(
        **{**H.client_cfg(P, D, K, "full").__dict__, "mode": mode})
    algo = hier.AlgoConfig(
        method=method, mu=0.125, mu_sgd=0.125, t_e=T_E, rho=0.5,
        transport=transport, state_layout=layout,
        compute_dtype=torch.float32, delta_dtype=torch.float32, clients=cc,
        **kw)
    init_fn, step = hier.make_hier_step(Topology(P, D, "cpu"), algo,
                                        injected_grads.make_bundle())
    gen = torch.Generator().manual_seed(3)
    state = init_fn({k: dyadic(gen, s) for k, s in SHAPES.items()})
    grads = [{"g": {k: dyadic(gen, (P, D, K) + s)
                    for k, s in sorted(SHAPES.items())}}
             for _ in range(4 * T_E)]
    return state, step, grads


def advance(state, step, grads, start, stop, mask=None):
    ew, dw = torch.full((P,), 0.5), torch.ones(P, D)
    for s in range(start, stop):
        state, _ = step(state, {"train": grads[s],
                                "anchor": grads[s - s % T_E]}, ew, dw,
                        torch.ones(P, D) if mask is None else mask)
    return state


def edges(state):
    return {k: v.clone() for k, v in hier.edge_params(state).items()}


def as_tree(slot):
    return slot.tree() if isinstance(slot, flatbuf.FlatState) else slot


@pytest.mark.parametrize("method", SIGN + ["hier_sgd"])
def test_zero_latency_commit_is_sync_and_keeps_a_staged_slot(method):
    """Sync commits the aggregate issued at the same boundary and never
    touches the staged slot: a sync run with ``agg_next`` pre-seeded is
    bitwise the plain sync run, and the seeded slot comes out as it
    went in."""
    state, step, grads = make_run(method)
    plain = advance(state, step, grads, 0, 2 * T_E + 1)
    state, step, grads = make_run(method)
    junk = state.params.replace(torch.full_like(state.params.buf, 7.25))
    seeded = advance(state._replace(agg_next=junk), step, grads, 0,
                     2 * T_E + 1)
    for k, v in edges(plain).items():
        assert torch.equal(v, edges(seeded)[k]), k
    assert seeded.agg_next is junk
    assert plain.agg_next is None


@pytest.mark.parametrize("method", SIGN + ["hier_sgd"])
def test_first_overlap_commit_is_w0(method):
    """Round 0 of an overlap run commits the staged copy of w0: its local
    steps run from w0 exactly as the sync run's do (the sync aggregate of
    identical edges is w0 on the dyadic grid), and the aggregate it
    issues at step 0 is staged."""
    sync_state, step, grads = make_run(method)
    sync = advance(sync_state, step, grads, 0, T_E)
    state, step, grads = make_run(method, cloud_overlap="overlap")
    w0 = edges(state)
    over = advance(state, step, grads, 0, T_E)
    for k, v in edges(sync).items():
        assert torch.equal(v, edges(over)[k]), k
        assert torch.equal(as_tree(over.agg_next)[k], w0[k]), k


@pytest.mark.parametrize("layout", ["tree", "flat"])
@pytest.mark.parametrize("method", SIGN + ["hier_sgd"])
def test_overlap_commits_the_previous_issue(method, layout):
    """At each boundary the edges adopt the aggregate staged at the one
    before: one all-abstaining step after two rounds (no vote, and zero
    shares for the mean) leaves the edges on exactly the previous
    ``agg_next``, and stages the mean of the edges' final models."""
    state, step, grads = make_run(method, layout=layout,
                                  transport="ar_int8" if layout == "tree"
                                  else "fused", cloud_overlap="overlap")
    state = advance(state, step, grads, 0, 2 * T_E)
    staged = {k: v.clone() for k, v in as_tree(state.agg_next).items()}
    final = edges(state)
    after = advance(state, step, grads, 2 * T_E, 2 * T_E + 1,
                    mask=torch.zeros(P, D))
    for k, v in as_tree(after.agg_next).items():
        assert torch.equal(v[0], 0.5 * final[k][0] + 0.5 * final[k][1]), k
    for k, v in edges(after).items():
        assert torch.equal(v, staged[k]), k
        assert not torch.equal(v, final[k]), k


@pytest.mark.parametrize("mode", ["merged", "stream"])
@pytest.mark.parametrize("layout", ["tree", "flat"])
def test_scaffold_bookkeeping_telescopes(layout, mode):
    """Full participation, dyadic data and shares: after every round the
    shared variate is the share-weighted mean of the client variates,
    ``c_global == sum_q ew_q sum_k sh_qk c_local_qk``, bitwise, on both
    pods."""
    state, step, grads = make_run("scaffold_hier_signsgd", layout=layout,
                                  mode=mode)
    for r in range(3):
        state = advance(state, step, grads, r * T_E, (r + 1) * T_E)
        cl = as_tree(state.corr_cl)
        ce = as_tree(state.corr_edge)
        for k in SHAPES:
            want = 0.5 * (cl[k][0].sum(0) + cl[k][1].sum(0)) / (D * K)
            assert torch.equal(ce[k][0], want), (r, k)
            assert torch.equal(ce[k][1], want), (r, k)


# -- a JAX TrainState into the port ------------------------------------------

STATE_CASES = [
    ("scaffold_hier_signsgd", {"cloud_overlap": "overlap",
                               "error_feedback": True, "momentum": 0.9}),
    ("dc_hier_signsgd", {"error_feedback": True, "momentum": 0.5}),
    ("mtgc_hier_signsgd", {"cloud_period": 1}),
    ("hier_sgd", {"cloud_overlap": "overlap"}),
]


@pytest.fixture(scope="module")
def toy_problem():
    prob = H.make_problem(pods=1, devs=1)
    return dict(prob, w0=jax.tree.map(np.asarray, prob["w0"]),
                xs=np.asarray(prob["xs"]), ys=np.asarray(prob["ys"]))


def toy_batch(prob, s, lib):
    a = s - s % prob["t_e"]
    conv = jnp.asarray if lib == "jax" else torch.from_numpy
    return {"train": {"x": conv(prob["xs"][s]), "y": conv(prob["ys"][s])},
            "anchor": {"x": conv(prob["xs"][a]), "y": conv(prob["ys"][a])}}


@pytest.mark.parametrize("layout", ["tree", "flat"])
@pytest.mark.parametrize("method,kw", STATE_CASES,
                         ids=["scaffold_overlap_ef_mom", "dc_ef_mom", "mtgc",
                              "hier_sgd_overlap"])
def test_train_state_from_numpy_round_trips(toy_problem, method, kw,
                                            layout):
    """A JAX state 4 steps into a run (P=D=1 parity toy; every slot the
    config reads filled) becomes the port's bitwise, slot for slot, and
    back; then both packages take 5 more steps from it, within atol
    1e-5 of each other."""
    prob = toy_problem
    algo = H._algo(method, "ag_packed", layout, t_e=prob["t_e"], **kw)
    init_fn, jstep = jhier.make_hier_step(single_device_topology(), algo,
                                          H.make_bundle())
    jstep = jax.jit(jstep)
    jstate = jax.jit(init_fn)(prob["w0"], jax.random.PRNGKey(1))
    ones = (jnp.ones(1), jnp.ones((1, 1)), jnp.ones((1, 1)))
    for s in range(4):
        jstate, _ = jstep(jstate, toy_batch(prob, s, "jax"), *ones)
    snap = jax.tree.map(np.asarray, jstate)

    base = dict(method=method, mu=5e-3, mu_sgd=0.05, t_e=prob["t_e"],
                rho=1.0, transport="ag_packed", state_layout=layout,
                compute_dtype=torch.float32, master_dtype=torch.float32,
                delta_dtype=torch.float32, **kw)
    init_t, step_t = hier.make_hier_step(
        Topology(1, 1, "cpu"), hier.AlgoConfig(**base),
        hier.ModelBundle(loss=toy_loss))
    like = init_t(convert.params_from_numpy(prob["w0"]))
    state = convert.train_state_from_numpy(snap, like)
    assert state.step == 4 and state.rng is like.rng
    for name in convert.SLOTS:
        src, got = getattr(snap, name), getattr(state, name)
        assert (src is None) == (got is None), name
        if got is None:
            continue
        want = src.buf if layout == "flat" else src
        got = got.buf if layout == "flat" else got
        for k, w in (want.items() if isinstance(want, dict)
                     else [("buf", want)]):
            g = got[k] if isinstance(got, dict) else got
            np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                          err_msg=f"{name}/{k}")
    back = convert.train_state_from_numpy(
        convert.train_state_to_numpy(state), like)
    for name in convert.SLOTS:
        a, b = getattr(state, name), getattr(back, name)
        if a is not None:
            for k, v in as_tree(a).items():
                assert torch.equal(v, as_tree(b)[k]), (name, k)
    if method == "scaffold_hier_signsgd":
        assert state.ef is not None and state.mom is not None
        assert state.corr_cl is not None and state.agg_next is not None

    for s in range(4, 9):
        jstate, _ = jstep(jstate, toy_batch(prob, s, "jax"), *ones)
        state, _ = step_t(state, toy_batch(prob, s, "torch"),
                          torch.ones(1), torch.ones(1, 1), torch.ones(1, 1))
    want = jax.tree.map(np.asarray, jstate.params.tree() if layout == "flat"
                        else jstate.params)
    for k, v in hier.edge_params(state).items():
        np.testing.assert_allclose(v.numpy(), want[k], rtol=0, atol=1e-5,
                                   err_msg=k)


def test_train_state_from_numpy_refuses_another_config():
    init_t, _ = hier.make_hier_step(
        Topology(1, 1, "cpu"), hier.AlgoConfig(method="dc_hier_signsgd"),
        hier.ModelBundle(loss=toy_loss))
    w0 = {"w": torch.zeros(2, 3), "b": torch.zeros(3)}
    like = init_t(w0)
    other_init, _ = hier.make_hier_step(
        Topology(1, 1, "cpu"), hier.AlgoConfig(method="hier_signsgd"),
        hier.ModelBundle(loss=toy_loss))
    other = convert.train_state_to_numpy(other_init(w0))
    with pytest.raises(ValueError, match="slot delta"):
        convert.train_state_from_numpy(other, like)
    snap = convert.train_state_to_numpy(like)
    snap = snap._replace(params={"w": np.zeros((1, 3, 2), np.float32),
                                 "b": np.zeros((1, 3), np.float32)})
    with pytest.raises(ValueError, match="shape"):
        convert.train_state_from_numpy(snap, like)
    snap = convert.train_state_to_numpy(like)._replace(
        delta={"w": np.full((1, 2, 3), 0.1, np.float32),
               "b": np.zeros((1, 3), np.float32)})
    with pytest.raises(ValueError, match="exactly"):
        convert.train_state_from_numpy(snap, like)
