"""The port's loop-over-clusters oracle (``repro_torch.core.ref_fed``).

  * against the JAX package's ``ref_fed.global_round`` on the same
    inputs, for all six methods, with the per-round participation masks,
    |D_qk| vote weights and reweighted shares of K=2 virtual clients,
    the chaos schedule's per-step masks and closing cloud weights
    (``device_mask_steps`` / ``edge_weights_agg``), the overlapped cloud
    and decay: within atol 1e-5 on the parity toy
    (``tests/helpers/parity_harness.py``), whose gradients come from two
    autograds; bitwise with the gradients injected
    (``tests/helpers/injected_grads.py``), every method but
    ``hier_local_qsgd``, whose norms sum in another order than XLA's
    (atol 1e-5; its uniforms are the JAX oracle's own draws);
  * against the port's own step (``core.hier.make_hier_step``, fused
    transport, flat state) at P=4 x D=5 on the MLP narrowed to
    64-16-10, unequal edge and device weights, 2 rounds of T_E=3: the
    sign methods bitwise, the mean methods within atol 1e-5 (QSGD with
    one ``uniforms`` callable for both);
  * ``regroup_client_data`` and the QSGD guard.

The runners here are shared with ``tests/test_torch_chaos.py``.
"""
import dataclasses
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

from repro.core import ref_fed as jref  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.core import clients as vclients  # noqa: E402
from repro_torch.core import hier, pytree, ref_fed, votes  # noqa: E402
from repro_torch.core.clients import ClientConfig  # noqa: E402
from repro_torch.core.topology import Topology  # noqa: E402
from repro_torch.models import mlp  # noqa: E402
from test_torch_hier import mlp_problem, toy_loss  # noqa: E402

MU, MU_SGD, RHO = 5e-3, 0.05, 1.0          # the parity harness's
METHODS = ("hier_signsgd", "dc_hier_signsgd", "scaffold_hier_signsgd",
           "mtgc_hier_signsgd", "hier_sgd", "hier_local_qsgd")
SIGN = METHODS[:4]
H_SHAPES = {"w": (16, 64), "b": (33,), "w2": (64, 33)}   # the parity toy's
H_SHAPES_SORTED = [H_SHAPES[k] for k in sorted(H_SHAPES)]  # leaf order


def port_cc(cc) -> ClientConfig:
    """The JAX package's ClientConfig as the port's (same fields)."""
    return ClientConfig(**dataclasses.asdict(cc))


def toy(pods, devs, rounds=2, t_e=3, clients=1, seed=0):
    """The parity toy as numpy: ``data`` a tree of [S, P, D, B, ...]."""
    prob = H.make_problem(pods, devs, rounds=rounds, t_e=t_e, seed=seed,
                          clients=clients)
    return {"w0": jax.tree.map(np.array, prob["w0"]),
            "data": {"x": np.array(prob["xs"]), "y": np.array(prob["ys"])},
            "pods": pods, "devs": devs, "rounds": rounds, "t_e": t_e}


def injected(pods, devs, k, rounds=2, t_e=3, seed=12):
    """Injected per-client gradients: ``data`` = {"g": {leaf: [S, P, D,
    K, *leaf]}}, one batch row a client."""
    gen = torch.Generator().manual_seed(seed)
    w0 = {name: np.random.default_rng(seed).standard_normal(s).astype(
        np.float32) for name, s in H_SHAPES.items()}
    steps = injected_grads.make_grads(H_SHAPES, pods, devs, k,
                                      rounds * t_e, gen)
    g = {name: np.stack([st["g"][name].numpy() for st in steps])
         for name in H_SHAPES}
    return {"w0": w0, "data": {"g": g}, "pods": pods, "devs": devs,
            "rounds": rounds, "t_e": t_e}


def jax_injected_grad(params, batch, rng):
    return {k: batch["g"][k][0] for k in params}


def jax_toy_grad(params, batch, rng):
    return jax.grad(H.loss_fn)(params, batch, rng)


def round_inputs(problem, cc, t, arrays=None, mask=None):
    """Round t's numpy inputs for either package's ``global_round``, as
    ``parity_harness.run_oracle`` (``arrays`` None: a fixed [P, D] mask)
    and ``run_oracle_chaos`` (compiled membership arrays) build them."""
    pods, devs, t_e = problem["pods"], problem["devs"], problem["t_e"]
    k = cc.count
    b_cl = jax.tree.leaves(problem["data"])[0].shape[3] // k

    def shard(s, q, dv):
        d, c = divmod(dv, k)
        return pytree.tree_map(lambda a: a[s, q, d, c * b_cl:(c + 1) * b_cl],
                               problem["data"])

    clients = range(devs * k)
    batches = [[[shard(t * t_e + tau, q, dv) for tau in range(t_e)]
                for dv in clients] for q in range(pods)]
    anchors = [[shard(t * t_e, q, dv) for dv in clients]
               for q in range(pods)]
    w_int = cc.weight_array(pods, devs).reshape(pods, devs * k)
    vote_w = [list(map(int, w_int[q])) for q in range(pods)]
    sampled = np.asarray(vclients.participation_mask(
        port_cc(cc), pods, devs, t)) > 0.5
    if arrays is None:
        mask_t = None if mask is None else np.asarray(mask, bool)
        if cc.active:
            part = sampled if mask_t is None else sampled & mask_t[:, :, None]
            mask_t = part.reshape(pods, devs * k)
        dev_w = ([[w_int[q][dv] * (1.0 / devs) for dv in clients]
                  for q in range(pods)] if cc.active
                 else [[1.0 / devs] * devs] * pods)
        return batches, anchors, [1.0 / pods] * pods, dev_w, dict(
            device_mask=None if mask_t is None else
            [list(row) for row in mask_t],
            vote_weights=vote_w if cc.active else None,
            reweight_participation=cc.active)

    def m_at(s):
        mm = np.asarray(arrays[s].mask) > 0.5                 # [P, D, K]
        return (sampled & mm).reshape(pods, devs * k)

    steps = [[list(row) for row in m_at(t * t_e + tau)] for tau in range(t_e)]
    dwq = np.asarray(arrays[t * t_e].dev_weights)
    dev_w = [[float(w_int[q][dv]) * float(dwq[q][dv // k]) for dv in clients]
             for q in range(pods)]
    ew = [float(x) for x in arrays[t * t_e].edge_weights]
    return batches, anchors, ew, dev_w, dict(
        device_mask=steps[0], device_mask_steps=steps, vote_weights=vote_w,
        reweight_participation=True,
        edge_weights_agg=[float(x) for x in
                          arrays[(t + 1) * t_e].edge_weights])


def run_port_oracle(problem, method, cc, grad_fn, arrays=None, mask=None,
                    uniforms=None, device="cpu", **cfg_kw):
    """The port's oracle over the problem's rounds; the returned tree is
    the committed model (the in-flight aggregate under overlap, as
    ``parity_harness.run_oracle`` returns it), as numpy."""
    cfg = ref_fed.HierConfig(mu=MU, mu_sgd=MU_SGD, t_e=problem["t_e"],
                             rho=RHO, method=method, **cfg_kw)
    state = ref_fed.init_state(params_from_numpy(problem["w0"], device),
                               problem["pods"])
    on_dev = lambda tree: pytree.tree_map(                    # noqa: E731
        lambda a: torch.from_numpy(a).to(device), tree)
    for t in range(problem["rounds"]):
        batches, anchors, ew, dw, kw = round_inputs(problem, cc, t, arrays,
                                                    mask)
        state = ref_fed.global_round(
            state, cfg, grad_fn,
            [[[on_dev(b) for b in c] for c in e] for e in batches],
            [[on_dev(a) for a in e] for e in anchors], ew, dw, None,
            uniforms=uniforms, **kw)
    out = state.w_inflight if cfg.cloud_schedule().staged else state.w
    return {k: v.cpu().numpy() for k, v in out.items()}


def run_jax_oracle(problem, method, cc, grad_fn, arrays=None, mask=None,
                   **cfg_kw):
    cfg = jref.HierConfig(mu=MU, mu_sgd=MU_SGD, t_e=problem["t_e"], rho=RHO,
                          method=method, **cfg_kw)
    state = jref.init_state(jax.tree.map(jnp.asarray, problem["w0"]),
                            problem["pods"])
    on_dev = lambda tree: jax.tree.map(jnp.asarray, tree)     # noqa: E731
    for t in range(problem["rounds"]):
        batches, anchors, ew, dw, kw = round_inputs(problem, cc, t, arrays,
                                                    mask)
        state = jref.global_round(
            state, cfg, grad_fn,
            [[[on_dev(b) for b in c] for c in e] for e in batches],
            [[on_dev(a) for a in e] for e in anchors], ew, dw,
            jax.random.PRNGKey(1), **kw)
    out = state.w_inflight if cfg.cloud_schedule().staged else state.w
    return jax.tree.map(np.asarray, out)


def jax_oracle_uniforms(problem, cc, shapes):
    """The uniforms the JAX oracle's ``hier_local_qsgd`` draws (the key
    chain of ``ref_fed.global_round``, restarted from PRNGKey(1) every
    round), as the port's ``uniforms`` callable."""
    pods, t_e, voters = problem["pods"], problem["t_e"], \
        problem["devs"] * cc.count
    table = {}
    for t in range(problem["rounds"]):
        rng = jax.random.PRNGKey(1)
        for q in range(pods):
            for tau in range(t_e):
                for _ in range(voters):                       # grad draws
                    rng, _sub = jax.random.split(rng)
                for v in range(voters):
                    rng, sub = jax.random.split(rng)
                    subs = jax.random.split(sub, len(shapes))
                    for i, shape in enumerate(shapes):
                        table[(t * t_e + tau, q, v, i)] = np.asarray(
                            jax.random.uniform(subs[i], shape))

    def uniforms(step, i, shape, vs):
        return np.stack([np.stack([table[(step, q, v, i)] for v in vs])
                         for q in range(shape[0])])
    return uniforms


def assert_trees(got, want, exact, what, atol=1e-5):
    for k in want:
        g = np.asarray(got[k], np.float32)
        w = np.asarray(want[k], np.float32)
        if exact:
            np.testing.assert_array_equal(g.view(np.int32), w.view(np.int32),
                                          err_msg=f"{what}/{k}")
        else:
            np.testing.assert_allclose(g, w, rtol=0, atol=atol,
                                       err_msg=f"{what}/{k}")


# -- port oracle vs JAX oracle -----------------------------------------------

CELLS = {
    # name: (pods, devs, K, client regime or None, chaos, cfg kw)
    "chaos_weighted": (2, 2, 2, "sampled_weighted", True, {}),
    "mask_legacy": (2, 3, 1, None, False, {}),
    "overlap_chaos": (2, 2, 2, "weighted", True, {"cloud_overlap": "overlap"}),
    "decay_fixed": (2, 2, 2, "fixed", False, {"decay": True}),
}


def cell_inputs(name, problem_fn):
    pods, devs, k, regime, chaotic, kw = CELLS[name]
    cc = H.client_cfg(pods, devs, k, regime) if regime else \
        H.vclients.ClientConfig()
    problem = problem_fn(pods, devs, k)
    arrays = mask = None
    if chaotic:
        inj = H.chaos_injector(pods, devs, k, problem["t_e"])
        member = H.elastic.Membership(pods, devs, clients=cc)
        arrays = H.chaos.compile_schedule(
            inj, member, problem["rounds"] * problem["t_e"] + 1)
    elif not cc.active:
        mask = np.ones((pods, devs), bool)
        mask[-1, 0] = False
    return cc, problem, arrays, mask, kw


@pytest.mark.parametrize("cell", list(CELLS))
@pytest.mark.parametrize("method", METHODS)
def test_oracle_matches_jax_oracle_injected(method, cell):
    """Injected gradients: bitwise the JAX oracle (QSGD at atol 1e-5)."""
    cc, problem, arrays, mask, kw = cell_inputs(
        cell, lambda p, d, k: injected(p, d, k))
    uniforms = (jax_oracle_uniforms(problem, cc, H_SHAPES_SORTED)
                if method == "hier_local_qsgd" else None)
    want = run_jax_oracle(problem, method, cc, jax_injected_grad, arrays,
                          mask, **kw)
    got = run_port_oracle(problem, method, port_cc(cc),
                          ref_fed.loss_grad_fn(injected_grads.loss), arrays,
                          mask, uniforms=uniforms, **kw)
    assert_trees(got, want, method != "hier_local_qsgd", f"{cell}/{method}")


@pytest.mark.parametrize("cell", ["chaos_weighted", "mask_legacy"])
@pytest.mark.parametrize("method", METHODS)
def test_oracle_matches_jax_oracle_toy(method, cell):
    """The parity toy, autograd on both sides: within atol 1e-5."""
    cc, problem, arrays, mask, kw = cell_inputs(
        cell, lambda p, d, k: toy(p, d, clients=k))
    uniforms = (jax_oracle_uniforms(problem, cc, H_SHAPES_SORTED)
                if method == "hier_local_qsgd" else None)
    want = run_jax_oracle(problem, method, cc, jax_toy_grad, arrays, mask,
                          **kw)
    got = run_port_oracle(problem, method, port_cc(cc),
                          ref_fed.loss_grad_fn(toy_loss), arrays, mask,
                          uniforms=uniforms, **kw)
    assert_trees(got, want, False, f"{cell}/{method}")


# -- port oracle vs the port's step ------------------------------------------

def seeded_uniforms(seed):
    """A ``uniforms`` callable that gives each (step, leaf, edge, voter)
    its own seeded draw, whatever range of voters asks."""
    def uniforms(step, i, shape, voters):
        out = torch.empty((shape[0], len(voters)) + tuple(shape[2:]))
        for q in range(shape[0]):
            for j, v in enumerate(voters):
                g = torch.Generator().manual_seed(
                    hash((seed, step, i, q, v)) & 0x7FFFFFFF)
                out[q, j] = torch.rand(tuple(shape[2:]), generator=g)
        return out
    return uniforms


ORACLE_CASES = [(m, {}) for m in METHODS] + [
    ("dc_hier_signsgd", {"cloud_overlap": "overlap"}),
    ("mtgc_hier_signsgd", {"cloud_period": 1}),
    ("dc_hier_signsgd", {"decay": True})]


@pytest.mark.parametrize("method,kw", ORACLE_CASES, ids=[
    m if not kw else f"{m}-{'-'.join(map(str, kw.values()))}"
    for m, kw in ORACLE_CASES])
def test_step_matches_port_oracle(method, kw):
    """P=4 x D=5 MLP 64-16-10, unequal weights, fused/flat: the cloud
    mean of the step's edge models (the step's own fold,
    ``votes.pod_weighted_average``) against the port's oracle -- bitwise
    for the sign methods, atol 1e-5 for hier_sgd and QSGD."""
    prob = mlp_problem(4, 5, 3, 2)
    rng = np.random.default_rng(7)
    ew = rng.random(4).astype(np.float32)
    ew /= ew.sum()
    dw = rng.random((4, 5)).astype(np.float32)
    dw /= dw.sum(1, keepdims=True)
    uniforms = seeded_uniforms(3) if method == "hier_local_qsgd" else None
    algo = hier.AlgoConfig(
        method=method, mu=MU, mu_sgd=MU_SGD, t_e=3, rho=0.2,
        transport="fused", state_layout="flat", compute_dtype=torch.float32,
        master_dtype=torch.float32, delta_dtype=torch.float32, **kw)
    init_fn, step = hier.make_hier_step(Topology(4, 5, "cpu"), algo,
                                        mlp.make_bundle(), uniforms=uniforms)
    state = init_fn(params_from_numpy(prob["w0"]))
    xs, ys = prob["xs"], prob["ys"]
    for s in range(6):
        batch = {"train": {"x": torch.from_numpy(xs[s]),
                           "y": torch.from_numpy(ys[s])}}
        state, _ = step(state, batch, torch.from_numpy(ew),
                        torch.from_numpy(dw), torch.ones(4, 5))
    got = {k: votes.pod_weighted_average(v, torch.from_numpy(ew))[0]
           for k, v in hier.edge_params(state).items()}

    cfg = ref_fed.HierConfig(mu=MU, mu_sgd=MU_SGD, t_e=3, rho=0.2,
                             method=method, **kw)
    w0 = params_from_numpy(prob["w0"])
    if not cfg.cloud_schedule().staged:
        # the step's first prologue commits the cloud mean of the P
        # copies of w0, which unequal weights do not give back exactly:
        # the oracle starts from that model (under overlap both start
        # from w0 itself and issue that mean)
        w0 = ref_fed._tree_weighted_sum([float(x) for x in ew], [w0] * 4)
    ostate = ref_fed.init_state(w0, 4)
    grad_fn = ref_fed.loss_grad_fn(mlp.loss_fn)
    as_t = lambda s, q, k: {"x": torch.from_numpy(xs[s, q, k]),  # noqa: E731
                            "y": torch.from_numpy(ys[s, q, k])}
    for t in range(2):
        ostate = ref_fed.global_round(
            ostate, cfg, grad_fn,
            [[[as_t(t * 3 + tau, q, k) for tau in range(3)] for k in range(5)]
             for q in range(4)],
            [[as_t(t * 3, q, k) for k in range(5)] for q in range(4)],
            [float(x) for x in ew], [[float(x) for x in r] for r in dw],
            uniforms=uniforms)
    want = ostate.w_inflight if kw.get("cloud_overlap") else ostate.w
    assert_trees({k: v.numpy() for k, v in got.items()},
                 {k: v.numpy() for k, v in want.items()},
                 method in SIGN, method)


# -- the rest -----------------------------------------------------------------

def test_regroup_client_data_matches_jax():
    nested = [[f"q{q}k{k}" for k in range(3)] for q in range(2)]
    order = [4, 0, 2, 5, 1, 3]
    assert ref_fed.regroup_client_data(nested, order, 2) == \
        jref.regroup_client_data(nested, order, 2)
    with pytest.raises(ValueError, match="permute"):
        ref_fed.regroup_client_data(nested, [0, 0, 1, 2, 3, 4], 2)
    with pytest.raises(ValueError, match="equal edges"):
        ref_fed.regroup_client_data(nested, list(range(6)), 4)


def test_participating_shares_match_jax():
    for w, m in (([1, 2, 3], None), ([1, 2, 3], [True, False, True]),
                 ([0.5, 0.25], [False, False])):
        assert ref_fed._participating_shares(w, m) == \
            jref._participating_shares(w, m)


def test_qsgd_needs_uniforms():
    prob = toy(1, 1, rounds=1)
    with pytest.raises(ValueError, match="uniforms"):
        run_port_oracle(prob, "hier_local_qsgd", ClientConfig(),
                        ref_fed.loss_grad_fn(toy_loss))


def test_loss_grad_fn_takes_the_steps_shape():
    """``loss_grad_fn(copies=(P, D))`` reads one client's gradient from a
    [P, D] block of its copies: bitwise the step's per-voter gradient at
    that client on the CPU, and the [1, 1] form's within 1e-6."""
    prob = mlp_problem(4, 5, 3, 1)
    params = params_from_numpy(prob["w0"])
    batch = {"x": torch.from_numpy(prob["xs"][0]),
             "y": torch.from_numpy(prob["ys"][0])}
    leaves, td = pytree.tree_flatten(params)
    copies = [x.expand((4, 5) + tuple(x.shape)).contiguous()
              .requires_grad_(True) for x in leaves]
    g_step = torch.autograd.grad(mlp.loss_fn(pytree.tree_unflatten(
        td, copies), batch).sum(), copies)
    block = ref_fed.loss_grad_fn(mlp.loss_fn, copies=(4, 5))
    one = ref_fed.loss_grad_fn(mlp.loss_fn)
    for q, d in ((0, 0), (2, 3), (3, 4)):
        client = {k: v[q, d] for k, v in batch.items()}
        for a, b, c in zip(g_step,
                           pytree.tree_flatten(block(params, client))[0],
                           pytree.tree_flatten(one(params, client))[0]):
            assert torch.equal(a[q, d], b)
            torch.testing.assert_close(c, b, rtol=0, atol=1e-6)
