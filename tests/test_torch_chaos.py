"""The port's chaos engine (``repro_torch.runtime.chaos``) against the JAX
package's, and the step under churn against the port's oracle.

  * ``FaultInjector.seeded`` draws the JAX package's events for the same
    seed (over seeds, fleet shapes and rates, nan events included), and
    ``compile_schedule`` gives its arrays bit for bit;
  * a replayed schedule prefix lands on the uninterrupted arrays,
    ``nan`` fires once per scheduled step, the legacy dict form and the
    ``failures.FaultInjector`` re-export work;
  * a demoted straggler is a sampled-out client: the same arrays and a
    bitwise trajectory;
  * the port's step under compiled membership arrays (the parity
    harness's churn schedule, P=1 x D=1 x K=2) against the port's oracle
    fed the same arrays (``tests/test_parity_matrix.py``'s chaos cells):
    the sign methods bitwise, ``hier_sgd`` within atol 1e-6;
  * kill-restore-replay: a nan event with checkpoints
    (``checkpoint.store``) gives, bitwise, the uninterrupted run -- also
    restored mid-round with an aggregate in flight -- and the JAX
    package's ``run_hier_chaos(..., ckpt_dir=...)``: within atol 1e-5 on
    the toy, bitwise with the gradients injected.
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

from repro.checkpoint import store as jstore  # noqa: E402
from repro.core import hier as jhier  # noqa: E402
from repro.core.topology import single_device_topology  # noqa: E402
from repro.runtime import chaos as jchaos  # noqa: E402
from repro.runtime import elastic as jelastic  # noqa: E402
from repro_torch.checkpoint import store  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.core import hier, pytree, ref_fed  # noqa: E402
from repro_torch.core.topology import Topology  # noqa: E402
from repro_torch.runtime import chaos, elastic, failures  # noqa: E402
from test_torch_hier import jax_injected_bundle, toy_loss  # noqa: E402
from test_torch_ref_fed import (MU, MU_SGD, RHO, assert_trees,  # noqa: E402
                                injected, port_cc, run_port_oracle, toy)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for this module's small tensors: the suite runs
    several pytest workers on the machine's cores, and PyTorch's thread
    pool in each of them would contend for the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def events(inj):
    return [(e.step, e.kind, e.pod, e.dev, e.client) for e in inj.events]


def port_injector(jinj):
    """The JAX package's schedule as the port's, event for event."""
    return chaos.FaultInjector([chaos.ChaosEvent(*ev) for ev in events(jinj)])


SEEDED = [(0, 40, 2, 2, 2, {}), (7, 30, 1, 3, 1, {}),
          (11, 25, 3, 2, 4, {"client_rate": 0.3, "pod_rate": 0.2,
                             "heartbeat_rate": 0.2, "straggler_rate": 0.3,
                             "nan_rate": 0.1}),
          (2**31 - 5, 50, 4, 5, 2, {"nan_rate": 0.05, "recover_after": 2})]


@pytest.mark.parametrize("seed,steps,pods,devs,k,kw", SEEDED)
def test_seeded_events_match_jax(seed, steps, pods, devs, k, kw):
    want = jchaos.FaultInjector.seeded(seed, steps, pods, devs, k, **kw)
    got = chaos.FaultInjector.seeded(seed, steps, pods, devs, k, **kw)
    assert events(got) == events(want)
    assert got.horizon == want.horizon
    assert got == chaos.FaultInjector.seeded(seed, steps, pods, devs, k, **kw)


@pytest.mark.parametrize("seed,steps,pods,devs,k,kw", SEEDED)
def test_compiled_arrays_match_jax(seed, steps, pods, devs, k, kw):
    """Seeded schedules on unequal data sizes, and the parity harness's
    churn schedule: the same arrays, bit for bit."""
    sizes = np.random.default_rng(seed % 1000).integers(1, 100, (pods, devs))
    jcc = H.client_cfg(pods, devs, k, "weighted") if k > 1 else \
        H.vclients.ClientConfig()
    for jinj in (jchaos.FaultInjector.seeded(seed, steps, pods, devs, k, **kw),
                 H.chaos_injector(pods, devs, k, 3, nan_step=4)):
        want = jchaos.compile_schedule(
            jinj, jelastic.Membership(pods, devs, clients=jcc,
                                      data_sizes=sizes), steps)
        got = chaos.compile_schedule(
            port_injector(jinj), elastic.Membership(
                pods, devs, clients=port_cc(jcc), data_sizes=sizes), steps)
        for s, (a, b) in enumerate(zip(got, want)):
            for x, y in zip(a, b):
                assert x.dtype == y.dtype == np.float32
                np.testing.assert_array_equal(x.view(np.int32),
                                              y.view(np.int32), err_msg=s)


@pytest.mark.parametrize("upto", [1, 5, 13, 24])
def test_replay_matches_uninterrupted_prefix(upto):
    m = elastic.Membership(2, 3, clients=port_cc(H.client_cfg(2, 3, 2,
                                                              "full")))
    inj = chaos.FaultInjector.seeded(5, 24, 2, 3, 2, client_rate=0.3,
                                     heartbeat_rate=0.2, straggler_rate=0.3,
                                     pod_rate=0.15)
    arrays = chaos.compile_schedule(inj, m, 24)
    assert m.live.all()                        # the caller's is untouched
    got = chaos.replay_membership(inj, m, upto).weights()
    for a, b in zip(got, arrays[upto - 1]):
        np.testing.assert_array_equal(a, b)


def test_nan_fires_once_and_legacy_dict_schedule():
    inj = chaos.FaultInjector([chaos.ChaosEvent(5, "nan")])
    assert inj.nan_due(4) is False
    assert inj.nan_due(5) is True
    assert inj.nan_due(5) is False             # the replay passes through
    legacy = failures.FaultInjector({6: ("device", 0, 0),
                                     9: ("recover", 0, 0)})
    assert legacy.at(6)[0].kind == "device"
    assert legacy.horizon == 10
    assert failures.FaultInjector is chaos.FaultInjector
    with pytest.raises(ValueError, match="kind"):
        chaos.ChaosEvent(0, "meteor")
    m = elastic.Membership(1, 2)
    chaos.apply_events(m, legacy.at(6))
    assert not m.live[0, 0].any() and m.live[0, 1].all()


# -- the step under churn -----------------------------------------------------

def run_port_chaos(problem, method, bundle, transport="ag_packed",
                   layout="tree", clients=None, injector=None, arrays=None,
                   ckpt_dir=None, ckpt_every=None, **kw):
    """``parity_harness.run_hier_chaos`` on the port: the membership
    arrays are the step's inputs every step; with ``ckpt_dir`` a
    checkpoint every ``ckpt_every`` steps (and at step 0), and the
    injector's nan restores the newest and replays.  Returns the final
    edge models as numpy."""
    t_e = problem["t_e"]
    algo = hier.AlgoConfig(
        method=method, mu=MU, mu_sgd=MU_SGD, t_e=t_e, rho=RHO,
        transport=transport, state_layout=layout, compute_dtype=torch.float32,
        master_dtype=torch.float32, delta_dtype=torch.float32,
        clients=clients, **kw)
    init_fn, step = hier.make_hier_step(
        Topology(problem["pods"], problem["devs"], "cpu"), algo, bundle)
    state = init_fn(params_from_numpy(problem["w0"]), 1)
    if ckpt_dir:
        store.save(ckpt_dir, 0, state)
    data = problem["data"]
    s = 0
    while s < problem["rounds"] * t_e:
        ew, dw, mask = arrays[s]
        a = s - s % t_e
        batch = {"train": pytree.tree_map(lambda x: torch.from_numpy(x[s]),
                                          data),
                 "anchor": pytree.tree_map(lambda x: torch.from_numpy(x[a]),
                                           data)}
        state, _ = step(state, batch, ew, dw, mask)
        if injector is not None and injector.nan_due(s):
            s, state = store.restore_latest(ckpt_dir, state)
            continue
        s += 1
        if ckpt_dir and ckpt_every and s % ckpt_every == 0:
            store.save(ckpt_dir, s, state)
    return {k: v.numpy().copy() for k, v in hier.edge_params(state).items()}


def cloud_mean(params, edge_weights):
    return {k: ref_fed._tree_weighted_sum(
        [float(x) for x in edge_weights],
        [torch.from_numpy(v[q]) for q in range(len(edge_weights))]).numpy()
        for k, v in params.items()}


@pytest.fixture(scope="module")
def churn():
    """The parity harness's churn schedule for P=1 x D=1 x K=2 (unit
    weights), compiled, on the toy problem."""
    problem = toy(1, 1, rounds=3, clients=2)
    cc = port_cc(H.client_cfg(1, 1, 2, "full"))
    inj = port_injector(H.chaos_injector(1, 1, 2, problem["t_e"]))
    arrays = chaos.compile_schedule(inj, elastic.Membership(1, 1, clients=cc),
                                    problem["rounds"] * problem["t_e"] + 1)
    return problem, cc, arrays


CHAOS_METHODS = ["hier_signsgd", "dc_hier_signsgd", "scaffold_hier_signsgd",
                 "mtgc_hier_signsgd"]


@pytest.mark.parametrize("method", CHAOS_METHODS + ["hier_sgd"])
def test_chaos_step_matches_port_oracle(churn, method):
    """The step on fused/flat (streamed clients) and ag_packed/tree
    (merged) under the compiled churn, against the oracle given the same
    arrays (per-step masks, closing cloud weights): bitwise for the
    sign methods, atol 1e-6 for hier_sgd."""
    problem, cc, arrays = churn
    bundle = hier.ModelBundle(loss=toy_loss)
    ref = run_port_chaos(problem, method, bundle, clients=cc, arrays=arrays)
    got = run_port_chaos(problem, method, bundle, "fused", "flat",
                         clients=hier.vclients.ClientConfig(
                             **{**cc.__dict__, "mode": "stream"}),
                         arrays=arrays)
    assert_trees(got, ref, True, f"stream/{method}")
    oracle = run_port_oracle(problem, method, cc,
                             ref_fed.loss_grad_fn(toy_loss), arrays)
    assert_trees(cloud_mean(ref, arrays[-1].edge_weights), oracle,
                 method != "hier_sgd", f"oracle/{method}", atol=1e-6)


def test_chaos_weighted_sampled_matches_port_oracle():
    """Churn with Bernoulli(0.5) sampling and unequal |D_qk| weights."""
    problem = toy(1, 1, rounds=3, clients=2)
    cc = port_cc(H.client_cfg(1, 1, 2, "sampled_weighted"))
    inj = port_injector(H.chaos_injector(1, 1, 2, problem["t_e"]))
    arrays = chaos.compile_schedule(inj, elastic.Membership(1, 1, clients=cc),
                                    problem["rounds"] * problem["t_e"] + 1)
    ref = run_port_chaos(problem, "dc_hier_signsgd",
                         hier.ModelBundle(loss=toy_loss), "fused", "flat",
                         clients=cc, arrays=arrays)
    oracle = run_port_oracle(problem, "dc_hier_signsgd", cc,
                             ref_fed.loss_grad_fn(toy_loss), arrays)
    assert_trees(cloud_mean(ref, arrays[-1].edge_weights), oracle, True,
                 "chaos-weighted-oracle")


def test_demoted_straggler_equals_sampled_out_client(churn):
    problem, cc, _ = churn
    m = elastic.Membership(1, 1, clients=cc)
    steps = problem["rounds"] * problem["t_e"] + 1
    arr_d = chaos.compile_schedule(chaos.FaultInjector(
        [chaos.ChaosEvent(2, "straggler", 0, 0, 1)]), m, steps)
    arr_k = chaos.compile_schedule(chaos.FaultInjector(
        [chaos.ChaosEvent(2, "client", 0, 0, 1)]), m, steps)
    for s in range(steps):
        for a, b in zip(arr_d[s], arr_k[s]):
            np.testing.assert_array_equal(a, b)
    bundle = hier.ModelBundle(loss=toy_loss)
    assert_trees(run_port_chaos(problem, "dc_hier_signsgd", bundle,
                                clients=cc, arrays=arr_d),
                 run_port_chaos(problem, "dc_hier_signsgd", bundle,
                                clients=cc, arrays=arr_k), True,
                 "straggler-vs-kill")


# -- kill-restore-replay ------------------------------------------------------

def run_jax_injected_chaos(problem, method, cc, arrays, injector=None,
                           ckpt_dir=None, ckpt_every=None, **kw):
    """``parity_harness.run_hier_chaos`` with the injected-gradient
    model (the JAX step fed the same G as the port)."""
    t_e = problem["t_e"]
    algo = H._algo(method, "ag_packed", "tree", t_e=t_e, clients=cc, **kw)
    init_fn, step = jhier.make_hier_step(single_device_topology(), algo,
                                         jax_injected_bundle())
    state = jax.jit(init_fn)(jax.tree.map(jnp.asarray, problem["w0"]),
                             jax.random.PRNGKey(1))
    jstep = jax.jit(step)
    g = problem["data"]["g"]
    if ckpt_dir:
        jstore.save(ckpt_dir, 0, state)
    s = 0
    while s < problem["rounds"] * t_e:
        ew, dw, mask = arrays[s]
        a = s - s % t_e
        batch = {"train": {"g": {k: jnp.asarray(v[s]) for k, v in g.items()}},
                 "anchor": {"g": {k: jnp.asarray(v[a])
                                  for k, v in g.items()}}}
        state, _ = jstep(state, batch, jnp.asarray(ew), jnp.asarray(dw),
                         jnp.asarray(mask))
        if injector is not None and injector.nan_due(s):
            s, state = jstore.restore_latest(ckpt_dir, state)
            continue
        s += 1
        if ckpt_dir and ckpt_every and s % ckpt_every == 0:
            jstore.save(ckpt_dir, s, state)
    return jax.tree.map(np.asarray, state.params)


@pytest.mark.parametrize("method,kw,every", [
    ("dc_hier_signsgd", {}, 3), ("scaffold_hier_signsgd", {}, 3),
    ("dc_hier_signsgd", {"cloud_overlap": "overlap"}, 2)],
    ids=["dc", "scaffold", "dc_overlap_midflight"])
def test_kill_restore_replay_is_bitwise(churn, tmp_path, method, kw, every):
    """A nan at step 5 restores the newest checkpoint (step 3, or step 4
    mid-round with an aggregate in flight under overlap) and replays:
    bitwise the uninterrupted run, on fused/flat and ag_packed/tree; and
    within atol 1e-5 of the JAX package's run through its own store."""
    problem, cc, arrays = churn
    bundle = hier.ModelBundle(loss=toy_loss)
    jinj = H.chaos_injector(1, 1, 2, problem["t_e"], nan_step=5)
    for transport, layout in (("fused", "flat"), ("ag_packed", "tree")):
        ref = run_port_chaos(problem, method, bundle, transport, layout,
                             clients=cc, arrays=arrays, **kw)
        got = run_port_chaos(problem, method, bundle, transport, layout,
                             clients=cc, injector=port_injector(jinj),
                             arrays=arrays,
                             ckpt_dir=tmp_path / f"{transport}-{layout}",
                             ckpt_every=every, **kw)
        assert_trees(got, ref, True, f"replay/{transport}/{layout}")
    jprob = H.make_problem(pods=1, devs=1, rounds=3, clients=2)
    want, _ = H.run_hier_chaos(single_device_topology(), jprob, method,
                               clients=H.client_cfg(1, 1, 2, "full"),
                               injector=jinj, arrays=arrays,
                               ckpt_dir=str(tmp_path / "jax"),
                               ckpt_every=every, **kw)
    assert_trees(got, want, False, f"jax/{method}")


@pytest.mark.parametrize("method", ["dc_hier_signsgd",
                                    "scaffold_hier_signsgd"])
def test_kill_restore_replay_injected_matches_jax_bitwise(tmp_path, method):
    """With the gradients injected, the port's kill-restore-replay run
    is the JAX package's bit for bit (P=1 x D=1 x K=2, churn, nan at 5)."""
    problem = injected(1, 1, 2, rounds=3)
    jcc = H.client_cfg(1, 1, 2, "full")
    arrays = chaos.compile_schedule(
        port_injector(H.chaos_injector(1, 1, 2, 3)),
        elastic.Membership(1, 1, clients=port_cc(jcc)), 10)
    want = run_jax_injected_chaos(
        problem, method, jcc, arrays,
        H.chaos_injector(1, 1, 2, 3, nan_step=5), tmp_path / "jax", 3)
    got = run_port_chaos(
        problem, method, injected_grads.make_bundle(), "fused", "flat",
        clients=port_cc(jcc),
        injector=port_injector(H.chaos_injector(1, 1, 2, 3, nan_step=5)),
        arrays=arrays, ckpt_dir=tmp_path / "port", ckpt_every=3)
    assert_trees(got, want, True, method)
