"""The hierarchy across processes: a gloo mesh of CPU ranks.

Each mesh shape runs once, in a module-scoped fixture, as separate
processes (``tests/helpers/torch_mesh_worker.py``, killed past 120 s):

  * 2 x 2 ranks over P=2 x D=2 (blocks 1 x 1);
  * 2 x 2 ranks over P=2 x D=4 (blocks 1 x 2);
  * 1 x 2 ranks over P=2 x D=2 (blocks 2 x 1).

On each, every cell -- the six methods x {ag_packed, ar_int8, fused} x
{tree, flat}; K=2 virtual clients, merged and stream, under
Bernoulli(0.5) participation with |D_qk| weights; error feedback;
momentum; the overlapped cloud -- trains 2 rounds of T_E=3 on injected
gradients (``tests/helpers/injected_grads.py``) under uneven edge and
device weights and a dropped voter, and its gathered final state (every
slot) and every step's loss must be bitwise the port's one-process run.
Injected gradients, because a rank takes its copies' gradients with a
[P_loc, D_loc] leading batch: the step-0 per-device gradients of the
MLP on a block against the same slice of the one-process run are
counted here, and their differing count reported.

Each topology-aware vote and mean (``core.votes`` with a mesh) on the
ranks' blocks of global numpy inputs is bitwise the JAX ``votes.*``
function on the whole inputs.  On the 2 x 2 mesh the MLP trajectory
(autograd gradients) is within atol 1e-5 of JAX's
``ref_fed.global_round`` and, with injected gradients, the sign methods
are bitwise JAX's oracle.  Then the refusals of the parts of ROADMAP
item 17 still to come, and a one-process topology that touches no
process group (the model axis: ``tests/test_torch_tp_*.py``).
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
import torch_mesh_worker as W  # noqa: E402

from repro.core import flatbuf as jflat  # noqa: E402
from repro.core.clients import ClientConfig as JClientConfig  # noqa: E402
from repro.core import ref_fed as jref  # noqa: E402
from repro.core import votes as jvotes  # noqa: E402
from repro.core.topology import single_device_topology  # noqa: E402
from repro.models import mlp as jmlp  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.core import comm, hier, votes  # noqa: E402
from repro_torch.core.topology import ProcessMesh, Topology  # noqa: E402
from repro_torch.launch import mesh, train  # noqa: E402
from test_torch_ref_fed import (MU, MU_SGD, RHO, injected,  # noqa: E402
                                jax_injected_grad, run_jax_oracle)

METHODS = ("hier_signsgd", "dc_hier_signsgd", "scaffold_hier_signsgd",
           "mtgc_hier_signsgd", "hier_sgd", "hier_local_qsgd")
SIGN = METHODS[:4]
SHORT = dict(zip(METHODS, ("hier", "dc", "scaffold", "mtgc", "sgd", "qsgd")))
TRANSPORTS = ("ag_packed", "ar_int8", "fused")
LAYOUTS = ("tree", "flat")
T_E, STEPS, K = 3, 6, 2
# mesh shape id -> (mesh pods, mesh data, block, global P, global D)
SHAPES = {"2x2": (2, 2, (1, 1), 2, 2), "2x2-D4": (2, 2, (1, 2), 2, 4),
          "1x2": (1, 2, (2, 1), 2, 2)}
TOY = {"w": (16, 64), "b": (33,), "w2": (64, 33)}
LM = {"arch": "gemma3_1b", "steps": 4, "t_e": 2, "seq": 16, "batch": 2}
PAPER = {   # run_paper_task at Q=2 x D=2: DC, and K=2 streamed clients
    "dc": dict(q_edges=2, devices_per_edge=2, rounds=2, t_e=2, batch=16,
               n_train=800),
    "clients": dict(q_edges=2, devices_per_edge=2, rounds=2, t_e=2,
                    batch=16, n_train=1600, clients_per_device=2,
                    participation="bernoulli", rate=0.5, client_seed=11,
                    data_weights=True, client_mode="stream")}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread here, as the ranks have: the suite runs
    several pytest workers on the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -- the problems and cells ----------------------------------------------------

def membership(p, d, k, seed):
    rng = np.random.default_rng(seed)
    ew = rng.random(p).astype(np.float32)
    dw = rng.random((p, d)).astype(np.float32)
    if k == 1:
        mask = np.ones((p, d), np.float32)
        mask[-1, 0] = 0.0                       # a dropped device
    else:
        mask = np.ones((p, d, k), np.float32)
        mask[0, -1, 1] = 0.0                    # a dropped client
    return ew / ew.sum(), dw / dw.sum(1, keepdims=True), mask


def injected_problem(p, d, k, seed=21):
    rng = np.random.default_rng(seed)
    w0 = {n: rng.standard_normal(s).astype(np.float32)
          for n, s in TOY.items()}
    batches = [{"g": {n: rng.standard_normal((p, d, k) + s).astype(
        np.float32) for n, s in TOY.items()}} for _ in range(STEPS)]
    ew, dw, mask = membership(p, d, k, seed + 1)
    return {"kind": "injected", "w0": w0, "batches": batches, "ew": ew,
            "dw": dw, "mask": mask}


def spec(method, transport, layout, problem, clients=None, **algo):
    return {"method": method, "transport": transport, "state_layout": layout,
            "t_e": T_E, "mu": MU, "mu_sgd": MU_SGD, "rho": 0.2,
            "clients": clients, "algo": algo, "problem": problem,
            "steps": STEPS}


def client_fields(p, d, mode):
    weights = tuple(tuple(tuple((q + 2 * j + 3 * c) % 5 + 1
                                for c in range(K)) for j in range(d))
                    for q in range(p))
    return {"count": K, "participation": "bernoulli", "rate": 0.5,
            "seed": 11, "weights": weights, "mode": mode}


def cells(p, d) -> dict:
    one, many = injected_problem(p, d, 1), injected_problem(p, d, K)
    out = {}
    for m in METHODS:
        for t in TRANSPORTS:
            for lay in LAYOUTS:
                out[f"{SHORT[m]}/{t}/{lay}"] = spec(m, t, lay, one)
        for mode in ("merged", "stream"):
            out[f"{SHORT[m]}/fused/flat/K2-{mode}"] = spec(
                m, "fused", "flat", many, client_fields(p, d, mode))
    for t, lay in (("ag_packed", "tree"), ("ar_int8", "tree")):
        for mode in ("merged", "stream"):
            out[f"dc/{t}/{lay}/K2-{mode}"] = spec(
                "dc_hier_signsgd", t, lay, many, client_fields(p, d, mode))
    for t, lay in (("fused", "flat"), ("ar_int8", "tree")):
        out[f"dc/{t}/{lay}/ef"] = spec("dc_hier_signsgd", t, lay, one,
                                       error_feedback=True)
        out[f"dc/{t}/{lay}/momentum"] = spec("dc_hier_signsgd", t, lay, one,
                                             momentum=0.9)
        out[f"dc/{t}/{lay}/overlap"] = spec("dc_hier_signsgd", t, lay, one,
                                            cloud_overlap="overlap")
    out["dc/fused/flat/ef-K2-stream"] = spec(
        "dc_hier_signsgd", "fused", "flat", many,
        client_fields(p, d, "stream"), error_feedback=True)
    out["scaffold/ag_packed/tree/overlap-momentum"] = spec(
        "scaffold_hier_signsgd", "ag_packed", "tree", one,
        cloud_overlap="overlap", momentum=0.9)
    return out


# cells that also start again from the one-process state after round 1,
# each rank taking its block of every slot
RESUMED = ("scaffold/fused/flat/K2-merged", "dc/ar_int8/tree/ef",
           "dc/fused/flat/overlap")
CELL_NAMES = list(cells(2, 2)) + [f"{n}/resumed" for n in RESUMED]


def mlp_problem(p, d, seed=0, b=8):
    """The MLP narrowed to 64-16-10 (``test_torch_hier.mlp_problem``'s),
    uniform weights, every voter in."""
    rng = np.random.default_rng(seed)
    w0 = jax.tree.map(np.asarray, jmlp.init_mlp(jax.random.PRNGKey(seed),
                                                dim=64, hidden=16))
    xs = rng.standard_normal((STEPS, p, d, b, 64)).astype(np.float32)
    ys = rng.integers(0, 10, size=(STEPS, p, d, b)).astype(np.int32)
    return {"kind": "mlp", "w0": w0,
            "batches": [{"x": xs[s], "y": ys[s]} for s in range(STEPS)],
            "ew": np.full(p, 1 / p, np.float32),
            "dw": np.full((p, d), 1 / d, np.float32),
            "mask": np.ones((p, d), np.float32)}


def oracle_problem():
    """``test_torch_ref_fed.injected`` at P=2 x D=2, K=1, as steps."""
    prob = injected(2, 2, 1)
    g = prob["data"]["g"]
    return {"kind": "injected", "w0": prob["w0"],
            "batches": [{"g": {n: a[s] for n, a in g.items()}}
                        for s in range(STEPS)],
            "ew": np.full(2, 0.5, np.float32),
            "dw": np.full((2, 2), 0.5, np.float32),
            "mask": np.ones((2, 2), np.float32)}, prob


def vote_inputs(p, d):
    rng = np.random.default_rng(5)
    bool_mask = np.ones((p, d), bool)
    bool_mask[0, -1] = False
    int_mask = (np.arange(p * d).reshape(p, d) % 3).astype(np.int32)
    int_mask[-1] = 0                                  # an empty quorum
    n = 4096
    return {
        "masks": {"none": None, "bool": bool_mask, "int": int_mask},
        "bound": 3 * d,
        "s": rng.choice([-1, 1], size=(p, d, 7, 64)).astype(np.int8),
        "u": {k: rng.standard_normal((p, d) + s).astype(np.float32)
              for k, s in TOY.items()},
        "delta": {k: (2 * rng.standard_normal((p,) + s)).astype(np.float32)
                  for k, s in TOY.items()},
        "v": {k: rng.standard_normal((p,) + s).astype(np.float32)
              for k, s in TOY.items()},
        "rho": 0.2, "mu": MU, "clients": K,
        "g": rng.standard_normal((p, d, 33)).astype(np.float32),
        "w": (rng.random((p, d)) / d).astype(np.float32),
        "g_k": rng.standard_normal((p, d * K, 33)).astype(np.float32),
        "w_k": (rng.random((p, d * K)) / (d * K)).astype(np.float32),
        "ew": np.linspace(0.2, 0.8, p).astype(np.float32),
        "tallies": {
            "int8": rng.integers(-3, 4, (p, d, n)).astype(np.int8),
            "int16": rng.integers(-300, 301, (p, d, n)).astype(np.int16)},
        "n_eff": np.array([3] * (p - 1) + [0], np.int32),
        "v_flat": rng.standard_normal((p, n)).astype(np.float32),
    }


@functools.lru_cache(maxsize=None)
def mesh_job(shape: str) -> dict:
    p, d = SHAPES[shape][3:]
    job = {"cells": cells(p, d), "votes": vote_inputs(p, d),
           "grads": {"w0": mlp_problem(p, d)["w0"],
                     "batch": mlp_problem(p, d)["batches"][0]}}
    for name in RESUMED:              # from the one-process state at step 3
        base = job["cells"][name]
        start = W.run_cell(Topology(p, d, "cpu"), dict(base, steps=T_E))
        job["cells"][f"{name}/resumed"] = dict(base, start=start["state"])
    if shape == "1x2":
        job["lm"] = LM
        job["paper"] = PAPER
    if shape == "2x2":
        job["cells"]["mlp/dc"] = spec("dc_hier_signsgd", "fused", "flat",
                                      mlp_problem(p, d))
        job["cells"]["mlp/hier"] = spec("hier_signsgd", "ar_int8", "tree",
                                        mlp_problem(p, d))
        oracle = oracle_problem()[0]
        for m in METHODS[:5]:
            job["cells"][f"oracle/{SHORT[m]}"] = dict(
                spec(m, "fused", "flat", oracle), rho=RHO)
    return job


@functools.lru_cache(maxsize=None)
def mesh_runs() -> dict:
    """Every mesh shape's run, the three at once (each its own ranks and
    its own 120 s limit)."""
    jobs = {shape: mesh_job(shape) for shape in SHAPES}
    with concurrent.futures.ThreadPoolExecutor(len(SHAPES)) as pool:
        futs = {shape: pool.submit(W.run_mesh, *SHAPES[shape][:3], job)
                for shape, job in jobs.items()}
        return {shape: dict(fut.result(), job=jobs[shape])
                for shape, fut in futs.items()}


def mesh_run(shape: str) -> dict:
    return mesh_runs()[shape]


@functools.lru_cache(maxsize=None)
def one_process(p: int, d: int, cell: str) -> dict:
    """The port's one-process run of a cell (the 2 x 2 and 1 x 2 meshes
    share it: both lay P=2 x D=2)."""
    return W.run_cell(Topology(p, d, "cpu"), mesh_job(
        {(2, 2): "2x2", (2, 4): "2x2-D4"}[(p, d)])["cells"][cell])


@pytest.fixture(scope="module", params=list(SHAPES))
def shape(request):
    return request.param


# -- every cell: bitwise the one-process run -------------------------------------

def assert_states_equal(got: dict, want: dict, tag: str):
    for slot, w in want.items():
        g = got[slot]
        if slot == "step":
            assert g == w, tag
            continue
        assert (g is None) == (w is None), (tag, slot)
        if w is None:
            continue
        gl, wl = jax.tree.leaves(g), jax.tree.leaves(w)
        assert len(gl) == len(wl), (tag, slot)
        for a, b in zip(gl, wl):
            a, b = np.asarray(a), np.asarray(b)
            assert a.shape == b.shape and a.dtype == b.dtype, (tag, slot)
            np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8),
                                          err_msg=f"{tag}/{slot}")


@pytest.mark.parametrize("cell", CELL_NAMES)
def test_mesh_cell_is_bitwise_the_one_process_run(shape, cell):
    res = mesh_run(shape)
    _, _, block, p, d = SHAPES[shape]
    assert res["blocks"] == block
    want = one_process(p, d, cell)
    got = res["cells"][cell]
    assert got["losses"] == want["losses"], cell
    assert_states_equal(got["state"], want["state"], f"{shape}/{cell}")
    if cell.endswith("/resumed"):     # the uninterrupted run's state too
        whole = one_process(p, d, cell[:-len("/resumed")])
        assert_states_equal(got["state"], whole["state"], cell)
        assert got["losses"] == whole["losses"][T_E:], cell
    # the sign words crossed the data group (every local step), and the
    # edge models the pod group (every round)
    traffic = got["traffic"]
    pods, data = SHAPES[shape][:2]
    if data > 1:
        assert traffic["gather_devices"]["calls"] \
            + traffic["sum_devices"]["calls"] >= STEPS
    if pods > 1:
        assert traffic["gather_pods"]["calls"] >= STEPS // T_E


# -- the votes and means against JAX --------------------------------------------

def jax_votes(inp) -> dict:
    topo = single_device_topology()
    j = lambda a: None if a is None else jnp.asarray(a)   # noqa: E731
    jt = lambda t: jax.tree.map(jnp.asarray, t)            # noqa: E731
    out = {}
    for name, mask in inp["masks"].items():
        out[f"ag_packed/{name}"] = jvotes.vote_ag_packed(
            topo, j(inp["s"]), j(mask), jax.sharding.PartitionSpec())
        out[f"ar_int8/{name}"] = jvotes.vote_ar_int8(
            topo, j(inp["s"]), j(mask), weight_bound=inp["bound"])
        out[f"fused/{name}"] = jvotes.fused_sign_vote(
            topo, jt(inp["u"]), jt(inp["delta"]), inp["rho"], j(mask))
        layout = jflat.make_layout(jt(inp["v"]), batch_dims=1)
        v_buf = jflat.flatten_tree(layout, jt(inp["v"]), batch_dims=1)
        d_buf = jflat.flatten_tree(layout, jt(inp["delta"]), batch_dims=1)
        for mu_static in (inp["mu"], None):
            out[f"fused_update/{name}/{mu_static is not None}"] = \
                jvotes.fused_sign_vote_update(
                    topo, layout, jt(inp["u"]), d_buf, inp["rho"], j(mask),
                    v_buf, jnp.float32(inp["mu"]), mu_static=mu_static)
    out["weighted_mean_dev"] = jvotes.weighted_mean_dev(
        topo, j(inp["g"]), j(inp["w"]))
    out["fold_devices"] = jvotes.weighted_mean_dev(
        topo, j(inp["g"]), jnp.ones(inp["w"].shape, jnp.float32))
    out["pod_weighted_average"] = jvotes.pod_weighted_average(
        topo, j(inp["g"][:, 0]), j(inp["ew"]))
    for name, tally in inp["tallies"].items():
        out[f"tally_vote_dev/{name}"] = jvotes.tally_vote_dev(
            topo, j(tally), j(inp["n_eff"]), jax.sharding.PartitionSpec())
        layout = jflat.make_layout({"t": j(tally[:, 0])}, batch_dims=1)
        out[f"fused_tally_finish/{name}"] = jvotes.fused_tally_finish(
            topo, layout, j(tally), j(inp["n_eff"]), j(inp["v_flat"]),
            jnp.float32(inp["mu"]))
    return out


def as_np(x):
    if isinstance(x, dict):
        return {k: as_np(v) for k, v in x.items()}
    return np.asarray(x)


def test_mesh_votes_are_bitwise_jax(shape):
    """Every topology-aware vote and mean against the JAX function on the
    whole inputs (the K=2 clients' mean against the port's one-process
    fold, whose bits the one-process tests hold)."""
    res = mesh_run(shape)
    inp = res["job"]["votes"]
    want = jax_votes(inp)
    got = res["votes"]
    chunked = ("weighted_mean_dev", "fold_devices", "pod_weighted_average")
    assert set(want) | {"weighted_mean_dev/clients"} | {
        f"{name}/chunked" for name in chunked} == set(got)
    for name in chunked:
        np.testing.assert_array_equal(got[f"{name}/chunked"].view(np.int32),
                                      got[name].view(np.int32), err_msg=name)
    for name, w in want.items():
        w = as_np(w)
        g = got[name]
        if isinstance(w, dict):
            for k in w:
                np.testing.assert_array_equal(
                    np.asarray(g[k]).view(np.uint8),
                    w[k].astype(np.asarray(g[k]).dtype).view(np.uint8),
                    err_msg=f"{name}/{k}")
        else:
            np.testing.assert_array_equal(
                np.asarray(g).view(np.uint8),
                w.astype(np.asarray(g).dtype).view(np.uint8), err_msg=name)
    one = votes.weighted_mean_dev(torch.from_numpy(inp["g_k"]),
                                  torch.from_numpy(inp["w_k"]),
                                  clients=inp["clients"]).numpy()
    np.testing.assert_array_equal(got["weighted_mean_dev/clients"].view(
        np.int32), one.view(np.int32))


# -- gradients by shape; the 2 x 2 trajectories against JAX --------------------

def grads_differing(shape: str) -> int:
    """The MLP's step-0 per-device gradients taken on each rank's block
    against the same slice of the one-process [P, D] run: the count of
    coordinates that differ."""
    res = mesh_run(shape)
    p, d = SHAPES[shape][3:]
    want = W.step0_grads(Topology(p, d, "cpu"), res["job"]["grads"])
    return sum(int((np.asarray(res["grads"][k]) != np.asarray(w)).sum())
               for k, w in want.items())


def test_step0_gradients_by_block_shape(shape):
    """The differing count of :func:`grads_differing`, reported, the
    gradients within 1e-6 of the one-process run's.  Whatever the count,
    the cells above hold the mesh bitwise with injected gradients."""
    res = mesh_run(shape)
    p, d = SHAPES[shape][3:]
    want = W.step0_grads(Topology(p, d, "cpu"), res["job"]["grads"])
    total = sum(np.asarray(w).size for w in want.values())
    print(f"[mesh {shape}] step-0 gradients: {grads_differing(shape)} of "
          f"{total} coordinates differ from the one-process run")
    for k in want:
        np.testing.assert_allclose(res["grads"][k], want[k], rtol=0,
                                   atol=1e-6)


def test_run_training_over_the_mesh():
    """``run_training`` of gemma3-1b's smoke config over the 1 x 2 mesh
    (each rank both edges and one device of each), 2 rounds: the losses
    and the edge models bitwise the one-process run's."""
    got = mesh_run("1x2")["lm"]
    want = W.lm_run(Topology(2, 2, "cpu"), LM)
    assert got["losses"] == want["losses"]
    for a, b in zip(jax.tree.leaves(got["params"]),
                    jax.tree.leaves(want["params"])):
        np.testing.assert_array_equal(a.view(np.int32), b.view(np.int32))
    assert got["losses"][-1] < got["losses"][0]


@pytest.mark.parametrize("name", list(PAPER))
def test_paper_task_over_the_mesh(name):
    """``run_paper_task`` over the 1 x 2 mesh: every rank samples the
    whole batch and keeps its block; the curves and the edge models
    bitwise the one-process run's."""
    got = mesh_run("1x2")["paper"][name]
    want = W.paper_run(Topology(2, 2, "cpu"), PAPER[name])
    assert got["curves"] == want["curves"]
    for k, w in want["params"].items():
        np.testing.assert_array_equal(got["params"][k].view(np.int32),
                                      w.view(np.int32), err_msg=k)


def jax_mlp_oracle(prob, method):
    grad_fn = jax.jit(lambda p, b, r: jax.grad(jmlp.loss_fn)(p, b))
    state = jref.init_state(jax.tree.map(jnp.asarray, prob["w0"]), 2)
    cfg = jref.HierConfig(mu=MU, t_e=T_E, rho=0.2, method=method)
    bs = prob["batches"]
    for t in range(STEPS // T_E):
        batches = [[[{"x": bs[t * T_E + tau]["x"][q, k],
                      "y": bs[t * T_E + tau]["y"][q, k]}
                     for tau in range(T_E)] for k in range(2)]
                   for q in range(2)]
        anchors = [[{"x": bs[t * T_E]["x"][q, k], "y": bs[t * T_E]["y"][q, k]}
                    for k in range(2)] for q in range(2)]
        state = jref.global_round(state, cfg, grad_fn, batches, anchors,
                                  [0.5, 0.5], [[0.5, 0.5]] * 2,
                                  jax.random.PRNGKey(0))
    return jax.tree.map(np.asarray, state.w)


def cloud_mean(params: dict, ew) -> dict:
    """The cloud mean of [P, *leaf] edge models (the step's own fold)."""
    return {k: votes.pod_weighted_average(torch.from_numpy(v),
                                          torch.from_numpy(ew))[0].numpy()
            for k, v in params.items()}


@pytest.mark.parametrize("cell", ["mlp/dc", "mlp/hier"])
def test_mesh_mlp_trajectory_matches_jax_ref_fed(cell):
    """The 2 x 2 mesh, the MLP on its own gradients, 2 rounds: the cloud
    mean of the edge models within atol 1e-5 of JAX's oracle, and the
    whole state bitwise the one-process run's where the step-0
    gradients of a block are bitwise the one-process run's."""
    res = mesh_run("2x2")
    sp = res["job"]["cells"][cell]
    if grads_differing("2x2") == 0:
        assert_states_equal(res["cells"][cell]["state"],
                            one_process(2, 2, cell)["state"], cell)
    mean = cloud_mean(res["cells"][cell]["params"], sp["problem"]["ew"])
    want = jax_mlp_oracle(sp["problem"], sp["method"])
    for k in want:
        np.testing.assert_allclose(mean[k], want[k], rtol=0, atol=1e-5,
                                   err_msg=k)


@pytest.mark.parametrize("method", METHODS[:5])
def test_mesh_matches_jax_oracle_with_injected_gradients(method):
    """The 2 x 2 mesh on ``test_torch_ref_fed``'s injected problem:
    the cloud mean of the edge models is bitwise JAX's
    ``ref_fed.global_round`` for the sign methods, within 1e-5 for
    hier_sgd (whose mean JAX's oracle sums in another order)."""
    res = mesh_run("2x2")
    cell = f"oracle/{SHORT[method]}"
    sp = res["job"]["cells"][cell]
    want = run_jax_oracle(oracle_problem()[1], method, JClientConfig(),
                          jax_injected_grad)
    mean = cloud_mean(res["cells"][cell]["params"], sp["problem"]["ew"])
    for k in want:
        if method in SIGN:
            np.testing.assert_array_equal(mean[k].view(np.int32),
                                          want[k].view(np.int32), err_msg=k)
        else:
            np.testing.assert_allclose(mean[k], want[k], rtol=0, atol=1e-5,
                                       err_msg=k)


# -- what is not ported yet, and the one-process topology -------------------------

def fake_mesh(pods=2, data=1) -> ProcessMesh:
    return ProcessMesh(pods=pods, data=data, pod_rank=0, data_rank=0,
                       pod_group=None, data_group=None, backend="gloo")


def test_refusals_name_their_part_of_item_17(tmp_path):
    # the model axis (item 17b) is ported: the production grids are
    # shapes, and laying one needs its 256 or 512 ranks
    assert mesh.make_production_mesh(multi_pod=True) == (
        (2, 16, 16), ("pod", "data", "model"))
    with pytest.raises(ValueError, match="needs 256 ranks"):
        mesh.make_topology()
    with pytest.raises(ValueError, match="needs 512 ranks"):
        train.main(["--device", "cpu", "--arch", "gemma3_1b", "--smoke",
                    "--multi_pod"])
    with pytest.raises(RuntimeError, match="init_process_group"):
        mesh.make_host_topology(2, 2, 2, backend="gloo", device="cpu")
    topo = Topology(2, 1, "cpu", mesh=fake_mesh())
    with pytest.raises(NotImplementedError, match="item 17c"):
        hier.make_hier_step(topo, hier.AlgoConfig(),
                            hier.ModelBundle(loss=None, param_mode="fsdp"))
    with pytest.raises(NotImplementedError, match="item 17e"):
        train.run_training(configs.get_smoke("gemma3_1b"), topo,
                           hier.AlgoConfig(), train.RunCfg(
                               steps=1, ckpt_dir=str(tmp_path)))
    from repro_torch.models import build
    gemma12 = build.build_model(configs.get_config("gemma3_12b"),
                                Topology(1, 1, "cpu"))
    with pytest.raises(NotImplementedError, match="item 17d"):
        gemma12.prefill({}, {"tokens": torch.zeros((1, 2), dtype=torch.long)},
                        4)
    with pytest.raises(ValueError, match="backend"):
        mesh.make_host_topology(1, 1, backend="mpi", device="cpu")
    with pytest.raises(ValueError, match="divide"):
        Topology(3, 2, "cpu", mesh=fake_mesh(2, 1))
    assert mesh.host_grid(4, 2, 2) == (2, 2)
    assert mesh.host_grid(4, 4, 2) == (2, 2)
    assert mesh.host_grid(2, 2, 3) == (2, 1)
    with pytest.raises(ValueError, match="tile"):
        mesh.host_grid(4, 3, 3)


def test_one_process_topology_has_no_collective(monkeypatch):
    """Without a mesh the step and every vote stay in the process: no
    process group exists and torch.distributed is never called."""
    def boom(*a, **kw):
        raise AssertionError("a collective without a mesh")
    for fn in ("all_gather", "all_reduce"):
        monkeypatch.setattr(torch.distributed, fn, boom)
    comm.reset_traffic()
    for name in ("dc/fused/flat/K2-stream", "qsgd/ar_int8/tree",
                 "dc/ar_int8/tree/overlap"):
        W.run_cell(Topology(2, 2, "cpu"), cells(2, 2)[name])
    assert not torch.distributed.is_initialized()
    assert all(v["calls"] == 0 for v in comm.traffic.values())
    # the model group's collectives are the identity without a mesh
    x = torch.ones(3)
    assert comm.sum_model(None, x) is x and comm.copy_to_model(None, x) is x
    assert comm.gather_model(Topology(2, 2, "cpu"), x, 0) is x
    topo = Topology(2, 3, "cpu")
    assert topo.model_shards == 1 and topo.model_rank == 0
    assert (topo.local_pods, topo.local_devices) == (2, 3)
    assert topo.block({"x": np.zeros((2, 3))})["x"].shape == (2, 3)
    blocks = hier.state_blocks(Topology(4, 6, "cpu", mesh=ProcessMesh(
        pods=2, data=3, pod_rank=1, data_rank=2, pod_group=None,
        data_group=None, backend="gloo")), clients=2)
    assert blocks.params == (slice(2, 4),)
    assert blocks.ef == (slice(2, 4), slice(8, 12))
