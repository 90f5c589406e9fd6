"""The port's FSDP regime against the JAX package, on the CPU.

  * the lift's backward (``core.device_axis``) on [2, 3, *leaf] f32 and
    bf16 cotangents with a straggler mask: bitwise the JAX lift's own
    arithmetic -- ``signs.sgn(g + rho*delta)`` and
    ``votes.majority_vote_dev`` (or ``weighted_mean_dev``) of the JAX
    package on ``single_device_topology()`` -- on every transport, the
    padded leaves (numel % 4096 != 0) included; the coordinate chunks of
    the large leaves bitwise the unchunked arithmetic;
  * the parity toy (``tests/helpers/parity_harness.py``) for
    hier_signsgd, DC and hier_sgd: P=1 x D=1 against JAX's FSDP
    ``make_hier_step`` at atol 1e-6, and P=2 x D=3 with a straggler
    against JAX's ``ref_fed`` oracle at atol 1e-5;
  * gemma3-12b's smoke config with ``param_mode="fsdp"`` (12 layers:
    both block kinds and the tied table): at P=D=1 against JAX's FSDP
    trajectory under ``tests/test_torch_lm_step.py``'s criterion; at P=2
    x D=3 bitwise the port's replicated ag_packed/tree run in f32 and
    bf16 compute, fused/ag_packed/ar_int8 bitwise each other;
  * the reference's refusals (four ``ValueError``s and the CLI's overlap
    error), its two FSDP quirks (QSGD is hier_sgd there; EF and momentum
    are dropped), one vote a leaf and layer a step under remat, the
    in-place update, ``run_training`` and its CLI on an FSDP config
    (every transport the same digits, a ``--ckpt`` resume bitwise the
    straight run), a JAX FSDP ``TrainState`` through
    ``convert.train_state_from_numpy``, and the port importing no JAX.
"""
import dataclasses
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

sys.path.insert(0, str(pathlib.Path(__file__).parent / "helpers"))
import parity_harness as H  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.core import hier as jhier  # noqa: E402
from repro.core import signs as jsigns  # noqa: E402
from repro.core import votes as jvotes  # noqa: E402
from repro.core.topology import single_device_topology  # noqa: E402
from repro.models import build as jbuild  # noqa: E402
from repro_torch import configs, convert  # noqa: E402
from repro_torch.checkpoint import store  # noqa: E402
from repro_torch.core import device_axis, hier, pytree, votes  # noqa: E402
from repro_torch.core.topology import Topology  # noqa: E402
from repro_torch.kernels.sign_pack import sign_pack  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.models import build  # noqa: E402
from test_torch_hier import run_port, toy_loss  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
P, D = 2, 3
MU, RHO = 1e-3, 0.2
STRAGGLER = np.array([[1, 0, 1], [1, 1, 1]], np.float32)
NP_DTYPES = {"f32": np.float32, "bf16": ml_dtypes.bfloat16}
TORCH_DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}
LEAVES = [(7, 64), (240,), (33,), (16,), (4, 96)]
TRANSPORTS = ("ag_packed", "ar_int8", "fused")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread (see tests/test_torch_lm_step.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def bits(x) -> np.ndarray:
    a = np.asarray(x.float() if isinstance(x, torch.Tensor) else x,
                   np.float32)
    return a.view(np.int32)


# -- the lift's backward ------------------------------------------------------

def lift_grad(cfg, w, delta, g, maskf, devwf):
    """The gradient the lift returns for w: its backward on g."""
    w = w.clone().requires_grad_(True)
    out = device_axis.fsdp_lift(cfg, w, delta, maskf=maskf, devwf=devwf)
    assert out.dtype == cfg.compute_dtype and out.shape == g.shape
    assert torch.equal(out, w.detach().to(out.dtype).unsqueeze(1)
                       .expand(g.shape))
    out.backward(g)
    return w.grad


def jax_direction(transport, g, delta, maskf, devwf, rho):
    """The JAX lift's backward arithmetic (``device_axis.fsdp_lift``),
    eager, on the same numpy inputs (fused is ag_packed there)."""
    topo = single_device_topology()
    g = jnp.asarray(g)
    if transport == "wmean":
        return jvotes.weighted_mean_dev(topo, g.astype(jnp.float32),
                                        jnp.asarray(devwf))
    u = g
    if rho:
        d_full = jnp.broadcast_to(jnp.asarray(delta)[:, None], g.shape)
        u = g + rho * d_full.astype(g.dtype)
    s = jsigns.sgn(u)
    tr = "ag_packed" if transport == "fused" else transport
    return jvotes.majority_vote_dev(topo, s, jnp.asarray(maskf) > 0.5, tr,
                                    jax.sharding.PartitionSpec())


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("transport", TRANSPORTS + ("wmean",))
@pytest.mark.parametrize("shape", LEAVES, ids=str)
def test_lift_backward_matches_jax(dt, transport, shape):
    rng = np.random.default_rng(3)
    g = rng.standard_normal((P, D) + shape).astype(NP_DTYPES[dt])
    g.reshape(-1)[::17] = 0.0                 # ties and zeros
    delta = (2 * rng.standard_normal((P,) + shape)).astype(
        NP_DTYPES["bf16"])
    w = rng.standard_normal((P,) + shape).astype(np.float32)
    devwf = rng.random((P, D)).astype(np.float32)
    rho = 0.0 if transport == "wmean" else RHO
    cfg = device_axis.LiftCfg(devices=D, transport=transport, rho=rho,
                              compute_dtype=TORCH_DTYPES[dt])
    got = lift_grad(cfg, torch.from_numpy(w),
                    convert.tensor_from_numpy(delta),
                    convert.tensor_from_numpy(g),
                    torch.from_numpy(STRAGGLER), torch.from_numpy(devwf))
    want = jax_direction(transport, g, delta, STRAGGLER, devwf, rho)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(bits(got),
                                  bits(np.asarray(want).astype(np.float32)))


@pytest.mark.parametrize("transport", ["fused", "ag_packed", "wmean"])
def test_lift_chunks_are_bitwise_whole(transport, monkeypatch):
    """A chunk of 96 coordinates (not a multiple of the leaf's rows) gives
    the one-chunk arithmetic to the bit, in the correction and the mean."""
    rng = np.random.default_rng(4)
    g = torch.from_numpy(rng.standard_normal((P, D, 5, 77))).to(
        torch.bfloat16)
    delta = torch.from_numpy(rng.standard_normal((P, 5, 77))).to(
        torch.bfloat16)
    devwf = torch.from_numpy(rng.random((P, D)).astype(np.float32))
    rho = 0.0 if transport == "wmean" else RHO
    cfg = device_axis.LiftCfg(devices=D, transport=transport, rho=rho)
    maskf = torch.from_numpy(STRAGGLER)
    whole = device_axis.lift_direction(cfg, g, delta, maskf, devwf)
    monkeypatch.setattr(votes, "CHUNK", 96)
    chunked = device_axis.lift_direction(cfg, g, delta, maskf, devwf)
    np.testing.assert_array_equal(bits(chunked), bits(whole))


# -- the parity toy -----------------------------------------------------------

def toy_loss_master(params, delta, batch, lift):
    """The parity toy's FSDP loss: the lift, then its MSE per replica."""
    pd = lift(params, delta)
    pred = batch["x"] @ pd["w"] @ pd["w2"] + pd["b"].unsqueeze(-2)
    losses = torch.mean((pred - batch["y"]) ** 2, dim=(-2, -1))
    return losses.sum(), losses


TOY_FSDP = hier.ModelBundle(loss=None, loss_master=toy_loss_master,
                            param_mode="fsdp")
TOY_METHODS = ("hier_signsgd", "dc_hier_signsgd", "hier_sgd")


def toy(pods, devs):
    prob = H.make_problem(pods=pods, devs=devs)
    return dict(prob, w0=jax.tree.map(np.asarray, prob["w0"]),
                xs=np.asarray(prob["xs"]), ys=np.asarray(prob["ys"]))


@pytest.fixture(scope="module")
def toy11():
    return toy(1, 1)


@pytest.mark.parametrize("method", TOY_METHODS)
def test_toy_matches_jax_fsdp_step(toy11, method):
    """P=D=1: every transport within atol 1e-6 of JAX's FSDP trajectory
    and bitwise the port's replicated ag_packed/tree run."""
    want, _ = H.run_hier(single_device_topology(), toy11, method,
                         regime="fsdp")
    kw = dict(method=method, mu_sgd=0.05)
    repl = run_port(toy11, hier.ModelBundle(loss=toy_loss), "ag_packed",
                    "tree", **kw)
    for transport in TRANSPORTS:
        got = run_port(toy11, TOY_FSDP, transport, "tree", **kw)
        for k in want:
            np.testing.assert_allclose(got[k][0].numpy(), want[k][0],
                                       rtol=0, atol=1e-6, err_msg=k)
            assert torch.equal(got[k], repl[k]), (transport, k)


@pytest.mark.parametrize("method", TOY_METHODS)
def test_toy_matches_ref_fed_oracle_with_a_straggler(method):
    """P=2 x D=3, device 1 of edge 0 a straggler: the cloud aggregate of
    the port's FSDP edge models is JAX's oracle within atol 1e-5."""
    prob = toy(P, D)
    mask = torch.from_numpy(STRAGGLER)
    got = run_port(prob, TOY_FSDP, "fused", "tree", method=method,
                   mu_sgd=0.05, mask=mask)
    want = H.run_oracle(prob, method, mask=STRAGGLER)
    agg = H.aggregate({k: v.numpy() for k, v in got.items()},
                      np.full(P, 1.0 / P))
    for k in want:
        np.testing.assert_allclose(agg[k], np.asarray(want[k]), rtol=0,
                                   atol=1e-5, err_msg=k)


# -- gemma3-12b's smoke config ------------------------------------------------

def smoke12(**kw):
    return (dataclasses.replace(jconfigs.get_smoke("gemma3_12b"),
                                param_mode="fsdp", **kw),
            dataclasses.replace(configs.get_smoke("gemma3_12b"),
                                param_mode="fsdp", **kw))


@pytest.fixture(scope="module")
def jax_fsdp_trajectory():
    """JAX's FSDP step, 4 steps (2 rounds of T_E=2) of DC on gemma3-12b's
    smoke config (seq 16 > window 8): (cfg, params, tokens, finals)."""
    jcfg, cfg = smoke12()
    jbuilt = jbuild.build_model(jcfg, single_device_topology())
    p = jax.tree.map(np.asarray, jbuilt.init_params(jax.random.PRNGKey(0)))
    algo = jhier.AlgoConfig(method="dc_hier_signsgd", mu=MU, rho=RHO, t_e=2,
                            compute_dtype=jnp.float32,
                            delta_dtype=jnp.float32)
    init_fn, step = jhier.make_hier_step(single_device_topology(), algo,
                                         jbuilt.bundle)
    state = jax.jit(init_fn)(p, jax.random.PRNGKey(1))
    jstep = jax.jit(step)
    tokens = np.random.default_rng(2).integers(
        0, cfg.vocab, (4, 1, 1, 2, 16)).astype(np.int32)
    ones = jnp.ones((1, 1))
    for s in range(4):
        state, _ = jstep(state, {"train": {"tokens": tokens[s]}},
                         jnp.ones(1), ones, ones)
    return cfg, p, tokens, jax.tree.map(np.asarray, state.params)


def test_lm_matches_jax_fsdp_trajectory(jax_fsdp_trajectory):
    """P=D=1: every coordinate within 2*mu + 1e-6 of JAX's, at most 0.1 %
    of them more than 1e-6 apart (the lm-step criterion); fused and
    ag_packed bitwise."""
    cfg, p, tokens, want = jax_fsdp_trajectory
    built = build.build_model(cfg, Topology(1, 1, "cpu"))
    assert built.bundle.loss is None and built.bundle.param_mode == "fsdp"
    finals = []
    for transport in ("fused", "ag_packed"):
        algo = hier.AlgoConfig(method="dc_hier_signsgd", mu=MU, rho=RHO,
                               t_e=2, transport=transport,
                               compute_dtype=torch.float32,
                               delta_dtype=torch.float32)
        init_fn, step = hier.make_hier_step(Topology(1, 1, "cpu"), algo,
                                            built.bundle)
        state = init_fn(convert.params_from_numpy(p))
        for s in range(4):
            state, _ = step(state, {"train": {"tokens": torch.from_numpy(
                tokens[s]).long()}}, torch.ones(1), torch.ones(1, 1),
                torch.ones(1, 1))
        finals.append(pytree.tree_flatten(state.params)[0])
    jleaves = jax.tree.leaves(want)
    n = far = 0
    for a, b, w in zip(finals[0], finals[1], jleaves):
        assert torch.equal(a, b)
        diff = np.abs(a.numpy() - w)
        assert diff.max() <= 2 * MU + 1e-6
        n += diff.size
        far += int((diff > 1e-6).sum())
    assert far <= 1e-3 * n, (far, n)
    moved = sum(float(np.abs(w - np.asarray(x)).sum()) for w, x in
                zip(jleaves, jax.tree.leaves(p)))
    assert moved > 0


def lm_run(cfg, compute, transport, mask=None, **kw):
    """4 steps (2 rounds of T_E=2: round 1 reads round 0's anchor) of DC
    at P=2 x D=3 from seed 0's parameters; the final edge models."""
    algo = hier.AlgoConfig(method=kw.pop("method", "dc_hier_signsgd"),
                           mu=MU, rho=RHO, t_e=2, transport=transport,
                           compute_dtype=compute, delta_dtype=compute, **kw)
    built = build.build_model(cfg, Topology(P, D, "cpu"))
    init_fn, step = hier.make_hier_step(Topology(P, D, "cpu"), algo,
                                        built.bundle)
    params = built.init_params(torch.Generator().manual_seed(0))
    state = init_fn(params)
    tokens = torch.from_numpy(np.random.default_rng(5).integers(
        0, cfg.vocab, (4, P, D, 1, 16))).long()
    m = torch.ones(P, D) if mask is None else mask
    for s in range(4):
        state, metrics = step(state, {"train": {"tokens": tokens[s]}},
                              torch.full((P,), 1 / P),
                              torch.full((P, D), 1 / D), m)
        assert torch.isfinite(metrics["loss"])
    return [x.clone() for x in pytree.tree_flatten(state.params)[0]]


@pytest.mark.parametrize("compute", ["f32", "bf16"])
def test_lm_fsdp_is_bitwise_replicated(compute):
    """P=2 x D=3 with a straggler: FSDP on fused, ag_packed and ar_int8
    bitwise each other and the replicated regime's ag_packed/tree run."""
    _, cfg = smoke12()
    dt = TORCH_DTYPES[compute]
    mask = torch.from_numpy(STRAGGLER)
    repl = lm_run(dataclasses.replace(cfg, param_mode="replicated"), dt,
                  "ag_packed", mask)
    for transport in TRANSPORTS:
        got = lm_run(cfg, dt, transport, mask)
        for a, b in zip(got, repl):
            assert torch.equal(a, b), transport
    assert sign_pack.launches == 0                    # the CPU route


# -- the refusals -------------------------------------------------------------

@pytest.mark.parametrize("kw", [
    {"state_layout": "flat"},
    {"clients": dataclasses.replace(hier.AlgoConfig().clients, count=2)},
    {"method": "scaffold_hier_signsgd"}, {"method": "mtgc_hier_signsgd"},
    {"cloud_overlap": "overlap"}],
    ids=["flat", "clients", "scaffold", "mtgc", "overlap"])
def test_fsdp_refuses_what_the_reference_refuses(kw):
    """The reference's four ValueErrors (both client-correction methods),
    each naming the replicated regime, as JAX raises them."""
    topo = Topology(1, 1, "cpu")
    with pytest.raises(ValueError, match="replicated"):
        hier.make_hier_step(topo, hier.AlgoConfig(**kw), TOY_FSDP)
    jkw = dict(kw)
    if "clients" in jkw:
        jkw["clients"] = dataclasses.replace(jhier.AlgoConfig().clients,
                                             count=2)
    with pytest.raises(ValueError, match="replicated"):
        jhier.make_hier_step(single_device_topology(),
                             jhier.AlgoConfig(**jkw), H.make_bundle("fsdp"))


def test_cli_reaches_the_fsdp_regime(capsys):
    """``--arch gemma3_12b`` (an FSDP config) reaches the regime: the
    overlapped cloud is the CLI's error, as in the JAX CLI, and the flat
    layout the step's ``ValueError`` (raised before any parameter is
    made)."""
    with pytest.raises(SystemExit):
        train.main(["--device", "cpu", "--arch", "gemma3_12b",
                    "--cloud_overlap", "overlap"])
    assert "requires the replicated regime" in capsys.readouterr().err
    with pytest.raises(ValueError, match="replicated"):
        train.main(["--device", "cpu", "--arch", "gemma3_12b",
                    "--state_layout", "flat"])


def test_unported_parts_of_fsdp_raise_with_their_item():
    """An FSDP config serves resident where its bf16 weights fit
    ``SERVE_RESIDENT_BUDGET`` (the reference's rule), else in the gather
    layout, which stays item 17; the vlm and moe pieces of the FSDP loss
    (patches, MTP) build."""
    cfg = smoke12()[1]
    assert build.serve_layout(cfg, 6 * 10**9) == "resident"
    assert build.serve_layout(cfg, 6 * 10**9 + 1) == "gather"
    assert build.serve_layout(dataclasses.replace(
        cfg, param_mode="replicated"), 10**12) == "resident"
    full = build.build_model(configs.get_config("gemma3_12b"),
                             Topology(1, 1, "cpu"))
    assert full.serve_layout == "gather"
    with pytest.raises(NotImplementedError, match="item 17"):
        full.prefill({}, {"tokens": torch.zeros((1, 2), dtype=torch.long)},
                     4)
    for name in ("internvl2_76b", "deepseek_v3_671b"):
        built = build.build_model(dataclasses.replace(
            configs.get_smoke(name), param_mode="fsdp"),
            Topology(1, 1, "cpu"))
        assert built.bundle.loss_master is not None


# -- the reference's two FSDP quirks ------------------------------------------

def test_fsdp_qsgd_is_hier_sgd_in_both_packages(toy11):
    """Under FSDP ``hier_local_qsgd`` quantizes nothing: the wmean of the
    raw gradients, so its trajectory is hier_sgd's, in JAX and here."""
    runs = [run_port(toy11, TOY_FSDP, "ag_packed", "tree", method=m,
                     mu_sgd=0.05) for m in ("hier_local_qsgd", "hier_sgd")]
    for k in runs[0]:
        assert torch.equal(runs[0][k], runs[1][k]), k
    jruns = [H.run_hier(single_device_topology(), toy11, m,
                        regime="fsdp")[0]
             for m in ("hier_local_qsgd", "hier_sgd")]
    for k in jruns[0]:
        np.testing.assert_array_equal(jruns[0][k], jruns[1][k])


@pytest.mark.parametrize("kw", [{"error_feedback": True},
                                {"momentum": 0.9}], ids=["ef", "momentum"])
def test_fsdp_drops_ef_and_momentum_in_both_packages(toy11, kw):
    """The state has no ef/mom slot and the step ignores the option: the
    trajectory is the plain DC one, in JAX and here."""
    init_fn, _ = hier.make_hier_step(Topology(1, 1, "cpu"),
                                     hier.AlgoConfig(**kw), TOY_FSDP)
    state = init_fn(convert.params_from_numpy(toy11["w0"]))
    assert state.ef is None and state.mom is None
    assert state.delta is not None
    base = run_port(toy11, TOY_FSDP, "fused", "tree")
    got = run_port(toy11, TOY_FSDP, "fused", "tree", **kw)
    for k in base:
        assert torch.equal(got[k], base[k]), k
    jbase = H.run_hier(single_device_topology(), toy11, "dc_hier_signsgd",
                       regime="fsdp")[0]
    jgot = H.run_hier(single_device_topology(), toy11, "dc_hier_signsgd",
                      regime="fsdp", **kw)[0]
    for k in jbase:
        np.testing.assert_array_equal(jgot[k], jbase[k])


def test_non_dc_fsdp_state_threads_a_zero_delta():
    init_fn, _ = hier.make_hier_step(
        Topology(1, 1, "cpu"), hier.AlgoConfig(method="hier_signsgd"),
        TOY_FSDP)
    state = init_fn({"w": torch.ones(2, 3)})
    assert state.delta_next is None
    assert torch.equal(state.delta["w"], torch.zeros(1, 2, 3,
                                                     dtype=torch.bfloat16))


# -- remat: one vote a leaf and layer -----------------------------------------

def test_remat_runs_each_vote_once():
    """A local step runs every layer's lift twice (the forward and the
    recompute) but its backward, the vote, once a leaf and layer; the
    round's first step adds the anchor pass's as many."""
    _, cfg = smoke12()
    built = build.build_model(cfg, Topology(P, D, "cpu"))
    params = built.init_params(torch.Generator().manual_seed(0))
    per_step = sum(
        x.shape[0] if name == "stacks" else 1
        for name, sub in params.items()
        for x in pytree.tree_flatten(sub)[0])
    assert per_step == 12 * 10 + 2       # 10 leaves a layer, table, norm
    init_fn, step = hier.make_hier_step(
        Topology(P, D, "cpu"), hier.AlgoConfig(t_e=3, transport="fused"),
        built.bundle)
    state = init_fn(params)
    tokens = torch.zeros((P, D, 1, 16), dtype=torch.long)
    counts = []
    for _ in range(2):
        device_axis.fsdp_lift.votes = 0
        state, _ = step(state, {"train": {"tokens": tokens}},
                        torch.full((P,), 0.5), torch.full((P, D), 1 / D),
                        torch.ones(P, D))
        counts.append(device_axis.fsdp_lift.votes)
    assert counts == [2 * per_step, per_step]


def test_fsdp_step_updates_the_state_in_place():
    """The prologue's cloud mean and the update write the master, and the
    fresh anchor the buffer of the delta the swap drops (the new
    delta_next), so the card holds the state once."""
    prob = toy(P, D)
    init_fn, step = hier.make_hier_step(
        Topology(P, D, "cpu"),
        hier.AlgoConfig(t_e=3, compute_dtype=torch.float32), TOY_FSDP)
    state = init_fn(convert.params_from_numpy(prob["w0"]))
    before = {k: v.clone() for k, v in state.params.items()}
    batch = {"train": {"x": torch.from_numpy(prob["xs"][0]),
                       "y": torch.from_numpy(prob["ys"][0])}}
    new, _ = step(state, batch, torch.full((P,), 0.5),
                  torch.full((P, D), 1 / D), torch.ones(P, D))
    for k, v in new.params.items():
        assert v is state.params[k] and not torch.equal(v, before[k])
        assert new.delta_next[k] is state.delta[k]
        assert new.delta[k] is state.delta_next[k]
        assert new.delta_next[k].abs().sum() > 0


# -- run_training, the CLI, checkpoints and conversion ------------------------

def run_smoke_fsdp(transport, ckpt=None, steps=4, log=None):
    _, cfg = smoke12()
    algo = hier.AlgoConfig(t_e=2, transport=transport, mu=MU, rho=RHO,
                           compute_dtype=torch.bfloat16)
    run = train.RunCfg(steps=steps, batch_per_device=1, seq_len=16,
                       ckpt_dir=ckpt, ckpt_every=2, log_every=1)
    return train.run_training(cfg, Topology(P, D, "cpu"), algo, run,
                              log=log or (lambda line: None))


def test_run_training_prints_the_same_digits_on_every_transport():
    """``run_training`` on the FSDP smoke config at P=2 x D=3 in bf16: the
    logged losses of ag_packed, ar_int8 and fused are the same digits,
    and so are the edge models' bits."""
    logs, finals = [], []
    for transport in TRANSPORTS:
        lines = []
        state, hist = run_smoke_fsdp(transport, log=lines.append)
        assert all(np.isfinite(h["loss"]) for h in hist)
        logs.append(lines)
        finals.append(pytree.tree_flatten(state.params)[0])
    assert len(logs[0]) == 4 and logs[0] == logs[1] == logs[2]
    for other in finals[1:]:
        for a, b in zip(finals[0], other):
            assert torch.equal(a, b)


def test_run_training_resumes_bitwise(tmp_path):
    """4 steps straight, and 2 steps with a checkpoint then a resume to 4,
    give the same edge models bit for bit."""
    straight, _ = run_smoke_fsdp("fused")
    ckpt = str(tmp_path / "ckpt")
    run_smoke_fsdp("fused", ckpt, steps=2)
    resumed, hist2 = run_smoke_fsdp("fused", ckpt, steps=4)
    assert [h["step"] for h in hist2] == [2, 3]
    for a, b in zip(pytree.tree_flatten(straight.params)[0],
                    pytree.tree_flatten(resumed.params)[0]):
        assert torch.equal(a, b)
    assert straight.ef is None and straight.delta_next is not None


def test_jax_fsdp_state_converts_and_round_trips(tmp_path):
    """A JAX FSDP ``TrainState`` (tree layout, delta for every method, no
    ef/mom) converts into the port's slot for slot, and the port's store
    saves and restores it bitwise."""
    jcfg, cfg = smoke12()
    jbuilt = jbuild.build_model(jcfg, single_device_topology())
    p = jax.tree.map(np.asarray, jbuilt.init_params(jax.random.PRNGKey(0)))
    jinit, _ = jhier.make_hier_step(single_device_topology(),
                                    jhier.AlgoConfig(method="hier_signsgd"),
                                    jbuilt.bundle)
    jstate = jax.tree.map(np.asarray, jax.jit(jinit)(
        p, jax.random.PRNGKey(1)))
    assert jstate.delta is not None and jstate.ef is None
    built = build.build_model(cfg, Topology(1, 1, "cpu"))
    init_fn, _ = hier.make_hier_step(Topology(1, 1, "cpu"),
                                     hier.AlgoConfig(method="hier_signsgd"),
                                     built.bundle)
    like = init_fn(built.init_params(torch.Generator().manual_seed(9)))
    state = convert.train_state_from_numpy(jstate, like)
    for a, b in zip(pytree.tree_flatten(state.params)[0],
                    jax.tree.leaves(jstate.params)):
        np.testing.assert_array_equal(bits(a), bits(b))
    store.save(tmp_path, 5, state)
    step, back = store.restore_latest(tmp_path, like)
    assert step == 5
    for name in ("params", "delta"):
        for a, b in zip(pytree.tree_flatten(getattr(back, name))[0],
                        pytree.tree_flatten(getattr(state, name))[0]):
            assert a.dtype == b.dtype and torch.equal(a, b)


# -- the port imports no JAX --------------------------------------------------

def test_fsdp_regime_imports_no_jax():
    code = (
        "import sys, torch\n"
        "from repro_torch import configs\n"
        "from repro_torch.core import device_axis, hier\n"
        "from repro_torch.core.topology import Topology\n"
        "from repro_torch.models import build\n"
        "import dataclasses\n"
        "cfg = dataclasses.replace(configs.get_smoke('gemma3_12b'), "
        "param_mode='fsdp', n_layers=6)\n"
        "topo = Topology(1, 2, 'cpu')\n"
        "built = build.build_model(cfg, topo)\n"
        "init_fn, step = hier.make_hier_step(topo, hier.AlgoConfig(), "
        "built.bundle)\n"
        "state = init_fn(built.init_params(torch.Generator()."
        "manual_seed(0)))\n"
        "state, m = step(state, {'train': {'tokens': torch.zeros("
        "(1, 2, 1, 8), dtype=torch.long)}}, torch.ones(1), "
        "torch.full((1, 2), 0.5), torch.ones(1, 2))\n"
        "assert torch.isfinite(m['loss'])\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")
