"""The port's LM train step against the JAX package, on the CPU.

  * the whole trajectory of ``make_hier_step`` on build_model's bundle:
    P = D = 1, DC-HierSignSGD, 2 rounds of T_E = 2 on the same tokens
    and parameters (gemma3's smoke config cut to 6 layers, seq 16 >
    window 8).  A sign step moves every coordinate by mu, so one
    gradient coordinate near zero whose sign the two packages' float
    sums decide differently moves that coordinate 2*mu apart: every
    coordinate within 2*mu + 1e-6 and at most 0.1 % of them more than
    1e-6 apart; the port's fused/flat and ag_packed/tree runs bitwise
    each other;
  * inside the port at P=2 x D=3 through ``run_training``: fused/flat,
    ag_packed/tree and ar_int8/flat bitwise the same edge models in
    bfloat16 compute (the card's route: rho*delta added before
    ``sign_pack``), and K=2 virtual clients streamed bitwise merged.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import hier as jhier
from repro.core.topology import single_device_topology
from repro_torch.convert import params_from_numpy
from repro_torch.core import hier, pytree
from repro_torch.core.clients import ClientConfig
from repro_torch.core.topology import Topology
from repro_torch.launch.train import RunCfg, run_training
from repro_torch.models import build
from test_torch_lm import jax_params, smoke

MU, RHO = 1e-3, 0.2


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for this module's small tensors: the suite runs
    several pytest workers on the machine's cores, and PyTorch's thread
    pool in each of them would contend for the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_trajectory():
    """The JAX step's 4 steps on gemma3's 6-layer smoke config: (the
    config, the initial parameters, the tokens, the final edge models)."""
    jcfg, cfg = smoke("gemma3_1b", n_layers=6)
    jbuilt, p = jax_params(jcfg)
    topo = single_device_topology()
    algo = jhier.AlgoConfig(method="dc_hier_signsgd", mu=MU, rho=RHO, t_e=2,
                            transport="ag_packed", state_layout="tree",
                            compute_dtype=jnp.float32,
                            delta_dtype=jnp.float32)
    init_fn, step = jhier.make_hier_step(topo, algo, jbuilt.bundle)
    state = jax.jit(init_fn)(p, jax.random.PRNGKey(1))
    jstep = jax.jit(step)
    tokens = np.random.default_rng(2).integers(
        0, cfg.vocab, (4, 1, 1, 2, 16)).astype(np.int32)
    ones = jnp.ones((1, 1))
    for s in range(4):
        state, _ = jstep(state, {"train": {"tokens": tokens[s]}},
                         jnp.ones(1), ones, ones)
    return cfg, p, tokens, jax.tree.map(np.asarray, state.params)


def test_step_matches_jax_make_hier_step(jax_trajectory):
    cfg, p, tokens, want = jax_trajectory
    built = build.build_model(cfg, Topology(1, 1, "cpu"))
    finals = []
    for transport, layout in (("fused", "flat"), ("ag_packed", "tree")):
        algo = hier.AlgoConfig(
            method="dc_hier_signsgd", mu=MU, rho=RHO, t_e=2,
            transport=transport, state_layout=layout,
            compute_dtype=torch.float32, delta_dtype=torch.float32)
        init_fn, step = hier.make_hier_step(Topology(1, 1, "cpu"), algo,
                                            built.bundle)
        state = init_fn(params_from_numpy(p))
        for s in range(4):
            state, _ = step(state, {"train": {"tokens": torch.from_numpy(
                tokens[s]).long()}}, torch.ones(1), torch.ones(1, 1),
                torch.ones(1, 1))
        finals.append(pytree.tree_flatten(hier.edge_params(state))[0])
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


def run_cell(cfg, **kw):
    """4 steps of run_training at P=2 x D=3 on the smoke config in
    bfloat16 compute; the final edge models as a list of leaves."""
    base = dict(method="dc_hier_signsgd", mu=MU, rho=RHO, t_e=2,
                compute_dtype=torch.bfloat16, delta_dtype=torch.bfloat16)
    base.update(kw)
    batch = 2 if "clients" in kw else 1
    state, hist = run_training(
        cfg, Topology(2, 3, "cpu"), hier.AlgoConfig(**base),
        RunCfg(steps=4, batch_per_device=batch, seq_len=16, log_every=0),
        log=lambda line: None)
    assert all(np.isfinite(h["loss"]) for h in hist)
    return pytree.tree_flatten(hier.edge_params(state))[0]


@pytest.fixture(scope="module")
def lm_cfg():
    return smoke("gemma3_1b", n_layers=6)[1]


def test_layouts_and_transports_are_bitwise(lm_cfg):
    """fused/flat (the kernels' route, bf16 leaves: rho*delta added
    first), ag_packed/tree and ar_int8/flat give the same edge models."""
    runs = [run_cell(lm_cfg, transport=t, state_layout=lay)
            for t, lay in (("fused", "flat"), ("ag_packed", "tree"),
                           ("ar_int8", "flat"))]
    for other in runs[1:]:
        for a, b in zip(runs[0], other):
            assert torch.equal(a, b)


def test_stream_equals_merged(lm_cfg):
    """K=2 virtual clients a device (one row each): the streamed sweep
    (tally_acc's plain version) equals the merged voter axis."""
    cc = ClientConfig(count=2, mode="stream")
    runs = [run_cell(lm_cfg, transport="fused", state_layout="flat",
                     clients=dataclasses.replace(cc, mode=m))
            for m in ("stream", "merged")]
    for a, b in zip(*runs):
        assert torch.equal(a, b)
