"""The moe family's loss and the FSDP regime on it, against the JAX
package and within the port, on the CPU.

  * the loss and its gradients on the arctic and deepseek-v3 smoke
    configs (deepseek: MLA, a leading dense layer, the shared expert and
    the MTP head, whose loss reads the embedding and the head a second
    time) against ``jax.grad`` of JAX's jitted ``make_loss_single`` at
    [1, 1] copies, float32: the loss and every gradient coordinate within
    1e-5 (the ``tests/test_torch_lm.py`` rule); both dispatch forms;
  * the FSDP regime inside the port: at P=2 x D=3 with a straggler, 4
    steps (2 rounds of T_E=2) of DC in float32 and bfloat16 compute,
    ``param_mode="fsdp"`` on fused, ag_packed and ar_int8 bitwise each
    other and the replicated regime's ag_packed/tree run (the same eager
    ops on the same [P, D] copies, the aux losses added in the same
    order);
  * one vote a leaf and layer a step under remat, MTP's leaves and the
    embedding and head it reuses included (each lifted once, so their
    cotangents sum before the sign), and twice that in the round's
    first step (the anchor pass).

The trajectories against JAX's ``make_hier_step`` in both regimes:
``tests/test_torch_moe_steps.py`` (arctic), ``tests/test_torch_mla_steps.py``
(deepseek-v3) and ``tests/test_torch_vlm.py`` (internvl2).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core import hier as jhier
from repro.core.topology import single_device_topology
from repro.models import build as jbuild
from repro_torch import configs
from repro_torch.convert import params_from_numpy
from repro_torch.core import device_axis, hier, pytree
from repro_torch.core.topology import Topology
from repro_torch.kernels.sign_pack import sign_pack
from repro_torch.models import build
from test_torch_lm import jax_params

P, D = 2, 3
MU, RHO = 1e-3, 0.2
STRAGGLER = torch.tensor([[1.0, 0.0, 1.0], [1.0, 1.0, 1.0]])
TRANSPORTS = ("ag_packed", "ar_int8", "fused")
SEQ = 16


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread (see tests/test_torch_lm_layers.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def smoke(name, **kw):
    """(JAX config, port config) of an arch's smoke config, fields
    replaced; ``dispatch`` goes to the MoE config."""
    jcfg, cfg = jconfigs.get_smoke(name), configs.get_smoke(name)
    if "dispatch" in kw:
        d = kw.pop("dispatch")
        jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(
            jcfg.moe, dispatch=d))
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, dispatch=d))
    return (dataclasses.replace(jcfg, **kw), dataclasses.replace(cfg, **kw))


def batches(cfg, lead, n, seed):
    """n steps' numpy batches of [*lead, 2, SEQ] tokens (and a vlm's
    [*lead, 2, n_patches, d_model] patches)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        b = {"tokens": rng.integers(0, cfg.vocab,
                                    lead + (2, SEQ)).astype(np.int32)}
        if cfg.n_patches:
            b["patches"] = (0.02 * rng.standard_normal(
                lead + (2, cfg.n_patches, cfg.d_model))).astype(np.float32)
        out.append(b)
    return out


def torch_batch(b: dict) -> dict:
    out = {k: torch.from_numpy(v) for k, v in b.items()}
    out["tokens"] = out["tokens"].long()
    return out


# -- loss and gradients -------------------------------------------------------

def loss_and_grads_match_jax(name, **kw):
    """The port's loss and gradients at [1, 1] copies against JAX's
    jitted ``make_loss_single`` (the module docstring's rule)."""
    jcfg, cfg = smoke(name, **kw)
    jbuilt, p = jax_params(jcfg)
    batch = batches(cfg, (), 1, 1)[0]
    loss_fn = jbuild.make_loss_single(jbuilt.arch)
    want, jgrads = jax.jit(jax.value_and_grad(
        lambda pp: loss_fn(pp, jax.tree.map(jnp.asarray, batch), None)))(p)
    built = build.build_model(cfg, Topology(1, 1, "cpu"))
    leaves, td = pytree.tree_flatten(params_from_numpy(p))
    copies = [a[None, None].clone().requires_grad_(True) for a in leaves]
    tb = {k: v[None, None] for k, v in torch_batch(batch).items()}
    loss = built.bundle.loss(pytree.tree_unflatten(td, copies), tb)
    assert loss.shape == (1, 1)
    np.testing.assert_allclose(float(loss.detach()[0, 0]), float(want),
                               rtol=0, atol=1e-5)
    grads = torch.autograd.grad(loss.sum(), copies)
    jleaves = jax.tree.leaves(jgrads)
    assert len(grads) == len(jleaves)
    for g, jg in zip(grads, jleaves):
        np.testing.assert_allclose(g[0, 0].numpy(), np.asarray(jg), rtol=0,
                                   atol=1e-5)


@pytest.mark.parametrize("name,dispatch", [
    ("arctic_480b", "einsum"), ("deepseek_v3_671b", "einsum"),
    ("deepseek_v3_671b", "gather")])
def test_loss_and_grads_match_jax(name, dispatch):
    loss_and_grads_match_jax(name, dispatch=dispatch)


# -- the FSDP regime inside the port ------------------------------------------

def port_run(cfg, compute, transport, mask=None, layout="tree", steps=4):
    """``steps`` steps (rounds of T_E=2) of DC at P=2 x D=3 from seed 0's
    parameters on [P, D, 2, SEQ] batches; the final edge models."""
    algo = hier.AlgoConfig(method="dc_hier_signsgd", mu=MU, rho=RHO, t_e=2,
                           transport=transport, state_layout=layout,
                           compute_dtype=compute, delta_dtype=compute)
    topo = Topology(P, D, "cpu")
    built = build.build_model(cfg, topo)
    init_fn, step = hier.make_hier_step(topo, algo, built.bundle)
    state = init_fn(built.init_params(torch.Generator().manual_seed(0)))
    m = torch.ones(P, D) if mask is None else mask
    for b in batches(cfg, (P, D), steps, 5):
        state, metrics = step(state, {"train": torch_batch(b)},
                              torch.full((P,), 1 / P),
                              torch.full((P, D), 1 / D), m)
        assert torch.isfinite(metrics["loss"])
    return [x.clone() for x in pytree.tree_flatten(
        hier.edge_params(state))[0]]


def fsdp_is_bitwise_replicated(cfg, compute):
    """The module docstring's second check on ``cfg``."""
    dt = {"f32": torch.float32, "bf16": torch.bfloat16}[compute]
    repl = port_run(dataclasses.replace(cfg, param_mode="replicated"), dt,
                    "ag_packed", STRAGGLER)
    fcfg = dataclasses.replace(cfg, param_mode="fsdp")
    for transport in TRANSPORTS:
        got = port_run(fcfg, dt, transport, STRAGGLER)
        assert len(got) == len(repl)
        for a, b in zip(got, repl):
            assert torch.equal(a, b), transport
    assert sign_pack.launches == 0                    # the CPU route


@pytest.mark.parametrize("compute", ["f32", "bf16"])
@pytest.mark.parametrize("name", ["arctic_480b", "deepseek_v3_671b"])
def test_fsdp_is_bitwise_replicated(name, compute):
    fsdp_is_bitwise_replicated(smoke(name)[1], compute)


def lifted_leaf_layers(params) -> int:
    """The lifts a pass makes: every stacked leaf once a layer, every
    other leaf (the table, the head, MTP's) once."""
    return sum(x.shape[0] if name == "stacks" else 1
               for name, sub in params.items()
               for x in pytree.tree_flatten(sub)[0])


def votes_a_step(cfg) -> tuple[list, int]:
    """The lift's backward calls in the first two steps of a T_E=3 round
    at P=2 x D=3, and the lifted leaf-layers of the tree."""
    fcfg = dataclasses.replace(cfg, param_mode="fsdp")
    built = build.build_model(fcfg, Topology(P, D, "cpu"))
    params = built.init_params(torch.Generator().manual_seed(0))
    per_step = lifted_leaf_layers(params)
    init_fn, step = hier.make_hier_step(
        Topology(P, D, "cpu"), hier.AlgoConfig(t_e=3, transport="fused"),
        built.bundle)
    state = init_fn(params)
    counts = []
    for b in batches(fcfg, (P, D), 2, 6):
        device_axis.fsdp_lift.votes = 0
        state, _ = step(state, {"train": torch_batch(b)},
                        torch.full((P,), 0.5), torch.full((P, D), 1 / D),
                        torch.ones(P, D))
        counts.append(device_axis.fsdp_lift.votes)
    return counts, per_step


def test_one_vote_a_leaf_and_layer_with_mtp():
    """deepseek-v3's smoke tree: 1 dense MLA layer and 2 MoE layers
    stacked (14 and 18 leaves a layer), the table, the untied head (norm,
    out) and MTP's 3 + 14 leaves (proj, n_x, n_e and its MLA dense
    block), each voted once a
    step -- the table and the head once although MTP reads them again."""
    _, cfg = smoke("deepseek_v3_671b")
    counts, per_step = votes_a_step(cfg)
    params = build.build_model(cfg, Topology(1, 1, "cpu")).abstract_params()
    n_mtp = len(pytree.tree_flatten(params["mtp"])[0])
    assert n_mtp == 3 + 14
    assert per_step == 14 * 1 + 18 * 2 + 1 + 2 + n_mtp
    assert counts == [2 * per_step, per_step]


def test_one_vote_a_leaf_and_layer_arctic():
    _, cfg = smoke("arctic_480b")
    counts, per_step = votes_a_step(cfg)
    assert per_step == 2 * 13 + 1 + 2     # 13 leaves a layer
    assert counts == [2 * per_step, per_step]


# -- the trajectory against JAX's make_hier_step ------------------------------

def jax_trajectory(name: str, mode: str):
    """JAX's step, 4 steps (2 rounds of T_E=2) of DC at P = D = 1 on an
    arch's smoke config in ``param_mode`` ``mode``, float32: (the port's
    config, the initial parameters, the batches, the final edge
    models)."""
    jcfg, cfg = smoke(name, param_mode=mode)
    jbuilt, p = jax_params(jcfg)
    algo = jhier.AlgoConfig(method="dc_hier_signsgd", mu=MU, rho=RHO, t_e=2,
                            transport="ag_packed", state_layout="tree",
                            compute_dtype=jnp.float32,
                            delta_dtype=jnp.float32)
    init_fn, step = jhier.make_hier_step(single_device_topology(), algo,
                                         jbuilt.bundle)
    state = jax.jit(init_fn)(p, jax.random.PRNGKey(1))
    jstep = jax.jit(step)
    bs = batches(cfg, (1, 1), 4, 2)
    ones = jnp.ones((1, 1))
    for b in bs:
        state, _ = jstep(state, {"train": b}, jnp.ones(1), ones, ones)
    return cfg, p, bs, jax.tree.map(np.asarray, state.params)


def step_matches_jax(name: str, mode: str):
    """The port's 4 steps from JAX's parameters on JAX's batches against
    :func:`jax_trajectory` (``tests/test_torch_lm_step.py``'s criterion:
    every coordinate within 2*mu + 1e-6, at most 0.1 % of them more than
    1e-6 apart); the port's two routes -- fused/flat and ag_packed/tree
    replicated, fused/tree and ag_packed/tree under FSDP -- bitwise."""
    cfg, p, bs, want = jax_trajectory(name, mode)
    built = build.build_model(cfg, Topology(1, 1, "cpu"))
    assert built.bundle.param_mode == mode
    routes = ((("fused", "flat"), ("ag_packed", "tree"))
              if mode == "replicated"
              else (("fused", "tree"), ("ag_packed", "tree")))
    finals = []
    for transport, layout in routes:
        algo = hier.AlgoConfig(method="dc_hier_signsgd", mu=MU, rho=RHO,
                               t_e=2, transport=transport,
                               state_layout=layout,
                               compute_dtype=torch.float32,
                               delta_dtype=torch.float32)
        init_fn, step = hier.make_hier_step(Topology(1, 1, "cpu"), algo,
                                            built.bundle)
        state = init_fn(params_from_numpy(p))
        for b in bs:
            state, _ = step(state, {"train": torch_batch(b)}, torch.ones(1),
                            torch.ones(1, 1), torch.ones(1, 1))
        finals.append(pytree.tree_flatten(hier.edge_params(state))[0])
    jleaves = jax.tree.leaves(want)
    assert len(jleaves) == len(finals[0])
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
