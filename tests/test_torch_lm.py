"""The port's LM against the JAX package, on the CPU: the loss and its
gradients.  ``jax.grad`` of JAX's ``make_loss_single`` against the
port's autograd at [1, 1] copies, float32, on the gemma3 and stablelm
smoke configs, on gemma3's with 6 layers (one 5:1 local:global period)
at seq 16 > window 8, and on the xlstm and whisper smoke configs
(whisper with the same frames in both) -- the loss within 1e-5, every
gradient coordinate within 1e-5 (XLA and PyTorch sum the matmuls and
reductions in other orders).  xlstm's gradients reach tens (the
mLSTM divides by a normalizer that can be small), so there the bound
is 1e-5 of each leaf's largest |gradient| where that passes 1: JAX's
own jitted and op-by-op gradients differ by more than 1e-5 on those
leaves too.  The train step on these models:
``tests/test_torch_lm_step.py``, ``tests/test_torch_lm_families.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core.topology import single_device_topology
from repro.models import build as jbuild
from repro_torch import configs
from repro_torch.convert import params_from_numpy
from repro_torch.core import pytree
from repro_torch.core.topology import Topology
from repro_torch.models import build


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for this module's small tensors: the suite runs
    several pytest workers on the machine's cores, and PyTorch's thread
    pool in each of them would contend for the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


CASES = [("gemma3_1b", {}), ("stablelm_3b", {}),
         ("gemma3_1b", {"n_layers": 6}), ("xlstm_350m", {}),
         ("whisper_base", {})]
IDS = ["gemma3-smoke", "stablelm-smoke", "gemma3-6-layers", "xlstm-smoke",
       "whisper-smoke"]


def smoke(name, **kw):
    return (dataclasses.replace(jconfigs.get_smoke(name), **kw),
            dataclasses.replace(configs.get_smoke(name), **kw))


def jax_params(jcfg, seed=0):
    built = jbuild.build_model(jcfg, single_device_topology())
    return built, jax.tree.map(np.asarray,
                               built.init_params(jax.random.PRNGKey(seed)))


@pytest.mark.parametrize("name,kw", CASES, ids=IDS)
def test_loss_and_grads_match_jax(name, kw):
    jcfg, cfg = smoke(name, **kw)
    jbuilt, p = jax_params(jcfg)
    rng = np.random.default_rng(1)
    batch = {"tokens": rng.integers(0, cfg.vocab, (2, 16)).astype(np.int32)}
    if cfg.encoder_layers:
        batch["frames"] = (0.1 * rng.standard_normal(
            (2, cfg.encoder_frames, cfg.frontend_dim))).astype(np.float32)
    loss_fn = jbuild.make_loss_single(jbuilt.arch)
    want, jgrads = jax.jit(jax.value_and_grad(
        lambda pp: loss_fn(pp, jax.tree.map(jnp.asarray, batch), None)))(p)
    built = build.build_model(cfg, Topology(1, 1, "cpu"))
    leaves, td = pytree.tree_flatten(params_from_numpy(p))
    copies = [a[None, None].clone().requires_grad_(True) for a in leaves]
    tbatch = {k: torch.from_numpy(v)[None, None] for k, v in batch.items()}
    tbatch["tokens"] = tbatch["tokens"].long()
    loss = built.bundle.loss(pytree.tree_unflatten(td, copies), tbatch)
    assert loss.shape == (1, 1)
    np.testing.assert_allclose(float(loss.detach()[0, 0]), float(want),
                               atol=1e-5)
    grads = torch.autograd.grad(loss.sum(), copies)
    for g, jg in zip(grads, jax.tree.leaves(jgrads)):
        jg = np.asarray(jg)
        scale = max(1.0, float(np.abs(jg).max())) if name == "xlstm_350m" \
            else 1.0
        np.testing.assert_allclose(g[0, 0].numpy(), jg, rtol=0,
                                   atol=1e-5 * scale)



def test_a_schedule_cut_below_its_period_fails_in_both_packages():
    """gemma3-1b's 5:1 local:global schedule cut to 2 layers (under one
    period) keeps a zero-count ``stacks.global`` block, initialised
    unstacked as a tied block is (both packages' ``stack_counts`` and
    ``_stack_init``): JAX's forward cannot trace it (its segment scan
    slices the unstacked set), and the port's step raises too, where
    autograd finds leaves no layer reads (ROADMAP section 3).  So the
    card's runs cut gemma3 to whole periods."""
    jcfg, cfg = smoke("gemma3_1b", n_layers=2)
    jbuilt, p = jax_params(jcfg)
    assert "global" in p["stacks"] and p["stacks"]["global"]["n1"].ndim == 1
    batch = {"tokens": np.random.default_rng(1).integers(
        0, cfg.vocab, (2, 16)).astype(np.int32)}
    loss_fn = jbuild.make_loss_single(jbuilt.arch)
    with pytest.raises(ValueError):
        jax.grad(lambda pp: loss_fn(pp, jax.tree.map(jnp.asarray, batch),
                                    None))(p)
    from repro_torch.core import hier

    built = build.build_model(cfg, Topology(1, 1, "cpu"))
    init_fn, step = hier.make_hier_step(
        Topology(1, 1, "cpu"), hier.AlgoConfig(compute_dtype=torch.float32),
        built.bundle)
    state = init_fn(params_from_numpy(p))
    tokens = torch.from_numpy(batch["tokens"]).long()[:1][None, None]
    with pytest.raises(RuntimeError, match="not have been used"):
        step(state, {"train": {"tokens": tokens}}, torch.ones(1),
             torch.ones((1, 1)), torch.ones((1, 1)))
