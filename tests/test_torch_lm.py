"""The port's LM (the zoo's dense family) against the JAX package, on the
CPU: the loss and its gradients.  ``jax.grad`` of JAX's
``make_loss_single`` against the port's autograd at [1, 1] copies,
float32, on the gemma3 and stablelm smoke configs and on gemma3's with 6
layers (one 5:1 local:global period) at seq 16 > window 8 -- the loss
within 1e-5, every gradient coordinate within 1e-5 (XLA and PyTorch sum
the matmuls and reductions in other orders).  The train step on this
model: ``tests/test_torch_lm_step.py``.
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
         ("gemma3_1b", {"n_layers": 6})]
IDS = ["gemma3-smoke", "stablelm-smoke", "gemma3-6-layers"]


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
    tokens = np.random.default_rng(1).integers(
        0, cfg.vocab, (2, 16)).astype(np.int32)
    loss_fn = jbuild.make_loss_single(jbuilt.arch)
    want, jgrads = jax.jit(jax.value_and_grad(
        lambda pp: loss_fn(pp, {"tokens": jnp.asarray(tokens)}, None)))(p)
    built = build.build_model(cfg, Topology(1, 1, "cpu"))
    leaves, td = pytree.tree_flatten(params_from_numpy(p))
    copies = [a[None, None].clone().requires_grad_(True) for a in leaves]
    loss = built.bundle.loss(pytree.tree_unflatten(td, copies),
                             {"tokens": torch.from_numpy(tokens)[None, None]
                              .long()})
    assert loss.shape == (1, 1)
    np.testing.assert_allclose(float(loss.detach()[0, 0]), float(want),
                               atol=1e-5)
    grads = torch.autograd.grad(loss.sum(), copies)
    for g, jg in zip(grads, jax.tree.leaves(jgrads)):
        np.testing.assert_allclose(g[0, 0].numpy(), np.asarray(jg), rtol=0,
                                   atol=1e-5)
