"""The LM zoo's layers, attention and dense block against the JAX package.

Each function of ``repro_torch.models.{layers,attention,blocks}`` runs on
the same float32 inputs (numpy, from a seed) and the same parameters (the
JAX package's initialisers, converted) as its JAX counterpart, on the
CPU.  The port sums in other orders than XLA (matmuls, means, softmax)
and rounds sin, cos and pow in its own libm, so float32 agreement is to
a stated absolute tolerance: 1e-6 where only elementwise float32 work
and one mean differ, 1e-5 where matmuls and a softmax do.  The same
functions also run with leading replica dims ([2, 3] copies of the
parameters), where each replica must equal the unbatched call.

Also the structure: for every config (dense, vlm, moe, ssm, hybrid,
encdec), the port's parameter tree has the JAX tree's keys and shapes,
and the same ``param_count``.  The ssm and encdec modules themselves:
``tests/test_torch_lm_families.py``; the moe ones:
``tests/test_torch_moe.py``; the hybrid ones:
``tests/test_torch_hybrid.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core.topology import single_device_topology
from repro.models import attention as jattn
from repro.models import blocks as jblocks
from repro.models import build as jbuild
from repro.models import layers as jlayers
from repro_torch import configs
from repro_torch.convert import params_from_numpy
from repro_torch.core import pytree
from repro_torch.core.topology import Topology
from repro_torch.models import attention, blocks, build, layers

CFG = configs.get_smoke("gemma3_1b")
JCFG = jconfigs.get_smoke("gemma3_1b")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for this module's small tensors: the suite runs
    several pytest workers on the machine's cores, and PyTorch's thread
    pool in each of them would contend for the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def rand(shape, seed=0, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def t(a):
    return torch.from_numpy(np.asarray(a).copy())


def close(got, want, atol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=0, atol=atol)


def jparams(init_fn, seed=0):
    """A JAX parameter tree as numpy, with the norm gains made nonzero."""
    p = jax.tree.map(np.asarray, init_fn(jax.random.PRNGKey(seed)))
    return jax.tree_util.tree_map_with_path(
        lambda path, a: (rand(a.shape, 7, 0.3) if str(path[-1].key)
                         in ("n1", "n2", "qn", "kn") else a), p)


def replicate(tree, lead=(2, 3)):
    """[*lead, *leaf] copies of a tree of tensors."""
    return pytree.tree_map(
        lambda a: a.expand(lead + tuple(a.shape)).contiguous(), tree)


def test_rms_norm_and_rope():
    """rms_norm (float32 scale by 1 + g) and rope (float32 rotation) within
    1e-6 of JAX on [2, 16, 4, 16] heads."""
    x, g = rand((2, 16, 4, 16)), rand((16,), 1, 0.3)
    close(layers.rms_norm(t(g), t(x)), jlayers.rms_norm(g, x), 1e-6)
    pos = np.arange(16, dtype=np.int32)
    for theta in (1e4, 1e6):
        close(layers.rope(t(x), t(pos), theta),
              jlayers.rope(x, jnp.asarray(pos), theta), 1e-6)


@pytest.mark.parametrize("act", ["swiglu", "gelu"])
def test_mlp(act):
    """The MLP block (swiglu; gelu's tanh approximation) within 1e-5, and
    per replica with [2, 3] copies."""
    p = jax.tree.map(np.asarray, jlayers.init_mlp(jax.random.PRNGKey(1), 32,
                                                  64, act))
    x = rand((2, 8, 32), 2)
    want = jlayers.mlp(p, x, act)
    tp = params_from_numpy(p)
    close(layers.mlp(tp, t(x), act), want, 1e-5)
    got = layers.mlp(replicate(tp), t(x).expand(2, 3, 2, 8, 32), act)
    for i in range(2):
        for j in range(3):
            close(got[i, j], want, 1e-5)


def test_embed_unembed_and_xent():
    """embed (scaled and not), the tied unembed and the masked
    cross-entropy; per replica the gather reads its own table."""
    table = rand((64, 16), 3, 0.02)
    tok = np.random.default_rng(4).integers(0, 64, (2, 8)).astype(np.int32)
    for scale in (False, True):
        close(layers.embed({"table": t(table)}, t(tok).long(), scale),
              jlayers.embed({"table": table}, tok, scale), 1e-6)
    x = rand((2, 8, 16), 5)
    logits = jlayers.unembed(table, x)
    close(layers.unembed(t(table), t(x)), logits, 1e-6)
    tgt = np.roll(tok, -1, axis=-1)
    mask = np.ones(tok.shape, np.float32)
    mask[..., -1] = 0.0
    for m in (None, mask):
        close(layers.softmax_xent(t(np.asarray(logits)), t(tgt).long(),
                                  None if m is None else t(m)),
              jlayers.softmax_xent(logits, tgt, m), 1e-6)
    tables = np.stack([table, table[::-1].copy()])[:, None]      # [2, 1]
    got = layers.embed({"table": t(tables)}, t(np.stack([tok, tok])[:, None])
                       .long())
    close(got[1, 0], jlayers.embed({"table": table[::-1]}, tok), 0)


@pytest.mark.parametrize("window,q_chunk", [(0, 1024), (5, 1024), (0, 8),
                                            (4, 8)],
                         ids=["full-mask", "windowed", "scan",
                              "scan-windowed"])
def test_attend_causal(window, q_chunk):
    """attend_causal on [2, 32, 4, 8]: the full-mask path (t <= q_chunk),
    with a window of 5, and the q-block loop at q_chunk 8 (4 blocks; with
    a window of 4 each block slices window + q_chunk keys) -- within 1e-5
    of JAX's paths, and the loop within 1e-5 of the full mask."""
    q, k, v = (rand((2, 32, 4, 8), s) for s in (10, 11, 12))
    want = jattn.attend_causal(q, k, v, window, q_chunk=q_chunk)
    got = attention.attend_causal(t(q), t(k), t(v), window, q_chunk=q_chunk)
    close(got, want, 1e-5)
    close(got, attention.attend_causal(t(q), t(k), t(v), window), 1e-5)


@pytest.mark.parametrize("qk_norm,window", [(True, 8), (False, 0)],
                         ids=["gemma3-local", "stablelm"])
def test_gqa_attn(qk_norm, window):
    """gqa_attn in train mode (4 heads over 1 kv head with qk-norm and a
    window of 8 at seq 16; or multi-head without), within 1e-5."""
    cfg = dataclasses.replace(CFG, qk_norm=qk_norm)
    jcfg = dataclasses.replace(JCFG, qk_norm=qk_norm)
    if not qk_norm:
        cfg = dataclasses.replace(cfg, n_kv_heads=4)
        jcfg = dataclasses.replace(jcfg, n_kv_heads=4)
    p = jparams(lambda key: jattn.init_gqa(key, jcfg))
    x = rand((2, 16, cfg.d_model), 13)
    pos = np.arange(16, dtype=np.int32)
    want, _ = jattn.gqa_attn(p, x, jnp.asarray(pos), jcfg, theta=1e4,
                             window=window)
    got = attention.gqa_attn(params_from_numpy(p), t(x), t(pos), cfg,
                             theta=1e4, window=window)
    close(got, want, 1e-5)


def test_dense_block():
    """The dense block (norm, GQA, residual, norm, MLP, residual), local
    and global flavours, within 1e-5; with [2, 3] replicas too."""
    pos = np.arange(16, dtype=np.int32)
    x = rand((2, 16, CFG.d_model), 14)
    for window, theta in ((CFG.window, 1e4), (0, 1e6)):
        jb = jblocks.dense_block(JCFG, 0, window=window, theta=theta)
        tb = blocks.dense_block(CFG, window=window, theta=theta)
        p = jparams(jb.init, 2)
        want, _, _ = jb.apply(p, x, jblocks.Ctx(JCFG, "train",
                                                positions=jnp.asarray(pos)),
                              None)
        ctx = blocks.Ctx(CFG, positions=t(pos))
        tp = params_from_numpy(p)
        got, aux = tb.apply(tp, t(x), ctx)
        close(got, want, 1e-5)
        assert aux.shape == () and float(aux) == 0.0
        got, aux = tb.apply(replicate(tp), t(x).expand((2, 3) + x.shape),
                            ctx)
        close(got[1, 2], want, 1e-5)
        assert torch.equal(aux, torch.zeros(2, 3))


PORTED = [n for n in configs.ARCH_NAMES
          if configs.get_config(n).family in build.PORTED_FAMILIES]


@pytest.mark.parametrize("name", PORTED)
def test_param_tree_matches_jax(name):
    """For every config of a ported family (full and smoke): the port's
    parameter tree (on the meta device) has the JAX tree's leaves in the
    same order with the same shapes, and param_count is the JAX
    config's (the config's formula, which for xlstm counts the
    embeddings alone)."""
    for getter, jgetter in ((configs.get_config, jconfigs.get_config),
                            (configs.get_smoke, jconfigs.get_smoke)):
        cfg, jcfg = getter(name), jgetter(name)
        assert cfg.param_count() == jcfg.param_count()
        want = jbuild.build_model(jcfg, single_device_topology()
                                  ).abstract_params()
        got = build.build_model(cfg, Topology(1, 1, "cpu")).abstract_params()
        jleaves = jax.tree_util.tree_leaves_with_path(want)
        leaves, _ = pytree.tree_flatten(got)
        assert [tuple(a.shape) for a in leaves] == [
            tuple(a.shape) for _, a in jleaves]
        names = [".".join(str(k.key) for k in path) for path, _ in jleaves]
        assert names == [n for n, _ in _named(got)]


def _named(tree, prefix=""):
    if not isinstance(tree, dict):
        return [(prefix, tree)]
    out = []
    for k in sorted(tree):
        out += _named(tree[k], f"{prefix}.{k}" if prefix else k)
    return out
