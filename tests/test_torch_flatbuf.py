"""The port's flat-buffer layout is the JAX package's, slot for slot, and
its flatten / unflatten / pack are bitwise the same.

Trees: the paper's MLP (784-64-10: leaves b1, b2, w1, w2 in sorted key
order), the parity toy of ``tests/helpers/parity_harness.py`` (odd minor
dim 33) and a mixed-dtype / zero-size / nested tree."""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.core import flatbuf as jflat
from repro.models import mlp as jmlp
from repro_torch.convert import params_from_numpy, tensor_to_numpy
from repro_torch.core import flatbuf, pytree, signs


def mlp_tree():
    return jax.tree.map(np.asarray, jmlp.init_mlp(jax.random.PRNGKey(0)))


def toy_tree():
    rng = np.random.default_rng(1)
    return {"w": rng.standard_normal((16, 64)).astype(np.float32),
            "b": rng.standard_normal((33,)).astype(np.float32),
            "w2": rng.standard_normal((64, 33)).astype(np.float32)}


def mixed_tree():
    rng = np.random.default_rng(2)
    return {"z": {"a": rng.standard_normal((5, 7)).astype(ml_dtypes.bfloat16),
                  "empty": np.zeros((0, 3), np.float32)},
            "k": rng.standard_normal((3,)).astype(np.float32)}


TREES = {"mlp": mlp_tree, "toy": toy_tree, "mixed": mixed_tree}


def batched(tree, lead):
    rng = np.random.default_rng(3)
    return jax.tree.map(
        lambda a: (rng.standard_normal(lead + a.shape) * 3).astype(a.dtype),
        tree)


def to_np(t):
    return tensor_to_numpy(t)


@pytest.mark.parametrize("name", sorted(TREES))
@pytest.mark.parametrize("batch_dims", [0, 1, 2])
def test_layout_matches_reference(name, batch_dims):
    tree = batched(TREES[name](), (2, 3)[:batch_dims])
    want = jflat.make_layout(jax.tree.map(jnp.asarray, tree),
                             batch_dims=batch_dims)
    got = flatbuf.make_layout(params_from_numpy(tree), batch_dims=batch_dims)
    assert (got.n, got.n_pad, got.n_words) == (want.n, want.n_pad,
                                               want.n_words)
    assert len(got.slots) == len(want.slots)
    for gs, ws in zip(got.slots, want.slots):
        assert (gs.shape, gs.size, gs.padded, gs.offset, gs.word_offset,
                gs.words) == (ws.shape, ws.size, ws.padded, ws.offset,
                              ws.word_offset, ws.words)
        assert str(gs.dtype).split(".")[-1] == str(ws.dtype)
    assert str(got.dtype).split(".")[-1] == str(want.dtype)


def test_mlp_layout_is_the_papers():
    layout = flatbuf.make_layout(params_from_numpy(mlp_tree()))
    assert [s.offset for s in layout.slots] == [0, 64, 96, 50272]
    assert (layout.n, layout.n_pad) == (50890, 53248)
    assert layout.treedef.keys == ("b1", "b2", "w1", "w2")


@pytest.mark.parametrize("name", sorted(TREES))
@pytest.mark.parametrize("batch_dims", [0, 1, 2])
def test_flatten_unflatten_match_reference(name, batch_dims):
    tree = batched(TREES[name](), (2, 3)[:batch_dims])
    jtree = jax.tree.map(jnp.asarray, tree)
    jl = jflat.make_layout(jtree, batch_dims=batch_dims)
    ttree = params_from_numpy(tree)
    tl = flatbuf.make_layout(ttree, batch_dims=batch_dims)
    want = np.asarray(jflat.flatten_tree(jl, jtree, batch_dims=batch_dims))
    got = flatbuf.flatten_tree(tl, ttree, batch_dims=batch_dims)
    np.testing.assert_array_equal(to_np(got), want.astype(np.float32))
    back = flatbuf.unflatten_tree(tl, got, batch_dims=batch_dims)
    want_back = jflat.unflatten_tree(jl, jnp.asarray(want),
                                     batch_dims=batch_dims)
    back_leaves = pytree.tree_flatten(back)[0]
    for g, w in zip(back_leaves, jax.tree.leaves(want_back)):
        assert str(g.dtype).split(".")[-1] == str(w.dtype)
        np.testing.assert_array_equal(to_np(g),
                                      np.asarray(w).astype(np.float32))
    for g, orig in zip(back_leaves, pytree.tree_flatten(ttree)[0]):
        assert torch.equal(g, orig)                  # exact round trip


@pytest.mark.parametrize("name", sorted(TREES))
@pytest.mark.parametrize("rho", [0.0, 0.7])
def test_pack_tree_matches_reference(name, rho):
    """[P, D, *leaf] directions + [P, *leaf] correction, added per leaf in
    the leaf's dtype (bf16 leaves round rho to bf16, as JAX does)."""
    u = batched(TREES[name](), (2, 3))
    dl = jax.tree.map(lambda a: a[:, 0] * 0.5,
                      batched(TREES[name](), (2, 3)))
    jl = jflat.make_layout(jax.tree.map(jnp.asarray, u), batch_dims=2)
    want = jflat.pack_tree(jl, jax.tree.map(jnp.asarray, u), batch_dims=2,
                           delta=jax.tree.map(jnp.asarray, dl), rho=rho,
                           delta_batch_dims=1)
    tu = params_from_numpy(u)
    tl = flatbuf.make_layout(tu, batch_dims=2)
    got = flatbuf.pack_tree(tl, tu, batch_dims=2,
                            delta=params_from_numpy(dl), rho=rho,
                            delta_batch_dims=1)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(want).view(np.int32))


def test_pack_tree_equals_pack_of_flat_buffer():
    tree = params_from_numpy(batched(toy_tree(), (2, 3)))
    layout = flatbuf.make_layout(tree, batch_dims=2)
    buf = flatbuf.flatten_tree(layout, tree, batch_dims=2)
    assert torch.equal(flatbuf.pack_tree(layout, tree, batch_dims=2),
                       signs.pack_signs(signs.sgn(buf)))


def test_flat_state_views_alias_and_with_dtype():
    tree = params_from_numpy(batched(mlp_tree(), (2,)))
    layout = flatbuf.make_layout(tree, batch_dims=1)
    fs = flatbuf.FlatState(flatbuf.flatten_tree(layout, tree, 1), layout)
    assert fs.buf.shape == (2, 53248)
    fs.tree()["b2"][0, 0] = 42.0                       # a view of the buffer
    assert fs.buf[0, 64] == 42.0
    lay16 = flatbuf.with_dtype(fs.layout, torch.bfloat16)
    assert lay16.dtype == torch.bfloat16
    assert all(s.dtype == torch.bfloat16 for s in lay16.slots)
    assert [s.offset for s in lay16.slots] == [s.offset
                                               for s in fs.layout.slots]


def test_layout_refuses_mixed_int_float_and_empty():
    with pytest.raises(ValueError, match="mix"):
        flatbuf.make_layout({"a": torch.zeros(3),
                             "b": torch.zeros(3, dtype=torch.int32)})
    with pytest.raises(ValueError, match="empty"):
        flatbuf.make_layout({})
    ints = flatbuf.make_layout({"s": torch.ones(40, dtype=torch.int8)})
    assert (ints.n_pad, ints.dtype) == (4096, torch.int8)
