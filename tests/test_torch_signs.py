"""The port's sign primitives are bitwise the JAX package's.

Inputs are drawn from a seed with numpy and fed to both packages; packed
words compare through their 32-bit pattern (the port carries them as
int32, the JAX package as uint32)."""
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.core import signs as jsigns
from repro_torch.convert import tensor_from_numpy
from repro_torch.core import signs


def as_i32(words) -> np.ndarray:
    return np.asarray(words).view(np.int32)


def test_sgn_matches_reference_on_special_values():
    x = np.array([-2.0, -0.0, 0.0, 3.0, np.nan, -np.inf, np.inf,
                  1e-45, -1e-45], np.float32)
    want = np.asarray(jsigns.sgn(jnp.asarray(x)))
    got = signs.sgn(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.int8
    np.testing.assert_array_equal(got[:4], [-1, 1, 1, 1])


@pytest.mark.parametrize("mu_kind", ["float", "tensor"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_descend_matches_eager_reference(dtype, mu_kind):
    """``v - mu * vote`` with subnormal, signed-zero and non-finite v
    against every vote, and mu = 5e-3 and 0: bitwise the eager JAX
    expression, whose XLA CPU ops treat subnormal operands as zeros of
    their sign and flush subnormal results (``-1e-40 -> -0.0``)."""
    npd = {torch.float32: np.float32, torch.bfloat16: ml_dtypes.bfloat16}
    vals = np.array([1e-40, -1e-40, 1e-45, -1e-45, 3e-39, -0.0, 0.0, 1.0,
                     -2.5, np.nan, np.inf], np.float32)
    v = np.repeat(vals, 3).astype(npd[dtype])
    vote = np.tile(np.array([-1, 0, 1], np.int8), len(vals))
    for mu in (5e-3, 0.0):
        # a weakly typed mu keeps v's dtype, as the port's 0-dim tensor
        want = np.asarray(jnp.asarray(v) - float(np.float32(mu))
                          * jnp.asarray(vote).astype(v.dtype))
        tmu = (float(np.float32(mu)) if mu_kind == "float"
               else torch.tensor(mu, dtype=torch.float32))
        got = signs.descend(tensor_from_numpy(v), tmu,
                            torch.from_numpy(vote))
        assert got.dtype == dtype
        # NaN payloads aside (bf16 NaNs come back with other payload bits)
        nan = np.isnan(want.astype(np.float32))
        np.testing.assert_array_equal(got.float().isnan().numpy(), nan)
        ints = torch.int16 if dtype == torch.bfloat16 else torch.int32
        np.testing.assert_array_equal(
            got.view(ints).numpy()[~nan],
            want.view(np.int16 if dtype == torch.bfloat16
                      else np.int32)[~nan])
    # the abstaining coordinates (vote 0) of the subnormals: signed zeros
    zeros = got[1:12:3][:4].float().numpy()
    assert not zeros.any() and np.signbit(zeros).tolist() == [
        False, True, False, True]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sgn_low_precision_zero_is_plus_one(dtype):
    x = torch.tensor([-0.0, 0.0, -1.0], dtype=dtype)
    assert signs.sgn(x).tolist() == [1, 1, -1]


@settings(max_examples=40, deadline=None)
@given(st.lists(st.integers(0, 1), min_size=1, max_size=200))
def test_pack_unpack_match_reference(bits):
    s = np.asarray([1 if b else -1 for b in bits], np.int8)
    want = jsigns.pack_signs(jnp.asarray(s))
    got = signs.pack_signs(torch.from_numpy(s))
    np.testing.assert_array_equal(got.numpy(), as_i32(want))
    assert got.shape[-1] == signs.packed_size(len(bits))
    back = signs.unpack_signs(got, len(bits))
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(jsigns.unpack_signs(want, len(bits))))
    np.testing.assert_array_equal(back.numpy(), s)


@settings(max_examples=30, deadline=None)
@given(st.integers(1, 9), st.integers(1, 70), st.integers(0, 2**31 - 1),
       st.sampled_from(["none", "bool", "int", "empty"]))
def test_votes_match_reference(k, n, seed, mask_kind):
    """Dense and packed votes, unweighted, masked, integer-weighted and
    with an empty quorum, on odd lengths."""
    rng = np.random.default_rng(seed)
    s = rng.choice([-1, 1], size=(k, n)).astype(np.int8)
    mask = {"none": None,
            "bool": rng.integers(0, 2, size=k).astype(bool),
            "int": rng.integers(0, 5, size=k).astype(np.int32),
            "empty": np.zeros(k, np.int32)}[mask_kind]
    jm = None if mask is None else jnp.asarray(mask)
    tm = None if mask is None else torch.from_numpy(mask)
    dense_j = np.asarray(jsigns.majority_vote(
        jnp.asarray(s), None if jm is None else jm[:, None], axis=0))
    dense_t = signs.majority_vote(
        torch.from_numpy(s), None if tm is None else tm[:, None], axis=0)
    np.testing.assert_array_equal(dense_t.numpy(), dense_j)
    words_j = jsigns.pack_signs(jnp.asarray(s))
    words_t = signs.pack_signs(torch.from_numpy(s))
    packed_j = np.asarray(jsigns.majority_vote_packed(words_j, n, jm))
    packed_t = signs.majority_vote_packed(words_t, n, tm)
    np.testing.assert_array_equal(packed_t.numpy(), packed_j)
    np.testing.assert_array_equal(packed_t.numpy(), dense_t.numpy())
    if mask_kind == "empty":
        assert not packed_t.any()


def test_vote_ties_and_vector_mask_broadcast():
    s = torch.tensor([[1, -1, 1], [-1, 1, 1]], dtype=torch.int8)
    assert signs.majority_vote(s, axis=0).tolist() == [1, 1, 1]
    m = torch.tensor([0, 3], dtype=torch.int32)          # [K] broadcasts
    assert signs.majority_vote(s, m, axis=0).tolist() == [-1, 1, 1]
    np.testing.assert_array_equal(
        signs.majority_vote(s, m, axis=0).numpy(),
        np.asarray(jsigns.majority_vote(jnp.asarray(s.numpy()),
                                        jnp.asarray(m.numpy()), axis=0)))


@pytest.mark.parametrize("method", ["hier_sgd", "hier_local_qsgd",
                                    "hier_signsgd", "dc_hier_signsgd",
                                    "scaffold_hier_signsgd",
                                    "mtgc_hier_signsgd"])
@pytest.mark.parametrize("clients,rate", [(1, 1.0), (4, 0.5), (64, 0.1)])
def test_uplink_bits_match_reference(method, clients, rate):
    for d, t_e in ((50890, 15), (1000, 3)):
        assert signs.uplink_bits(method, d, t_e, clients, rate) == \
            jsigns.uplink_bits(method, d, t_e, clients, rate)
    with pytest.raises(ValueError):
        signs.uplink_bits("bogus", 10, 1)


def test_packed_size_matches_reference():
    for n in (0, 1, 31, 32, 33, 4096, 50890):
        assert signs.packed_size(n) == jsigns.packed_size(n)
