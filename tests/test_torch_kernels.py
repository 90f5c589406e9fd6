"""The port's kernel plain versions and ``kernels.ops`` (CPU route) are
bitwise the JAX package's Pallas kernels, run in interpret mode.

P=2 edges x D=3 devices over n = 2*4096 coordinates, u in f32 and bf16,
the DC correction re-read per voter (the slab map on the TPU, the (p, i)
index here), voter masks none / bool / integer weights with one pod's
quorum empty.  Inputs come from a seed through numpy and carry the
special values the sign rule must get right: +-0.0, NaN and subnormals.

Exact cancellations of u + rho*delta are pinned apart: XLA's CPU backend
contracts the jitted multiply-add (Pallas interpret mode included) into
an FMA, while the eager reference and the port round the product first,
so there the port follows the eager reference."""
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.core import signs
from repro_torch.convert import tensor_from_numpy
from repro_torch.kernels import build, ops, ref
from repro_torch.kernels.sign_pack import sign_pack
from repro_torch.kernels.vote_update import vote_update

P, D, N = 2, 3, 2 * 4096
RHO, MU = 0.2, 5e-3
NP_DTYPES = {torch.float32: np.float32, torch.bfloat16: ml_dtypes.bfloat16}


def make_inputs(dtype, seed=0, cancel=False):
    """u [P, D, N] and delta [P, N] with special values; ``cancel`` sets
    u = -(rho*delta) exactly (in f32) on pod 1's first 256 coordinates."""
    rng = np.random.default_rng(seed)
    u = rng.standard_normal((P, D, N)).astype(np.float32)
    delta = rng.standard_normal((P, N)).astype(np.float32)
    u[0, 0, :64] = 0.0
    u[0, 0, 64:128] = -0.0
    u[0, 1, :32] = np.nan
    u[0, 2, :32] = -1e-40
    npd = NP_DTYPES[dtype]
    u, delta = u.astype(npd), delta.astype(npd)
    prod = np.float32(RHO) * delta.astype(np.float32)
    if cancel:
        u[1, :, :256] = (-prod[1, :256]).astype(npd)
    else:
        # break the cancellations the dtype's grid makes by chance
        # (frequent in bf16): double u where u + rho*delta rounds to 0
        hit = (u.astype(np.float32) + prod[:, None] == 0) & (prod[:, None]
                                                             != 0)
        u[hit] = (u[hit].astype(np.float32) * 2).astype(npd)
    return u, delta


def make_mask(kind):
    return {"none": None,
            "bool": np.array([[1, 0, 1], [1, 1, 1]], bool),
            "int": np.array([[3, 0, 2], [0, 0, 0]], np.int32)}[kind]


def jnp_or_none(a):
    return None if a is None else jnp.asarray(a)


def tensor_or_none(a):
    return None if a is None else tensor_from_numpy(a)


def as_i32(a) -> np.ndarray:
    return np.asarray(a).view(np.int32)


@pytest.fixture(autouse=True)
def no_launches():
    """The CPU route never launches a kernel."""
    sign_pack.launches = vote_update.launches = 0
    yield
    assert sign_pack.launches == 0 and vote_update.launches == 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_delta", [False, True])
def test_sign_pack_matches_pallas(dtype, with_delta):
    u, delta = make_inputs(dtype)
    d = delta if with_delta else None
    want = jops.fused_pack_flat(jnp.asarray(u), jnp_or_none(d), RHO,
                                interpret=True)
    u_t, d_t = tensor_from_numpy(u), tensor_or_none(d)
    got_ref = ref.sign_pack_ref(u_t, d_t, RHO)
    got_ops = ops.fused_pack_flat(u_t, d_t, RHO)
    np.testing.assert_array_equal(got_ref.numpy(), as_i32(want))
    np.testing.assert_array_equal(got_ops.numpy(), as_i32(want))


@pytest.mark.parametrize("mask_kind", ["none", "bool", "int"])
def test_vote_update_matches_pallas(mask_kind):
    u, _ = make_inputs(torch.float32, seed=1)
    mask = make_mask(mask_kind)
    words_j = jops.fused_pack_flat(jnp.asarray(u), None, 0.0, interpret=True)
    v = np.random.default_rng(2).standard_normal((P, N)).astype(np.float32)
    v[0, :8] = -0.0
    want = jops.fused_vote_update_words(words_j, jnp.asarray(v),
                                        jnp_or_none(mask), MU,
                                        interpret=True)
    want_vote = jops.fused_vote_update_words(words_j, None,
                                             jnp_or_none(mask), -1.0,
                                             interpret=True)
    words = torch.from_numpy(as_i32(words_j).copy())
    m = tensor_or_none(mask)
    v_t = torch.from_numpy(v.copy())
    got = vote_update(words, v_t, MU, m)
    assert got is v_t                                 # updated in place
    np.testing.assert_array_equal(as_i32(got.numpy()), as_i32(want))
    np.testing.assert_array_equal(
        as_i32(ref.vote_update_ref(words, torch.from_numpy(v), MU,
                                   m).numpy()), as_i32(want))
    vote = ref.vote_update_ref(words, None, 0.0, m)
    assert vote.dtype == torch.int8
    np.testing.assert_array_equal(vote.numpy(),
                                  np.asarray(want_vote).astype(np.int8))
    if mask_kind == "int":                            # pod 1 abstains
        assert not vote[1].any()
        np.testing.assert_array_equal(got[1].numpy(), v[1])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mask_kind", ["none", "bool", "int"])
def test_fused_flat_ops_match_pallas(dtype, mask_kind):
    u, delta = make_inputs(dtype, seed=3)
    mask = make_mask(mask_kind)
    v = np.random.default_rng(4).standard_normal((P, N)).astype(np.float32)
    want = jops.fused_vote_update_flat(
        jnp.asarray(u), jnp.asarray(delta), RHO, jnp_or_none(mask),
        jnp.asarray(v), MU, interpret=True)
    want_vote = jops.fused_sign_vote_flat(
        jnp.asarray(u), jnp.asarray(delta), RHO, jnp_or_none(mask),
        interpret=True)
    u_t, d_t, m = (tensor_from_numpy(u), tensor_from_numpy(delta),
                   tensor_or_none(mask))
    got = ops.fused_vote_update_flat(u_t, d_t, RHO, m,
                                     torch.from_numpy(v.copy()), MU)
    np.testing.assert_array_equal(as_i32(got.numpy()), as_i32(want))
    vote = ops.fused_sign_vote_flat(u_t, d_t, RHO, m)
    np.testing.assert_array_equal(vote.numpy(), np.asarray(want_vote))


def test_exact_cancellation_rounds_like_the_eager_reference():
    """Where u + rho*delta cancels exactly in f32, the port's sign is
    that of the separately rounded sum (0 -> +1), as in the eager JAX
    reference; the jitted Pallas interpret run fuses the multiply-add
    and takes the sign of the product's rounding error instead."""
    u, delta = make_inputs(torch.float32, cancel=True)
    rows = u.reshape(P * D * N // 4096, 4096)
    d_rows = np.broadcast_to(delta[:, None], u.shape).reshape(rows.shape)
    eager = as_i32(jref.sign_pack_ref(jnp.asarray(rows), jnp.asarray(d_rows),
                                      RHO)).reshape(P, D, N // 32)
    got = ref.sign_pack_ref(tensor_from_numpy(u), tensor_from_numpy(delta),
                            RHO).numpy()
    np.testing.assert_array_equal(got, eager)
    bits = signs.unpack_bits(torch.from_numpy(got)).numpy()
    assert bits[1, :, :256].all()                    # exact 0 -> +1
    fused = as_i32(jops.fused_pack_flat(jnp.asarray(u), jnp.asarray(delta),
                                        RHO, interpret=True))
    differ = np.argwhere(fused != got)
    assert len(differ) and (differ[:, 0] == 1).all() and \
        (differ[:, 2] < 256 // 32).all()


def test_rho_zero_drops_delta():
    u, delta = make_inputs(torch.float32)
    u_t = tensor_from_numpy(u)
    np.testing.assert_array_equal(
        ops.fused_pack_flat(u_t, tensor_from_numpy(delta), 0.0).numpy(),
        ref.sign_pack_ref(u_t, None, 0.0).numpy())


def test_wrappers_check_their_inputs():
    u = torch.zeros(P, D, N)
    with pytest.raises(ValueError, match="dtype"):
        sign_pack(u.double())
    with pytest.raises(ValueError, match="multiple of 32"):
        sign_pack(torch.zeros(P, D, 33))
    with pytest.raises(ValueError, match="delta"):
        sign_pack(u, torch.zeros(P + 1, N), RHO)
    with pytest.raises(ValueError, match="contiguous"):
        sign_pack(torch.zeros(D, P, N).transpose(0, 1))
    words = torch.zeros(P, D, N // 32, dtype=torch.int32)
    with pytest.raises(ValueError, match="float32"):
        vote_update(words, torch.zeros(P, N, dtype=torch.bfloat16), MU)
    with pytest.raises(ValueError, match="weights"):
        vote_update(words, None, MU, torch.ones(P, D + 1, dtype=torch.bool))
    with pytest.raises(ValueError, match="bool or integer"):
        vote_update(words, None, MU, torch.ones(P, D))
    with pytest.raises(ValueError, match="n_pad"):
        ops.fused_pack_flat(torch.zeros(P, D, 4096 + 32), None, 0.0)


def test_build_without_nvcc_raises(monkeypatch):
    """The modules import and the CPU route runs with no CUDA compiler;
    asking for the kernels then fails loudly."""
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    monkeypatch.setattr(build.os.path, "isfile", lambda path: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.find_nvcc()
    assert len(build.sources()) == 2
