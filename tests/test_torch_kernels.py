"""The port's kernel plain versions and ``kernels.ops`` (CPU route) are
bitwise the JAX package's Pallas kernels, run in interpret mode:
``sign_pack``, ``vote_update``, ``tally_acc`` (int8 / int16 / int32
tallies that do not start at zero, vote weights with zeros and an empty
pod) and ``ternary_quant`` (uniforms injected at the JAX 2-D shape; the
per-row form of the QSGD step one row at a time, rows of the MLP's leaf
lengths with zero and subnormal rows).

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

from repro.core import votes as jvotes
from repro.core.topology import single_device_topology
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.core import signs as jsigns
from repro_torch.core import signs
from repro_torch.convert import tensor_from_numpy
from repro_torch.kernels import build, ops, ref
from repro_torch.core import votes
from repro_torch.kernels import sign_pack as sign_pack_mod
from repro_torch.kernels import tally_acc as tally_acc_mod
from repro_torch.kernels import ternary_quant as ternary_quant_mod
from repro_torch.kernels import vote_update as vote_update_mod
from repro_torch.kernels.sign_pack import sign_pack
from repro_torch.kernels.tally_acc import tally_acc
from repro_torch.kernels.ternary_quant import ternary_quant
from repro_torch.kernels.vote_update import vote_update

P, D, N = 2, 3, 2 * 4096
RHO, MU = 0.2, 5e-3
NP_DTYPES = {torch.float32: np.float32, torch.bfloat16: ml_dtypes.bfloat16}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for this module's small tensors: the suite runs
    several pytest workers on the machine's cores, and PyTorch's thread
    pool in each of them would contend for the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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


KERNELS = (sign_pack, vote_update, tally_acc, ternary_quant)


@pytest.fixture(autouse=True)
def no_launches():
    """The CPU route never launches a kernel."""
    for k in KERNELS:
        k.launches = 0
    yield
    assert all(k.launches == 0 for k in KERNELS)


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


@pytest.mark.parametrize("mask_kind", ["bool", "int"])
def test_vote_update_flushes_subnormal_results(mask_kind):
    """v with +-1e-40, -1e-45 and 3e-39 entries; pod 0 votes, pod 1's
    quorum is empty (vote 0).  The update flushes a subnormal operand or
    result to the zero of its sign, so pod 1's subnormals become signed
    zeros and its other coordinates stay; bitwise the JAX package's eager
    reference (``repro.kernels.ref.vote_update_ref``, whose XLA CPU ops
    flush subnormals), with mu = 5e-3 and with mu = 0 (a vote of -1 then
    adds -0.0: a flush where the reference's subtract runs).

    Against the Pallas kernel in interpret mode: bitwise on the voting
    pod, and on pod 1 apart from the subnormal coordinates, which the
    jitted kernel keeps -- XLA folds ``v - mu * 0`` to ``v`` at compile
    time, so the flush never runs there.  Like the FMA contraction above,
    the port follows the eager reference where jitted code differs."""
    u, _ = make_inputs(torch.float32, seed=5)
    mask = np.array([[1, 0, 1], [0, 0, 0]],
                    bool if mask_kind == "bool" else np.int32)
    words_j = jops.fused_pack_flat(jnp.asarray(u), None, 0.0, interpret=True)
    words = torch.from_numpy(as_i32(words_j).copy())
    v = np.random.default_rng(6).standard_normal((P, N)).astype(np.float32)
    sub = np.zeros(N, bool)
    sub[:128] = True
    v[:, :32], v[:, 32:64], v[:, 64:96], v[:, 96:128] = (1e-40, -1e-40,
                                                         -1e-45, 3e-39)
    packed = np.asarray(words_j).reshape(P, D, N // 4096, 4096 // 32)
    for mu in (MU, 0.0):
        got = vote_update(words, torch.from_numpy(v.copy()), mu,
                          torch.from_numpy(mask)).numpy()
        eager = np.stack([np.asarray(jref.vote_update_ref(
            jnp.asarray(packed[q]), jnp.asarray(v[q].reshape(-1, 4096)), mu,
            jnp.asarray(mask[q]))).reshape(N) for q in range(P)])
        np.testing.assert_array_equal(as_i32(got), as_i32(eager))
        # pod 1 abstains: signed zeros where v was subnormal, v elsewhere
        assert not got[1, sub].any()
        np.testing.assert_array_equal(np.signbit(got[1, sub]),
                                      np.signbit(v[1, sub]))
        np.testing.assert_array_equal(as_i32(got[1, ~sub]),
                                      as_i32(v[1, ~sub]))
    interp = np.asarray(jops.fused_vote_update_words(
        words_j, jnp.asarray(v), jnp.asarray(mask), MU, interpret=True))
    got = vote_update(words, torch.from_numpy(v.copy()), MU,
                      torch.from_numpy(mask)).numpy()
    np.testing.assert_array_equal(as_i32(got[0]), as_i32(interp[0]))
    np.testing.assert_array_equal(as_i32(got[1, ~sub]),
                                  as_i32(interp[1, ~sub]))
    np.testing.assert_array_equal(as_i32(interp[1, sub]), as_i32(v[1, sub]))


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
    # the bulk-copy kernels' refusals, made on the CUDA route only: whole
    # 16-byte runs (n % 128), 16-byte aligned tensors, 1..512 voters
    w96 = torch.zeros(P, D, 3, dtype=torch.int32)
    bad_u = torch.zeros(P * D * N + 1)[1:].view(P, D, N)
    bad_d = torch.zeros(P * N + 1)[1:].view(P, N)
    bad_w = torch.zeros(words.numel() + 1, dtype=torch.int32)[1:].view(
        words.shape)
    with pytest.raises(ValueError, match="multiple of 128"):
        sign_pack_mod.check_kernel_inputs(torch.zeros(P, D, 96), None)
    with pytest.raises(ValueError, match="multiple of 128"):
        vote_update_mod.check_kernel_inputs(w96, None)
    with pytest.raises(ValueError, match="16-byte boundary"):
        sign_pack_mod.check_kernel_inputs(bad_u, None)
    with pytest.raises(ValueError, match="16-byte boundary"):
        sign_pack_mod.check_kernel_inputs(u, bad_d)
    with pytest.raises(ValueError, match="16-byte boundary"):
        vote_update_mod.check_kernel_inputs(bad_w, None)
    with pytest.raises(ValueError, match="16-byte boundary"):
        vote_update_mod.check_kernel_inputs(words, bad_d)
    for voters in (0,):
        with pytest.raises(ValueError, match="voters"):
            vote_update_mod.check_kernel_inputs(
                torch.zeros(P, voters, 4, dtype=torch.int32), None)
    for voters in (513, 5000):        # counted over voter groups
        vote_update_mod.check_kernel_inputs(
            torch.zeros(P, voters, 4, dtype=torch.int32), None)
    sign_pack_mod.check_kernel_inputs(u, torch.zeros(P, N))
    vote_update_mod.check_kernel_inputs(words, torch.zeros(P, N))
    # the plain version, which CPU tensors take, needs none of it
    sign_pack(torch.zeros(P, D, 96))
    vote_update(w96, None, MU)
    assert torch.equal(sign_pack(bad_u, bad_d, RHO),
                       sign_pack(u, torch.zeros(P, N), RHO))
    assert torch.equal(vote_update(bad_w, bad_d, MU),
                       vote_update(words, torch.zeros(P, N), MU))
    assert vote_update(torch.zeros(P, 513, 4, dtype=torch.int32), None,
                       MU).shape == (P, 128)
    # a 16-byte offset is aligned: accepted, and the same words
    off = torch.zeros(P * D * N + 4)[4:].view(P, D, N)
    sign_pack_mod.check_kernel_inputs(off, None)
    assert torch.equal(sign_pack(off), sign_pack(u))


@pytest.mark.parametrize("voters", [600, 1030])
@pytest.mark.parametrize("mask_kind", ["bool", "int"])
@pytest.mark.parametrize("form", ["update", "vote"])
def test_vote_update_many_voters_matches_pallas(voters, mask_kind, form):
    """More voters a pod than one 512-voter group of the CUDA kernel (and,
    at 1030, than the bit-sliced count's 1023): the port's
    ``fused_vote_update_words`` is bitwise the JAX package's at P = 1,
    n = 4096, with integer weights (zeros among them) and with a bool
    mask, neither of which empties the quorum."""
    rng = np.random.default_rng(voters)
    words = rng.integers(-2**31, 2**31, (1, voters, 128)).astype(np.int32)
    if mask_kind == "int":
        mask = rng.integers(0, 8, (1, voters)).astype(np.int32)
        mask[0, 0] = 5
    else:
        mask = rng.random((1, voters)) < 0.6
        mask[0, 0] = True
    v = rng.standard_normal((1, 4096)).astype(np.float32)
    words_j = jnp.asarray(words.view(np.uint32))
    words_t, mask_t = torch.from_numpy(words), torch.from_numpy(mask)
    if form == "update":
        want = jops.fused_vote_update_words(words_j, jnp.asarray(v),
                                            jnp.asarray(mask), MU,
                                            interpret=True)
        v_t = torch.from_numpy(v.copy())
        got = ops.fused_vote_update_words(words_t, v_t, mask_t, MU)
        assert got is v_t                             # updated in place
        np.testing.assert_array_equal(as_i32(got.numpy()), as_i32(want))
    else:
        want = jops.fused_vote_update_words(words_j, None,
                                            jnp.asarray(mask), -1.0,
                                            interpret=True)
        got = ops.fused_vote_update_words(words_t, None, mask_t, 0.0)
        assert got.dtype == torch.int8 and got.any()
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(want).astype(np.int8))


def test_build_without_nvcc_raises(monkeypatch):
    """The modules import and the CPU route runs with no CUDA compiler;
    asking for the kernels then fails loudly."""
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    monkeypatch.setattr(build.os.path, "isfile", lambda path: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.find_nvcc()
    assert [p.name for p in build.sources()] == [
        "sign_pack.cu", "tally_acc.cu", "ternary_quant.cu", "vote_update.cu"]
    assert set(build.SIGNATURES) == {
        "repro_sign_pack_f32", "repro_sign_pack_bf16", "repro_vote_update",
        "repro_tally_acc", "repro_ternary_quant"}


# -- tally_acc: the streamed client sweep's per-client fold -----------------

TALLY_DTYPES = {torch.int8: (np.int8, 4), torch.int16: (np.int16, 700),
                torch.int32: (np.int32, 40000)}


def tally_inputs(tally_dtype, seed):
    """Starting tallies that are not zero and vote weights with zeros and
    an empty pod (pod 1), within the tally dtype's range."""
    np_dt, hi = TALLY_DTYPES[tally_dtype]
    rng = np.random.default_rng(seed)
    w = rng.integers(0, hi, (P, D)).astype(np.int32)
    w[0, 1] = 0
    w[1] = 0
    t0 = rng.integers(-20, 20, (P, D, N)).astype(np_dt)
    return w, t0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("tally_dtype", list(TALLY_DTYPES))
@pytest.mark.parametrize("rho", [0.0, RHO])
def test_tally_acc_matches_pallas(dtype, tally_dtype, rho):
    u, delta = make_inputs(dtype, seed=5)
    w, t0 = tally_inputs(tally_dtype, 6)
    d = delta if rho else None
    want = jops.fused_tally_acc_flat(jnp.asarray(u), jnp_or_none(d), rho,
                                     jnp.asarray(w), jnp.asarray(t0),
                                     interpret=True)
    want_eager = jref.tally_acc_ref(jnp.asarray(u), jnp_or_none(d), rho,
                                    jnp.asarray(w), jnp.asarray(t0))
    u_t, d_t = tensor_from_numpy(u), tensor_or_none(d)
    w_t, t_t = torch.from_numpy(w), torch.from_numpy(t0.copy())
    got_ref = ref.tally_acc_ref(u_t, d_t, rho, w_t, t_t)
    got = ops.fused_tally_acc_flat(u_t, d_t, rho, w_t, t_t)
    assert got is t_t and got.dtype == tally_dtype     # updated in place
    for g in (got_ref, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(want))
        np.testing.assert_array_equal(g.numpy(), np.asarray(want_eager))
    np.testing.assert_array_equal(got[1].numpy(), t0[1])   # weight 0
    if not rho:       # the -1e-40 coordinates count as 0 -> +1 (w * 1)
        np.testing.assert_array_equal(
            got[0, 2, :32].numpy().astype(np.int64),
            t0[0, 2, :32].astype(np.int64) + w[0, 2])


def test_tally_acc_exact_cancellation_rounds_like_the_eager_reference():
    """As for sign_pack: where u + rho*delta cancels exactly in f32 the
    port (and the eager reference) add +w, the FMA-contracted interpret
    run takes the sign of the product's rounding error."""
    u, delta = make_inputs(torch.float32, cancel=True)
    w, t0 = tally_inputs(torch.int16, 7)
    w[1] = 3                                   # pod 1 votes
    got = ref.tally_acc_ref(tensor_from_numpy(u), tensor_from_numpy(delta),
                            RHO, torch.from_numpy(w), torch.from_numpy(t0))
    eager = jref.tally_acc_ref(jnp.asarray(u), jnp.asarray(delta), RHO,
                               jnp.asarray(w), jnp.asarray(t0))
    np.testing.assert_array_equal(got.numpy(), np.asarray(eager))
    np.testing.assert_array_equal(got[1, :, :256].numpy(),
                                  t0[1, :, :256] + 3)
    fused = np.asarray(jops.fused_tally_acc_flat(
        jnp.asarray(u), jnp.asarray(delta), RHO, jnp.asarray(w),
        jnp.asarray(t0), interpret=True))
    differ = np.argwhere(fused != got.numpy())
    assert len(differ) and (differ[:, 0] == 1).all() and \
        (differ[:, 2] < 256).all()


@pytest.mark.parametrize("tally_dtype", list(TALLY_DTYPES))
def test_tally_accumulate_words_matches_reference(tally_dtype):
    """The word-level fold (one client's packed uplink into the tally) is
    the reference's, and equals tally_acc on the unpacked directions."""
    u, delta = make_inputs(torch.float32, seed=11)
    w, t0 = tally_inputs(tally_dtype, 12)
    words = ops.fused_pack_flat(tensor_from_numpy(u),
                                tensor_from_numpy(delta), RHO)
    got = votes.tally_accumulate_words(words, torch.from_numpy(w),
                                       torch.from_numpy(t0))
    want = jvotes.tally_accumulate_words(
        jnp.asarray(words.numpy()).view(jnp.uint32), jnp.asarray(w),
        jnp.asarray(t0))
    assert got.dtype == tally_dtype
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    direct = ops.fused_tally_acc_flat(
        tensor_from_numpy(u), tensor_from_numpy(delta), RHO,
        torch.from_numpy(w), torch.from_numpy(t0.copy()))
    np.testing.assert_array_equal(got.numpy(), direct.numpy())


@pytest.mark.parametrize("rho", [0.0, RHO])
def test_tally_fold_equals_merged_vote(rho):
    """Folding K clients through tally_acc and thresholding the summed
    tally is the weighted vote of the merged [P, D*K] voter axis (voter
    d*K + c), as vote_update computes it from the packed words and as
    the reference's int-tally vote computes it -- the CPU twin of the
    card-side check in chip_smoke.py."""
    k = 4
    rng = np.random.default_rng(8)
    us = rng.standard_normal((k, P, D, N)).astype(np.float32)
    delta = rng.standard_normal((P, N)).astype(np.float32)
    ws = rng.integers(0, 3, (k, P, D)).astype(np.int32)
    ws[:, 1, :] = 0                                 # pod 1 abstains
    bound = int(ws.sum(axis=(0, 2)).max())
    tally = torch.zeros((P, D, N), dtype=votes.tally_dtype(bound))
    d_t = torch.from_numpy(delta)
    for c in range(k):
        ops.fused_tally_acc_flat(torch.from_numpy(us[c]), d_t, rho,
                                 torch.from_numpy(ws[c]), tally)
    n_eff = torch.from_numpy(ws.sum(axis=(0, 2)).astype(np.int32))
    got = votes.tally_vote_dev(tally, n_eff)
    u_m = torch.from_numpy(np.ascontiguousarray(
        us.transpose(1, 2, 0, 3).reshape(P, D * k, N)))
    w_m = torch.from_numpy(np.ascontiguousarray(
        ws.transpose(1, 2, 0).reshape(P, D * k)))
    merged = ops.fused_sign_vote_flat(u_m, d_t, rho, w_m)
    np.testing.assert_array_equal(got.numpy(), merged.numpy())
    assert not got[1].any()
    s_m = signs.sgn(u_m + ref.f32(rho) * d_t[:, None]) if rho else \
        signs.sgn(u_m)
    want = jvotes.vote_ar_int8(single_device_topology(),
                               jnp.asarray(s_m.numpy()),
                               jnp.asarray(w_m.numpy()), weight_bound=bound)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# -- ternary_quant ------------------------------------------------------------

def ternary_inputs(dtype, seed):
    """x [64, 4096] (the JAX kernel's block) with zeros, signed zeros,
    subnormals, a NaN and values whose |x|/norm is subnormal, and u with
    zeros where those sit."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((64, 4096)).astype(np.float32)
    x[0, :16] = 0.0
    x[0, 16:32] = -0.0
    x[0, 32:48] = 1e-40
    x[0, 48:64] = -1e-39
    x[0, 64:80] = 1e-37 * np.sign(x[0, 64:80])
    x[1, 0] = np.nan
    u = rng.random((64, 4096)).astype(np.float32)
    u[0, :80] = 0.0
    return x.astype(NP_DTYPES[dtype]), u


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("norm", ["l2", "big", "zero"])
def test_ternary_quant_matches_pallas(dtype, norm):
    x, u = ternary_inputs(dtype, 9)
    finite = np.nan_to_num(x.astype(np.float32))
    n = {"l2": np.float32(np.linalg.norm(finite)), "big": np.float32(1e4),
         "zero": np.float32(0.0)}[norm]
    from repro.kernels import ternary_quant as jtq
    want = np.asarray(jtq.ternary_quant(jnp.asarray(x), jnp.asarray(u),
                                        jnp.asarray(n), interpret=True))
    want_eager = np.asarray(jref.ternary_quant_ref(
        jnp.asarray(x), jnp.asarray(u), jnp.asarray(n)))
    x_t, u_t = tensor_from_numpy(x), torch.from_numpy(u)
    n_t = torch.tensor(n)
    got = ternary_quant(x_t, u_t, n_t)
    assert got.dtype == dtype and got.shape == x_t.shape
    for w in (want, want_eager):
        np.testing.assert_array_equal(
            got.to(torch.float32).numpy().view(np.int32),
            w.astype(np.float32).view(np.int32))
    np.testing.assert_array_equal(
        ref.ternary_quant_ref(x_t, u_t, n_t).to(torch.float32).numpy(),
        got.to(torch.float32).numpy())
    if norm == "zero":
        assert not got.to(torch.float32).any()
    else:              # zeros and subnormals give 0 even with u = 0
        assert not got[0, :64].to(torch.float32).any()


@pytest.mark.parametrize("shape", [(500,), (32, 48), (3, 4096)])
def test_ternary_quant_nd_draws_from_its_generator(shape):
    x = torch.from_numpy(np.random.default_rng(10).standard_normal(
        shape).astype(np.float32))
    got = ops.ternary_quant_nd(x, torch.Generator().manual_seed(3))
    assert got.shape == x.shape
    u = torch.rand(x.numel(), generator=torch.Generator().manual_seed(3))
    norm = torch.linalg.vector_norm(x.reshape(-1))
    np.testing.assert_array_equal(
        got.numpy(), ref.ternary_quant_ref(x.reshape(-1), u,
                                           norm).reshape(shape).numpy())
    vals = set(np.unique(np.abs(got.numpy())))
    assert vals <= {0.0, float(norm)} and len(vals) == 2
    assert np.array_equal(np.sign(got.numpy())[got.numpy() != 0],
                          np.sign(x.numpy())[got.numpy() != 0])


def test_ternary_quant_nd_is_unbiased():
    """E[q] = x: the mean of many draws is within 5 standard errors."""
    x = torch.tensor([0.5, -1.0, 2.0, 0.0, -0.25])
    gen = torch.Generator().manual_seed(4)
    draws = torch.stack([ops.ternary_quant_nd(x, gen) for _ in range(4000)])
    norm = float(torch.linalg.vector_norm(x))
    se = norm / np.sqrt(4000)
    np.testing.assert_allclose(draws.mean(0).numpy(), x.numpy(),
                               atol=5 * se)


def test_new_wrappers_check_their_inputs():
    u = torch.zeros(P, D, N)
    w = torch.ones(P, D, dtype=torch.int32)
    t = torch.zeros(P, D, N, dtype=torch.int16)
    with pytest.raises(ValueError, match="tally must be"):
        tally_acc(u, None, 0.0, w, t.to(torch.float32))
    with pytest.raises(ValueError, match="weights must be"):
        tally_acc(u, None, 0.0, w.float(), t)
    with pytest.raises(ValueError, match="delta must be"):
        tally_acc(u, torch.zeros(P, N, dtype=torch.bfloat16), RHO, w, t)
    with pytest.raises(ValueError, match="contiguous"):
        tally_acc(u, None, 0.0, w, torch.zeros(D, P, N,
                                                dtype=torch.int16)
                  .transpose(0, 1))
    with pytest.raises(ValueError, match="u must be"):
        tally_acc(u.double(), None, 0.0, w, t)
    x = torch.zeros(8)
    with pytest.raises(ValueError, match="u must be"):
        ternary_quant(x, torch.zeros(9), torch.tensor(1.0))
    with pytest.raises(ValueError, match="norm must be"):
        ternary_quant(x, torch.zeros(8), torch.ones(1, 1))
    with pytest.raises(ValueError, match="equal rows"):
        ternary_quant(x, torch.zeros(8), torch.ones(3))
    with pytest.raises(ValueError, match="contiguous"):
        ternary_quant(x, torch.zeros(8), torch.ones(4)[::2])
    # a [1] norm is one row, a [2] norm two rows of 4
    assert torch.equal(ternary_quant(x + 1, torch.zeros(8), torch.ones(1)),
                       torch.ones(8))
    assert torch.equal(ternary_quant(x + 1, torch.zeros(8),
                                     torch.tensor([1.0, 0.0])),
                       torch.tensor([1.0] * 4 + [0.0] * 4))
    with pytest.raises(ValueError, match="dtype"):
        ternary_quant(x.double(), torch.zeros(8), torch.tensor(1.0))


def test_new_wrappers_check_their_kernel_inputs():
    """The bulk-copy and 16-byte-vector kernels' refusals, made on the
    CUDA route only: tally_acc wants n % 128 == 0 and 16-byte aligned u,
    delta and tally, ternary_quant 16-byte aligned x and u.  The plain
    version, which CPU tensors take, needs none of it; and
    ``ops.ternary_quant_nd`` copies a misaligned flat view first."""
    u = torch.randn(P, D, N, generator=torch.Generator().manual_seed(0))
    d = torch.randn(P, N, generator=torch.Generator().manual_seed(1))
    w = torch.tensor([[1, 2, 0], [0, 0, 0]], dtype=torch.int32)
    t = torch.zeros(P, D, N, dtype=torch.int8)

    def off(src):                     # the same values, 4 bytes off
        buf = torch.zeros(src.numel() + 1, dtype=src.dtype)
        buf[1:] = src.reshape(-1)
        return buf[1:].view(src.shape)

    bad_u, bad_d, bad_t = off(u), off(d), off(t)
    with pytest.raises(ValueError, match="multiple of 128"):
        tally_acc_mod.check_kernel_inputs(u[..., :N - 64].contiguous(),
                                          None, t[..., :N - 64].contiguous())
    for args in ((bad_u, None, t), (u, bad_d, t), (u, d, bad_t)):
        with pytest.raises(ValueError, match="16-byte boundary"):
            tally_acc_mod.check_kernel_inputs(*args)
    tally_acc_mod.check_kernel_inputs(u, d, t)
    want = tally_acc(u, d, RHO, w, t.clone())
    for uu, dd, tt in ((bad_u, bad_d, bad_t),
                       (u[..., :N - 64].contiguous(), d[:, :N - 64]
                        .contiguous(), t[..., :N - 64].contiguous())):
        got = tally_acc(uu, dd, RHO, w, tt)
        assert got is tt
        np.testing.assert_array_equal(got.numpy(),
                                      want[..., :uu.shape[-1]].numpy())
    x = u.reshape(-1)[:1000]
    ux = torch.rand(1000, generator=torch.Generator().manual_seed(2))
    nrm = torch.linalg.vector_norm(x)
    for args in ((off(x), ux), (x, off(ux))):
        with pytest.raises(ValueError, match="16-byte boundary"):
            ternary_quant_mod.check_kernel_inputs(*args)
    ternary_quant_mod.check_kernel_inputs(x, ux)
    want = ternary_quant(x, ux, nrm)
    assert torch.equal(ternary_quant(off(x), off(ux), nrm), want)
    q = ops.ternary_quant_nd(off(x), torch.Generator().manual_seed(3))
    assert torch.equal(q, ops.ternary_quant_nd(
        x, torch.Generator().manual_seed(3)))


# -- ternary_quant per row: the QSGD step's form -------------------------------

ROW_LENGTHS = (10, 64, 640, 50176)     # the MLP's leaves


def row_inputs(cols, dtype, seed):
    """x [3, cols]: a normal row with zeros and subnormals (u = 0 there),
    a zero row and a row of subnormals (whose squares flush: norm 0);
    u [3, cols] uniforms."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((3, cols)).astype(np.float32)
    u = rng.random((3, cols)).astype(np.float32)
    x[0, :2] = 0.0
    x[0, 2:4] = (1e-40, -1e-39)
    u[0, :4] = 0.0
    x[1] = 0.0
    x[2] = np.where(np.arange(cols) % 2, 1e-40, -3e-39)
    u[2] = 0.0
    return x.astype(NP_DTYPES[dtype]), u


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cols", ROW_LENGTHS)
def test_ternary_quant_rows_match_pallas(cols, dtype):
    """R = 3 rows, each with its own norm (``signs.row_norms``): each row
    of the plain version is bitwise the Pallas kernel (interpret mode)
    called with that row's norm, the row laid into its [64, 4096] block;
    ``ops.ternary_quant_rows`` and ``signs.ternary_quantize(rows=3)`` are
    the same call."""
    from repro.kernels import ternary_quant as jtq
    x, u = row_inputs(cols, dtype, 30 + cols)
    x_t, u_t = tensor_from_numpy(x), torch.from_numpy(u)
    norms = signs.row_norms(x_t)
    assert norms.shape == (3,) and norms[1] == 0 and norms[2] == 0
    got = ternary_quant(x_t, u_t, norms)
    assert got.dtype == dtype and got.shape == (3, cols)
    for r in range(3):
        bx = np.zeros(64 * 4096, x.dtype)
        bu = np.ones(64 * 4096, np.float32)
        bx[:cols], bu[:cols] = x[r], u[r]
        want = np.asarray(jtq.ternary_quant(
            jnp.asarray(bx.reshape(64, 4096)), jnp.asarray(
                bu.reshape(64, 4096)), jnp.asarray(norms[r].numpy()),
            interpret=True)).reshape(-1)[:cols]
        np.testing.assert_array_equal(
            got[r].to(torch.float32).numpy().view(np.int32),
            want.astype(np.float32).view(np.int32), err_msg=f"row {r}")
    assert not got[1:].to(torch.float32).any()
    assert not got[0, :4].to(torch.float32).any()
    for other in (ops.ternary_quant_rows(x_t, u_t).to(dtype),
                  signs.ternary_quantize(x_t, u_t, rows=3)):
        assert torch.equal(other, got)


@pytest.mark.parametrize("cols", ROW_LENGTHS)
def test_ternary_quantize_matches_reference_arithmetic(cols):
    """The port's ``signs.ternary_quantize`` on the uniforms the JAX
    ``signs.ternary_quantize`` draws from its key: the same output up to
    the norm's last bits (the port sums the squares in its fixed order,
    XLA in its own)."""
    import jax
    x = np.random.default_rng(cols).standard_normal(cols).astype(np.float32)
    key = jax.random.PRNGKey(cols)
    want = np.asarray(jsigns.ternary_quantize(jnp.asarray(x), key))
    u = np.asarray(jax.random.uniform(key, x.shape))
    got = signs.ternary_quantize(torch.from_numpy(x), torch.from_numpy(u))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)
    assert np.count_nonzero(want) > 0
    np.testing.assert_allclose(float(signs.row_norms(
        torch.from_numpy(x)[None])[0]), float(np.linalg.norm(
            x.astype(np.float64))), rtol=1e-6)


def test_row_norms_do_not_depend_on_the_row_count():
    """A row's norm (and sum) is the same whether the call holds 1, 20 or
    40 rows: the merged voter axis and one streamed client agree."""
    x = torch.randn(40, 50176, generator=torch.Generator().manual_seed(0))
    full = signs.row_norms(x)
    for rows in (1, 7, 20):
        assert torch.equal(signs.row_norms(x[:rows].contiguous()),
                           full[:rows])
    assert torch.equal(signs.row_sums(x[3:4]), signs.row_sums(x)[3:4])
    assert signs.row_sums(torch.ones(2, 0)).tolist() == [0.0, 0.0]
    assert signs.row_sums(torch.ones(1, 5)).tolist() == [5.0]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,cols,limit", [(8, 40, 100), (7, 10, 45),
                                             (9, 3, 13)])
def test_ternary_quant_rows_splits_at_the_launch_limit(monkeypatch, dtype,
                                                       rows, cols, limit):
    """With ``MAX_NUMEL`` cut to ``limit`` coordinates a launch, rows of
    ``cols`` coordinates go to ``ternary_quant`` in runs of whole rows
    that start on 16-byte boundaries of the float32 buffers, each row
    with its own norm: bitwise the one call at the real limit, in
    ceil(rows / per) calls (the split that lets the QSGD step quantize a
    leaf of 2^31 coordinates or more on the card)."""
    gen = torch.Generator().manual_seed(rows * cols)
    x = torch.randn((rows, cols), generator=gen).to(dtype)
    x[1] = 0.0
    u = torch.rand((rows, cols), generator=gen)
    want = ops.ternary_quant_rows(x, u)
    monkeypatch.setattr(ternary_quant_mod, "MAX_NUMEL", limit)
    per = ops.rows_per_launch(cols)
    assert 1 <= per < rows and per * cols <= limit
    assert (per * cols * 4) % 16 == 0
    calls = []

    def counted(*args, **kw):
        calls.append(args[0].shape[0])
        return ternary_quant(*args, **kw)
    monkeypatch.setattr(ops, "ternary_quant", counted)
    got = ops.ternary_quant_rows(x, u)
    assert calls == [per] * (rows // per) + ([rows % per] if rows % per
                                             else [])
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert got.any()


def test_ternary_quant_rows_refuses_a_row_past_the_limit(monkeypatch):
    """A row that no aligned run of whole rows fits in one launch raises
    ValueError; the kernel's wrapper names the split."""
    monkeypatch.setattr(ternary_quant_mod, "MAX_NUMEL", 10)
    with pytest.raises(ValueError, match="does not fit"):
        ops.rows_per_launch(3)          # 3 rows fit, 4 are the aligned run
    with pytest.raises(ValueError, match="ternary_quant_rows"):
        ternary_quant_mod.check_kernel_inputs(torch.zeros(12),
                                              torch.zeros(12))
