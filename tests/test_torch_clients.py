"""The port's virtual clients (``repro_torch.core.clients``) against the
JAX package's ``core/clients.py``.

  * ``participation_mask`` is bitwise the reference's for full /
    bernoulli / fixed participation over several seeds and rounds 0-7,
    and bitwise the independent numpy transcription of the pinned
    splitmix32 scheme in ``tests/test_ref_fed_participation.py``;
  * ``carve_batch``, ``client_slice`` and ``regroup_clients`` move
    exactly the reference's rows;
  * ``participating_shares`` and the weight helpers give the reference's
    values, and the validation raises where the reference raises.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_ref_fed_participation as participation_suite
from repro.core import clients as jclients
from repro_torch.core import clients

SHAPES = [(1, 1, 4), (2, 3, 2), (4, 5, 2)]


def both(**kw):
    return jclients.ClientConfig(**kw), clients.ClientConfig(**kw)


@pytest.mark.parametrize("participation,rate", [
    ("full", 1.0), ("bernoulli", 0.5), ("bernoulli", 0.3), ("fixed", 0.5),
    ("fixed", 0.1)])
@pytest.mark.parametrize("seed", [0, 11, 2**31 + 5])
def test_participation_mask_matches_reference(participation, rate, seed):
    for pods, devs, k in SHAPES:
        jc, tc = both(count=k, participation=participation, rate=rate,
                      seed=seed)
        for t in range(8):
            want = np.asarray(jclients.participation_mask(jc, pods, devs, t))
            got = clients.participation_mask(tc, pods, devs, t)
            assert got.dtype == np.float32 and got.shape == (pods, devs, k)
            np.testing.assert_array_equal(got, want)
            if participation != "full":
                np.testing.assert_array_equal(
                    clients._client_words(tc, pods, devs, t),
                    np.asarray(jclients._client_words(jc, pods, devs, t)))
            if participation == "bernoulli":
                np.testing.assert_array_equal(
                    got, participation_suite._mask_np(seed, rate, pods, devs,
                                                      k, t))
            if participation == "fixed":
                m = max(1, int(round(rate * devs * k)))
                np.testing.assert_array_equal(
                    got.reshape(pods, -1).sum(1), m)


@pytest.mark.parametrize("count", [1, 2, 4])
def test_carve_and_slice_match_reference(count):
    rng = np.random.default_rng(0)
    batch = {"x": rng.standard_normal((2, 3, 8, 5)).astype(np.float32),
             "y": rng.integers(0, 9, (2, 3, 8)).astype(np.int32)}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    want = jclients.carve_batch(jb, count)
    got = clients.carve_batch(tb, count)
    for k in batch:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
        for c in range(count):
            np.testing.assert_array_equal(
                clients.client_slice(tb, count, c)[k].numpy(),
                np.asarray(jclients.client_slice(jb, count, c)[k]))
            # client c of device d is voter d*K + c of the carve
            np.testing.assert_array_equal(
                clients.client_slice(tb, count, c)[k].numpy(),
                got[k].numpy()[:, c::count])
    order = np.random.default_rng(1).permutation(2 * 3 * count)
    moved = clients.regroup_clients(tb, order, count)
    want_moved = jclients.regroup_clients(jb, order, count)
    for k in batch:
        np.testing.assert_array_equal(moved[k].numpy(),
                                      np.asarray(want_moved[k]))
    assert clients.regroup_clients(tb, None, count) is tb


def test_carve_refuses_what_the_reference_refuses():
    tb = {"x": torch.zeros(2, 3, 6)}
    for fn in (lambda: clients.carve_batch(tb, 4),
               lambda: clients.client_slice(tb, 4, 0),
               lambda: clients.regroup_clients(tb, np.arange(24), 4)):
        with pytest.raises(ValueError, match="does not divide"):
            fn()
    with pytest.raises(ValueError, match="permutes"):
        clients.regroup_clients(tb, np.arange(5), 2)
    with pytest.raises(ValueError, match="clients_per_device"):
        clients.validate_batch_carve(10, 4)
    with pytest.raises(ValueError, match="--K"):
        clients.validate_batch_carve(10, 3, flag="K")
    clients.validate_batch_carve(10, 1)
    clients.validate_batch_carve(12, 4)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_participating_shares_match_reference(seed):
    rng = np.random.default_rng(seed)
    p, d, k = 3, 4, 2
    dev_w = rng.random((p, d)).astype(np.float32)
    w = rng.integers(0, 700, (p, d, k)).astype(np.float32)
    mask = (rng.random((p, d, k)) < 0.5).astype(np.float32)
    mask[1] = 0.0                                  # pod 1 abstains
    want = np.asarray(jclients.participating_shares(
        jnp.asarray(dev_w), jnp.asarray(w), jnp.asarray(mask)))
    got = clients.participating_shares(torch.from_numpy(dev_w),
                                       torch.from_numpy(w),
                                       torch.from_numpy(mask)).numpy()
    np.testing.assert_array_equal(got, want)
    assert not got[1].any()


def test_weights_and_validation_match_reference():
    weights = tuple(tuple(tuple(q + 2 * dv + c for c in range(2))
                          for dv in range(3)) for q in range(2))
    jc, tc = both(count=2, weights=weights)
    np.testing.assert_array_equal(tc.weight_array(2, 3),
                                  jc.weight_array(2, 3))
    assert tc.weight_bound(2, 3) == jc.weight_bound(2, 3) == 21
    assert tc.active and jc.active
    jd, td = both(count=3)
    np.testing.assert_array_equal(td.weight_array(2, 3),
                                  jd.weight_array(2, 3))
    assert td.weight_bound(2, 3) == jd.weight_bound(2, 3) == 9
    assert not clients.ClientConfig().active
    assert clients.ClientConfig(participation="fixed").active
    with pytest.raises(ValueError, match="shape"):
        tc.weight_array(3, 3)
    for bad in ({"count": 0}, {"participation": "x"}, {"mode": "x"},
                {"rate": 0.0}, {"rate": 1.5}, {"weights": (((-1,),),)},
                {"weights": (((1.5,),),)}, {"weights": ()}):
        with pytest.raises(ValueError):
            jclients.ClientConfig(**bad)
        with pytest.raises(ValueError):
            clients.ClientConfig(**bad)
    assert ([f.name for f in dataclasses.fields(clients.ClientConfig)]
            == [f.name for f in dataclasses.fields(jclients.ClientConfig)])
    assert clients.CLIENT_MODES == jclients.CLIENT_MODES
    assert clients.PARTICIPATION_MODES == jclients.PARTICIPATION_MODES
