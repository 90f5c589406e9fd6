"""The port's checkpoint store and async saver (``repro_torch.checkpoint``).

  * the behaviours of ``tests/test_checkpoint.py`` on the port's trees:
    roundtrip (bfloat16 and the generator's seed included), LATEST and
    keep-k GC, CRC fallback to the previous checkpoint, the saver's
    failure contract, the staged overlap slot, the flat-state layout
    record, flat <-> tree conversion both ways and its errors naming
    the leaf and field; the model-sharded, uneven and old copy-style
    flat layouts arrive as checkpoints the JAX package wrote;
  * the saver's host copy is complete when ``submit`` returns (the
    fused update writes the master in place), and the CRC read in
    chunks is ``zlib.crc32`` of the whole file;
  * interop: a JAX ``store.save`` of a JAX ``TrainState`` restores into
    the port bitwise equal to ``convert.train_state_from_numpy`` of the
    same state, every slot but ``.rng`` (the target's generator is kept,
    with a warning) -- tree and flat, DC with bfloat16 deltas, the
    staged overlap slot, K=2 with error feedback; a port checkpoint of
    the same configuration has the JAX manifest's keys, shapes, dtypes
    and flat-state records, and the JAX store restores it.
"""
import json
import pathlib
import sys
import time
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, str(pathlib.Path(__file__).parent / "helpers"))
import parity_harness as H  # noqa: E402

from repro.checkpoint import store as jstore  # noqa: E402
from repro.core import flatbuf as jflat  # noqa: E402
from repro.core import hier as jhier  # noqa: E402
from repro.core.topology import single_device_topology  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.checkpoint import async_ckpt, store  # noqa: E402
from repro_torch.core import flatbuf, hier, pytree  # noqa: E402
from repro_torch.core.clients import ClientConfig  # noqa: E402
from repro_torch.core.topology import Topology  # noqa: E402
from test_torch_hier import toy_loss  # noqa: E402

AsyncSaver = async_ckpt.AsyncSaver


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for this module's small tensors: the suite runs
    several pytest workers on the machine's cores, and PyTorch's thread
    pool in each of them would contend for the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {
        "params": {"w": torch.randn(4, 8, generator=g),
                   "b": torch.randn(8, generator=g).to(torch.bfloat16)},
        "step": seed,
        "rng": torch.Generator().manual_seed(seed + 1),
        "none_leaf": None,
    }


def _leaves(tree):
    return [x for _, x in store._items_with_path(tree)
            if isinstance(x, torch.Tensor)]


def test_roundtrip(tmp_path):
    t = _tree(3)
    store.save(tmp_path, 3, t)
    out = store.restore(tmp_path, 3, _tree(0))
    for a, b in zip(_leaves(t), _leaves(out)):
        assert a.dtype == b.dtype
        assert torch.equal(a, b)
    assert out["step"] == 3 and out["none_leaf"] is None


def test_bf16_and_generator_roundtrip(tmp_path):
    t = _tree(1)
    t["rng"] = torch.Generator().manual_seed(2**40 + 12345)
    store.save(tmp_path, 1, t)
    out = store.restore(tmp_path, 1, _tree(0))
    assert out["params"]["b"].dtype == torch.bfloat16
    assert out["rng"].initial_seed() == 2**40 + 12345
    torch.randn(2, generator=out["rng"])        # usable after restore


def test_latest_and_gc(tmp_path):
    t = _tree(0)
    for s in [1, 2, 3, 4, 5]:
        store.save(tmp_path, s, t, keep=2)
    assert store.available_steps(tmp_path) == [4, 5]
    assert (tmp_path / "LATEST").read_text() == "5"


def test_corruption_falls_back(tmp_path):
    t = _tree(0)
    store.save(tmp_path, 1, t, keep=5)
    store.save(tmp_path, 2, _tree(2), keep=5)
    npz = tmp_path / "step_0000000002" / "arrays.npz"
    npz.write_bytes(b"garbage")
    got = store.restore_latest(tmp_path, _tree(9))
    assert got is not None and got[0] == 1
    assert torch.equal(got[1]["params"]["w"], t["params"]["w"])
    with pytest.raises(IOError, match="integrity"):
        store.restore(tmp_path, 2, t)


def test_restore_latest_none_when_empty(tmp_path):
    assert store.restore_latest(tmp_path / "nope", _tree()) is None


def test_crc_in_chunks_is_the_whole_file_crc(tmp_path, monkeypatch):
    monkeypatch.setattr(store, "CRC_CHUNK", 7)
    path = store.save(tmp_path, 1, _tree(1))
    npz = path / "arrays.npz"
    want = zlib.crc32(npz.read_bytes())
    assert store.crc32_file(npz) == want
    assert json.loads((path / "manifest.json").read_text())["crc32"] == want


def test_async_saver(tmp_path):
    saver = AsyncSaver(tmp_path, keep=2)
    for s in [10, 20]:
        saver.submit(s, _tree(s))
    saver.close()
    assert store.available_steps(tmp_path) == [10, 20]
    out = store.restore(tmp_path, 20, _tree(0))
    assert out["step"] == 20
    assert [r["step"] for r in saver.records] == [10, 20]
    assert all(r["bytes"] > 0 and r["save_s"] >= 0 and r["submit_s"] >= 0
               for r in saver.records)


def test_submit_copies_before_it_returns(tmp_path):
    """The step overwrites the master in place: a submitted state must
    be saved as it was at submit, whatever happens to it afterwards."""
    t = _tree(4)
    want = t["params"]["w"].clone()
    saver = AsyncSaver(tmp_path)
    saver.submit(4, t)
    t["params"]["w"].add_(1.0)                 # the next step, in place
    saver.close()
    assert torch.equal(store.restore(tmp_path, 4, _tree(0))["params"]["w"],
                       want)


def test_async_saver_surfaces_worker_failure(tmp_path, monkeypatch):
    orig = store.save

    def flaky(ckpt_dir, step, tree, keep=3):
        if step == 1:
            raise IOError("disk full")
        return orig(ckpt_dir, step, tree, keep=keep)

    monkeypatch.setattr(async_ckpt.store, "save", flaky)
    saver = AsyncSaver(tmp_path, keep=5)
    saver.submit(1, _tree(1))
    with pytest.raises(RuntimeError,
                       match="background checkpoint save failed") as exc:
        saver.wait()
    assert isinstance(exc.value.__cause__, IOError)
    saver.submit(2, _tree(2))
    saver.close()
    assert store.available_steps(tmp_path) == [2]


def test_async_saver_submit_reraises(tmp_path, monkeypatch):
    def failing(*a, **kw):
        raise IOError("disk full")

    monkeypatch.setattr(async_ckpt.store, "save", failing)
    saver = AsyncSaver(tmp_path)
    saver.submit(1, _tree(1))
    deadline = time.time() + 10
    while saver._err is None and time.time() < deadline:
        time.sleep(0.01)
    with pytest.raises(RuntimeError,
                       match="background checkpoint save failed"):
        saver.submit(2, _tree(2))
    saver.close()


def test_async_saver_malformed_item_cannot_deadlock(tmp_path):
    saver = AsyncSaver(tmp_path)
    saver._q.put("bogus")        # a corrupted handoff
    with pytest.raises(RuntimeError,
                       match="background checkpoint save failed"):
        saver.wait()
    saver.submit(3, _tree(3))
    saver.close()
    assert store.available_steps(tmp_path) == [3]


def test_async_saver_submit_after_close_raises(tmp_path):
    saver = AsyncSaver(tmp_path)
    saver.close()
    with pytest.raises(RuntimeError, match="not running"):
        saver.submit(1, _tree(1))


def test_manifest_records_leaves(tmp_path):
    path = store.save(tmp_path, 7, _tree(0))
    manifest = json.loads((path / "manifest.json").read_text())
    assert manifest["step"] == 7
    assert manifest["leaves"]["params/w"] == {"shape": [4, 8],
                                             "dtype": "float32"}
    assert manifest["leaves"]["params/b"]["dtype"] == "float32"   # bf16
    assert manifest["leaves"]["rng"] == {"shape": [2], "dtype": "uint32"}
    assert manifest["leaves"]["step"] == {"shape": [], "dtype": "int32"}
    assert manifest["torch_seed"] == ["rng"]
    assert "none_leaf" not in json.dumps(manifest["leaves"])


def _train_state(staged: bool):
    p = {"w": torch.arange(8.0).reshape(2, 4), "b": torch.ones(3)}
    agg = pytree.tree_map(lambda x: x + 1.0, p) if staged else None
    return hier.TrainState(step=4, params=p, agg_next=agg, delta=None,
                           delta_next=None, ef=None, mom=None, corr_cl=None,
                           corr_edge=None, rng=torch.Generator())


def test_overlap_staged_slot_roundtrip(tmp_path):
    t = _train_state(staged=True)
    path = store.save(tmp_path / "a", 4, t)
    manifest = json.loads((path / "manifest.json").read_text())
    assert ".agg_next/w" in manifest["leaves"]
    out = store.restore(tmp_path / "a", 4, _train_state(staged=True))
    for k in t.params:
        assert torch.equal(out.agg_next[k], t.agg_next[k])
    store.save(tmp_path / "b", 5, _train_state(staged=False))
    with pytest.raises(IOError, match="missing leaf"):
        store.restore(tmp_path / "b", 5, t)


# -- flat state ---------------------------------------------------------------

def _flat_tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    leaves = {"w": torch.randn(2, 4, 8, generator=g),
              "b": torch.randn(2, 33, generator=g).to(torch.bfloat16)}
    lay = flatbuf.make_layout(leaves, batch_dims=1)
    buf = flatbuf.flatten_tree(lay, leaves, 1)
    buf[..., lay.n:] = -7.0     # padding is don't-care
    return {"params": flatbuf.FlatState(buf, lay), "step": seed,
            "rng": torch.Generator().manual_seed(seed + 1)}


def test_flat_roundtrip_records_layout(tmp_path):
    t = _flat_tree(3)
    path = store.save(tmp_path, 3, t)
    meta = json.loads((path / "manifest.json").read_text())[
        "flat_state"]["params"]
    lay = t["params"].layout
    assert meta["n"] == lay.n and meta["n_pad"] == lay.n_pad
    assert [s["offset"] for s in meta["slots"]] == [
        s.offset for s in lay.slots]
    out = store.restore(tmp_path, 3, _flat_tree(0))
    assert torch.equal(out["params"].buf, t["params"].buf)


def test_flat_tree_conversion_roundtrip(tmp_path):
    """save flat -> load tree -> save tree -> load flat: bit-exact."""
    t = _flat_tree(5)
    tree_like = dict(t, params=t["params"].tree())
    store.save(tmp_path / "a", 1, t)
    as_tree = store.restore(tmp_path / "a", 1, dict(
        tree_like, params=pytree.tree_map(torch.zeros_like,
                                          tree_like["params"])))
    for a, b in zip(_leaves(as_tree["params"]), _leaves(tree_like["params"])):
        assert a.dtype == b.dtype and torch.equal(a, b)
    store.save(tmp_path / "b", 2, as_tree)
    as_flat = store.restore(tmp_path / "b", 2, _flat_tree(0))
    for a, b in zip(_leaves(as_flat["params"].tree()),
                    _leaves(t["params"].tree())):
        assert torch.equal(a, b)


def _jax_leaves(seed, dtype_b=jnp.bfloat16):
    k = jax.random.PRNGKey(seed)
    return {"w": jax.random.normal(k, (2, 4, 8)),
            "b": jax.random.normal(jax.random.fold_in(k, 1), (2, 33),
                                   dtype_b)}


def _port_flat_like(leaves):
    t = convert.params_from_numpy(jax.tree.map(np.asarray, leaves))
    lay = flatbuf.make_layout(t, batch_dims=1)
    return flatbuf.FlatState(flatbuf.flatten_tree(lay, t, 1), lay), t


@pytest.mark.parametrize("b_spec", ["replicated", "uneven"])
def test_jax_sharded_flat_checkpoint_restores(tmp_path, b_spec):
    """A JAX checkpoint of a model-sharded flat layout (two shards; the
    33-wide leaf copied into both buckets, or stored as zero-tailed
    uneven blocks) restores into the port's unsharded flat state and
    into its tree, by the logical leaves, bit-exactly."""
    from jax.sharding import PartitionSpec as P
    leaves = _jax_leaves(7, jnp.float32 if b_spec == "uneven"
                         else jnp.bfloat16)
    specs = {"w": P(None, "model"),
             "b": P("model") if b_spec == "uneven" else P(None)}
    fs = jflat.from_tree(leaves, batch_dims=1, sharding=jflat.ModelSharding(
        2, "model", specs))
    path = jstore.save(tmp_path, 1, {"params": fs})
    meta = json.loads((path / "manifest.json").read_text())
    assert meta["flat_state"]["params"]["shards"] == 2
    flat_like, tree = _port_flat_like(leaves)
    out = store.restore(tmp_path, 1, {"params": flat_like.replace(
        torch.zeros_like(flat_like.buf))})
    assert torch.equal(out["params"].buf[..., :flat_like.layout.n],
                       flat_like.buf[..., :flat_like.layout.n])
    for a, b in zip(_leaves(out["params"].tree()), _leaves(tree)):
        assert torch.equal(a, b)
    as_tree = store.restore(tmp_path, 1, {"params": pytree.tree_map(
        torch.zeros_like, tree)})
    for a, b in zip(_leaves(as_tree["params"]), _leaves(tree)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_jax_old_copy_style_manifest_restores(tmp_path):
    """A JAX checkpoint of the old copy-style layout (manifest without
    global_shape/shard_pad) restores by its logical leaves."""
    from jax.sharding import PartitionSpec as P
    leaves = _jax_leaves(5, jnp.float32)
    copy_style = jflat.make_layout(
        leaves, batch_dims=1, sharding=jflat.ModelSharding(
            2, "model", {"w": P(None, "model"), "b": P()}))
    buckets = [jflat.flatten_tree(copy_style.bucket(), bt, batch_dims=1)
               for bt in jflat.bucket_trees(copy_style, leaves, 1)]
    legacy = jflat.FlatState(jnp.concatenate(buckets, axis=-1), copy_style,
                             batch_dims=1)
    path = jstore.save(tmp_path, 1, {"params": legacy})
    manifest = json.loads((path / "manifest.json").read_text())
    for slot in manifest["flat_state"]["params"]["slots"]:
        slot.pop("global_shape")
        slot.pop("shard_pad")
    (path / "manifest.json").write_text(json.dumps(manifest, indent=1))
    flat_like, tree = _port_flat_like(leaves)
    out = store.restore(tmp_path, 1, {"params": flat_like})
    for a, b in zip(_leaves(out["params"].tree()), _leaves(tree)):
        assert torch.equal(a, b)


def test_layout_mismatch_error_names_leaf_and_field(tmp_path):
    t = _flat_tree(0)
    store.save(tmp_path, 1, t)
    other, _ = _port_flat_like({"w": np.zeros((2, 4, 8), np.float32),
                                "b": np.zeros((2, 34), np.float32)})
    with pytest.raises(IOError, match=r"leaf 'params/b'.*expects \(34,\)"):
        store.restore(tmp_path, 1, dict(t, params=other))


def test_flat_restore_validates_layout(tmp_path):
    t = _flat_tree(0)
    store.save(tmp_path, 1, t)
    other, _ = _port_flat_like({"w": np.zeros((2, 5, 5), np.float32),
                                "b": np.zeros((2, 33), np.float32)})
    with pytest.raises(IOError, match="layout mismatch"):
        store.restore(tmp_path, 1, dict(t, params=other))
    lay = t["params"].layout
    wrong_batch = flatbuf.FlatState(torch.zeros((3, lay.n_pad)), lay)
    with pytest.raises(IOError, match="layout mismatch"):
        store.restore(tmp_path, 1, dict(t, params=wrong_batch))
    with pytest.raises(IOError, match="missing leaf"):
        store.restore(tmp_path, 1, dict(t, extra=torch.zeros(2)))


def test_flat_conversion_matches_by_key_not_position(tmp_path):
    """A renamed leaf of identical shape must raise, never be silently
    loaded into another slot's coordinates."""
    t = _flat_tree(0)
    tree_like = dict(t, params=t["params"].tree())
    store.save(tmp_path / "a", 1, tree_like)
    renamed, _ = _port_flat_like({"v": np.zeros((2, 4, 8), np.float32),
                                  "b": np.zeros((2, 33), np.float32)})
    with pytest.raises(IOError, match="missing leaf"):
        store.restore(tmp_path / "a", 1, dict(t, params=renamed))
    store.save(tmp_path / "b", 2, t)
    with pytest.raises(IOError, match="layout mismatch"):
        store.restore(tmp_path / "b", 2, dict(t, params=renamed))
    tree_renamed = dict(t, params={"v": torch.zeros(2, 4, 8),
                                   "b": torch.zeros(2, 33)})
    with pytest.raises(IOError, match="missing leaf"):
        store.restore(tmp_path / "b", 2, tree_renamed)


# -- interop with the JAX package's TrainState --------------------------------

INTEROP = {
    "dc": dict(method="dc_hier_signsgd"),
    "dc_overlap": dict(method="dc_hier_signsgd", cloud_overlap="overlap"),
    "dc_k2_ef": dict(method="dc_hier_signsgd", error_feedback=True,
                     clients="K2"),
    "scaffold_mom": dict(method="scaffold_hier_signsgd", momentum=0.9),
}


def _configs(name, layout):
    kw = dict(INTEROP[name])
    k2 = kw.pop("clients", None) == "K2"
    jcc = H.client_cfg(1, 1, 2, "weighted") if k2 else \
        H.vclients.ClientConfig()
    common = dict(mu=5e-3, t_e=3, rho=1.0, state_layout=layout,
                  transport="ag_packed", **kw)
    jalgo = jhier.AlgoConfig(compute_dtype=jnp.float32, clients=jcc,
                             master_dtype=jnp.float32,
                             delta_dtype=jnp.bfloat16, **common)
    palgo = hier.AlgoConfig(compute_dtype=torch.float32,
                            clients=ClientConfig(**jcc.__dict__),
                            master_dtype=torch.float32,
                            delta_dtype=torch.bfloat16, **common)
    return jalgo, palgo


def _jax_state(jalgo, steps=4):
    """A JAX TrainState after ``steps`` steps of the parity toy."""
    problem = H.make_problem(1, 1)
    init_fn, step = jhier.make_hier_step(single_device_topology(), jalgo,
                                         H.make_bundle())
    state = jax.jit(init_fn)(problem["w0"], jax.random.PRNGKey(1))
    jstep = jax.jit(step)
    for s in range(steps):
        a = s - s % 3
        state, _ = jstep(state, {"train": {"x": problem["xs"][s],
                                           "y": problem["ys"][s]},
                                 "anchor": {"x": problem["xs"][a],
                                            "y": problem["ys"][a]}},
                         jnp.ones(1), jnp.ones((1, 1)), jnp.ones((1, 1)))
    return state, problem


def _port_like(palgo, problem, seed=5):
    init_fn, _ = hier.make_hier_step(Topology(1, 1, "cpu"), palgo,
                                     hier.ModelBundle(loss=toy_loss))
    return init_fn(convert.params_from_numpy(
        jax.tree.map(np.asarray, problem["w0"])), seed)


def _slot_tensors(state):
    out = {}
    for name in convert.SLOTS:
        slot = getattr(state, name)
        if isinstance(slot, flatbuf.FlatState):
            out[name] = [slot.buf]
        elif slot is not None:
            out[name] = pytree.tree_flatten(slot)[0]
    return out


@pytest.mark.parametrize("layout", ["tree", "flat"])
@pytest.mark.parametrize("name", list(INTEROP))
def test_jax_checkpoint_restores_into_the_port(tmp_path, name, layout):
    jalgo, palgo = _configs(name, layout)
    jstate, problem = _jax_state(jalgo)
    jstore.save(tmp_path, 4, jstate)
    like = _port_like(palgo, problem)
    want = convert.train_state_from_numpy(
        jax.tree.map(np.asarray, jstate), like)
    with pytest.warns(UserWarning, match="jax.random key"):
        step, got = store.restore_latest(tmp_path, like)
    assert step == 4 and got.step == want.step == 4
    assert got.rng is like.rng                  # the target's generator
    gs, ws = _slot_tensors(got), _slot_tensors(want)
    assert gs.keys() == ws.keys()
    for slot in ws:
        for a, b in zip(gs[slot], ws[slot]):
            assert a.dtype == b.dtype and torch.equal(a, b), slot


@pytest.mark.parametrize("layout", ["tree", "flat"])
@pytest.mark.parametrize("name", ["dc", "dc_k2_ef"])
def test_port_manifest_matches_jax_manifest(tmp_path, name, layout):
    """The same state saved by both packages: the same leaf keys, shapes
    and dtypes and the same flat-state records; and the JAX store
    restores the port's checkpoint (its ``.rng`` as the key data of
    ``PRNGKey(seed)``)."""
    jalgo, palgo = _configs(name, layout)
    jstate, problem = _jax_state(jalgo)
    like = _port_like(palgo, problem, seed=1)
    pstate = convert.train_state_from_numpy(
        jax.tree.map(np.asarray, jstate), like)
    jpath = jstore.save(tmp_path / "jax", 4, jstate)
    ppath = store.save(tmp_path / "port", 4, pstate)
    jm = json.loads((jpath / "manifest.json").read_text())
    pm = json.loads((ppath / "manifest.json").read_text())
    assert pm["leaves"] == jm["leaves"]
    assert pm.get("flat_state") == jm.get("flat_state")
    assert set(pm) - set(jm) == {"torch_seed"} and pm["torch_seed"] == [".rng"]
    back = jstore.restore(tmp_path / "port", 4, jstate)
    np.testing.assert_array_equal(np.asarray(back.rng),
                                  np.asarray(jax.random.PRNGKey(1)))
    for a, b in zip(jax.tree.leaves(back._replace(rng=None)),
                    jax.tree.leaves(jstate._replace(rng=None))):
        np.testing.assert_array_equal(np.asarray(a, np.float32),
                                      np.asarray(b, np.float32))
