"""The model axis's layouts and specs against the JAX package, in one
process (no mesh), and what is still refused.

The port's sharded ``flatbuf.make_layout(..., sharding=)`` must equal
the JAX function's -- every slot's shape, offset, ``shard_dim`` and
``shard_pad``, ``n``, ``n_pad``, the normalisation to ``shards=1`` --
for the parity toy's tree (hidden 64, and 65 whose matrices shard as
padded blocks) and gemma3-1b's smoke tree at M = 2 and 4; the
multi-bucket ``flatten_tree`` / ``pack_tree`` / ``unflatten_tree``,
``pad_tree`` / ``unpad_tree`` and ``bucket_trees`` must be bitwise
JAX's; ``build.compute_specs`` must equal JAX's ``compute_specs(
make_archdef(cfg, M), M)`` leaf for leaf, and a rank's bucket
(``convert.local_params``) must be its slice of JAX's global buffer
(its block of the experts), for the smoke trees of gemma3-1b,
deepseek-v3, arctic, internvl2, xlstm, zamba2 and whisper at M = 2 and
4.  Then the production grids, checkpoints under a model axis (ROADMAP
item 17e: ``run_training`` on 1 x 1 x 2 CPU ranks stopped and resumed,
bitwise the uninterrupted run) and a data rank's block of a cache split
by length (item 17d, part two)
(every family builds over a model axis, the ssm, hybrid and encdec ones
at the production grid's 16 too; the FSDP regime over a model axis
builds for every family that runs it), and a
one-process topology that touches no process group at any model axis.
"""
import dataclasses
import inspect
import pathlib
import sys
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core import flatbuf as jflat
from repro.launch import mesh as jmesh
from repro.models import build as jbuild
from repro_torch import configs
from repro_torch.core import comm, flatbuf, hier, pytree, shardflat
from repro_torch.core.topology import ProcessMesh, Topology
from repro_torch.kernels import ops as kops
from repro_torch.launch import mesh, train
from repro_torch.models import attention, build

sys.path.insert(0, str(pathlib.Path(__file__).parent / "helpers"))
import torch_tp_worker as TW  # noqa: E402

TOY_SPECS = {"w": (None, "model"), "b": (None,), "w2": ("model", None)}
JTOY_SPECS = {"w": jax.sharding.PartitionSpec(None, "model"),
              "b": jax.sharding.PartitionSpec(None),
              "w2": jax.sharding.PartitionSpec("model", None)}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for this module's small tensors: the suite runs
    several pytest workers on the machine's cores, and PyTorch's thread
    pool in each of them would contend for the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def toy(hid: int, seed: int = 0, lead=(2,)) -> dict:
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal(lead + (16, hid)).astype(np.float32),
            "b": rng.standard_normal(lead + (33,)).astype(np.float32),
            "w2": rng.standard_normal(lead + (hid, 33)).astype(np.float32)}


def as_spec(p) -> tuple | None:
    return None if p is None else tuple(p)


def gemma_tree(m: int, arch: str = "gemma3_1b"):
    """An arch's smoke parameters (gemma3-1b's by default; numpy, two
    edges' [2, *leaf]) and both packages' specs."""
    cfg, jcfg = configs.get_smoke(arch), jconfigs.get_smoke(arch)
    params = pytree.tree_map(
        lambda x: np.stack([x.numpy(), -x.numpy()]),
        build.build_model(cfg, Topology(1, 1, "cpu")).init_params(
            torch.Generator().manual_seed(1)))
    specs = build.compute_specs(build.make_archdef(cfg, m), m)
    jspecs = jbuild.compute_specs(jbuild.make_archdef(jcfg, m), m)
    return params, specs, jspecs


# the tensor-parallel families' smoke trees (gemma3-1b's cases keep
# their ids, the model axis alone)
TP_ARCHS = ("gemma3_1b", "deepseek_v3_671b", "arctic_480b",
            "internvl2_76b", "xlstm_350m", "zamba2_2p7b", "whisper_base")
ARCH_M = [(arch, m) for arch in TP_ARCHS for m in (2, 4)]
ARCH_M_IDS = [str(m) if arch == "gemma3_1b" else f"{arch}-{m}"
              for arch, m in ARCH_M]


def cases():
    out = []
    for m in (2, 4):
        for hid in (64, 65):
            out.append((f"toy{hid}/M{m}", m, lambda h=hid: (
                toy(h), TOY_SPECS, JTOY_SPECS)))
        out.append((f"gemma3_1b/M{m}", m, lambda m=m: gemma_tree(m)))
    return out


CASES = cases()


def both_layouts(m, make, batch_dims):
    tree, specs, jspecs = make()
    lay = flatbuf.make_layout(pytree.tree_map(torch.from_numpy, tree),
                              batch_dims=batch_dims,
                              sharding=flatbuf.ModelSharding(m, "model",
                                                             specs))
    jlay = jflat.make_layout(jax.tree.map(jnp.asarray, tree),
                             batch_dims=batch_dims,
                             sharding=jflat.ModelSharding(m, "model",
                                                          jspecs))
    return tree, lay, jlay


@pytest.mark.parametrize("name,m,make", CASES, ids=[c[0] for c in CASES])
def test_sharded_layout_equals_jax(name, m, make):
    _, lay, jlay = both_layouts(m, make, 1)
    assert (lay.shards, lay.n, lay.n_pad) == (jlay.shards, jlay.n,
                                              jlay.n_pad)
    assert lay.shards == m
    assert lay.bucket_pad == jlay.bucket_pad
    assert lay.n_pad % (lay.shards * flatbuf.TILE) == 0
    assert len(lay.slots) == len(jlay.slots)
    for s, j in zip(lay.slots, jlay.slots):
        assert (s.shape, s.size, s.padded, s.offset, s.shard_dim,
                s.shard_pad) == (tuple(j.shape), j.size, j.padded, j.offset,
                                 j.shard_dim, j.shard_pad), name
        assert s.global_shape(m) == tuple(j.global_shape(m))
    b, jb = lay.bucket(), jlay.bucket()
    assert (b.shards, b.n, b.n_pad) == (jb.shards, jb.n, jb.n_pad)
    assert b.sharded(m) == lay
    if name.startswith("toy65"):
        assert [s.shard_pad for s in lay.slots] == [0, m - 65 % m,
                                                    m - 65 % m]


@pytest.mark.parametrize("name,m,make", CASES, ids=[c[0] for c in CASES])
def test_multi_bucket_flatten_pack_unflatten_are_bitwise_jax(name, m, make):
    tree, lay, jlay = both_layouts(m, make, 1)
    t = pytree.tree_map(torch.from_numpy, tree)
    jt = jax.tree.map(jnp.asarray, tree)
    buf = flatbuf.flatten_tree(lay, t, 1)
    jbuf = np.asarray(jflat.flatten_tree(jlay, jt, batch_dims=1))
    np.testing.assert_array_equal(buf.numpy().view(np.int32),
                                  jbuf.view(np.int32))
    back = flatbuf.unflatten_tree(lay, buf, 1)
    for a, b in zip(pytree.tree_flatten(back)[0], pytree.tree_flatten(tree)[0]):
        np.testing.assert_array_equal(a.numpy(), b)
    for a, b in zip(pytree.tree_flatten(back)[0], jax.tree.leaves(
            jflat.unflatten_tree(jlay, jnp.asarray(jbuf), batch_dims=1))):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    # [P, D, *leaf] signs with the DC correction folded pre-sign
    rng = np.random.default_rng(7)
    u = pytree.tree_map(lambda x: rng.standard_normal(
        (x.shape[0], 3) + x.shape[1:]).astype(np.float32), tree)
    words = flatbuf.pack_tree(lay, pytree.tree_map(torch.from_numpy, u), 2,
                              delta=t, rho=0.2, delta_batch_dims=1)
    jwords = np.asarray(jflat.pack_tree(
        jlay, jax.tree.map(jnp.asarray, u), batch_dims=2, delta=jt, rho=0.2,
        delta_batch_dims=1))
    np.testing.assert_array_equal(words.numpy(), jwords.view(np.int32))


@pytest.mark.parametrize("hid", [64, 65])
@pytest.mark.parametrize("m", [2, 4])
def test_pad_unpad_and_buckets_are_jax_and_a_rank_holds_its_slice(hid, m):
    tree, lay, jlay = both_layouts(m, lambda: (toy(hid), TOY_SPECS,
                                               JTOY_SPECS), 1)
    t = pytree.tree_map(torch.from_numpy, tree)
    jt = jax.tree.map(jnp.asarray, tree)
    padded = flatbuf.pad_tree(lay, t, 1)
    jpadded = jflat.pad_tree(jlay, jt, 1)
    for k in tree:
        np.testing.assert_array_equal(padded[k].numpy(),
                                      np.asarray(jpadded[k]))
        np.testing.assert_array_equal(
            flatbuf.unpad_tree(lay, padded, 1)[k].numpy(), tree[k])
    buckets = flatbuf.bucket_trees(lay, t, 1)
    jbuckets = jflat.bucket_trees(jlay, jt, 1)
    glob = flatbuf.flatten_tree(lay, t, 1)
    for r, (bt, jbt) in enumerate(zip(buckets, jbuckets)):
        for k in tree:
            np.testing.assert_array_equal(bt[k].numpy(), np.asarray(jbt[k]))
        topo = Topology(2, 1, "cpu", mesh=ProcessMesh(
            pods=1, data=1, pod_rank=0, data_rank=0, pod_group=None,
            data_group=None, backend="gloo", model=m, model_rank=r))
        assert topo.model_shards == m and topo.model_rank == r
        local = shardflat.local_block(topo, lay, t, 1)
        bp = lay.bucket_pad
        bucket = shardflat.flatten(topo, lay, local, 1)
        np.testing.assert_array_equal(bucket.numpy(),
                                      glob[:, r * bp:(r + 1) * bp].numpy())
        views = flatbuf.FlatState(bucket, lay.bucket()).tree()
        for k in tree:
            assert torch.equal(views[k], local[k])
        assert [s.shard_dim for s in lay.slots] == [None, 1, 0]
        # the rank's logical rows are its block without the zero tail
        logical = shardflat.logical(topo, lay, local, 1)
        for s, k in zip(lay.slots, sorted(tree)):
            if s.shard_dim is not None:
                ax = 1 + s.shard_dim
                assert logical[k].shape[ax] == s.local_extent(m, r)
                assert not local[k].narrow(
                    ax, s.local_extent(m, r),
                    local[k].shape[ax] - s.local_extent(m, r)).any()


@pytest.mark.parametrize("arch,m", ARCH_M, ids=ARCH_M_IDS)
def test_compute_specs_equal_jax(arch, m):
    _, specs, jspecs = gemma_tree(m, arch)
    mine = pytree.tree_flatten(specs)
    theirs, jtd = jax.tree_util.tree_flatten(
        jspecs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    assert len(mine[0]) == len(theirs)
    keys = [jax.tree_util.keystr(p) for p, _ in
            jax.tree_util.tree_flatten_with_path(
                jspecs, is_leaf=lambda x: isinstance(
                    x, jax.sharding.PartitionSpec))[0]]
    for key, a, b in zip(keys, mine[0], theirs):
        assert as_spec(a) == as_spec(b), key


def test_nothing_shards_normalises_and_zero_size_dims_warn():
    tree = toy(64)
    specs = {"w": (None, None), "b": (None,), "w2": None}
    lay = flatbuf.make_layout(pytree.tree_map(torch.from_numpy, tree), 1,
                              sharding=flatbuf.ModelSharding(2, "model",
                                                             specs))
    plain = flatbuf.make_layout(pytree.tree_map(torch.from_numpy, tree), 1)
    assert lay.shards == 1 and lay == plain and lay.bucket() is lay
    zero = {"e": torch.zeros((2, 0, 4)), "w": torch.zeros((2, 4, 4))}
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        z = flatbuf.make_layout(zero, 1, sharding=flatbuf.ModelSharding(
            2, "model", {"e": ("model", None), "w": (None, "model")}))
    assert any("zero-size" in str(w.message) for w in caught)
    assert z.slots[0].shard_dim is None and z.slots[1].shard_dim == 1


def test_ternary_quant_rows_takes_its_norms_from_outside():
    from repro_torch.core import signs

    g = torch.Generator().manual_seed(0)
    x = torch.randn((6, 100), generator=g)
    u = torch.rand((6, 100), generator=g)
    mine = kops.ternary_quant_rows(x, u)
    given = kops.ternary_quant_rows(x, u, signs.row_norms(x))
    assert torch.equal(mine, given)
    doubled = kops.ternary_quant_rows(x, u, 2 * signs.row_norms(x))
    assert not torch.equal(mine, doubled)


# -- the production grids, the refusals, one process -----------------------------

def test_production_grids_are_the_jax_constants():
    assert mesh.make_production_mesh() == ((16, 16), ("data", "model"))
    assert mesh.make_production_mesh(multi_pod=True) == (
        (2, 16, 16), ("pod", "data", "model"))
    src = inspect.getsource(jmesh.make_production_mesh)
    assert "(2, 16, 16) if multi_pod else (16, 16)" in src
    assert '("pod", "data", "model") if multi_pod else ("data", "model")' \
        in src
    for multi_pod, need in ((False, 256), (True, 512)):
        with pytest.raises(ValueError, match=f"needs {need} ranks"):
            mesh.make_topology(multi_pod=multi_pod, device="cpu")
    with pytest.raises(ValueError, match="512"):
        train.main(["--device", "cpu", "--arch", "gemma3_1b", "--smoke",
                    "--multi_pod"])


def fake_mesh(model: int = 2) -> ProcessMesh:
    return ProcessMesh(pods=1, data=1, pod_rank=0, data_rank=0,
                       pod_group=None, data_group=None, backend="gloo",
                       model=model, model_rank=0)


def jax_cache_specs(arch: str, m: int, batch_ax, smoke: bool = False):
    """JAX's ``build.cache_specs`` of a config at M = m, as tuples."""
    get = jconfigs.get_smoke if smoke else jconfigs.get_config
    return jax.tree.map(tuple, jbuild.cache_specs(
        jbuild.make_archdef(get(arch), m), batch_ax),
        is_leaf=lambda v: isinstance(v, jax.sharding.PartitionSpec))


def test_refusals_name_their_part_of_item_17():
    topo = Topology(2, 2, "cpu", mesh=fake_mesh())
    # the FSDP regime over a model axis (item 17c) builds for the dense,
    # moe and vlm families (item 17f, part one)
    for arch in ("gemma3_1b", "deepseek_v3_671b", "internvl2_76b"):
        fsdp = build.build_model(dataclasses.replace(
            configs.get_smoke(arch), param_mode="fsdp"), topo)
        init_fn, step = hier.make_hier_step(topo, hier.AlgoConfig(),
                                            fsdp.bundle)
        assert callable(init_fn) and callable(step)
        assert fsdp.bundle.loss_master is not None and fsdp.bundle.specs
    # serving over a model axis (item 17d, part one): gemma3 serves
    # resident, its caches laid out by JAX's specs (the single kv head
    # whole on every model rank); a cache split by length (part two)
    # gives a data rank its block of the global layers' length, the
    # window layers' whole
    gemma = build.build_model(configs.get_smoke("gemma3_1b"), topo)
    assert gemma.serve_layout == "resident"
    assert gemma.cache_specs("data") == jax_cache_specs("gemma3_1b", 2,
                                                         "data", smoke=True)
    assert gemma.cache_specs("data")["stacks"]["global"]["self"]["k"] == (
        None, "data", None, None, None)
    two = Topology(2, 2, "cpu", mesh=dataclasses.replace(fake_mesh(),
                                                         data=2))
    cfg = gemma.cfg
    st = build.make_cache(gemma.arch, 1, 12, topo=two,
                          len_axis="data")["stacks"]
    hkv = (cfg.n_kv_heads, cfg.hd)
    assert st["global"]["self"]["k"].shape == (1, 1, 6) + hkv
    assert st["local"]["self"]["k"].shape[1:] == (1, cfg.window) + hkv
    assert build.cache_bytes(gemma.arch, 1, 12, two, len_axis="data") == \
        sum(x.numel() * 2 for x in pytree.tree_flatten(st)[0])
    with pytest.raises(ValueError, match="does not split"):
        build.make_cache(gemma.arch, 1, 13, topo=two, len_axis="data")
    # checkpoints under a model axis (item 17e): on 1 x 1 x 2 CPU ranks
    # run_training stopped at step 2 (saved there) and run again on its
    # directory resumes and ends bitwise the uninterrupted run
    lm = {"arch": "gemma3_1b", "steps": 4, "t_e": 2, "seq": 8, "batch": 1}
    ranks = TW.run_mesh(1, 1, 2, (2, 2), {"lm": lm,
                                          "lm_ckpt": dict(lm, stop=2)})
    got, want = ranks["lm_ckpt"], ranks["lm"]
    assert [e["event"] for e in got["events"]] == ["save", "resume", "save"]
    assert got["losses"][0] + got["losses"][1] == want["losses"]
    for a, b in zip(pytree.tree_flatten(got["params"])[0],
                    pytree.tree_flatten(want["params"])[0]):
        np.testing.assert_array_equal(a.view(np.int32), b.view(np.int32))
    # MLA serves its heads over the model axis from a latent cache whole
    # on every model rank
    dcfg = configs.get_smoke("deepseek_v3_671b")
    assert attention.mla_cache_specs(dcfg, 2, "data") == {
        "ckv": ("data", None, None), "kr": ("data", None, None)}
    assert build.cache_specs(build.make_archdef(dcfg, 2), "data") == \
        jax_cache_specs("deepseek_v3_671b", 2, "data", smoke=True)
    # every family trains over a model axis (item 17f): the ssm, hybrid
    # and encdec/audio families build at M = 2, 4 and the production
    # grid's 16, as published, and serve there with JAX's cache specs
    for arch in ("xlstm_350m", "whisper_base", "zamba2_2p7b"):
        for m in (2, 4, 16):
            cfg = configs.get_config(arch)
            built = build.build_model(cfg, Topology(2, 2, "cpu",
                                                    mesh=fake_mesh(m)))
            assert built.bundle.specs == build.compute_specs(
                build.make_archdef(cfg, m), m)
            init_fn, step = hier.make_hier_step(
                Topology(2, 2, "cpu", mesh=fake_mesh(m)), hier.AlgoConfig(),
                built.bundle)
            assert callable(init_fn) and callable(step)
            assert built.serve_layout == "resident"
            assert built.cache_specs(("pod", "data")) == jax_cache_specs(
                arch, m, ("pod", "data"))
    zamba2 = build.build_model(dataclasses.replace(
        configs.get_smoke("zamba2_2p7b"), param_mode="fsdp"), topo)
    assert zamba2.bundle.loss_master is not None
    with pytest.raises(NotImplementedError, match="replicated regime"):
        build.build_model(dataclasses.replace(
            configs.get_smoke("whisper_base"), param_mode="fsdp"), topo)


def test_one_process_topology_touches_no_group_at_any_model_axis(
        monkeypatch):
    def boom(*a, **kw):
        raise AssertionError("a collective without a mesh")
    for fn in ("all_gather", "all_reduce", "new_group"):
        monkeypatch.setattr(torch.distributed, fn, boom)
    comm.reset_traffic()
    x = torch.randn(3, requires_grad=True)
    for topo in (None, Topology(1, 1, "cpu")):
        assert comm.sum_model(topo, x) is x
        assert comm.copy_to_model(topo, x) is x
        assert comm.max_model(topo, x) is x
        assert comm.gather_model(topo, x, 0) is x
    # the layouts and specs at any model axis are pure geometry
    for m in (2, 4, 16):
        cfg = configs.get_smoke("gemma3_1b")
        specs = build.compute_specs(build.make_archdef(cfg, m), m)
        lay = flatbuf.make_layout(
            build.build_model(cfg, Topology(1, 1, "cpu")).abstract_params(),
            sharding=flatbuf.ModelSharding(m, "model", specs))
        assert lay.shards == m
    # a one-process step with the dense bundle's specs trains as before
    from repro_torch.launch.train import RunCfg, run_training
    state, history = run_training(
        configs.get_smoke("gemma3_1b"), Topology(1, 2, "cpu"),
        hier.AlgoConfig(t_e=2, transport="fused", state_layout="flat",
                        compute_dtype=torch.float32),
        RunCfg(steps=2, batch_per_device=1, seq_len=8, log_every=0),
        log=lambda line: None)
    assert state.params.layout.shards == 1 and len(history) == 2
    assert all(v["calls"] == 0 for v in comm.traffic.values())
    assert not torch.distributed.is_initialized()


@pytest.mark.parametrize("arch,m", ARCH_M, ids=ARCH_M_IDS)
def test_a_rank_takes_its_bucket_of_jax_parameters(arch, m):
    """``convert.local_params``: a JAX tree (numpy) -> the rank's blocks
    and its bucket, bitwise bucket ``model_rank`` of JAX's buffer; a
    split expert leaf's block is the rank's experts."""
    from repro_torch import convert

    params, specs, jspecs = gemma_tree(m, arch)
    jlay = jflat.make_layout(jax.tree.map(jnp.asarray, params),
                             batch_dims=1, sharding=jflat.ModelSharding(
                                 m, "model", jspecs))
    jbuf = np.asarray(jflat.flatten_tree(
        jlay, jax.tree.map(jnp.asarray, params), batch_dims=1))
    bp = jlay.bucket_pad
    for r in range(m):
        topo = Topology(2, 1, "cpu", mesh=ProcessMesh(
            pods=1, data=1, pod_rank=0, data_rank=0, pod_group=None,
            data_group=None, backend="gloo", model=m, model_rank=r))
        local, lay, bucket = convert.local_params(params, topo, specs,
                                                  batch_dims=1)
        assert lay.shards == m and bucket.shape == (2, bp)
        np.testing.assert_array_equal(bucket.numpy(),
                                      jbuf[:, r * bp:(r + 1) * bp])
        if "moe" in params["stacks"]:
            w = params["stacks"]["moe"]["moe"]["w_up"]   # [2, L, E, d, f]
            e = w.shape[2] // m
            np.testing.assert_array_equal(
                local["stacks"]["moe"]["moe"]["w_up"].numpy(),
                w[:, :, r * e:(r + 1) * e])
