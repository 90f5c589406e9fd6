"""The FSDP masters' layout against the JAX package, in one process.

``build.master_specs`` (``ModelBundle.master_specs``) must equal the
JAX ``build_master_specs``' full specs leaf for leaf for all ten
configs at (D, M) = (2, 1), (2, 2) and the production grid's (16, 16):
the JAX function reads only D and M from its topology, so it gets a
stand-in and ``jax.eval_shape``'s shapes, not 512 forced devices --
every family at every grid, each having its tensor-parallel forward;
the per-layer specs ``engine.FsdpPlan`` hands
the lift equal JAX's second result.  ``hier.state_blocks`` indexes an
FSDP slot by its rank's block of the data-sharded dim, JAX's order of
``("model", "data")`` included; ``fsdpify_leaf`` follows JAX's on the
edge cases.
"""
import dataclasses
import functools

import jax
import numpy as np
import pytest

from repro import configs as jconfigs
from repro.models import build as jbuild
from repro_torch import configs
from repro_torch.core import hier, pytree
from repro_torch.core.topology import ProcessMesh, Topology
from repro_torch.models import build

GRIDS = ((2, 1), (2, 2), (16, 16))


@dataclasses.dataclass(frozen=True)
class StandIn:
    """What JAX's ``build_master_specs`` reads of a topology."""
    devices_per_pod: int
    model_shards: int


def as_spec(p):
    return None if p is None else tuple(p)


def jax_specs(name: str, d: int, m: int):
    jcfg = jconfigs.get_config(name)
    arch = jbuild.make_archdef(jcfg, m)
    cspecs = jbuild.compute_specs(arch, m)
    shapes = jax.eval_shape(functools.partial(jbuild.init_params, arch),
                            jax.random.PRNGKey(0))
    return jbuild.build_master_specs(arch, cspecs, shapes, StandIn(d, m),
                                     jcfg.param_mode == "fsdp")


def flat(tree, is_jax: bool) -> dict:
    if is_jax:
        leaves = jax.tree_util.tree_flatten_with_path(
            tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec)
            or x is None)[0]
        return {jax.tree_util.keystr(k): as_spec(v) for k, v in leaves}
    return dict(zip(keys(tree), pytree.tree_flatten(tree)[0]))


def keys(tree, prefix="") -> list:
    if not isinstance(tree, dict):
        return [prefix]
    out = []
    for k in sorted(tree):
        out += keys(tree[k], f"{prefix}['{k}']")
    return out


@pytest.mark.parametrize("d,m", GRIDS, ids=[f"D{d}M{m}" for d, m in GRIDS])
@pytest.mark.parametrize("name", configs.ARCH_NAMES)
def test_master_specs_equal_jax(name, d, m):
    cfg = configs.get_config(name)
    arch = build.make_archdef(cfg, m)
    cspecs = build.compute_specs(arch, m)
    fsdp = cfg.param_mode == "fsdp"
    mine = build.master_specs(arch, cspecs, build.init_params(
        arch, None, "meta"), d, m, fsdp)
    want, per_block = jax_specs(name, d, m)
    got, exp = flat(mine, False), flat(want, True)
    assert got == exp
    if fsdp:
        layers = build.layer_specs(arch, mine)
        for block, tree in per_block.items():
            if block in layers:
                assert flat(layers[block], False) == flat(tree, True), block


def fake_mesh(data: int, model: int, data_rank: int, model_rank: int):
    return ProcessMesh(pods=2, data=data, pod_rank=1, data_rank=data_rank,
                       pod_group=None, data_group=None, backend="gloo",
                       model=model, model_rank=model_rank)


def test_bundle_carries_the_master_specs_over_a_mesh():
    """build_model over a (fake) 2 x 2 x 2 mesh: the bundle's master
    specs are the function's at the global D; the FSDP loss builds."""
    cfg = dataclasses.replace(configs.get_smoke("gemma3_1b"),
                              param_mode="fsdp")
    topo = Topology(2, 4, "cpu", mesh=fake_mesh(2, 2, 0, 0))
    built = build.build_model(cfg, topo)
    arch = build.make_archdef(cfg, 2)
    assert built.bundle.master_specs == build.master_specs(
        arch, build.compute_specs(arch, 2), built.abstract_params(), 4, 2,
        True)
    assert built.bundle.loss_master is not None and built.bundle.specs


@pytest.mark.parametrize("data_rank,model_rank", [(0, 0), (1, 0), (1, 1)])
def test_state_blocks_index_a_rank_s_shard(data_rank, model_rank):
    """``("model", "data")``: block ``model_rank * data + data_rank``;
    ``"data"``: block ``data_rank`` of the whole dim; no data dim: the
    rows alone.  D = 4 over 2 data ranks: a rank's two JAX blocks."""
    topo = Topology(4, 4, "cpu", mesh=fake_mesh(2, 2, data_rank,
                                                model_rank))
    specs = {"a": ("data", "model"), "b": (None, ("model", "data")),
             "c": (None,)}
    params = {"a": np.zeros((4, 8, 6)), "b": np.zeros((4, 3, 16)),
              "c": np.zeros((4, 5))}
    blocks = hier.state_blocks(topo, master_specs=specs, params=params)
    rows = slice(2, 4)
    assert blocks.params["a"] == (rows, slice(4 * data_rank,
                                              4 * data_rank + 4))
    b0 = 4 * (model_rank * 2 + data_rank)
    assert blocks.params["b"] == (rows, slice(None), slice(b0, b0 + 4))
    assert blocks.params["c"] == (rows,)
    assert blocks.delta == blocks.params
    assert blocks.ef == (rows, slice(2 * data_rank, 2 * data_rank + 2))


def test_fsdpify_leaf_follows_jax():
    cases = [((None, None), (6, 20), 4, 1), (("model", None), (8, 8), 2, 2),
             ((None,), (33,), 2, 1), (("model", None), (8, 3), 4, 2),
             ((None, "model"), (3, 16), 4, 4), ((), (5, 5, 8), 4, 1)]
    for spec, shape, d, m in cases:
        want = jbuild.fsdpify_leaf(jax.sharding.PartitionSpec(*spec), shape,
                                   d, m)
        assert build.fsdpify_leaf(spec, shape, d, m) == as_spec(want), (
            spec, shape)
