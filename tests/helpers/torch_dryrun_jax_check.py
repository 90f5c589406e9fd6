"""The JAX dry run's cells, skips, abstract specs and chaos report on the
production grids, for ``tests/test_torch_dryrun.py`` to hold the port's
dry run against.

Run as ``python torch_dryrun_jax_check.py IN.json OUT.json`` (it forces
512 host devices before importing jax: ``repro.launch.dryrun`` sets the
same flag at import).  ``IN.json`` holds the cases: ``skips`` (name ->
[arch, shape, method, K clients, cloud_overlap]), ``states`` ([arch,
layout] pairs), ``chaos`` (archs), ``chaos_seed`` and ``cli`` (name ->
flags).  It writes:

  * ``skips`` -- name -> ``run_cell``'s record of each skipped cell;
  * ``specs`` -- ``"single"``/``"multi"`` -> arch -> kind -> {tree path:
    [shard shape, dtype, partition spec]}: the shard shapes of
    ``launch.specs``' ``train_batch_abstract`` (train_4k),
    ``weights_abstract`` (without and with K=2 clients),
    ``prefill_batch_abstract`` (prefill_32k) and ``decode_args_abstract``
    (decode_32k and long_500k; the cache's stacks and the tokens);
  * ``states`` -- grid -> ``"<arch>/<layout>"`` -> slot -> [[shard shape,
    dtype], ...] of ``train_state_abstract`` (DC on the fused transport),
    or ``{"error": ...}`` where the JAX step refuses the layout.  On the
    grid of ``mesh.make_topology`` its ``init_fn`` raises: ``jax.make_mesh``
    makes Explicit axes, which its sharding constraints may not name.  So
    the states are taken on ``mesh.make_host_topology``'s grid of the same
    shape and axis names (``jax.sharding.Mesh``'s Auto axes), as the JAX
    package's own mesh tests lay theirs;
  * ``chaos`` -- grid -> arch -> ``chaos_report`` for the seed over 4
    T_E (T_E = 3);
  * ``cli`` -- name -> the ``error:`` line ``main`` prints for a bad
    flag.
"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"

import contextlib  # noqa: E402
import io  # noqa: E402
import json  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[2] / "src"))

import jax  # noqa: E402

from repro import configs  # noqa: E402
from repro.core import clients as vclients  # noqa: E402
from repro.core import hier  # noqa: E402
from repro.launch import dryrun  # noqa: E402
from repro.launch import mesh as mesh_mod  # noqa: E402
from repro.launch import specs as S  # noqa: E402
from repro.models import build  # noqa: E402
from repro.models.config import SHAPES  # noqa: E402

def spec(sds) -> list:
    return [list(e) if isinstance(e, tuple) else e
            for e in sds.sharding.spec]


def shard(sds) -> list:
    return [list(sds.sharding.shard_shape(sds.shape)), str(sds.dtype)]


def paths(tree) -> dict:
    leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {jax.tree_util.keystr(k): shard(v) + [spec(v)]
            for k, v in leaves}


def specs_of(topo, name: str) -> dict:
    cfg = configs.get_config(name)
    built = build.build_model(cfg, topo)
    out = {"train": paths(S.train_batch_abstract(cfg, SHAPES["train_4k"],
                                                 topo)),
           "weights": paths(list(S.weights_abstract(topo))),
           "weights_k2": paths(list(S.weights_abstract(
               topo, vclients.ClientConfig(count=2)))),
           "prefill": paths(S.prefill_batch_abstract(
               cfg, SHAPES["prefill_32k"], topo))}
    for shape in ("decode_32k", "long_500k"):
        cache, tokens = S.decode_args_abstract(built, SHAPES[shape], topo)
        out[shape] = paths({"stacks": cache["stacks"], "tokens": tokens})
    return out


def state_of(topo, name: str, layout: str) -> dict:
    cfg = configs.get_config(name)
    built = build.build_model(cfg, topo)
    algo = hier.AlgoConfig(transport="fused", state_layout=layout)
    try:
        state = S.train_state_abstract(built, topo, algo)
    except ValueError as e:
        return {"error": str(e)}
    return {f: [shard(x) for x in jax.tree.leaves(getattr(state, f))]
            for f in state._fields if f not in ("step", "rng")}


def cli_error(flags: list) -> str:
    err = io.StringIO()
    argv = sys.argv
    sys.argv = ["dryrun"] + flags
    try:
        with contextlib.redirect_stderr(err):
            dryrun.main()
    except SystemExit:
        pass
    finally:
        sys.argv = argv
    return [line for line in err.getvalue().splitlines()
            if "error:" in line][-1].split("error: ", 1)[1]


def main(src: str, dst: str) -> None:
    cases = json.loads(pathlib.Path(src).read_text())
    out = {"skips": {}, "specs": {}, "states": {}, "chaos": {}, "cli": {}}
    for name, (arch, shape, method, k, overlap) in cases["skips"].items():
        with contextlib.redirect_stdout(io.StringIO()):
            out["skips"][name] = dryrun.run_cell(
                arch, shape, False, method, "ag_packed", 15, verbose=False,
                clients=vclients.ClientConfig(count=k),
                cloud_overlap=overlap)
    for multi in (False, True):
        grid = "multi" if multi else "single"
        topo = mesh_mod.make_topology(multi_pod=multi)
        out["specs"][grid] = {name: specs_of(topo, name)
                              for name in configs.ARCH_NAMES}
        auto = mesh_mod.make_host_topology(2 if multi else 1, 16, 16)
        out["states"][grid] = {f"{n}/{lay}": state_of(auto, n, lay)
                               for n, lay in cases["states"]}
        out["states"][grid]["make_topology"] = state_of(
            topo, *cases["states"][0])
        out["chaos"][grid] = {}
        for name in cases["chaos"]:
            algo = hier.AlgoConfig(t_e=3)
            out["chaos"][grid][name] = dryrun.chaos_report(
                topo, algo, configs.get_config(name), cases["chaos_seed"],
                4 * 3)
    for name, flags in cases["cli"].items():
        out["cli"][name] = cli_error(flags)
    pathlib.Path(dst).write_text(json.dumps(out))


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
