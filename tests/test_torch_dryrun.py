"""The port's dry run (item 16) against the JAX package's.

One JAX subprocess on 512 forced host devices
(``tests/helpers/torch_dryrun_jax_check.py``: this process never imports
``repro.launch.dryrun``, whose first line sets ``XLA_FLAGS``) beside one
spawn of 8 gloo CPU ranks (``tests/helpers/torch_dryrun_worker.py``):

  * the cells: ``configs.all_cells`` and every ``shape_applicable``
    reason equal JAX's (in process);
  * the skips: ``dryrun.run_cell``'s record of each kind of skipped cell
    equals JAX's, dict for dict;
  * the specs: each abstract function's rank-0 blocks, dtypes and specs
    (``launch.specs``) equal JAX's shard shapes and partition specs on
    both production grids -- the batch, weights, prefill and decode
    specs of all ten configs; ``train_state_abstract`` in the flat and
    tree layouts for gemma3-1b, deepseek-v3 (FSDP: the flat layout
    refused by both) and zamba2-2.7b.  The port's tokens are int64 where
    JAX's are int32 (its stream's and embedding's dtype), by design;
  * the chaos report equals JAX's for one seed on both grids;
  * traffic: a dry run's ``comm`` bytes (every group and op, sent and
    received) and its tally of each kernel wrapper's calls, for a sync
    step and a local step, equal a real 8-rank gloo run's of the same
    steps (gemma3-1b's smoke config on 2 x 2 x 2: DC fused/flat, its
    FSDP regime, K=2 streamed clients and hier_local_qsgd -- all four
    wrappers; each case dry-run at another rank of the grid);
  * a production cell, gemma3-1b decode_32k on the 16x16 grid, through
    ``main --device cpu`` in a subprocess: its record, in under 4 GB of
    peak RSS;
  * the CLI's validation errors are JAX's messages, and the dry run
    refuses a process group it did not make.
"""
import functools
import json
import os
import pathlib
import subprocess
import sys
import tempfile
import time

import pytest
import torch

from repro import configs as jconfigs
from repro.models import config as jconfig
from repro_torch import configs
from repro_torch.core import clients as vclients
from repro_torch.core import hier, pytree
from repro_torch.kernels import build as kbuild
from repro_torch.launch import dryrun, mesh
from repro_torch.launch import specs as S
from repro_torch.models import build
from repro_torch.models.config import SHAPES, ShapeCfg

HELPERS = pathlib.Path(__file__).resolve().parent / "helpers"
ROOT = HELPERS.parents[1]
sys.path.insert(0, str(HELPERS))

import torch_dryrun_worker as W  # noqa: E402

GRIDS = ("single", "multi")
SKIPS = {   # name -> (arch, shape, method, clients K, cloud_overlap)
    "shape rule": ("arctic_480b", "long_500k", "dc_hier_signsgd", 1, "sync"),
    "scaffold under FSDP": ("deepseek_v3_671b", "train_4k",
                            "scaffold_hier_signsgd", 1, "sync"),
    "mtgc under FSDP": ("gemma3_12b", "train_4k", "mtgc_hier_signsgd", 1,
                        "sync"),
    "clients under FSDP": ("arctic_480b", "train_4k", "dc_hier_signsgd", 2,
                           "sync"),
    "overlap under FSDP": ("internvl2_76b", "train_4k", "dc_hier_signsgd", 1,
                           "overlap"),
}
STATES = (("gemma3_1b", "flat"), ("gemma3_1b", "tree"),
          ("deepseek_v3_671b", "flat"), ("deepseek_v3_671b", "tree"),
          ("zamba2_2p7b", "flat"), ("zamba2_2p7b", "tree"))
CHAOS = ("gemma3_1b", "deepseek_v3_671b")
CHAOS_SEED = 7
CLI = {   # name -> the flags
    "cloud_overlap": ["--cloud_overlap", "lagged"],
    "edge_assign": ["--edge_assign", "clustered"],
    "carve": ["--clients_per_device", "3", "--shape", "train_4k"],
    "carve multi": ["--clients_per_device", "16", "--shape", "train_4k",
                    "--mesh", "multi"],
}
STREAM = vclients.ClientConfig(count=2, mode="stream")
CASES = {   # name -> (smoke fields, AlgoConfig fields, the rank dry-run)
    "replicated": ({}, dict(transport="fused", state_layout="flat", t_e=3),
                   0),
    "fsdp": ({"param_mode": "fsdp"},
             dict(transport="fused", state_layout="tree", t_e=3), 7),
    "stream": ({}, dict(transport="fused", state_layout="flat", t_e=3,
                        clients=STREAM), 5),
    "qsgd": ({}, dict(method="hier_local_qsgd", transport="fused",
                      state_layout="flat", t_e=3), 2),
}
JOB = {"arch": "gemma3_1b", "batch": 2, "seq": 8, "seed": 0,
       "cases": {k: v[:2] for k, v in CASES.items()}}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def runs() -> dict:
    """The JAX subprocess and the 8 ranks, run side by side."""
    with tempfile.TemporaryDirectory() as tmp:
        out = pathlib.Path(tmp) / "jax.json"
        cases = pathlib.Path(tmp) / "cases.json"
        cases.write_text(json.dumps({"skips": SKIPS, "states": STATES,
                                     "chaos": CHAOS,
                                     "chaos_seed": CHAOS_SEED, "cli": CLI}))
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            [str(ROOT / "src"), os.environ.get("PYTHONPATH", "")]),
            JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1")
        log = open(pathlib.Path(tmp) / "jax.log", "w+")
        proc = subprocess.Popen(
            [sys.executable, str(HELPERS / "torch_dryrun_jax_check.py"),
             str(cases), str(out)], env=env, stdout=log,
            stderr=subprocess.STDOUT)
        try:
            ranks = W.run(JOB)
            proc.wait(timeout=120)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            log.seek(0)
            text = log.read()
            log.close()
        assert proc.returncode == 0, text[-3000:]
        return {"jax": json.loads(out.read_text()), "ranks": ranks}


def jax_out() -> dict:
    return runs()["jax"]


# -- the cells ----------------------------------------------------------------

def test_all_cells_equal_jax():
    got = list(configs.all_cells())
    assert got == list(jconfigs.all_cells())
    assert len(got) == 40
    skips = [c for c in got if not c[2]]
    assert len(skips) == 6 and {c[1] for c in skips} == {"long_500k"}


@pytest.mark.parametrize("name", configs.ARCH_NAMES)
def test_shape_rules_and_reasons_equal_jax(name):
    import dataclasses
    for decoder in (True, False):     # and an encoder-only variant
        cfg = dataclasses.replace(configs.get_config(name),
                                  has_decoder=decoder)
        jcfg = dataclasses.replace(jconfigs.get_config(name),
                                   has_decoder=decoder)
        for s in SHAPES:
            assert (configs.shape_applicable(cfg, SHAPES[s])
                    == jconfigs.shape_applicable(jcfg, jconfig.SHAPES[s]))


@pytest.mark.parametrize("kind", list(SKIPS))
def test_skip_records_equal_jax(kind, capsys):
    arch, shape, method, k, overlap = SKIPS[kind]
    got = dryrun.run_cell(arch, shape, False, method, "ag_packed", 15,
                          verbose=False, clients=vclients.ClientConfig(
                              count=k), cloud_overlap=overlap)
    assert got == jax_out()["skips"][kind]
    assert f"SKIP {arch} x {shape}" in capsys.readouterr().out


# -- the specs ----------------------------------------------------------------

def keystr(path) -> str:
    return "".join(f"[{k!r}]" if isinstance(k, str) else f"[{k}]"
                   for k in path)


def leaves(tree, specs, path=()) -> dict:
    """{JAX keystr: [block shape, dtype, spec]} of a port tree and its
    spec tree (dicts in sorted key order, lists and tuples by index)."""
    if isinstance(tree, torch.Tensor):
        return {keystr(path): [list(tree.shape),
                               str(tree.dtype).replace("torch.", ""),
                               [list(e) if isinstance(e, tuple) else e
                                for e in specs]]}
    items = (sorted(tree.items()) if isinstance(tree, dict)
             else enumerate(tree))
    out = {}
    for k, v in items:
        out.update(leaves(v, specs[k], path + (k,)))
    return out


def port_specs(topo, name: str) -> dict:
    cfg = configs.get_config(name)
    built = build.build_model(cfg, topo)
    ws, wspecs = S.weights_abstract(topo)
    ws2, wspecs2 = S.weights_abstract(topo, vclients.ClientConfig(count=2))
    out = {"train": leaves(*S.train_batch_abstract(cfg, SHAPES["train_4k"],
                                                   topo)),
           "weights": leaves(list(ws), list(wspecs)),
           "weights_k2": leaves(list(ws2), list(wspecs2)),
           "prefill": leaves(*S.prefill_batch_abstract(
               cfg, SHAPES["prefill_32k"], topo))}
    for shape in ("decode_32k", "long_500k"):
        (cache, tokens), (cspecs, tspec) = S.decode_args_abstract(
            built, SHAPES[shape], topo)
        out[shape] = leaves({"stacks": cache["stacks"], "tokens": tokens},
                            {"stacks": cspecs["stacks"], "tokens": tspec})
    return out


def tokens_int64(got: dict, want: dict) -> dict:
    """``want`` with its int32 token leaves as the port's int64 (the one
    dtype the port changes, by design)."""
    for k, v in want.items():
        if k.endswith("['tokens']"):
            assert v[1] == "int32" and got[k][1] == "int64", (k, got[k])
            want = {**want, k: [v[0], "int64", v[2]]}
    return want


@pytest.mark.parametrize("name", configs.ARCH_NAMES)
@pytest.mark.parametrize("grid", GRIDS)
def test_abstract_blocks_equal_jax_shards(grid, name):
    with mesh.dry_topology(multi_pod=grid == "multi", device="cpu") as topo:
        got = port_specs(topo, name)
    want = jax_out()["specs"][grid][name]
    assert set(got) == set(want)
    for kind in want:
        assert got[kind] == tokens_int64(got[kind], want[kind]), kind


def port_state(topo, name: str, layout: str) -> dict:
    built = build.build_model(configs.get_config(name), topo)
    algo = hier.AlgoConfig(transport="fused", state_layout=layout)
    try:
        state, index = S.train_state_abstract(built, topo, algo)
    except ValueError as e:
        return {"error": str(e)}
    out = {}
    for f in state._fields:
        if f in ("step", "rng"):
            continue
        slot = getattr(state, f)
        xs = ([] if slot is None else [slot.buf] if hasattr(slot, "buf")
              else pytree.tree_flatten(slot)[0])
        out[f] = [[list(x.shape), str(x.dtype).replace("torch.", "")]
                  for x in xs]
        assert all(dryrun.kbuild.is_fake(x) for x in xs)
    assert index.step is None and index.rng is None
    return out


@pytest.mark.parametrize("case", [f"{n}/{lay}" for n, lay in STATES])
@pytest.mark.parametrize("grid", GRIDS)
def test_train_state_blocks_equal_jax_shards(grid, case):
    name, layout = case.split("/")
    with mesh.dry_topology(multi_pod=grid == "multi", device="cpu") as topo:
        got = port_state(topo, name, layout)
    want = jax_out()["states"][grid][case]
    if "error" in want:     # the FSDP regime refuses the flat layout
        prefix = "state_layout='flat' requires the replicated regime"
        assert want["error"].startswith(prefix)
        assert got["error"].startswith(prefix)
        return
    assert got == want


@pytest.mark.parametrize("grid", GRIDS)
def test_jax_dry_run_cannot_trace_a_train_state_on_its_production_mesh(grid):
    """A fault of the reference (ROADMAP queue 3): ``jax.make_mesh``
    makes Explicit axes, which the JAX step's sharding constraints may
    not name, so its dry run's train cells fail on the installed JAX;
    the states above are JAX's on a mesh of Auto axes."""
    assert "Auto axes" in jax_out()["states"][grid]["make_topology"]["error"]


@pytest.mark.parametrize("name", CHAOS)
@pytest.mark.parametrize("grid", GRIDS)
def test_chaos_report_equals_jax(grid, name):
    with mesh.dry_topology(multi_pod=grid == "multi", device="cpu") as topo:
        got = dryrun.chaos_report(topo, hier.AlgoConfig(t_e=3),
                                  configs.get_config(name), CHAOS_SEED,
                                  4 * 3)
    assert got == jax_out()["chaos"][grid][name]


# -- traffic and kernel calls against a gloo run ------------------------------

@pytest.mark.parametrize("case", list(CASES))
def test_dry_traffic_and_calls_equal_a_gloo_run(case):
    fields, algo_kw, rank = CASES[case]
    real = runs()["ranks"][rank][case]
    shape = ShapeCfg("smoke", "train", JOB["seq"], JOB["batch"] * 2 * 2)
    launches = {k: getattr(sys.modules[f"repro_torch.kernels.{k}"],
                           k).launches for k in kbuild.KERNELS}
    with mesh.dry_grid(*W.GRID, rank=rank, device="cpu") as topo:
        built = build.build_model(W.case_cfg(JOB["arch"], fields), topo)
        algo = hier.AlgoConfig(**algo_kw)
        for label, sync in (("sync_step", "always"), ("local_step", "never")):
            rec = dryrun.analyze(dryrun.lower_train(built, topo, algo, shape,
                                                    sync), label,
                                 verbose=False)
            assert rec["comm"]["groups"] == real[label]["groups"], label
            assert rec["comm"]["ops"] == real[label]["ops"], label
            assert rec["launches"] == real[label]["calls"], label
            assert rec["memory"]["peak_bytes"] >= (
                rec["memory"]["argument_bytes"])
    assert sum(real["sync_step"]["calls"].values()) > 0
    # the fake path counted, and launched nothing
    assert launches == {k: getattr(sys.modules[f"repro_torch.kernels.{k}"],
                                   k).launches for k in kbuild.KERNELS}


@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_a_fake_tensor_gets_its_shape_and_no_launch(device):
    """Each wrapper's fake path on fake CPU and fake CUDA tensors (made
    here with no card): the output's shape, dtype and device, the
    in-place forms' own tensor back, a count in ``build.fake_calls``, no
    launch (on CUDA the kernel library is never loaded: there is no nvcc
    here) and no plain version."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.kernels import ref
    mods = {k: sys.modules[f"repro_torch.kernels.{k}"]
            for k in kbuild.KERNELS}
    launches = {k: getattr(m, k).launches for k, m in mods.items()}
    kbuild.reset_fake_calls()
    plain = [name for name in dir(ref) if name.endswith("_ref")]
    saved = {name: getattr(ref, name) for name in plain}
    try:
        for name in plain:       # a plain version called would raise
            setattr(ref, name, None)
        with FakeTensorMode():
            u = torch.empty((2, 3, 4096), dtype=torch.bfloat16,
                            device=device)
            dl = torch.empty((2, 4096), dtype=torch.bfloat16, device=device)
            words = mods["sign_pack"].sign_pack(u, dl, 0.2)
            v = torch.empty((2, 4096), device=device)
            w = torch.ones((2, 3), dtype=torch.int32, device=device)
            vote = mods["vote_update"].vote_update(words, None, 1e-3, w)
            updated = mods["vote_update"].vote_update(words, v, 1e-3)
            tally = torch.zeros((2, 3, 4096), dtype=torch.int16,
                                device=device)
            tallied = mods["tally_acc"].tally_acc(u, dl, 0.2, w, tally)
            q = mods["ternary_quant"].ternary_quant(
                u, torch.empty((2, 3, 4096), device=device),
                torch.ones(6, device=device))
    finally:
        for name, fn in saved.items():
            setattr(ref, name, fn)
    assert (words.shape, words.dtype) == ((2, 3, 128), torch.int32)
    assert (vote.shape, vote.dtype) == ((2, 4096), torch.int8)
    assert updated is v and tallied is tally
    assert (q.shape, q.dtype) == ((2, 3, 4096), torch.bfloat16)
    assert {x.device.type for x in (words, vote, q)} == {device}
    assert kbuild.fake_calls == {"sign_pack": 1, "vote_update": 2,
                                 "tally_acc": 1, "ternary_quant": 1}
    # the bytes each kernel would move: every input read once, every
    # output written once (the byte counts of chip_smoke.py's bounds)
    u_b, dl_b, words_b = 2 * 3 * 4096 * 2, 2 * 4096 * 2, 2 * 3 * 128 * 4
    w_b, v_b, tally_b = 2 * 3 * 4, 2 * 4096 * 4, 2 * 3 * 4096 * 2
    assert kbuild.fake_bytes == {
        "sign_pack": u_b + dl_b + words_b,
        "vote_update": (words_b + w_b + 2 * 4096) + (words_b + 2 * v_b),
        "tally_acc": u_b + dl_b + w_b + 2 * tally_b,
        "ternary_quant": u_b + 2 * 3 * 4096 * 4 + 6 * 4 + u_b}
    assert launches == {k: getattr(m, k).launches for k, m in mods.items()}


def test_bytes_accessed_counts_what_is_read_and_written():
    """``cost.bytes_accessed``: an op's tensor input and output, nothing
    for an allocation that writes nothing, and a kernel's reads and
    writes on its fake path (its output's allocation not counted)."""
    pack = sys.modules["repro_torch.kernels.sign_pack"]
    mode = dryrun.fake_mode()
    with mode:
        u = torch.empty((2, 3, 4096), dtype=torch.bfloat16)

    def fn(u):
        torch.empty_like(u)
        return u + 1, pack.sign_pack(u)
    rec = dryrun.analyze(dryrun.Lowered(fn, (u,), mode), "t",
                         verbose=False)
    n = u.numel() * u.element_size()
    assert rec["cost"]["bytes_accessed"] == 2 * n + (n + u.numel() // 8)
    assert rec["launches"]["sign_pack"] == 1


def test_every_wrapper_is_reached():
    ranks = runs()["ranks"]
    reached = {k for r in ranks for case in r.values()
               for step in case.values() for k, n in step["calls"].items()
               if n}
    assert reached == set(kbuild.KERNELS)


# -- a production cell, the CLI, the group ------------------------------------

def test_a_production_cell_through_the_cli_in_under_4_gb():
    with tempfile.TemporaryDirectory() as tmp:
        code = ("import resource, sys\n"
                "from repro_torch.launch import dryrun\n"
                "try:\n"
                "    dryrun.main(sys.argv[1:])\n"
                "finally:\n"
                "    print('maxrss_kb', resource.getrusage("
                "resource.RUSAGE_SELF).ru_maxrss)\n")
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                   OMP_NUM_THREADS="1")
        t0 = time.perf_counter()
        res = subprocess.run(
            [sys.executable, "-c", code, "--device", "cpu", "--arch",
             "gemma3_1b", "--shape", "decode_32k", "--mesh", "single",
             "--out", tmp, "--quiet"], env=env, capture_output=True,
            text=True, timeout=300)
        assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-2000:]
        rss_kb = int(res.stdout.split("maxrss_kb")[-1])
        assert rss_kb < 4e6, rss_kb
        rec = json.loads((pathlib.Path(tmp) / (
            "baseline.gemma3_1b.decode_32k.single.json")).read_text())
        rows = [line for line in dryrun.table(tmp).splitlines()
                if line.startswith("| gemma3_1b")]
    assert time.perf_counter() - t0 < 300
    assert rec["mesh"] == "16x16" and not rec["skipped"]
    assert rec["rank"] == 0 and rec["device"] == "cpu"
    assert rec["params"] == build.param_count(build.init_params(
        build.make_archdef(configs.get_config("gemma3_1b")), None, "meta"))
    ph = rec["phases"]["decode"]
    mem = ph["memory"]
    assert mem["peak_bytes"] == mem["argument_bytes"] + mem["temp_bytes"]
    assert mem["argument_bytes"] > 0 and mem["output_bytes"] > 0
    assert mem["generated_code_bytes"] is None
    assert ph["cost"]["flops"] > 0 and ph["cost"]["bytes_accessed"] > 0
    assert ph["comm"]["groups"]["model"]["sent"] > 0
    assert ph["launches"] == dict.fromkeys(kbuild.KERNELS, 0)
    peak = f"{mem['peak_bytes'] / 1e9:.2f} / -"
    assert rows == [f"| gemma3_1b | decode_32k | decode | {peak} | yes / - "
                    f"| {mem['argument_bytes'] / 1e9:.2f} / - | 0.0 / - | "
                    "0.00:0.00 / - | 0.00:0.00 / - | 0.00:0.01 / - | 0 / - "
                    f"| {ph['trace_s']:.1f} / - |"]


@pytest.mark.parametrize("name", list(CLI))
def test_cli_errors_are_jax_s(name, capsys):
    with pytest.raises(SystemExit) as exc:
        dryrun.main(CLI[name])
    assert exc.value.code == 2
    err = [line for line in capsys.readouterr().err.splitlines()
           if "error:" in line][-1].split("error: ", 1)[1]
    assert err == jax_out()["cli"][name]


def test_the_dry_run_refuses_a_group_it_did_not_make():
    import torch.distributed as dist
    with mesh.dry_grid(1, 2, rank=1, device="cpu") as topo:
        assert dist.get_backend() == mesh.FAKE_BACKEND
        assert topo.mesh.data_rank == 1
        with pytest.raises(RuntimeError, match="already initialised"):
            with mesh.dry_grid(1, 2, device="cpu"):
                pass
    assert not dist.is_initialized()
    with pytest.raises(ValueError, match="unknown backend 'fake'"):
        mesh.make_host_topology(1, 1, backend="fake", device="cpu")
    with pytest.raises(SystemExit):
        dryrun.main(["--device", "cpu", "--rank", "256"])
