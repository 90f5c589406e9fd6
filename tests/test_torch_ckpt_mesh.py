"""Checkpoints and restore under a process mesh (ROADMAP item 17e).

One spawn of 8 gloo CPU ranks (``tests/helpers/torch_ckpt_mesh_worker.py``)
beside one JAX subprocess on 8 forced host devices
(``tests/helpers/torch_ckpt_jax_check.py``), sharing a directory:

  * the file: the ranks' checkpoint of the parity toy (hidden 65, DC with
    error feedback) and of gemma3-1b's smoke config (DC), flat and tree,
    at M = 2 (2 x 2 x 2) and M = 1 (2 x 4 x 1), is the JAX store's file
    of the same global state -- ``leaves`` and ``flat_state`` equal,
    every array bitwise -- and restores into JAX's sharded state;
  * JAX's checkpoints from its 2 x 2 x 2 mesh restore onto the ranks,
    each rank's blocks bitwise;
  * on the ranks, ``run_training`` (DC fused/flat; FSDP ag_packed/tree)
    with a nan restored and replayed, and stopped and run again on its
    directory, ends bitwise the uninterrupted run;
  * another shape: the ranks' checkpoint restores in one process
    (bitwise ``gather_train_state(logical=True)``), a one-process
    checkpoint onto the 2 x 2 x 2 ranks and the 2 x 2 x 2 one onto 2 x 1
    x 4 ranks (data 2 -> 1, M = 2 -> 4), each rank's logical blocks
    bitwise;
  * failures: a planted failure of rank 0's write raises on every rank
    at its next ``submit`` within a few seconds; differing generator
    seeds raise at ``submit``; the bytes each rank sends the writer are
    its blocks' to the byte, and at most its state;
  * the CLI: ``lm_main`` on 4 ranks with ``--ckpt DIR --chaos SEED``
    prints the one-process run's lines.
"""
import contextlib
import functools
import io
import json
import os
import pathlib
import pickle
import socket
import subprocess
import sys
import time

import jax
import numpy as np
import pytest
import torch

HELPERS = pathlib.Path(__file__).parent / "helpers"
sys.path.insert(0, str(HELPERS))
import torch_ckpt_mesh_worker as W  # noqa: E402

from repro_torch.checkpoint import store  # noqa: E402
from repro_torch.convert import gather_train_state  # noqa: E402
from repro_torch.core import hier  # noqa: E402
from repro_torch.core.topology import Topology  # noqa: E402
from repro_torch.launch import train  # noqa: E402

CASES = {f"{kind}_{layout}_m{m}": (kind, layout, grid)
         for kind in ("toy", "gemma") for layout in ("flat", "tree")
         for m, grid in ((2, "2x2x2"), (1, "2x4x1"))}
RESUME = {"dc fused/flat": {"fsdp": False, "layout": "flat", "nan": 2,
                            "stop": 2},
          "fsdp ag_packed/tree": {"fsdp": True, "layout": "tree", "nan": 2}}
JAX_CKPTS = ("toy_flat", "toy_tree")


def cli_args(ckpt: pathlib.Path) -> list:
    return ["--device", "cpu", "--arch", "gemma3_1b", "--smoke", "--steps",
            "12", "--t_e", "3", "--ckpt", str(ckpt), "--chaos", "3",
            "--pods", "2", "--devices_per_pod", "2"]


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def one_process_state(d: pathlib.Path):
    """gemma3-1b smoke, flat, P=2 x D=2 in this process, its first step,
    saved to ``d/one``; its logical global state pickled beside."""
    topo = Topology(2, 2, "cpu")
    run = train.RunCfg(steps=1, batch_per_device=W.LM["batch"],
                       seq_len=W.LM["seq"], log_every=0,
                       ckpt_dir=str(d / "one"))
    state, _ = train.run_training(W.smoke(), topo, W.lm_algo("flat"), run,
                                  log=lambda line: None)
    logical = gather_train_state(state, topo, logical=True)._asdict()
    del logical["rng"]
    with open(d / "one.pkl", "wb") as f:
        pickle.dump({"logical": logical}, f)


@functools.lru_cache(maxsize=None)
def runs(root: str) -> dict:
    d = pathlib.Path(root)
    one_process_state(d)
    with open(d / "cases.pkl", "wb") as f:
        pickle.dump(CASES, f)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(HELPERS.parents[1] / "src"), os.environ.get("PYTHONPATH", "")]),
        JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1")
    log = open(d / "jax.log", "w+")
    jax_proc = subprocess.Popen(
        [sys.executable, str(HELPERS / "torch_ckpt_jax_check.py"), str(d)],
        env=env, stdout=log, stderr=subprocess.STDOUT)
    port = d / "port"
    job = {"dir": str(d), "files": CASES, "resume": RESUME,
           "reshape": {
               "one process -> 2x2x2": (str(d / "one"), str(d / "one.pkl"),
                                        "2x2x2", "flat"),
               "2x2x2 -> 2x1x4": (str(port / "gemma_flat_m2"),
                                  str(port / "gemma_flat_m2.pkl"), "2x1x4",
                                  "flat")},
           "failures": True, "jax": list(JAX_CKPTS),
           "cli": cli_args(d / "cli_mesh"), "port": free_port()}
    t0 = time.perf_counter()
    try:
        res = W.run(job)
        jax_proc.wait(timeout=120)
    finally:
        if jax_proc.poll() is None:
            jax_proc.kill()
            jax_proc.wait()
        log.seek(0)
        jax_log = log.read()
        log.close()
    assert jax_proc.returncode == 0, jax_log[-3000:]
    res["spawn_s"] = time.perf_counter() - t0
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        train.main(cli_args(d / "cli_one"))
    res["cli_one"] = buf.getvalue().splitlines()
    return res


@pytest.fixture(scope="module")
def root(tmp_path_factory) -> pathlib.Path:
    return tmp_path_factory.mktemp("ckpt_mesh")


@pytest.fixture(scope="module")
def res(root) -> dict:
    return runs(str(root))


def step_dir(base: pathlib.Path) -> pathlib.Path:
    (path,) = [p for p in base.iterdir() if p.name.startswith("step_")]
    return path


def as_bytes(a) -> np.ndarray:
    return np.ascontiguousarray(a).reshape(-1).view(np.uint8)


def assert_bitwise(got, want, tag: str):
    gl, wl = jax.tree.leaves(got), jax.tree.leaves(want)
    assert len(gl) == len(wl), tag
    for a, b in zip(gl, wl):
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape and a.dtype == b.dtype, tag
        np.testing.assert_array_equal(as_bytes(a), as_bytes(b), err_msg=tag)


# -- the file is JAX's -------------------------------------------------------------

@pytest.mark.parametrize("case", list(CASES))
def test_mesh_checkpoint_is_the_jax_stores_file(res, root, case):
    port = step_dir(root / "port" / case)
    jax_ = step_dir(root / "jaxsave" / case)
    assert port.name == jax_.name
    mp, mj = (json.loads((p / "manifest.json").read_text())
              for p in (port, jax_))
    assert mp["leaves"] == mj["leaves"]
    assert mp.get("flat_state") == mj.get("flat_state")
    if CASES[case][1] == "flat" and CASES[case][2] == "2x2x2":
        assert mp["flat_state"][".params"]["shards"] == 2
    zp, zj = np.load(port / "arrays.npz"), np.load(jax_ / "arrays.npz")
    assert sorted(zp.files) == sorted(zj.files)
    for k in zp.files:
        assert zp[k].dtype == zj[k].dtype, k
        np.testing.assert_array_equal(as_bytes(zp[k]), as_bytes(zj[k]),
                                      err_msg=k)


@pytest.mark.parametrize("case", list(CASES))
def test_jax_restores_the_mesh_checkpoint(res, root, case):
    """JAX's ``store.restore`` of the ranks' checkpoint into its state on
    the same mesh (sharded at M = 2): every slot the ranks' global state
    (a bfloat16 slot widened), the generator the ranks' seed's key."""
    with open(root / "jaxsave" / f"{case}.pkl", "rb") as f:
        got = pickle.load(f)
    want = res["files"][case]["state"]
    for name, w in want.items():
        g = got["restored"][name]
        if name == "step":
            assert int(g) == w
            continue
        assert (g is None) == (w is None), name
        widened = jax.tree.map(
            lambda a: np.asarray(a, np.float32)
            if a.dtype.name == "bfloat16" else a, g)
        assert_bitwise(widened, w, f"{case}/{name}")
    assert got["rng"].tolist() == [0, res["files"][case]["seed"]]


@pytest.mark.parametrize("name", JAX_CKPTS)
def test_jax_checkpoint_restores_onto_the_ranks(res, name):
    got = res["jax"][name]
    assert got["step"] == 2
    assert got["differ"] == [[0]] * 8


# -- restore and resume on ranks ---------------------------------------------------

@pytest.mark.parametrize("case", list(RESUME))
def test_kill_restore_replay_on_ranks(res, case):
    runs_ = res["resume"][case]
    want, got = runs_["uninterrupted"], runs_["replayed"]
    assert [e["event"] for e in got["events"]] == ["restore", "save", "save"]
    assert got["events"][0]["step"] == 2
    assert got["losses"] == want["losses"]
    assert_bitwise(got["state"], want["state"], case)


@pytest.mark.parametrize("case", [c for c in RESUME if "stop" in RESUME[c]])
def test_stopped_run_resumes_on_ranks(res, case):
    runs_ = res["resume"][case]
    want, first, again = (runs_[k] for k in ("uninterrupted", "stopped",
                                              "resumed"))
    assert [e["event"] for e in again["events"]] == ["resume", "save"]
    assert first["losses"] + again["losses"] == want["losses"]
    assert_bitwise(again["state"], want["state"], case)


# -- another shape -----------------------------------------------------------------

@pytest.mark.parametrize("layout", ["flat", "tree"])
def test_one_process_restores_the_ranks_checkpoint(res, root, layout):
    """The 2 x 2 x 2 checkpoint (M = 2) into one process at P=2 x D=2
    (M = 1): bitwise the ranks' ``gather_train_state(logical=True)``."""
    from repro_torch.models import build

    topo = Topology(2, 2, "cpu")
    cfg = W.smoke()
    built = build.build_model(cfg, topo)
    init_fn, _ = hier.make_hier_step(topo, W.lm_algo(layout), built.bundle)
    like = init_fn(built.init_params(torch.Generator().manual_seed(0)), 5)
    step, state = store.restore_latest(root / "port" / f"gemma_{layout}_m2",
                                       like)
    got = gather_train_state(state, topo, logical=True)._asdict()
    assert state.rng.initial_seed() == res["files"][
        f"gemma_{layout}_m2"]["seed"]
    del got["rng"]
    assert_bitwise(got, res["files"][f"gemma_{layout}_m2"]["logical"],
                   layout)


@pytest.mark.parametrize("case", ["one process -> 2x2x2", "2x2x2 -> 2x1x4"])
def test_ranks_restore_another_shape(res, case):
    got = res["reshape"][case]
    assert got["step"] == 1
    assert got["differ"] == [[0]] * 8


# -- failures and bytes ------------------------------------------------------------

def test_failed_write_raises_on_every_rank(res):
    for r, row in enumerate(res["failures"]):
        msg, secs = row["write"]
        assert "background checkpoint save failed" in msg, (r, msg)
        assert secs < 5.0, (r, secs)
    assert "on the writer" in res["failures"][1]["write"][0]


def test_differing_seeds_raise_at_submit(res):
    for r, row in enumerate(res["failures"]):
        msg, secs = row["seeds"]
        assert "generator seeds differ" in msg, (r, msg)
        assert secs < 5.0, (r, secs)


@pytest.mark.parametrize("case", [c for c in CASES if "flat" in c])
def test_save_sends_each_block_once(res, root, case):
    """Each rank sends the writer its blocks, to the byte of the
    reckoning from the file's shapes: of a per-edge slot data rank 0's
    rows of its bucket, of a per-voter slot its voters' rows of its
    bucket; rank 0 sends nothing and receives the rest; no rank sends
    more than its state holds."""
    grid, _, _ = W.GRIDS[CASES[case][2]]
    pods, data, model = grid
    manifest = json.loads((step_dir(root / "port" / case)
                           / "manifest.json").read_text())
    reckoned = []
    for rank in range(8):
        rest, _ = divmod(rank, model)
        _, data_rank = divmod(rest, data)
        sent = 0
        for key, meta in manifest["flat_state"].items():
            nbytes = (int(np.prod(manifest["leaves"][key]["shape"]))
                      * torch.empty(0, dtype=getattr(
                          torch, meta["dtype"])).element_size())
            if meta["batch_dims"] == 2:
                sent += nbytes // (pods * data * model)
            elif data_rank == 0:
                sent += nbytes // (pods * model)
        reckoned.append(0 if rank == 0 else sent)
    rows = res["files"][case]["bytes"]
    assert [r[0] for r in rows] == reckoned
    assert rows[0][1] == sum(reckoned)
    for sent, _, own, local in rows[1:]:
        assert sent == own <= local


# -- the CLI -----------------------------------------------------------------------

def test_cli_over_ranks_prints_the_one_process_lines(res):
    assert any("chaos seed 3" in line for line in res["cli"])
    assert res["cli"] == res["cli_one"]
    assert res["cli"][-1].startswith("[train] done: loss")


@pytest.mark.parametrize("chunk", [4096, 4096 * 3 + 64])
def test_store_chunks_agree_with_one_pass(tmp_path, monkeypatch, chunk):
    """The store's chunked I/O at a chunk far below the arrays' sizes
    (the card's checkpoints run to hundreds of 16 MiB chunks): each
    member is ``np.save``'s bytes, the manifest's CRC and ``crc32_file``
    are ``zlib.crc32`` of the whole file, and the state restores
    bitwise."""
    import zipfile
    import zlib

    monkeypatch.setattr(store, "CRC_CHUNK", chunk)
    gen = torch.Generator().manual_seed(0)
    tree = {"a": torch.randn(3000, generator=gen),
            "b": torch.randn(40, 50, generator=gen).to(torch.bfloat16),
            "c": torch.arange(7, dtype=torch.int32), "step": 4}
    path = store.save(tmp_path, 4, tree)
    raw = (path / "arrays.npz").read_bytes()
    manifest = json.loads((path / "manifest.json").read_text())
    assert manifest["crc32"] == zlib.crc32(raw) == store.crc32_file(
        path / "arrays.npz")
    arrays = store._flatten(tree)[0]
    with zipfile.ZipFile(path / "arrays.npz") as z:
        for key, arr in arrays.items():
            buf = io.BytesIO()
            np.save(buf, arr)
            assert z.read(key + ".npy") == buf.getvalue(), key
    got = store.restore(tmp_path, 4, tree)
    assert got["step"] == 4
    for key in ("a", "b", "c"):
        assert torch.equal(got[key], tree[key]), key
