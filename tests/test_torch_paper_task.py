"""The paper task on the port: data copies, the MLP, conversion, the
training entry point, and the port's independence from JAX."""
import ast
import dataclasses
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.core import flatbuf as jflat
from repro.data import cluster as jcluster
from repro.data import emnist_like as jemnist
from repro.models import mlp as jmlp
from repro_torch import convert
from repro_torch.core import flatbuf
from repro_torch.core.topology import Topology
from repro_torch.data import cluster, emnist_like
from repro_torch.launch import train
from repro_torch.models import mlp

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for this module's small tensors: the suite runs
    several pytest workers on the machine's cores, and PyTorch's thread
    pool in each of them would contend for the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("kw", [
    {}, {"iid": True}, {"alpha_client": 0.3},
    {"edge_assign": "random"}, {"edge_assign": "clustered"}],
    ids=["fixed", "iid", "alpha_client", "random", "clustered"])
def test_data_matches_reference(kw):
    cfg = dict(n_train=1200, n_test=200, seed=3, **kw)
    want = jemnist.make_federated_data(jemnist.FedDataCfg(**cfg))
    got = emnist_like.make_federated_data(emnist_like.FedDataCfg(**cfg))
    (wd, wt, wew, wdw), (gd, gt, gew, gdw) = want, got
    assert (gew, gdw) == (wew, wdw)
    for k in ("x", "y"):
        np.testing.assert_array_equal(gt[k], wt[k])
    for we, ge in zip(wd, gd):
        for w, g in zip(we, ge):
            for k in ("x", "y"):
                np.testing.assert_array_equal(g[k], w[k])
    rw, rg = np.random.default_rng(1), np.random.default_rng(1)
    for q, k in ((0, 0), (3, 4), (2, 1)):
        bw = jemnist.device_batches(wd, q, k, 32, rw)
        bg = emnist_like.device_batches(gd, q, k, 32, rg)
        np.testing.assert_array_equal(bg["x"], bw["x"])


def test_cluster_helpers_match_reference():
    rng = np.random.default_rng(0)
    sigs = rng.random((12, 5))
    assert (cluster.cluster_edges(sigs, 4)
            == jcluster.cluster_edges(sigs, 4)).all()
    assert (cluster.random_assignment(12, 3, seed=2)
            == jcluster.random_assignment(12, 3, seed=2)).all()
    for n in (0, 7, 100):
        p = rng.dirichlet(np.full(4, 0.1))
        assert (cluster.largest_remainder(p, n)
                == jcluster.largest_remainder(p, n)).all()


def test_mlp_matches_reference():
    params = jax.tree.map(np.asarray, jmlp.init_mlp(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(0)
    batch = {"x": rng.standard_normal((64, 784)).astype(np.float32),
             "y": rng.integers(0, 10, 64).astype(np.int32)}
    tp = convert.params_from_numpy(params)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    np.testing.assert_allclose(
        float(mlp.loss_fn(tp, tb)),
        float(jmlp.loss_fn(jax.tree.map(jnp.asarray, params), batch)),
        rtol=1e-6)
    assert float(mlp.accuracy(tp, tb)) == float(jmlp.accuracy(params, batch))
    assert mlp.param_count(tp) == jmlp.param_count(params) == 50890
    model = mlp.MLP(tp)
    assert torch.equal(model(tb["x"]), mlp.logits_fn(tp, tb["x"]))
    grads = jmlp.grad_fn(params, batch, None)
    tg = convert.params_from_numpy(params)
    for v in tg.values():
        v.requires_grad_(True)
    mlp.loss_fn(tg, tb).backward()
    for k, v in tg.items():
        np.testing.assert_allclose(v.grad.numpy(), np.asarray(grads[k]),
                                   rtol=0, atol=1e-6, err_msg=k)


def test_convert_round_trips_bitwise():
    params = jax.tree.map(np.asarray, jmlp.init_mlp(jax.random.PRNGKey(1)))
    params["b1"] = (params["b1"] + 1.5).astype(ml_dtypes.bfloat16)
    tp = convert.params_from_numpy(params)
    assert tp["b1"].dtype == torch.bfloat16 and tp["w1"].dtype == \
        torch.float32
    back = convert.params_to_numpy(tp)
    for k in params:
        np.testing.assert_array_equal(back[k],
                                      params[k].astype(np.float32))


def test_flat_state_from_numpy_matches_reference_buffer():
    params = jax.tree.map(np.asarray, jmlp.init_mlp(jax.random.PRNGKey(2)))
    stacked = jax.tree.map(lambda a: np.stack([a, 2 * a]), params)
    jfs = jflat.from_tree(jax.tree.map(jnp.asarray, stacked), batch_dims=1)
    tp = convert.params_from_numpy(stacked)
    layout = flatbuf.make_layout(tp, batch_dims=1)
    fs = convert.flat_state_from_numpy(np.asarray(jfs.buf), layout)
    for k, v in fs.tree().items():
        assert torch.equal(v, tp[k])
    assert torch.equal(fs.buf, flatbuf.flatten_tree(layout, tp, 1))
    with pytest.raises(ValueError, match="n_pad"):
        convert.flat_state_from_numpy(np.zeros((2, 4096), np.float32),
                                      layout)


def test_run_paper_task_on_cpu(capsys):
    cfg = train.FedBenchCfg(rounds=1, t_e=2)
    res = train.run_paper_task(cfg, device="cpu")
    assert len(res["loss"]) == len(res["acc"]) == 1
    assert np.isfinite(res["loss"]).all() and 0 <= res["acc"][0] <= 1
    assert res["state"].step == 2
    assert res["params"]["w1"].shape == (4, 784, 64)
    assert res["d"] == 50890
    assert res["uplink_bits_per_round"] == 2 * 50890 + 32 * 50890
    assert "[train] round 0" in capsys.readouterr().out
    with pytest.raises(ValueError, match="smallest device"):
        train.run_paper_task(dataclasses.replace(cfg, batch=10_000),
                             device="cpu")


def test_cuda_is_the_default_and_is_refused_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        train.run_paper_task(train.FedBenchCfg(rounds=1, t_e=1))
    with pytest.raises(RuntimeError, match="cuda"):
        Topology(4, 5)
    assert Topology(4, 5, "cpu").device == torch.device("cpu")


def test_cli_parses_config_fields(monkeypatch):
    seen = {}
    monkeypatch.setattr(train, "run_paper_task", lambda cfg, device: (
        seen.update(cfg=cfg, device=device) or
        {"loss": [1.0], "acc": [0.5]}))
    train.main(["--rounds", "2", "--batch", "400", "--iid", "--rho", "0.5",
                "--device", "cpu", "--transport", "ar_int8"])
    assert seen["device"] == "cpu"
    assert (seen["cfg"].rounds, seen["cfg"].batch, seen["cfg"].iid,
            seen["cfg"].rho, seen["cfg"].transport) == (2, 400, True, 0.5,
                                                        "ar_int8")
    train.main(["--clients_per_device", "2", "--participation", "fixed",
                "--rate", "0.5", "--client_seed", "11", "--client_mode",
                "stream", "--data_weights", "--device", "cpu"])
    cfg = seen["cfg"]
    assert (cfg.clients_per_device, cfg.participation, cfg.rate,
            cfg.client_seed, cfg.client_mode, cfg.data_weights) == (
        2, "fixed", 0.5, 11, "stream", True)
    train.main(["--method", "mtgc_hier_signsgd", "--cloud_period", "3",
                "--cloud_overlap", "overlap", "--error_feedback",
                "--momentum", "0.9", "--device", "cpu"])
    cfg = seen["cfg"]
    assert (cfg.method, cfg.cloud_period, cfg.cloud_overlap,
            cfg.error_feedback, cfg.momentum) == (
        "mtgc_hier_signsgd", 3, "overlap", True, 0.9)


def test_virtual_clients_stream_equals_merged_on_cpu():
    """The launcher with K=2 clients per device, Bernoulli(0.5) participation
    and |D_qk| row-count weights: the streamed fused/flat run is bitwise
    the merged fused/flat and ag_packed/tree runs, and its test loss
    falls."""
    cfg = train.FedBenchCfg(rounds=2, t_e=2, clients_per_device=2,
                            participation="bernoulli", rate=0.5,
                            client_seed=11, data_weights=True,
                            client_mode="stream")
    res = train.run_paper_task(cfg, device="cpu", log=lambda line: None)
    assert res["loss"][-1] < res["loss"][0]
    cc = res["clients"]
    assert cc.active and cc.mode == "stream" and cc.count == 2
    data = emnist_like.make_federated_data(emnist_like.FedDataCfg(
        n_train=cfg.n_train, n_test=train.N_TEST, q_edges=4,
        devices_per_edge=10))[0]
    assert cc.weights[2][3][1] == len(data[2][7]["y"])
    assert res["uplink_bits_per_round"] == 2 * 0.5 * (2 * 50890
                                                      + 32 * 50890)
    for mode, transport, layout in (("merged", "fused", "flat"),
                                    ("merged", "ag_packed", "tree")):
        other = train.run_paper_task(
            dataclasses.replace(cfg, client_mode=mode, transport=transport,
                                state_layout=layout),
            device="cpu", log=lambda line: None)
        for k, v in res["params"].items():
            assert torch.equal(v, other["params"][k]), (mode, k)
        assert other["loss"] == res["loss"]


@pytest.mark.parametrize("method,kw", [
    ("hier_sgd", {}), ("hier_local_qsgd", {}),
    ("scaffold_hier_signsgd", {"cloud_overlap": "overlap",
                               "momentum": 0.9})],
    ids=["hier_sgd", "qsgd", "scaffold_overlap_mom"])
def test_launcher_runs_the_baselines_and_corrections(method, kw):
    """The paper task with the full-precision baselines and a correction
    method, 2 rounds of T_E=2 on the CPU: the test loss falls below the
    initial model's, and the wire cost is the method's Table II entry."""
    cfg = train.FedBenchCfg(method=method, rounds=2, t_e=2, **kw)
    res = train.run_paper_task(cfg, device="cpu", log=lambda line: None)
    assert np.isfinite(res["loss"]).all()
    assert res["loss"][-1] < res["loss_init"]
    assert res["uplink_bits_per_round"] == signs_uplink(method, 50890, 2)
    state = res["state"]
    assert (state.corr_cl is not None) == (method == "scaffold_hier_signsgd")
    assert (state.agg_next is not None) == ("cloud_overlap" in kw)


def signs_uplink(method, d, t_e):
    from repro_torch.core import signs
    return signs.uplink_bits(method, d, t_e)


def test_sampled_batches_replay_the_run():
    """``sample_batches`` draws what ``run_paper_task`` samples, so a run
    fed them is bitwise the run that samples (with no data time)."""
    cfg = train.FedBenchCfg(method="hier_local_qsgd", rounds=1, t_e=2)
    batches = train.sample_batches(cfg, "cpu")
    assert len(batches) == 2 and batches[0]["x"].shape == (4, 5, 64, 784)
    fed = train.run_paper_task(cfg, "cpu", log=lambda line: None,
                               batches=batches)
    own = train.run_paper_task(cfg, "cpu", log=lambda line: None)
    assert fed["loss"] == own["loss"]
    assert fed["data_ms_per_step"][0] < own["data_ms_per_step"][0]
    for k, v in fed["params"].items():
        assert torch.equal(v, own["params"][k]), k


def test_launcher_rejects_a_batch_the_clients_do_not_divide():
    with pytest.raises(ValueError, match="does not divide"):
        train.run_paper_task(train.FedBenchCfg(rounds=1, t_e=1, batch=63,
                                               clients_per_device=2),
                             device="cpu")


def test_batches_stack_clients_in_carve_order():
    """Device d's rows [c*B/K, (c+1)*B/K) are data client d*K + c's."""
    cfg = train.FedBenchCfg(q_edges=2, devices_per_edge=2, batch=6,
                            clients_per_device=3)
    rng = np.random.default_rng(0)
    data = [[{"x": np.full((4, 2), 10 * q + j, np.float32),
              "y": np.full(4, j, np.int32)} for j in range(6)]
            for q in range(2)]
    b = train._stack_batches(data, cfg, rng, "cpu")
    assert b["x"].shape == (2, 2, 6, 2)
    for q in range(2):
        for d in range(2):
            want = np.repeat([d * 3 + c for c in range(3)], 2)
            np.testing.assert_array_equal(b["y"][q, d].numpy(), want)


def _imported_modules(path: pathlib.Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_port_imports_neither_jax_nor_the_jax_package():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 15
    for f in files:
        bad = _imported_modules(f) & {"jax", "jaxlib", "repro"}
        assert not bad, f"{f.relative_to(ROOT)} imports {bad}"
    mods = [".".join(f.relative_to(ROOT / "src").with_suffix("").parts)
            for f in sorted(PORT.rglob("*.py"))]
    mods = [m[:-len(".__init__")] if m.endswith(".__init__") else m
            for m in mods]
    assert {"repro_torch.launch.specs",
            "repro_torch.examples.serve_decode"} <= set(mods)
    # the configs registry imports its modules by name, which the AST
    # walk cannot see: load every arch, and build every one of a ported
    # family (all of them since the hybrid family)
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "from repro_torch import configs\n"
            "from repro_torch.core.topology import Topology\n"
            "from repro_torch.models import build\n"
            "built = 0\n"
            "for a in configs.ARCH_NAMES:\n"
            "    for cfg in (configs.get_config(a), configs.get_smoke(a)):\n"
            "        if cfg.family in build.PORTED_FAMILIES:\n"
            "            build.build_model(cfg, Topology(1, 1, 'cpu'))"
            ".abstract_params()\n"
            "            built += 1\n"
            "assert len(configs.ARCH_NAMES) == 10 and built == 20, built\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro'))\n"
            "assert not bad, bad\n"
            "print('ok', len(sys.modules))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")
