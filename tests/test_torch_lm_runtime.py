"""The LM trainer's host side against the JAX package, and its entry points.

  * the token stream (``data.synthetic``): the edge and client logits are
    the JAX package's bitwise for ``hetero``, ``alpha_client`` and
    ``edge_assign`` in {fixed, random, clustered}; ``batch_at(step)`` is
    the same on two calls and two streams, differs between steps, stays
    in the vocabulary, and gives each client rows from its own logits;
    ``validate_scenario`` raises where the JAX package's raises;
  * the runtime (``runtime.elastic``, ``runtime.failures``): on the same
    failures, heartbeats, quorum and data sizes the port's ``Membership``
    emits the JAX package's arrays bitwise, and ``FailureDetector`` makes
    the same decisions (the invariants of ``tests/test_elastic.py``);
  * the trainer (``launch.train``): ``run_training`` lowers the loss on the
    CPU (the JAX ``test_training_reduces_loss`` analogue), the ``--arch``
    CLI runs and prints the same digits on every transport and layout,
    the paper-task CLI runs as before, and what is not ported raises
    ``NotImplementedError`` naming its ROADMAP item (checkpointing and
    fault injection, item 13 and 14, are ported and run).
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core.clients import ClientConfig as JClientConfig
from repro.data import synthetic as jsynthetic
from repro.runtime import elastic as jelastic
from repro.runtime import failures as jfailures
from repro_torch import configs
from repro_torch.core import hier
from repro_torch.core.clients import ClientConfig
from repro_torch.core.topology import Topology
from repro_torch.data import synthetic
from repro_torch.launch import train
from repro_torch.runtime import elastic, failures


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for this module's small tensors: the suite runs
    several pytest workers on the machine's cores, and PyTorch's thread
    pool in each of them would contend for the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


STREAM_CASES = [
    dict(hetero=1.0), dict(hetero=0.3),
    dict(clients_per_device=2, alpha_client=0.5),
    dict(clients_per_device=2, alpha_client=0.5, edge_assign="random"),
    dict(clients_per_device=2, alpha_client=0.5, edge_assign="clustered"),
]
STREAM_IDS = ["hetero1", "hetero0.3", "alpha_client", "random", "clustered"]


def stream_cfgs(**kw):
    base = dict(vocab=96, seq_len=8, batch_per_device=4, pods=2,
                devices_per_pod=3, seed=5)
    base.update(kw)
    return jsynthetic.LMStreamCfg(**base), synthetic.LMStreamCfg(**base)


@pytest.mark.parametrize("kw", STREAM_CASES, ids=STREAM_IDS)
def test_stream_logits_match_jax(kw):
    jcfg, cfg = stream_cfgs(**kw)
    np.testing.assert_array_equal(synthetic._edge_logits(cfg),
                                  jsynthetic._edge_logits(jcfg))
    np.testing.assert_array_equal(synthetic._client_logits(cfg),
                                  jsynthetic._client_logits(jcfg))


@pytest.mark.parametrize("kw", STREAM_CASES, ids=STREAM_IDS)
def test_batch_at_is_a_pure_function_of_seed_and_step(kw):
    cfg = stream_cfgs(**kw)[1]
    a, b = synthetic.make_stream(cfg), synthetic.make_stream(cfg)
    t3 = a(3)["tokens"]
    assert t3.shape == (2, 3, 4, 8) and t3.dtype == torch.int64
    assert torch.equal(t3, a(3)["tokens"]) and torch.equal(t3, b(3)["tokens"])
    assert not torch.equal(t3, a(4)["tokens"])
    assert int(t3.min()) >= 0 and int(t3.max()) < cfg.vocab


def test_clients_draw_from_their_own_logits():
    """One client's rows follow its tilted unigram: with alpha_client
    small each client's most frequent token is its logits' argmax."""
    cfg = stream_cfgs(vocab=16, seq_len=256, batch_per_device=2,
                      clients_per_device=2, alpha_client=0.05)[1]
    toks = synthetic.make_stream(cfg)(0)["tokens"]      # [P, D, 2, 256]
    logits = synthetic._client_logits(cfg)               # [P, D, K, V]
    for q in range(2):
        for d in range(3):
            for c in range(2):
                counts = torch.bincount(toks[q, d, c], minlength=16)
                assert int(counts.argmax()) == int(logits[q, d, c].argmax())


@pytest.mark.parametrize("kw", [
    dict(edge_assign="nope"), dict(alpha_client=0.0),
    dict(alpha_client=-1.0), dict(edge_assign="clustered"),
    dict(edge_assign="clustered", clients_per_device=2),
    dict(edge_assign="clustered", clients_per_device=2, alpha_client=1.0),
    dict(edge_assign="random", clients_per_device=2)])
def test_validate_scenario_raises_where_jax_raises(kw):
    jcfg, cfg = stream_cfgs(**kw)
    try:
        jsynthetic.validate_scenario(jcfg)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            synthetic.validate_scenario(cfg)
        assert str(got.value) == str(e)
    else:
        synthetic.validate_scenario(cfg)


def test_stream_refuses_a_batch_that_does_not_carve():
    cfg = stream_cfgs(batch_per_device=3, clients_per_device=2)[1]
    with pytest.raises(ValueError, match="does not divide"):
        synthetic.make_stream(cfg)


def membership_pair(pods, devs, k, seed, quorum=0.5):
    rng = np.random.default_rng(seed)
    sizes = rng.integers(1, 100, (pods, devs))
    jcc = JClientConfig(count=k)
    cc = ClientConfig(count=k)
    return (jelastic.Membership(pods, devs, clients=jcc, data_sizes=sizes,
                                quorum=quorum),
            elastic.Membership(pods, devs, clients=cc, data_sizes=sizes,
                               quorum=quorum), rng)


@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("seed", range(6))
def test_membership_emits_the_jax_arrays(seed, k):
    """Random client, device and pod failures, restores, heartbeats and a
    sweep, applied to both: the same (edge_weights, dev_weights, mask)
    after every event, bitwise, and the same live set."""
    pods, devs = 1 + seed % 3, 2 + seed % 4
    jm, m, rng = membership_pair(pods, devs, k, seed)
    for event in range(12):
        kind = rng.integers(5)
        q, d, c = (int(rng.integers(pods)), int(rng.integers(devs)),
                   int(rng.integers(k)))
        for mem in (jm, m):
            if kind == 0:
                mem.mark_failed(q, d, c)
            elif kind == 1:
                mem.mark_failed(q, d)
            elif kind == 2:
                mem.restore(q, d, now=float(event))
            elif kind == 3:
                mem.heartbeat(q, d, now=float(event))
            else:
                mem.sweep(now=float(event))
        want, got = jm.weights(), m.weights()
        for a, b in zip(got, want):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(m.live, jm.live)
        np.testing.assert_array_equal(m.pod_live(), jm.pod_live())


def test_membership_invariants():
    """The invariants of tests/test_elastic.py on the port: a lost pod's
    weight moves to the survivors, the quorum gates a pod, fresh() is an
    all-live copy of the config, bad sizes raise."""
    m = elastic.Membership(2, 4)
    m.mark_failed(0)
    ew, dw, mask = m.weights()
    assert ew[0] == 0.0 and np.isclose(ew[1], 1.0) and (mask[0] == 0).all()
    q = elastic.Membership(1, 4, quorum=0.75)
    q.mark_failed(0, 0)
    q.mark_failed(0, 1)
    assert not q.pod_live()[0]
    c = elastic.Membership(2, 2, clients=ClientConfig(count=2), quorum=0.25)
    c.mark_failed(1)
    f = c.fresh()
    assert f.live.all() and f.quorum == c.quorum and f.clients is c.clients
    assert not c.live[1].any()
    with pytest.raises(ValueError):
        elastic.Membership(2, 2, data_sizes=np.ones((3, 2)))


def test_failure_detector_decides_as_jax():
    policy = dict(straggler_factor=2.0, patience=2, max_restores=2,
                  window=8)
    jd = jfailures.FailureDetector(jfailures.FailurePolicy(**policy))
    d = failures.FailureDetector(failures.FailurePolicy(**policy))
    rng = np.random.default_rng(0)
    for i in range(40):
        dt = float(rng.choice([1.0, 1.1, 5.0]))
        jd.record_step(dt)
        d.record_step(dt)
        key = (int(rng.integers(2)), int(rng.integers(2)),
               None if i % 3 else int(rng.integers(2)))
        assert d.device_slow(*key[:2], dt, client=key[2]) == \
            jd.device_slow(*key[:2], dt, client=key[2])
        assert d.median_step() == jd.median_step()
    for x in (1.0, float("nan"), float("inf")):
        assert d.check_loss(x) == jd.check_loss(x)
    for _ in range(3):
        assert d.may_restore() == jd.may_restore()
        d.record_restore()
        jd.record_restore()


def algo(**kw):
    base = dict(method="dc_hier_signsgd", mu=1e-3, rho=0.2, t_e=3,
                compute_dtype=torch.float32, transport="fused",
                state_layout="flat")
    base.update(kw)
    return hier.AlgoConfig(**base)


def test_training_reduces_loss():
    """stablelm's smoke config, 24 steps of batch 8 x seq 64 on the CPU:
    the mean loss of the last 4 steps is below the first 4's."""
    _, hist = train.run_training(
        configs.get_smoke("stablelm_3b"), Topology(1, 1, "cpu"), algo(),
        train.RunCfg(steps=24, batch_per_device=8, seq_len=64, log_every=0))
    first = sum(h["loss"] for h in hist[:4]) / 4
    last = sum(h["loss"] for h in hist[-4:]) / 4
    assert last < first, (first, last)
    assert [h["step"] for h in hist] == list(range(24))
    assert all(h["live"] == 1.0 and h["ms"] > 0 for h in hist)


def run_cli(capsys, *argv):
    train.main(list(argv))
    return capsys.readouterr().out


@pytest.mark.parametrize("arch", ["gemma3_1b", "xlstm_350m", "whisper_base",
                                  "internvl2_76b", "arctic_480b",
                                  "deepseek_v3_671b"])
def test_arch_cli_prints_the_same_digits_on_every_route(arch, capsys):
    base = ("--device", "cpu", "--arch", arch, "--smoke", "--steps",
            "4", "--t_e", "2", "--batch", "2", "--seq", "16")
    outs = [run_cli(capsys, *base, *extra) for extra in (
        (), ("--transport", "fused", "--state_layout", "flat"),
        ("--transport", "ar_int8", "--pods", "1"))]
    assert outs[0] == outs[1] == outs[2]
    assert "[train] done: loss" in outs[0]
    two = run_cli(capsys, *base, "--pods", "2", "--devices_per_pod", "3",
                  "--transport", "fused", "--state_layout", "flat")
    assert "[train] done: loss" in two


def test_paper_task_cli_runs_without_arch(capsys):
    out = run_cli(capsys, "--device", "cpu", "--rounds", "1", "--t_e", "2",
                  "--q_edges", "2", "--devices_per_edge", "2", "--batch",
                  "16", "--n_train", "600")
    assert "[train] round 0" in out and "test loss" in out


@pytest.mark.parametrize("what", ["ckpt_dir", "fault_injector", "family",
                                  "cli_chaos", "cli_multi_pod"])
def test_unported_options_name_their_item(what, capsys, tmp_path):
    """The options still unported raise naming their ROADMAP item; the
    checkpoint store (item 13), the chaos engine (item 14) and the hybrid
    family (item 15) are ported, and their options now run."""
    cfg = configs.get_smoke("gemma3_1b")
    run = train.RunCfg(steps=1, batch_per_device=1, seq_len=8)
    topo = Topology(1, 1, "cpu")
    ported = {
        "ckpt_dir": lambda: train.run_training(
            cfg, topo, algo(), dataclasses.replace(
                run, ckpt_dir=str(tmp_path / "ckpt")), log=lambda _: None),
        "fault_injector": lambda: train.run_training(
            cfg, topo, algo(), run, log=lambda _: None,
            fault_injector=failures.FaultInjector({0: ("device", 0, 0)})),
        "cli_chaos": lambda: train.main(
            ["--device", "cpu", "--arch", "gemma3_1b", "--smoke", "--steps",
             "1", "--batch", "1", "--seq", "8", "--chaos", "1"]),
        "family": lambda: train.run_training(
            configs.get_smoke("zamba2_2p7b"), topo, algo(), run,
            log=lambda _: None),
    }
    if what in ported:
        out = ported[what]()
        if what == "family":
            _, hist = out
            assert len(hist) == 1 and np.isfinite(hist[0]["loss"])
        if what == "ckpt_dir":
            assert (tmp_path / "ckpt" / "LATEST").read_text() == "1"
        if what == "cli_chaos":
            assert "[train] chaos seed 1" in capsys.readouterr().out
        return
    # --multi_pod is ported (item 17b): the production grid needs its
    # 512 ranks, and a world of one is refused naming them
    cases = {
        "cli_multi_pod": (lambda: train.main(
            ["--device", "cpu", "--arch", "gemma3_1b", "--smoke",
             "--multi_pod"]), ValueError, "needs 512 ranks"),
    }
    fn, error, item = cases[what]
    with pytest.raises(error, match=item):
        fn()
