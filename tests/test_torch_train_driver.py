"""The LM trainer's fault tolerance (``launch.train.run_training`` with a
checkpoint directory and a fault injector) and ``hier.make_global_round``.

  * a run stopped and started again on its checkpoint directory resumes
    at the newest checkpoint and ends bitwise where the uninterrupted
    run ends -- also when the checkpoint was written by the tree layout
    and the run resumes on the flat one, and when it was written
    mid-round with the overlapped cloud's aggregate in flight;
  * device loss (kill, recover) with an injected nan: the run restores
    and replays, bitwise the run without the nan; without a checkpoint
    the nan raises;
  * a JAX checkpoint at step 2, continued in the port, agrees with the
    JAX package's continued run on the same tokens within atol 1e-5;
  * ``--ckpt`` and ``--chaos`` on the smoke config print the same digits
    on fused/flat and ag_packed/tree;
  * ``make_global_round`` is bitwise T_E eager steps, for all six methods;
  * the ``fault_tolerant_train`` example runs on the CPU.
"""
import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, str(pathlib.Path(__file__).parent / "helpers"))

from repro.checkpoint import store as jstore  # noqa: E402
from repro.core import hier as jhier  # noqa: E402
from repro.core.topology import single_device_topology  # noqa: E402
from repro_torch.checkpoint import store  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.core import hier, pytree  # noqa: E402
from repro_torch.core.clients import ClientConfig  # noqa: E402
from repro_torch.core.topology import Topology  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.models import build, mlp  # noqa: E402
from repro_torch.runtime.chaos import ChaosEvent, FaultInjector  # noqa: E402
from test_torch_hier import mlp_problem  # noqa: E402
from test_torch_lm import jax_params, smoke  # noqa: E402
from test_torch_ref_fed import seeded_uniforms  # noqa: E402

MU, RHO = 1e-3, 0.2


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for this module's small tensors (the suite
    runs several pytest workers on the machine's cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def lm_cfg():
    return smoke("gemma3_1b", n_layers=6)[1]


def algo(**kw):
    base = dict(method="dc_hier_signsgd", mu=MU, rho=RHO, t_e=3,
                transport="fused", state_layout="flat",
                compute_dtype=torch.float32, delta_dtype=torch.bfloat16)
    base.update(kw)
    return hier.AlgoConfig(**base)


def train_run(cfg, algo_, steps, ckpt=None, every=3, injector=None,
              events=None):
    """run_training at P=2 x D=3, batch 1 x 16 tokens; (edge models as
    leaves, history)."""
    state, hist = train.run_training(
        cfg, Topology(2, 3, "cpu"), algo_,
        train.RunCfg(steps=steps, batch_per_device=1, seq_len=16,
                     ckpt_dir=None if ckpt is None else str(ckpt),
                     ckpt_every=every, ckpt_keep=2, log_every=0),
        fault_injector=injector, log=lambda _: None,
        on_checkpoint=None if events is None else events.append)
    return pytree.tree_flatten(hier.edge_params(state))[0], hist


def assert_bitwise(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


@pytest.mark.parametrize("first,then", [
    ({}, {}),
    ({"transport": "ag_packed", "state_layout": "tree"}, {}),
    ({"cloud_overlap": "overlap"}, {"cloud_overlap": "overlap"})],
    ids=["flat", "tree_to_flat", "overlap_midflight"])
def test_resume_continues_bitwise(lm_cfg, tmp_path, first, then):
    """Stop after 4 steps (checkpoints at 2 and 4: mid-round with T_E=3,
    an aggregate in flight under overlap), start again to 8: the second
    run resumes at 4 and ends bitwise the uninterrupted 8 steps."""
    straight, _ = train_run(lm_cfg, algo(**then), 8)
    events = []
    train_run(lm_cfg, algo(**first), 4, tmp_path, every=2, events=events)
    assert [e["step"] for e in events] == [2, 4]
    assert all(e["event"] == "save" and e["bytes"] > 0 for e in events)
    assert store.available_steps(tmp_path) == [2, 4]
    got, hist = train_run(lm_cfg, algo(**then), 8, tmp_path, every=2,
                          events=events)
    assert hist[0]["step"] == 4 and hist[-1]["step"] == 7
    assert events[2]["event"] == "resume" and events[2]["step"] == 4
    assert_bitwise(got, straight)
    assert store.available_steps(tmp_path) == [6, 8]


def test_device_loss_and_nan_restore_replay(lm_cfg, tmp_path):
    """A device dies at step 1 and recovers at 4, a straggler is demoted
    at 2; the nan at 5 restores step 4 and replays: bitwise the run of
    the same schedule without the nan and without checkpoints."""
    evs = [ChaosEvent(1, "device", 0, 1), ChaosEvent(2, "straggler", 1, 2),
           ChaosEvent(4, "recover", 0, 1), ChaosEvent(5, "recover", 1, 2)]
    want, whist = train_run(lm_cfg, algo(), 7, injector=FaultInjector(evs))
    assert [h["live"] < 1.0 for h in whist] == [False, True, True, True,
                                                True, False, False]
    events = []
    got, hist = train_run(lm_cfg, algo(), 7, tmp_path, every=2,
                          injector=FaultInjector(evs + [ChaosEvent(5, "nan")]),
                          events=events)
    assert_bitwise(got, want)
    assert [h["step"] for h in hist] == [0, 1, 2, 3, 4, 4, 5, 6]
    restore = [e for e in events if e["event"] == "restore"]
    assert len(restore) == 1 and restore[0]["step"] == 4 and \
        restore[0]["at"] == 5 and restore[0]["restore_s"] >= 0
    with pytest.raises(RuntimeError, match="no checkpoint"):
        train_run(lm_cfg, algo(), 3,
                  injector=FaultInjector([ChaosEvent(1, "nan")]))


def test_jax_checkpoint_continues_in_the_port(tmp_path):
    """The JAX step runs 2 steps and checkpoints; the port restores that
    checkpoint and takes the next 2 steps on the same tokens as the JAX
    step does: the edge models agree within atol 1e-5 (the step's
    tolerance against JAX: autograd sums in another order than XLA)."""
    jcfg, cfg = smoke("gemma3_1b", n_layers=6)
    jbuilt, p = jax_params(jcfg)
    jalgo = jhier.AlgoConfig(method="dc_hier_signsgd", mu=MU, rho=RHO, t_e=3,
                             transport="ag_packed", state_layout="flat",
                             compute_dtype=jnp.float32,
                             delta_dtype=jnp.bfloat16)
    init_fn, step = jhier.make_hier_step(single_device_topology(), jalgo,
                                         jbuilt.bundle)
    state = jax.jit(init_fn)(p, jax.random.PRNGKey(1))
    jstep = jax.jit(step)
    tokens = np.random.default_rng(3).integers(
        0, cfg.vocab, (4, 1, 1, 2, 16)).astype(np.int32)
    ones = jnp.ones((1, 1))
    for s in range(4):
        if s == 2:
            jstore.save(tmp_path, 2, state)
        state, _ = jstep(state, {"train": {"tokens": tokens[s]}},
                         jnp.ones(1), ones, ones)
    want = jax.tree.leaves(state.params.tree())

    built = build.build_model(cfg, Topology(1, 1, "cpu"))
    pinit, pstep = hier.make_hier_step(
        Topology(1, 1, "cpu"), algo(transport="fused", state_layout="flat"),
        built.bundle)
    with pytest.warns(UserWarning, match="jax.random key"):
        s0, pstate = store.restore_latest(tmp_path, pinit(
            params_from_numpy(p)))
    assert s0 == pstate.step == 2
    for s in range(2, 4):
        pstate, _ = pstep(pstate, {"train": {"tokens": torch.from_numpy(
            tokens[s]).long()}}, torch.ones(1), torch.ones(1, 1),
            torch.ones(1, 1))
    got = pytree.tree_flatten(hier.edge_params(pstate))[0]
    for a, w in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-5)


def test_ckpt_and_chaos_cli_print_the_same_digits(capsys, tmp_path):
    base = ("--device", "cpu", "--arch", "gemma3_1b", "--smoke", "--steps",
            "8", "--t_e", "2", "--batch", "2", "--seq", "16", "--pods", "2",
            "--devices_per_pod", "2", "--chaos", "3")
    outs = []
    for i, route in enumerate((("--transport", "fused", "--state_layout",
                                 "flat"),
                                ("--transport", "ag_packed",
                                 "--state_layout", "tree"))):
        train.main([*base, *route, "--ckpt", str(tmp_path / str(i))])
        outs.append(capsys.readouterr().out)
    assert outs[0] == outs[1]
    assert "scheduled events" in outs[0] and "[train] done: loss" in outs[0]
    assert store.available_steps(tmp_path / "0") == [8]


def test_ckpt_cli_run_again_on_one_directory(capsys, tmp_path):
    """The same ``--ckpt`` command twice: the second run resumes at its
    ``--steps`` and has no step to run; a third with more steps resumes
    there and saves at its end."""
    base = ["--device", "cpu", "--arch", "gemma3_1b", "--smoke", "--t_e",
            "2", "--batch", "2", "--seq", "16", "--chaos", "3", "--ckpt",
            str(tmp_path)]
    train.main([*base, "--steps", "4"])
    assert "[train] done: loss" in capsys.readouterr().out
    train.main([*base, "--steps", "4"])
    out = capsys.readouterr().out
    assert "resumed from step 4" in out and "no step to run" in out
    train.main([*base, "--steps", "6"])
    out = capsys.readouterr().out
    assert "resumed from step 4" in out and "[train] done: loss" in out
    assert store.available_steps(tmp_path) == [4, 6]


GLOBAL_ROUND_CASES = [("dc_hier_signsgd", {}), ("hier_signsgd", {}),
                      ("scaffold_hier_signsgd", {}),
                      ("mtgc_hier_signsgd", {"cloud_period": 1}),
                      ("hier_sgd", {}), ("hier_local_qsgd", {}),
                      ("dc_hier_signsgd", {"clients": ClientConfig(
                          count=2, participation="bernoulli", rate=0.5,
                          seed=3, mode="stream")})]


@pytest.mark.parametrize("method,kw", GLOBAL_ROUND_CASES, ids=[
    "dc", "hier", "scaffold", "mtgc", "hier_sgd", "qsgd", "dc_k2_stream"])
def test_global_round_is_the_eager_steps(method, kw):
    """P=2 x D=3 MLP 64-16-10, 2 rounds of T_E=3: ``global_round`` on
    [T_E, P, D, b, ...] batches is bitwise three ``train_step`` calls
    (the round's first batch as the anchor), and its loss their mean."""
    prob = mlp_problem(2, 3, 3, 2, b=8)
    a = hier.AlgoConfig(method=method, mu=5e-3, mu_sgd=0.05, t_e=3, rho=0.2,
                        transport="fused", state_layout="flat",
                        compute_dtype=torch.float32,
                        delta_dtype=torch.float32, **kw)
    topo, bundle = Topology(2, 3, "cpu"), mlp.make_bundle()
    uniforms = seeded_uniforms(5) if method == "hier_local_qsgd" else None
    init_fn, step = hier.make_hier_step(topo, a, bundle, uniforms=uniforms)
    rinit, rnd = hier.make_global_round(topo, a, bundle, uniforms=uniforms)
    ew, dw, mask = torch.tensor([0.3, 0.7]), torch.full((2, 3), 1 / 3), \
        torch.ones(2, 3)
    x, y = torch.from_numpy(prob["xs"]), torch.from_numpy(prob["ys"])
    w0 = params_from_numpy(prob["w0"])
    s1, s2 = init_fn(w0, 4), rinit(w0, 4)
    for t in range(2):
        losses = []
        for tau in range(3):
            i = t * 3 + tau
            s1, m = step(s1, {"train": {"x": x[i], "y": y[i]},
                              "anchor": {"x": x[t * 3], "y": y[t * 3]}},
                         ew, dw, mask)
            losses.append(m["loss"])
        s2, m2 = rnd(s2, {"x": x[t * 3:t * 3 + 3], "y": y[t * 3:t * 3 + 3]},
                     ew, dw, mask)
        assert torch.equal(m2["loss"], torch.stack(losses).mean())
    assert s1.step == s2.step == 6
    assert_bitwise(pytree.tree_flatten(hier.edge_params(s2))[0],
                   pytree.tree_flatten(hier.edge_params(s1))[0])


def test_fault_tolerant_example_runs(capsys):
    """``python -m repro_torch.examples.fault_tolerant_train --device
    cpu``: churn visible, the nan restored, the crash resumed."""
    from repro_torch.examples import fault_tolerant_train
    fault_tolerant_train.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert "non-finite loss at step 9; restored step 8" in out
    assert "resumed from step 12" in out and out.rstrip().endswith("OK")
