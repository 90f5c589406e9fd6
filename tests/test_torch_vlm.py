"""The vlm family (internvl2: stub vision patches before the tokens)
against the JAX package and within the port, on the CPU.

  * the loss and its gradients on internvl2's smoke config (8 patches a
    row, positions over patches and tokens, the patch positions cut off
    before the head) against JAX's jitted ``make_loss_single`` within
    1e-5 (``tests/test_torch_moe_train.py``'s rule);
  * 4 steps of DC against JAX's ``make_hier_step``, replicated and with
    ``param_mode="fsdp"`` (``step_matches_jax``);
  * FSDP bitwise the replicated regime at P=2 x D=3 in float32 and
    bfloat16, one vote a leaf and layer;
  * the stream's patches [P, D, b, n_patches, d_model], 0.02 x standard
    normals from their own key (apart from the frames'), carved with the
    tokens for K=2 clients; K=2 streamed clients bitwise the merged voter
    axis through ``run_training``;
  * serving: ``prefill`` puts the request's patches first and returns
    ``pos = n_patches + t``; a decode step after a prefill gives the
    logits of the one-longer prefill (the JAX package's 2e-2); the
    requests carry patches.  Prefill and decode against JAX's:
    ``tests/test_torch_serve.py``.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.core import clients, hier, pytree
from repro_torch.core.topology import Topology
from repro_torch.data import synthetic
from repro_torch.launch import specs
from repro_torch.launch.train import RunCfg, run_training
from repro_torch.models import build
from test_torch_moe_train import (fsdp_is_bitwise_replicated,
                                  loss_and_grads_match_jax,
                                  step_matches_jax, votes_a_step)

NAME = "internvl2_76b"
CFG = configs.get_smoke(NAME)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread (see tests/test_torch_lm_layers.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_loss_and_grads_match_jax():
    assert CFG.family == "vlm" and CFG.n_patches == 8
    loss_and_grads_match_jax(NAME)


@pytest.mark.parametrize("mode", ["replicated", "fsdp"])
def test_steps_match_jax(mode):
    step_matches_jax(NAME, mode)


@pytest.mark.parametrize("compute", ["f32", "bf16"])
def test_fsdp_is_bitwise_replicated(compute):
    fsdp_is_bitwise_replicated(CFG, compute)


def test_one_vote_a_leaf_and_layer():
    counts, per_step = votes_a_step(CFG)
    assert per_step == 2 * 9 + 1 + 2           # 9 leaves a layer
    assert counts == [2 * per_step, per_step]


def stream_cfg(**kw):
    base = dict(vocab=64, seq_len=8, batch_per_device=4, pods=2,
                devices_per_pod=3, seed=5, n_patches=6, d_model=16)
    base.update(kw)
    return synthetic.LMStreamCfg(**base)


def test_stream_patches_and_their_carve():
    """``batch_at`` gives the patches, the same on two streams and calls,
    other at another step and other than frames drawn at the same step;
    ``carve_batch`` hands client c of device d the rows [c*b/K,
    (c+1)*b/K) of its patches, as of its tokens."""
    cfg = stream_cfg()
    a, b = synthetic.make_stream(cfg), synthetic.make_stream(cfg)
    p0 = a(0)["patches"]
    assert p0.shape == (2, 3, 4, 6, 16) and p0.dtype == torch.float32
    assert torch.equal(p0, b(0)["patches"]) and torch.equal(
        p0, a(0)["patches"])
    assert not torch.equal(p0, a(1)["patches"])
    assert 0.016 < float(p0.std()) < 0.024
    both = synthetic.make_stream(dataclasses.replace(
        cfg, frames=6, frontend_dim=16))(0)
    assert torch.equal(both["patches"], p0)
    assert not torch.equal(both["frames"] / 0.1, p0 / 0.02)
    assert "patches" not in synthetic.make_stream(
        dataclasses.replace(cfg, n_patches=0))(0)
    batch = a(0)
    carved = clients.carve_batch(batch, 2)
    assert carved["patches"].shape == (2, 6, 2, 6, 16)
    for d in range(3):
        for c in range(2):
            rows = slice(2 * c, 2 * c + 2)
            assert torch.equal(carved["patches"][:, 2 * d + c],
                               batch["patches"][:, d, rows])
            assert torch.equal(carved["tokens"][:, 2 * d + c],
                               batch["tokens"][:, d, rows])


def test_clients_stream_equals_merged():
    """K=2 virtual clients a device (patches carved with the tokens): the
    streamed sweep gives the merged voter axis's edge models bitwise, 4
    steps of ``run_training`` at P=2 x D=3 in bfloat16."""
    runs = []
    for mode in ("stream", "merged"):
        algo = hier.AlgoConfig(
            method="dc_hier_signsgd", mu=1e-3, rho=0.2, t_e=2,
            transport="fused", state_layout="flat",
            compute_dtype=torch.bfloat16, delta_dtype=torch.bfloat16,
            clients=clients.ClientConfig(count=2, mode=mode))
        state, hist = run_training(
            CFG, Topology(2, 3, "cpu"), algo,
            RunCfg(steps=4, batch_per_device=2, seq_len=16, log_every=0),
            log=lambda line: None)
        assert all(np.isfinite(h["loss"]) for h in hist)
        runs.append(pytree.tree_flatten(hier.edge_params(state))[0])
    for a, b in zip(*runs):
        assert torch.equal(a, b)


def test_serving_puts_the_patches_first():
    """Prefill of 2 requests (8 patches and 7 tokens each) into max_len
    20: ``pos`` 15; decoding token 8 gives the logits of a prefill of all
    8 tokens within 2e-2 (the JAX package's consistency bound) and the
    same greedy token; other patches give other logits."""
    built = build.build_model(CFG, Topology(1, 1, "cpu"))
    params = built.init_params(torch.Generator().manual_seed(0))
    scfg = stream_cfg(vocab=CFG.vocab, n_patches=CFG.n_patches,
                      d_model=CFG.d_model)
    req = synthetic.serve_request_batch(scfg, 2, 8)
    assert req["patches"].shape == (2, CFG.n_patches, CFG.d_model)
    again = synthetic.serve_request_batch(scfg, 2, 8)
    assert torch.equal(req["patches"], again["patches"])
    head = {"tokens": req["tokens"][:, :7], "patches": req["patches"]}
    _, cache = built.prefill(params, head, max_len=20)
    assert cache["pos"] == CFG.n_patches + 7
    dec, cache = built.decode_step(params, cache, req["tokens"][:, 7:8])
    full, fcache = built.prefill(params, req, max_len=20)
    assert cache["pos"] == fcache["pos"] == CFG.n_patches + 8
    np.testing.assert_allclose(dec[:, -1].numpy(), full[:, -1].numpy(),
                               rtol=2e-2, atol=2e-2)
    assert torch.equal(dec.argmax(-1), full.argmax(-1))
    other, _ = built.prefill(params, dict(req, patches=req["patches"] + 1.0),
                             max_len=20)
    assert not torch.allclose(other, full)
    with pytest.raises(ValueError, match="max_len"):
        built.prefill(params, req, max_len=CFG.n_patches + 7)


def test_serving_the_fsdp_state_a_training_run_leaves():
    """run_training in the FSDP regime at P=2 edges, then edge 0 of its
    [P, *leaf] masters served in bfloat16 (``specs.serve_params_from_
    tree``; the config serves resident): finite logits, bitwise those of
    the edge's tree cast by hand; the float32 views alias the masters."""
    cfg = dataclasses.replace(CFG, param_mode="fsdp")
    topo = Topology(2, 1, "cpu")
    algo = hier.AlgoConfig(method="dc_hier_signsgd", mu=1e-3, rho=0.2,
                           t_e=2, transport="fused", state_layout="tree",
                           compute_dtype=torch.float32)
    state, _ = run_training(cfg, topo, algo,
                            RunCfg(steps=2, batch_per_device=2, seq_len=8,
                                   log_every=0), log=lambda _: None)
    built = build.build_model(cfg, topo)
    assert built.serve_layout == "resident"
    masters = hier.edge_params(state)
    views = specs.serve_params_from_tree(masters)
    for v, m in zip(pytree.tree_flatten(views)[0],
                    pytree.tree_flatten(masters)[0]):
        assert v.untyped_storage().data_ptr() == m.untyped_storage(
        ).data_ptr() and torch.equal(v, m[0])
    served = specs.serve_params_from_tree(masters, torch.bfloat16)
    by_hand = pytree.tree_map(lambda a: a[0].clone().to(torch.bfloat16),
                              masters)
    req = synthetic.serve_request_batch(stream_cfg(
        vocab=cfg.vocab, n_patches=cfg.n_patches, d_model=cfg.d_model), 2, 4)
    got, _ = built.prefill(served, req, max_len=16)
    want, _ = built.prefill(by_hand, req, max_len=16)
    assert got.dtype == torch.bfloat16 and bool(torch.isfinite(got).all())
    assert torch.equal(got, want)
