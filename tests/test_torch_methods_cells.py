"""The rest of the step within the port: every new method and option
gives one trajectory, bitwise, whatever the transport, layout or client
mode.

  * the six transport x layout cells are bitwise each other for every
    method and option, in f32 and in the default bf16 compute/delta
    dtypes (P=2 x D=3, MLP 64-16-10, 2 rounds of T_E=3);
  * with K=2 virtual clients the streamed sweep is bitwise the merged
    voter axis for every method and option x the parity harness's five
    participation regimes, on fused/flat and on the per-leaf tree routes;
  * the gates of a [P, D, K] client mask, with injected gradients
    (``tests/helpers/injected_grads.py``, so every quantity is known): a
    client masked out of the round keeps its EF residual whole (``e' =
    u``) and its SCAFFOLD/MTGC terms, an edge whose whole quorum abstains
    keeps its model and MTGC's cloud term, and without virtual clients
    every device refreshes its terms;
  * the whole product of the six methods x EF x momentum x sync/overlap
    builds and runs in every transport, layout and client mode, to one
    result (injected gradients, a few steps).
"""
import dataclasses
import functools
import pathlib
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, str(pathlib.Path(__file__).parent / "helpers"))
import injected_grads  # noqa: E402
import parity_harness as H  # noqa: E402

from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.core import flatbuf, hier, keys, signs  # noqa: E402
from repro_torch.core.topology import Topology  # noqa: E402
from repro_torch.kernels.sign_pack import sign_pack  # noqa: E402
from repro_torch.kernels.tally_acc import tally_acc  # noqa: E402
from repro_torch.kernels.ternary_quant import ternary_quant  # noqa: E402
from repro_torch.kernels.vote_update import vote_update  # noqa: E402
from repro_torch.models import mlp  # noqa: E402
from test_torch_hier import CELLS, mlp_problem  # noqa: E402

P, D, K = 2, 3, 2
MU, RHO = 5e-3, 0.2
OPTIONS = {
    "hier_sgd": ("hier_sgd", {}),
    "qsgd": ("hier_local_qsgd", {}),
    "scaffold": ("scaffold_hier_signsgd", {}),
    "mtgc": ("mtgc_hier_signsgd", {"cloud_period": 1}),
    "dc_ef": ("dc_hier_signsgd", {"error_feedback": True}),
    "dc_mom": ("dc_hier_signsgd", {"momentum": 0.9}),
    "hier_ef_mom": ("hier_signsgd", {"error_feedback": True,
                                     "momentum": 0.9}),
    "dc_overlap": ("dc_hier_signsgd", {"cloud_overlap": "overlap"}),
    "scaffold_overlap_mom": ("scaffold_hier_signsgd",
                             {"cloud_overlap": "overlap", "momentum": 0.9}),
    "mtgc_ef_overlap": ("mtgc_hier_signsgd", {"error_feedback": True,
                                              "cloud_overlap": "overlap"}),
}


@pytest.fixture(autouse=True)
def no_launches():
    """The CPU route never launches a kernel."""
    kernels = (sign_pack, vote_update, tally_acc, ternary_quant)
    for kern in kernels:
        kern.launches = 0
    yield
    assert all(kern.launches == 0 for kern in kernels)


@functools.lru_cache(maxsize=None)
def run(option, transport, layout, compute=torch.float32, regime=None,
        mode="merged"):
    """Final edge models and state slots (numpy) of the MLP 64-16-10,
    P=2 x D=3 (x K=2 clients under a regime), unequal edge and device
    weights, 2 rounds of T_E=3."""
    method, kw = OPTIONS[option]
    cc = hier.vclients.ClientConfig()
    if regime is not None:
        cc = dataclasses.replace(H.client_cfg(P, D, K, regime), mode=mode)
        cc = hier.vclients.ClientConfig(**cc.__dict__)
    prob = mlp_problem(P, D, 3, 2, b=8, seed=4)
    algo = hier.AlgoConfig(
        method=method, mu=MU, mu_sgd=0.05, t_e=3, rho=RHO,
        transport=transport, state_layout=layout, compute_dtype=compute,
        master_dtype=torch.float32, delta_dtype=compute, clients=cc, **kw)
    init_fn, step = hier.make_hier_step(Topology(P, D, "cpu"), algo,
                                        mlp.make_bundle())
    state = init_fn(params_from_numpy(prob["w0"]), 5)
    rng = np.random.default_rng(9)
    ew = rng.random(P).astype(np.float32)
    ew /= ew.sum()
    dw = torch.from_numpy(rng.random((P, D)).astype(np.float32))
    for s in range(6):
        batch = {"train": {"x": torch.from_numpy(prob["xs"][s]),
                           "y": torch.from_numpy(prob["ys"][s])}}
        state, metrics = step(state, batch, torch.from_numpy(ew), dw,
                              torch.ones(P, D))
        assert torch.isfinite(metrics["loss"])
    out = {f"params/{k}": v.numpy().copy()
           for k, v in hier.edge_params(state).items()}
    for slot in ("agg_next", "ef", "mom", "corr_cl", "corr_edge"):
        val = getattr(state, slot)
        if val is None:
            continue
        tree = val.tree(cast=False) if isinstance(val, flatbuf.FlatState) \
            else val
        out.update({f"{slot}/{k}": v.to(torch.float32).numpy().copy()
                    for k, v in tree.items()})
    return out


def assert_bitwise(got, want, tag):
    assert got.keys() == want.keys(), tag
    for k in want:
        np.testing.assert_array_equal(got[k].view(np.int32),
                                      want[k].view(np.int32),
                                      err_msg=f"{tag}: {k}")


@pytest.mark.parametrize("compute", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("option", list(OPTIONS))
def test_transports_and_layouts_bitwise(option, compute):
    """The six cells give identical edge models and state slots (EF
    residual, momentum, corrections, the staged aggregate)."""
    base = run(option, "ag_packed", "tree", compute)
    for cell in CELLS[1:]:
        assert_bitwise(run(option, *cell, compute), base, str(cell))
    assert any(np.any(base[k] != 0) for k in base if k.startswith("params"))


@pytest.mark.parametrize("regime", H.CLIENT_REGIMES)
@pytest.mark.parametrize("option", list(OPTIONS))
def test_stream_matches_merged(option, regime):
    """K=2 clients a device: streamed fused/flat and ar_int8/tree are
    bitwise the merged fused/flat and ag_packed/tree runs (edge models
    and every state slot)."""
    base = run(option, "ag_packed", "tree", regime=regime)
    for mode, transport, layout in (("merged", "fused", "flat"),
                                    ("stream", "fused", "flat"),
                                    ("stream", "ar_int8", "tree")):
        assert_bitwise(run(option, transport, layout, regime=regime,
                           mode=mode), base, f"{mode}/{transport}/{layout}")


def test_qsgd_stream_holds_one_clients_uniforms():
    """K=4 clients a device, hier_local_qsgd: the streamed step asks for
    one client's uniforms at a time (a voter range of D on the merged
    axis) and drops each block after its leaf's quantization, so the
    bytes of uniforms alive at once -- counted through a wrapping
    ``uniforms`` callable that keeps a weak reference to every block it
    returns -- never exceed one client's worth (P*D voters x the model's
    coordinates x 4 B); the merged step asks for all D*K voters at once.
    Both modes give the same edge models, bitwise."""
    import weakref

    k = 4
    prob = mlp_problem(P, D, 3, 1, b=8, seed=4)
    shapes = [tuple(np.shape(v)) for _, v in sorted(prob["w0"].items())]
    client_bytes = P * D * sum(int(np.prod(sh)) for sh in shapes) * 4
    finals = {}
    for mode in ("stream", "merged"):
        alive, most, ranges = [], [0], []

        def uniforms(step, leaf, shape, voters):
            blocks = []
            for q in range(P):
                for v in voters:
                    g = torch.Generator().manual_seed(keys.key_seed(
                        3, step, leaf, q * D * k + v))
                    blocks.append(torch.rand(shape[2:], generator=g))
            u = torch.stack(blocks).reshape(shape)
            alive.append((weakref.ref(u), u.numel() * 4))
            most[0] = max(most[0], sum(n for r, n in alive
                                       if r() is not None))
            ranges.append(len(voters))
            return u

        algo = hier.AlgoConfig(
            method="hier_local_qsgd", mu_sgd=0.05, t_e=3,
            transport="fused", state_layout="flat",
            compute_dtype=torch.float32, delta_dtype=torch.float32,
            clients=hier.vclients.ClientConfig(count=k, mode=mode))
        init_fn, step = hier.make_hier_step(Topology(P, D, "cpu"), algo,
                                            mlp.make_bundle(), uniforms)
        state = init_fn(params_from_numpy(prob["w0"]), 5)
        for s_ in range(2):
            batch = {"train": {"x": torch.from_numpy(prob["xs"][s_]),
                               "y": torch.from_numpy(prob["ys"][s_])}}
            state, _ = step(state, batch, torch.full((P,), 0.5),
                            torch.full((P, D), 1.0 / D), torch.ones(P, D))
        finals[mode] = {n: v.clone()
                        for n, v in hier.edge_params(state).items()}
        if mode == "stream":
            assert ranges == [D] * (2 * k * len(shapes))
            assert 0 < most[0] <= client_bytes, (most[0], client_bytes)
        else:
            assert ranges == [D * k] * (2 * len(shapes))
    for n in finals["stream"]:
        assert torch.equal(finals["stream"][n], finals["merged"][n]), n


# -- the gates of a client mask, with known gradients -------------------------

SHAPES = {"w": (4, 64), "b": (33,)}


def gate_run(method, mode, layout, transport, mask, steps, virtual=True,
             **kw):
    """P=2 x D=3 x K=2 with injected standard-normal gradients (seed
    21), unit client weights (full participation: only ``mask`` drops
    clients); returns (final state, the gradients)."""
    gen = torch.Generator().manual_seed(21)
    grads = injected_grads.make_grads(SHAPES, P, D, K if virtual else 1,
                                      steps, gen)
    cc = hier.vclients.ClientConfig()
    if virtual:
        cc = hier.vclients.ClientConfig(
            **{**H.client_cfg(P, D, K, "full").__dict__, "mode": mode})
    algo = hier.AlgoConfig(
        method=method, mu=MU, t_e=3, rho=RHO, transport=transport,
        state_layout=layout, compute_dtype=torch.float32,
        delta_dtype=torch.float32, clients=cc, **kw)
    init_fn, step = hier.make_hier_step(Topology(P, D, "cpu"), algo,
                                        injected_grads.make_bundle())
    w0 = {k: torch.randn(s, generator=gen) for k, s in SHAPES.items()}
    state = init_fn(w0)
    for s in range(steps):
        state, _ = step(state, {"train": grads[s],
                                "anchor": grads[s - s % 3]},
                        torch.full((P,), 1.0 / P), torch.ones(P, D), mask)
    return state, grads, w0


def slot_tree(val):
    return val.tree(cast=False) if isinstance(val, flatbuf.FlatState) \
        else val


def client_mask():
    """Pod 1's whole quorum out; pod 0's client (device 0, client 1) out."""
    mask = torch.ones(P, D, K)
    mask[1] = 0.0
    mask[0, 0, 1] = 0.0
    return mask


GATE_CELLS = [("merged", "tree", "ag_packed"), ("merged", "flat", "fused"),
              ("stream", "flat", "fused"), ("stream", "tree", "ar_int8")]


@pytest.mark.parametrize("mode,layout,transport", GATE_CELLS)
def test_ef_residual_carries_forward_for_masked_clients(mode, layout,
                                                        transport):
    """After one step from zero residuals (no DC delta yet: it is staged),
    a masked client's residual is its whole gradient, ``e' = u``; a live
    one's is ``u - mean|u| * sgn(u)`` per leaf; and pod 1, whose quorum
    is empty, keeps its model."""
    mask = client_mask()
    state, grads, w0 = gate_run("dc_hier_signsgd", mode, layout, transport,
                                mask, 1, error_feedback=True)
    ef = slot_tree(state.ef)
    live = mask.reshape(P, D * K) > 0
    for k, g in grads[0]["g"].items():
        u = g.reshape((P, D * K) + g.shape[3:])
        rows = P * D * K
        scale = signs.row_sums(u.abs().reshape(rows, -1)) / float(
            u[0, 0].numel())
        sent = scale.reshape((P, D * K) + (1,) * (u.dim() - 2)) * \
            signs.sgn(u).to(u.dtype)
        want = torch.where(live.reshape(live.shape + (1,) * (u.dim() - 2)),
                           u - sent, u)
        assert torch.equal(ef[k], want), k
        assert torch.equal(hier.edge_params(state)[k][1], w0[k]), k


@pytest.mark.parametrize("mode,layout,transport", GATE_CELLS)
@pytest.mark.parametrize("method", ["scaffold_hier_signsgd",
                                    "mtgc_hier_signsgd"])
def test_correction_gates(method, mode, layout, transport):
    """Round 0's prologue at a [P, D, K] mask: only clients with a live
    vote refresh their term (SCAFFOLD ``c_local <- a``, MTGC ``gamma <-
    c_q - a``), masked ones keep theirs (zeros here); MTGC's cloud term
    of pod 1, whose whole quorum abstains, stays as it was while pod 0's
    is refreshed; SCAFFOLD's shared variate is one copy on both pods.
    The edge model of pod 1 does not move."""
    mask = client_mask()
    state, grads, w0 = gate_run(method, mode, layout, transport, mask, 1,
                                cloud_period=1)
    cl, ce = slot_tree(state.corr_cl), slot_tree(state.corr_edge)
    live = (mask.reshape(P, D * K) > 0)
    for k, g in grads[0]["g"].items():
        a = g.reshape((P, D * K) + g.shape[3:])
        gate = live.reshape(live.shape + (1,) * (a.dim() - 2))
        assert not cl[k][~live].any(), k
        if method == "scaffold_hier_signsgd":
            assert torch.equal(cl[k], torch.where(gate, a, 0.0)), k
            assert torch.equal(ce[k][0], ce[k][1]) and ce[k].any(), k
        else:
            assert not ce[k][1].any() and ce[k][0].any(), k
            assert cl[k][live].any(), k
        assert torch.equal(hier.edge_params(state)[k][1], w0[k]), k


def test_mtgc_cloud_term_waits_for_its_period():
    """cloud_period=2: round 1's prologue refreshes gamma but keeps eta."""
    ones = torch.ones(P, D, K)
    after0, _, _ = gate_run("mtgc_hier_signsgd", "merged", "tree",
                            "ag_packed", ones, 3, cloud_period=2)
    after1, _, _ = gate_run("mtgc_hier_signsgd", "merged", "tree",
                            "ag_packed", ones, 4, cloud_period=2)
    for k in SHAPES:
        assert torch.equal(after0.corr_edge[k], after1.corr_edge[k]), k
        assert not torch.equal(after0.corr_cl[k], after1.corr_cl[k]), k


@pytest.mark.parametrize("method", ["scaffold_hier_signsgd",
                                    "mtgc_hier_signsgd"])
def test_corrections_refresh_every_device_without_clients(method):
    """Without virtual clients the refresh is unconditional: a device
    masked out of the vote still takes its fresh term (the reference's
    legacy path)."""
    mask = torch.ones(P, D)
    mask[0, 1] = 0.0
    state, grads, _ = gate_run(method, "merged", "tree", "ag_packed", mask,
                               1, virtual=False, cloud_period=1)
    for k, g in grads[0]["g"].items():
        a = g[:, :, 0]
        if method == "scaffold_hier_signsgd":
            assert torch.equal(state.corr_cl[k], a), k
        else:
            assert state.corr_cl[k][0, 1].any(), k


@pytest.mark.parametrize("overlap", ["sync", "overlap"])
@pytest.mark.parametrize("momentum", [0.0, 0.9], ids=["no_mom", "mom"])
@pytest.mark.parametrize("ef", [False, True], ids=["no_ef", "ef"])
@pytest.mark.parametrize("method", hier.ALL_METHODS)
def test_every_combination_builds_runs_and_agrees(method, ef, momentum,
                                                  overlap):
    """The whole option product -- six methods x EF x momentum x sync /
    overlap -- builds and runs in the 3 transports x 2 layouts x merged
    and stream (K=2, sampled weighted clients, injected gradients, two
    rounds of T_E=2), and all twelve runs end on the same bits.  (The
    mean methods read neither EF nor momentum, as in the reference.)"""
    gen = torch.Generator().manual_seed(31)
    grads = injected_grads.make_grads(SHAPES, P, D, K, 4, gen)
    w0 = {k: torch.randn(s, generator=gen) for k, s in SHAPES.items()}
    ref = None
    for mode in ("merged", "stream"):
        cc = hier.vclients.ClientConfig(**{**H.client_cfg(
            P, D, K, "sampled_weighted").__dict__, "mode": mode})
        for transport, layout in CELLS:
            algo = hier.AlgoConfig(
                method=method, mu=MU, t_e=2, rho=RHO, transport=transport,
                state_layout=layout, error_feedback=ef, momentum=momentum,
                cloud_overlap=overlap, cloud_period=1,
                compute_dtype=torch.float32, delta_dtype=torch.float32,
                clients=cc)
            init_fn, step = hier.make_hier_step(
                Topology(P, D, "cpu"), algo, injected_grads.make_bundle())
            state = init_fn(w0)
            for s, g in enumerate(grads):
                state, metrics = step(state, {"train": g,
                                              "anchor": grads[s - s % 2]},
                                      torch.full((P,), 1.0 / P),
                                      torch.ones(P, D), torch.ones(P, D))
                assert torch.isfinite(metrics["loss"])
            got = hier.edge_params(state)
            if ref is None:
                ref = {k: v.clone() for k, v in got.items()}
                assert any(not torch.equal(ref[k][None], w0[k][None])
                           for k in ref)
            for k, v in got.items():
                assert torch.equal(v, ref[k]), (mode, transport, layout, k)
