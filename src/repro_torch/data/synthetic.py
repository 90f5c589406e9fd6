"""Deterministic synthetic LM token pipeline with two-level heterogeneity.

The JAX package's ``data/synthetic.py`` for the token stream.  The
paper's setting is *inter-cluster* statistical heterogeneity (edges
skewed).  For LM training each edge q draws tokens from its own
Zipf-like unigram distribution (a per-edge permutation + temperature of
a shared base distribution, mixing-parameter ``hetero``: 0 = IID).  On
top of that, ``alpha_client`` adds *intra-edge* heterogeneity: each
virtual client tilts its edge's unigram by a per-client
Dirichlet(alpha_client) reweighting, and client c's rows of the [P, D,
b, L] batch are drawn from ITS logits (rows [c*b/K, (c+1)*b/K) of slice
d belong to voter d*K + c, the carve contract).  ``edge_assign``
regroups clients across edges (``data.cluster``).

The logits are the JAX package's numpy code, bitwise.  The tokens are
not: no torch generator reproduces ``jax.random.categorical``'s
threefry draws, so edge q's tokens at a step come from a CPU
``torch.Generator`` seeded from (seed, step, q) (``torch.multinomial``
on the softmax of the logits in float64), drawn on the host, so the CPU
and the card get the same batch.  Tests that compare with the JAX
package hand both the same tokens.

``batch_at(step)`` is a pure function of (seed, step): restoring a step
counter resumes the stream (no iterator state to persist).

The encdec/audio family's stub audio frames (``frames`` > 0) are ``0.1``
times standard normals of shape [P, D, b, frames, frontend_dim], drawn
the same way from a CPU generator seeded from (seed, step,
``FRAMES_TAG``); the parity tests hand both packages the same frames.

The vlm family's stub vision patches (``n_patches`` > 0) are ``0.02``
times standard normals of shape [P, D, b, n_patches, d_model], drawn
the same way from a CPU generator seeded from (seed, step,
``PATCHES_TAG``), a key apart from the frames'.

``serve_request_batch`` draws a batch of serving prompts (uniform
tokens) from a CPU generator seeded from its ``seed``, where the JAX
package draws ``jax.random.randint``; whisper's requests add stub frames
and a vlm's stub patches, drawn as the stream's are.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.keys import key_seed
from repro_torch.data import cluster

FRAMES_TAG = 0xF4A3E5     # the frames' generator key, apart from the edges'
PATCHES_TAG = 0x9A7C4E    # the patches' key, apart from the frames'


@dataclasses.dataclass(frozen=True)
class LMStreamCfg:
    vocab: int
    seq_len: int
    batch_per_device: int
    pods: int
    devices_per_pod: int
    seed: int = 0
    skew: float = 1.2          # Zipf exponent of the base distribution
    hetero: float = 1.0        # 0 = IID edges, 1 = fully per-edge skewed
    clients_per_device: int = 1  # K virtual clients per slice: the train
                                 # step carves each device batch into K
                                 # contiguous per-client shards
                                 # (core.clients.carve_batch), so
                                 # batch_per_device must divide by K;
                                 # with alpha_client=None the K clients
                                 # share the edge distribution (the
                                 # paper's inter-edge-only setting)
    alpha_client: float | None = None  # intra-edge Dirichlet tilt of
                                 # each client's unigram; None or inf =
                                 # legacy per-edge stream, bitwise
    edge_assign: str = "fixed"   # fixed | random | clustered (see
                                 # data.cluster)
    frames: int = 0              # encdec/audio: stub audio frames a row
    frontend_dim: int = 0        # and their feature width
    n_patches: int = 0           # vlm: stub vision patches a row
    d_model: int = 0             # and their width


def _edge_logits(cfg: LMStreamCfg) -> np.ndarray:
    """[P, V] unigram logits per edge (numpy, deterministic)."""
    rng = np.random.default_rng(cfg.seed)
    base = -cfg.skew * np.log(np.arange(1, cfg.vocab + 1))
    logits = np.zeros((cfg.pods, cfg.vocab), np.float32)
    for q in range(cfg.pods):
        perm = rng.permutation(cfg.vocab)
        edge = base[perm]                       # edge-specific Zipf ranks
        logits[q] = cfg.hetero * edge + (1.0 - cfg.hetero) * base
    return logits


def _client_skew_active(cfg: LMStreamCfg) -> bool:
    return cfg.alpha_client is not None and np.isfinite(cfg.alpha_client)


def _client_logits(cfg: LMStreamCfg) -> np.ndarray:
    """[P, D, K, V] per-virtual-client unigram logits (numpy,
    deterministic): the edge logits tilted by log(V * Dirichlet
    (alpha_client)) per client -- a mean-zero perturbation in
    distribution space that vanishes as alpha_client -> inf -- then
    regrouped across edges per ``edge_assign``."""
    p, d, k = cfg.pods, cfg.devices_per_pod, cfg.clients_per_device
    out = np.broadcast_to(_edge_logits(cfg)[:, None, None, :],
                          (p, d, k, cfg.vocab)).copy()
    if _client_skew_active(cfg):
        rng = np.random.default_rng((cfg.seed, 0xA1FA))
        mix = rng.dirichlet(np.full(cfg.vocab, cfg.alpha_client),
                            size=(p, d, k))
        out += np.log(np.maximum(mix * cfg.vocab, 1e-20)).astype(
            np.float32)
    if cfg.edge_assign != "fixed":
        flat = out.reshape(p * d * k, cfg.vocab)
        if cfg.edge_assign == "random":
            assign = cluster.random_assignment(p * d * k, p, cfg.seed)
        else:
            # unigram sketches: each client contributes ONE aggregate
            # [V] distribution (softmax of its logits), never tokens
            probs = np.exp(flat - flat.max(axis=1, keepdims=True))
            sigs = cluster.sketch_signatures(
                probs / probs.sum(axis=1, keepdims=True))
            assign = cluster.cluster_edges(sigs, p)
        out = flat[cluster.assignment_order(assign, p)].reshape(out.shape)
    return out


def validate_scenario(cfg: LMStreamCfg) -> None:
    """Scenario-axis validation shared with the launch CLIs (they call
    this up front so a bad flag combination rejects before tracing)."""
    if cfg.edge_assign not in cluster.EDGE_ASSIGN_MODES:
        raise ValueError(
            f"unknown edge_assign {cfg.edge_assign!r}; expected one of "
            f"{cluster.EDGE_ASSIGN_MODES}")
    if cfg.alpha_client is not None and cfg.alpha_client <= 0:
        raise ValueError(
            f"alpha_client must be positive (or None): {cfg.alpha_client}")
    if cfg.edge_assign == "clustered":
        if cfg.clients_per_device == 1:
            raise ValueError(
                "clustered edge assignment regroups VIRTUAL clients, so "
                "the client carve must be active: clients_per_device > 1 "
                "(--clients_per_device)")
        if not _client_skew_active(cfg):
            raise ValueError(
                "clustered edge assignment needs --alpha_client: without "
                "intra-edge skew the edge's clients are identical and "
                "there is nothing to cluster")


def make_stream(cfg: LMStreamCfg):
    """Returns batch_at(step) -> {"tokens": [P, D, b, L] int64} on the
    CPU, with ``"frames"`` [P, D, b, frames, frontend_dim] float32 when
    ``cfg.frames`` and ``"patches"`` [P, D, b, n_patches, d_model]
    float32 when ``cfg.n_patches``.  Validates the carve contract and the scenario axes
    up front."""
    if cfg.batch_per_device % cfg.clients_per_device:
        raise ValueError(
            f"batch_per_device={cfg.batch_per_device} does not divide "
            f"into {cfg.clients_per_device} virtual clients per device")
    validate_scenario(cfg)
    per_client = _client_skew_active(cfg) or cfg.edge_assign != "fixed"
    logits = torch.from_numpy(_client_logits(cfg) if per_client
                              else _edge_logits(cfg)).to(torch.float64)
    probs = torch.softmax(logits, dim=-1)
    p, d, k_c = cfg.pods, cfg.devices_per_pod, cfg.clients_per_device
    rows = cfg.batch_per_device // k_c

    def batch_at(step: int):
        edges = []
        for q in range(p):
            gen = torch.Generator().manual_seed(key_seed(cfg.seed, step, q))
            if per_client:     # one distribution a client: [D*K, rows*L]
                toks = torch.multinomial(
                    probs[q].reshape(d * k_c, cfg.vocab), rows * cfg.seq_len,
                    replacement=True, generator=gen)
            else:              # the edge's: [D*b*L]
                toks = torch.multinomial(
                    probs[q], d * cfg.batch_per_device * cfg.seq_len,
                    replacement=True, generator=gen)
            edges.append(toks.reshape(d, cfg.batch_per_device, cfg.seq_len))
        batch = {"tokens": torch.stack(edges)}
        if cfg.frames:
            gen = torch.Generator().manual_seed(
                key_seed(cfg.seed, step, FRAMES_TAG))
            batch["frames"] = 0.1 * torch.randn(
                (p, d, cfg.batch_per_device, cfg.frames, cfg.frontend_dim),
                generator=gen)
        if cfg.n_patches:
            gen = torch.Generator().manual_seed(
                key_seed(cfg.seed, step, PATCHES_TAG))
            batch["patches"] = 0.02 * torch.randn(
                (p, d, cfg.batch_per_device, cfg.n_patches, cfg.d_model),
                generator=gen)
        return batch

    return batch_at


def serve_request_batch(cfg: LMStreamCfg, n_requests: int, prompt_len: int,
                        seed: int = 17) -> dict:
    """Batched serving requests on the CPU: ``{"tokens": [n_requests,
    prompt_len] int64}`` uniform over the vocabulary, with
    ``cfg.frames`` the requests' stub audio ``"frames"`` [n_requests,
    frames, frontend_dim] (``0.1`` times standard normals), and with
    ``cfg.n_patches`` their stub ``"patches"`` [n_requests, n_patches,
    d_model] (``0.02`` times standard normals)."""
    gen = torch.Generator().manual_seed(key_seed(seed))
    batch = {"tokens": torch.randint(0, cfg.vocab, (n_requests, prompt_len),
                                     generator=gen)}
    if cfg.frames:
        gen = torch.Generator().manual_seed(key_seed(seed, FRAMES_TAG))
        batch["frames"] = 0.1 * torch.randn(
            (n_requests, cfg.frames, cfg.frontend_dim), generator=gen)
    if cfg.n_patches:
        gen = torch.Generator().manual_seed(key_seed(seed, PATCHES_TAG))
        batch["patches"] = 0.02 * torch.randn(
            (n_requests, cfg.n_patches, cfg.d_model), generator=gen)
    return batch
