"""Serve a reduced model: batched prefill, then greedy decode over the
model's caches, straight from a flat-state checkpoint.

    PYTHONPATH=src python -m repro_torch.examples.serve_decode
    PYTHONPATH=src python -m repro_torch.examples.serve_decode --device cpu

The JAX package's ``examples/serve_decode.py`` on the port: the
parameters go into ONE ``[P, n_pad]`` flat buffer, as a flat-state
training run holds its master (``state_layout="flat"``),
``specs.serve_params_from_flat`` hands the model slice views of it (no
per-leaf tree is assembled), and a 4 x 24 prompt is prefilled and
decoded greedily for 15 more tokens -- on the card unless ``--device``
says otherwise.  As the JAX example, it serves zamba2's reduced config
(the hybrid family): the Mamba2 blocks' decode state is O(1) in the
sequence, and the tied shared-attention block keeps a KV cache for each
of its occurrences.
"""
import argparse
import time

import torch

from repro_torch import configs
from repro_torch.core import flatbuf, pytree
from repro_torch.core.topology import Topology
from repro_torch.data import synthetic
from repro_torch.launch import specs
from repro_torch.models import build


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = configs.get_smoke("zamba2_2p7b")  # hybrid SSM: O(1) decode state
    topo = Topology(1, 1, args.device)       # the card unless "cpu"
    device = topo.device
    built = build.build_model(cfg, topo)
    tree = built.init_params(torch.Generator(device=device).manual_seed(0))

    # what a flat-state training run checkpoints: ONE [P, n_pad] buffer
    # (P = 1 edge here); serving slices views out of it directly
    ckpt = flatbuf.from_tree(pytree.tree_map(lambda v: v[None], tree),
                             batch_dims=1)
    params = specs.serve_params_from_flat(built, ckpt)
    probe = pytree.tree_flatten(params)[0][0]
    assert torch.equal(probe, pytree.tree_flatten(tree)[0][0])
    assert (probe.untyped_storage().data_ptr()
            == ckpt.buf.untyped_storage().data_ptr())
    print(f"serving {ckpt.layout.n} params from a FlatState view "
          f"(n_pad={ckpt.layout.n_pad}, on {device})")

    b, prompt_len, gen = 4, 24, 16
    prompts = synthetic.serve_request_batch(
        synthetic.LMStreamCfg(vocab=cfg.vocab, seq_len=prompt_len,
                              batch_per_device=b, pods=1,
                              devices_per_pod=1),
        b, prompt_len, seed=1)["tokens"].to(device)

    logits, cache = built.prefill(params, {"tokens": prompts},
                                  max_len=prompt_len + gen)
    tok = torch.argmax(logits[:, -1:], dim=-1)
    out = [tok]
    t0 = time.perf_counter()
    for _ in range(gen - 1):
        logits, cache = built.decode_step(params, cache, tok)
        tok = torch.argmax(logits[:, -1:], dim=-1)
        out.append(tok)
    generated = torch.cat(out, dim=1).cpu()
    dt = time.perf_counter() - t0
    print(f"prompts {tuple(prompts.shape)} -> generated "
          f"{tuple(generated.shape)}")
    print(f"decode: {(gen - 1) * b / dt:.1f} tok/s (batch {b}, "
          f"{device.type}, reduced config)")
    print("sample token ids:", generated[0][:10].tolist())
    assert bool(torch.isfinite(logits).all())
    print("OK")


if __name__ == "__main__":
    main()
