"""How far gemma3-1b's tensor-parallel gradients fall from one process's,
sound and with a model collective dropped: the readings behind the limit
that ``chip_smoke.py``'s ``tp`` phase puts on step 0's gradients
(``TP_STEP0_REL``).

gemma3-1b's smoke config (seed-0 parameters, seed-0 tokens [2, 2, 2,
16]) on a 1 x 1 x 2 gloo mesh of CPU ranks, each rank the whole P=2 x
D=2 block (``torch_tp_worker.run_mesh``), in float32 and in bfloat16:
every gradient leaf gathered over the model group against the
one-process port's, as the ``tp`` phase measures it -- the largest
``max|a - b| / max|b|`` over the leaves -- and the share of coordinates
that differ, for the sound port and for each of ``sum_model`` and
``copy_to_model`` replaced by the identity in the ranks.  Prints one
JSON object.  Run it as

    PYTHONPATH=src python tests/helpers/torch_tp_step0_bound.py

(about a minute on a few CPU cores).  Imports torch, numpy and the port.
"""
from __future__ import annotations

import json
import pathlib
import sys

HERE = pathlib.Path(__file__).resolve().parent
sys.path[:0] = [str(HERE.parents[1] / "src"), str(HERE)]

import numpy as np  # noqa: E402
import torch  # noqa: E402

import torch_tp_worker as W  # noqa: E402

from repro_torch import configs  # noqa: E402
from repro_torch.convert import params_to_numpy  # noqa: E402
from repro_torch.core import pytree  # noqa: E402
from repro_torch.core.topology import Topology  # noqa: E402
from repro_torch.models import build  # noqa: E402

DROPPED = {"sound": (), "no_sum_model": ("sum_model",),
           "no_copy_to_model": ("copy_to_model",)}


def reading(got: list, want: list) -> dict:
    worst, differ, n = 0.0, 0, 0
    for a, b in zip(got, want):
        a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
        worst = max(worst, float(np.abs(a - b).max())
                    / max(float(np.abs(b).max()), 1e-30))
        differ += int((a != b).sum())
        n += b.size
    return {"max_rel_diff": worst, "differing_share": differ / n}


def main() -> None:
    torch.set_num_threads(1)
    cfg = configs.get_smoke("gemma3_1b")
    built = build.build_model(cfg, Topology(1, 1, "cpu"))
    params = params_to_numpy(built.init_params(
        torch.Generator().manual_seed(0)))
    tokens = np.random.default_rng(0).integers(
        0, cfg.vocab, (2, 2, 2, 16)).astype(np.int64)
    out = {}
    for dtype in ("float32", "bfloat16"):
        spec = {"arch": "gemma3_1b", "params": params, "tokens": tokens,
                "dtype": dtype}
        want = pytree.tree_flatten(W.dense_grads(
            Topology(2, 2, "cpu"), spec)["grads"])[0]
        for name, dropped in DROPPED.items():
            got = W.run_mesh(1, 1, 2, (2, 2), {"dense": {"lm": spec},
                                               "identity": dropped})
            out[f"{dtype}/{name}"] = reading(
                pytree.tree_flatten(got["dense"]["lm"]["grads"])[0], want)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
