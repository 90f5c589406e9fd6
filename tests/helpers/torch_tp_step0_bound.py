"""How far the tensor-parallel gradients fall from one process's, sound
and with a model collective dropped: the readings behind the limit that
``chip_smoke.py``'s ``tp`` phase puts on step 0's gradients
(``TP_STEP0_REL``) and behind the dtype it takes them in
(``TP_MOE_STEP0_DTYPE``, ``TP_FAM_STEP0_DTYPE``).

The smoke configs of gemma3-1b, deepseek-v3 (also with every expert
chosen and none dropped: top-k 8 of 8, capacity factor 2, so no
routing decision can flip), internvl2, xlstm (also at d_model 48 with 3
heads: the mixed layout), zamba2 (also at d_model 96: 3 Mamba2 heads;
every ``a_log`` lowered by 3, so that the SSD scan does not overflow)
and whisper (seed-0 parameters, seed-0 tokens [2, 2, 2, 16],
internvl2's patches, whisper's frames) on a 1 x 1 x 2 gloo mesh of
CPU ranks, each rank the whole P=2 x D=2 block
(``torch_tp_worker.run_mesh``), in float32 and in bfloat16: every
gradient leaf gathered over the model group against the one-process
port's, as the ``tp`` phase measures it -- the largest ``max|a - b| /
max|b|`` over the leaves -- and the share of coordinates that differ,
for the sound port and for each of ``sum_model`` and ``copy_to_model``
replaced by the identity in the ranks; and, in float32, how far the
one-process gradients themselves move when every parameter is scaled
by ``1 + 2e-7 z`` (z standard normal, seed 5: a rounding's worth), the
``"perturbed"`` reading.  Prints one JSON object, a key a config.  Run
it as

    PYTHONPATH=src python tests/helpers/torch_tp_step0_bound.py

(a few minutes on a few CPU cores).  Imports torch, numpy and the port.
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


CONFIGS = {      # name -> (arch, overridden fields)
    "gemma3_1b": ("gemma3_1b", {}),
    "deepseek_v3_671b": ("deepseek_v3_671b", {}),
    "deepseek_v3_671b, every expert": (
        "deepseek_v3_671b", {"moe": {"top_k": 8, "capacity_factor": 2.0}}),
    "internvl2_76b": ("internvl2_76b", {}),
    "xlstm_350m": ("xlstm_350m", {}),
    "xlstm_350m, 3 heads": ("xlstm_350m", {"d_model": 48, "n_heads": 3,
                                           "n_kv_heads": 3}),
    "zamba2_2p7b": ("zamba2_2p7b", {}),
    "zamba2_2p7b, 3 heads": ("zamba2_2p7b", {"d_model": 96}),
    "whisper_base": ("whisper_base", {}),
}
CALM = 3.0       # zamba2's a_log lowered by this


def main() -> None:
    torch.set_num_threads(1)
    out = {}
    for key, (arch, over) in CONFIGS.items():
        cfg = W.smoke_config(configs, arch, over)
        built = build.build_model(cfg, Topology(1, 1, "cpu"))
        params = params_to_numpy(built.init_params(
            torch.Generator().manual_seed(0)))
        if cfg.family == "hybrid":
            params["stacks"]["mamba"]["mamba"]["a_log"] -= np.float32(CALM)
        rng = np.random.default_rng(0)
        base = {"arch": arch, "overrides": over, "params": params,
                "tokens": rng.integers(0, cfg.vocab, (2, 2, 2, 16))
                .astype(np.int64)}
        if cfg.n_patches:
            base["patches"] = (0.02 * rng.standard_normal(
                (2, 2, 2, cfg.n_patches, cfg.d_model))).astype(np.float32)
        if cfg.encoder_layers:
            base["frames"] = (0.1 * rng.standard_normal(
                (2, 2, 2, cfg.encoder_frames, cfg.frontend_dim))).astype(
                    np.float32)
        out[key] = {}
        for dtype in ("float32", "bfloat16"):
            spec = dict(base, dtype=dtype)
            want = pytree.tree_flatten(W.dense_grads(
                Topology(2, 2, "cpu"), spec)["grads"])[0]
            for name, dropped in DROPPED.items():
                got = W.run_mesh(1, 1, 2, (2, 2), {"dense": {"lm": spec},
                                                   "identity": dropped})
                out[key][f"{dtype}/{name}"] = reading(
                    pytree.tree_flatten(got["dense"]["lm"]["grads"])[0],
                    want)
            if dtype == "float32":
                z = np.random.default_rng(5)
                moved = dict(spec, params=pytree.tree_map(
                    lambda x: (x * (1 + 2e-7 * z.standard_normal(x.shape)))
                    .astype(np.float32), params))
                out[key]["float32/perturbed"] = reading(
                    pytree.tree_flatten(W.dense_grads(
                        Topology(2, 2, "cpu"), moved)["grads"])[0], want)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
