"""The mesh's shared host memory (``core.host_exchange``): all-gathers and
all-to-alls among ranks of one host through files they all map, in
place of the backend's.

One spawn of 2 pods x 2 data x 2 model gloo CPU ranks (blocks 1 x 1),
built with ``make_host_topology(shared_dir=...)`` and a piece of 4096
bytes, so that a tensor crosses in many pieces through both halves of
each slot:

  * every all-gather and the all-to-all of ``core.comm`` -- the data,
    pod and model groups, dims 0 to 3, float32, bfloat16, bool, int32
    and int8, ``all_gather_model``'s two backwards -- has the bits of
    the backend's on a second mesh over the same ranks, and
    ``comm.traffic`` the same counts, on every rank;
  * the parity toy's cells (``tests/helpers/torch_tp_worker.py``, h =
    65: padded shard blocks) train through it bitwise the one-process
    run (QSGD at atol 1e-5, as in ``tests/test_torch_tp_mesh.py``);
  * no slot file is left in the directory.
"""
import functools
import pathlib
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, str(pathlib.Path(__file__).parent / "helpers"))
import torch_tp_worker as W  # noqa: E402

from repro_torch.core.topology import Topology  # noqa: E402

GRID, BLOCK, P, D, HID = (2, 2, 2), (1, 1), 2, 2, 65
PIECE = 4096
CELLS = ("dc/fused/flat", "dc/ag_packed/tree", "dc/fused/flat/K2-stream",
         "qsgd/fused/flat", "scaffold/ar_int8/flat")
OPS = ("gather_devices", "gather_pods", "gather_pods bf16",
       "gather_pods bool", "gather_shards dim 2", "gather_shards int32",
       "scatter_shards", "scatter_shards int8", "gather_model dim 3",
       "all_gather_model slice", "all_gather_model sum")


def cells() -> dict:
    every = W.cells(P, D, HID)
    return {c: every[f"h{HID}/{c}"] for c in CELLS}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def mesh_run() -> dict:
    return W.run_mesh(*GRID, BLOCK, {"cells": cells(), "shared": True,
                                     "piece": PIECE, "exchange": 5})


@pytest.mark.parametrize("op", OPS)
def test_shared_memory_gathers_match_the_backend(op):
    res = mesh_run()
    assert set(res["exchange"]) == set(OPS)
    per_rank = res["exchange"][op]
    assert len(per_rank) == 8
    assert all(bits for bits, _ in per_rank), f"{op}: bits differ"
    assert all(counted for _, counted in per_rank), f"{op}: traffic differs"


def test_no_slot_file_is_left():
    assert mesh_run()["left"] == []


@pytest.mark.parametrize("cell", CELLS)
def test_shared_memory_cell_matches_the_one_process_run(cell):
    got = mesh_run()["cells"][cell]
    want = W.run_cell(Topology(P, D, "cpu"), cells()[cell])
    assert got["shards"] == 2 and got["copies_agree"], cell
    assert got["state"]["step"] == want["state"]["step"]
    tolerant = W.held_at_tolerance(cell)
    for slot, tree in want["state"].items():
        if slot == "step" or tree is None:
            continue
        for k, w in tree.items():
            g, w = np.asarray(got["state"][slot][k]), np.asarray(w)
            assert g.shape == w.shape and g.dtype == w.dtype, (cell, k)
            if tolerant:
                np.testing.assert_allclose(g, w, rtol=0, atol=1e-5,
                                           err_msg=f"{cell}/{slot}/{k}")
            else:
                np.testing.assert_array_equal(
                    g.view(np.uint8), w.view(np.uint8),
                    err_msg=f"{cell}/{slot}/{k}")
    if tolerant:
        np.testing.assert_allclose(got["losses"], want["losses"], rtol=0,
                                   atol=1e-5)
    else:
        assert got["losses"] == want["losses"], cell
