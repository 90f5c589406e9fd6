"""The model axis across processes: the parity toy's matrix on a gloo
mesh of 2 pods x 2 data x 2 model CPU ranks (8 ranks, blocks 1 x 1).

The toy's ``w`` [16, h] splits column-parallel and ``w2`` [h, 33]
row-parallel over the model axis (``TOY_SPECS``, the JAX parity
harness's Megatron specs); ``b`` is a copy in every bucket.  At h = 64
the blocks are even; at h = 65 both matrices shard as padded blocks
(``LeafSlot.shard_pad``).  Every cell -- the six methods x {ag_packed,
ar_int8, fused} x {tree, flat}; K=2 clients merged and stream under
Bernoulli(0.5); EF; momentum; the overlapped cloud -- trains 2 rounds of
T_E=3 on injected gradients (``tests/helpers/injected_grads.py``'s
tensor-parallel bundle), and its gathered final state on logical
coordinates (every slot, the zero tails dropped) and every step's loss
must be bitwise the port's one-process run; QSGD and EF, whose norms
and scales sum over the model group, are held at atol 1e-5 (the
multi-device atol of ``tests/helpers/parity_matrix_check.py``).  Every
copy leaf of every slot is bitwise the same on both model ranks after
every step, and the only model-group sums of a cell are QSGD's and EF's.
A flat cell's gathered master is the JAX sharded layout's multi-bucket
buffer; four cells gather their global state after round 1 and start
again from it (``convert.train_state_from_numpy``), bitwise the
uninterrupted run.
The ranks run in ``tests/helpers/torch_tp_worker.py`` (killed past 150
s); ``tests/test_torch_tp_mesh_pair.py`` runs the same matrix on 1 x 1 x
2 ranks.
"""
import functools
import pathlib
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, str(pathlib.Path(__file__).parent / "helpers"))
import torch_tp_worker as W  # noqa: E402

from repro_torch.core import flatbuf  # noqa: E402
from repro_torch.core.topology import Topology  # noqa: E402

GRID, BLOCK, P, D = (2, 2, 2), (1, 1), 2, 2
HIDS = (64, 65)
ATOL = 1e-5


def job(p: int, d: int) -> dict:
    cells = {}
    for hid in HIDS:
        cells.update(W.cells(p, d, hid))
    return {"cells": cells}


CELLS = list(job(P, D)["cells"])


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def mesh_run(grid=GRID, block=BLOCK) -> dict:
    return W.run_mesh(*grid, block, job(P, D))


@functools.lru_cache(maxsize=None)
def one_process(cell: str) -> dict:
    return W.run_cell(Topology(P, D, "cpu"), job(P, D)["cells"][cell])


def wl_params(want: dict) -> dict:
    return {k: np.asarray(v) for k, v in want["state"]["params"].items()}


def leaves(state: dict):
    for slot, tree in sorted(state.items()):
        if slot == "step" or tree is None:
            continue
        for k in sorted(tree):
            yield f"{slot}/{k}", np.asarray(tree[k])


def check_cell(res: dict, cell: str) -> None:
    got = res["cells"][cell]
    want = one_process(cell.removesuffix("/restarted"))
    assert got["shards"] == 2, cell
    assert got["copies_agree"], f"{cell}: a copy differs across model ranks"
    assert got["state"]["step"] == want["state"]["step"]
    wl = dict(leaves(want["state"]))
    gl = dict(leaves(got["state"]))
    assert set(gl) == set(wl), cell
    tolerant = W.held_at_tolerance(cell)
    for k, w in wl.items():
        g = gl[k]
        assert g.shape == w.shape and g.dtype == w.dtype, (cell, k)
        if tolerant:
            np.testing.assert_allclose(g, w, rtol=0, atol=ATOL,
                                       err_msg=f"{cell}/{k}")
        else:
            np.testing.assert_array_equal(g.view(np.uint8), w.view(np.uint8),
                                          err_msg=f"{cell}/{k}")
    if tolerant:
        np.testing.assert_allclose(got["losses"], want["losses"], rtol=0,
                                   atol=ATOL)
    else:
        assert got["losses"] == want["losses"], cell
    if got["buffer"] is not None:
        # the gathered master is the JAX sharded layout's global buffer
        lay = flatbuf.make_layout(
            {k: torch.from_numpy(v) for k, v in wl_params(want).items()},
            batch_dims=1, sharding=flatbuf.ModelSharding(2, "model",
                                                         W.TOY_SPECS))
        buf = torch.from_numpy(got["buffer"])
        assert buf.shape == (P, lay.n_pad)
        back = flatbuf.unflatten_tree(lay, buf, 1)
        for k, v in back.items():
            np.testing.assert_array_equal(v.numpy(),
                                          got["state"]["params"][k])
    # the words (or tallies) crossed the data group every local step;
    # the model group carried only QSGD's and EF's per-leaf sums
    t = got["traffic"]
    assert t["copy_to_model"]["calls"] == 0, cell
    assert (t["sum_model"]["calls"] > 0) == tolerant, (cell, t["sum_model"])


@pytest.mark.parametrize("cell", CELLS)
def test_tp_cell_matches_the_one_process_run(cell):
    res = mesh_run()
    assert res["blocks"] == BLOCK
    check_cell(res, cell)
