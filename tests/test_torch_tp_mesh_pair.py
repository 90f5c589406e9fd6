"""The parity toy's matrix over 1 pod x 1 data x 2 model CPU ranks: each
rank holds the whole P=2 x D=2 hierarchy (a 2 x 2 block) and one model
shard, so the votes and means stay in the process and only the model
axis splits.  The same cells and checks as ``tests/test_torch_tp_mesh.py``
(bitwise the one-process run on logical coordinates, QSGD and EF at atol
1e-5, the copies bitwise across the two model ranks)."""
import functools
import pathlib
import sys

import pytest
import torch

sys.path.insert(0, str(pathlib.Path(__file__).parent))
sys.path.insert(0, str(pathlib.Path(__file__).parent / "helpers"))
import torch_tp_worker as W  # noqa: E402
from test_torch_tp_mesh import CELLS, check_cell, job  # noqa: E402

GRID, BLOCK = (1, 1, 2), (2, 2)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def mesh_run() -> dict:
    return W.run_mesh(*GRID, BLOCK, job(2, 2))


@pytest.mark.parametrize("cell", CELLS)
def test_tp_pair_cell_matches_the_one_process_run(cell):
    res = mesh_run()
    assert res["blocks"] == BLOCK
    check_cell(res, cell)
