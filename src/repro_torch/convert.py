"""Move parameters and flat buffers between numpy and the port.

A JAX parameter tree turned into numpy (``jax.tree.map(np.asarray, t)``)
is a dict of arrays; these helpers turn it into the port's tensors, and
back.  bfloat16 arrays (numpy dtype ``bfloat16`` from ``ml_dtypes``)
move through their 16-bit pattern, so every value survives bitwise.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.core import flatbuf, pytree

PyTree = Any


def tensor_from_numpy(a, device: str | torch.device = "cpu") -> torch.Tensor:
    """numpy array (any dtype torch has, or bfloat16) -> tensor, bitwise."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.int16).copy())
        return t.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.ascontiguousarray(a).copy()).to(device)


def tensor_to_numpy(t: torch.Tensor) -> np.ndarray:
    """tensor -> numpy array; bfloat16 comes back as float32 (exact)."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.to(torch.float32)
    return t.numpy()


def params_from_numpy(tree: PyTree,
                      device: str | torch.device = "cpu") -> PyTree:
    """A parameter tree with numpy leaves -> the same tree of tensors."""
    return pytree.tree_map(lambda a: tensor_from_numpy(a, device), tree)


def params_to_numpy(tree: PyTree) -> PyTree:
    return pytree.tree_map(tensor_to_numpy, tree)


def flat_state_from_numpy(buf, layout: flatbuf.FlatLayout,
                          batch_dims: int = 1,
                          device: str | torch.device = "cpu"
                          ) -> flatbuf.FlatState:
    """A ``[*batch, n_pad]`` numpy buffer laid out by ``layout`` (the
    port's layout of the same tree: offsets match the JAX package's slot
    for slot) -> a :class:`flatbuf.FlatState`."""
    t = tensor_from_numpy(buf, device)
    if t.shape[-1] != layout.n_pad:
        raise ValueError(f"buffer length {t.shape[-1]} != layout n_pad "
                         f"{layout.n_pad}")
    return flatbuf.FlatState(t, layout, batch_dims)
