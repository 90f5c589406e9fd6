"""Flat-buffer bucketization: one contiguous view of a parameter tree.

The unsharded (``shards=1``) form of the JAX package's
``core/flatbuf.py``, slot for slot.  A static layout places every leaf
of a tree at a coordinate range ``[offset, offset + size)`` of ONE
``[*batch, n_pad]`` buffer, so the sign -> pack -> vote -> update sweep
runs over one tensor instead of per leaf:

  * ``offset % 32 == 0`` (each leaf padded to the 32-bit pack word), so
    the float and packed-word domains share one layout: leaf i's words
    are ``[offset/32, (offset + padded)/32)``;
  * the total is padded to ``TILE = 4096`` coordinates, so the kernels
    need no further padding;
  * the buffer dtype is the promotion of the leaf dtypes (widening, so
    ``unflatten_tree(flatten_tree(t))`` restores every leaf exactly).

Float padding is 0 and ``sgn(0) = +1``, bit-identical to
``signs.pack_signs``'s all-ones tail bits, so ``pack_tree(layout, t) ==
pack_signs(sgn(flatten_tree(layout, t)))`` bitwise.  Padding coordinates
are don't-care: the fused update sweeps them, no view reads them.

With ``AlgoConfig(state_layout="flat")`` the buffer is the persistent
master state (:class:`FlatState`); leaf views are materialized only at
the loss boundary.  Views from :func:`unflatten_tree` alias the buffer.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any

import torch

from repro_torch.core import pytree, signs

PyTree = Any

PACK = signs.PACK_WIDTH          # 32 sign bits per word
LANES = 128                      # kept from the TPU layout: slot offsets
TILE = PACK * LANES              # and n_pad match the JAX package's


def _ceil_to(x: int, m: int) -> int:
    return -(-x // m) * m


def scaled(x: torch.Tensor, s: float) -> torch.Tensor:
    """``s * x`` with ``s`` rounded to x's dtype first -- JAX's rule for a
    Python scalar meeting an array (a bf16 array is scaled by bf16(s),
    not by f32(s))."""
    return x * torch.tensor(s, dtype=x.dtype, device=x.device)


@dataclasses.dataclass(frozen=True)
class LeafSlot:
    """Static placement of one leaf inside the flat buffer."""
    shape: tuple[int, ...]       # leaf dims (batch dims excluded)
    dtype: torch.dtype           # original leaf dtype (restored on unflatten)
    size: int                    # prod(shape)
    padded: int                  # size padded to a PACK multiple
    offset: int                  # coordinate offset; offset % PACK == 0

    @property
    def word_offset(self) -> int:
        return self.offset // PACK

    @property
    def words(self) -> int:
        return self.padded // PACK


@dataclasses.dataclass(frozen=True)
class FlatLayout:
    """Static layout of a tree as one tile-aligned flat buffer."""
    treedef: pytree.TreeDef
    slots: tuple[LeafSlot, ...]
    n: int                       # real coordinates
    n_pad: int                   # buffer length; n_pad % TILE == 0
    dtype: torch.dtype           # promoted dtype of the flat buffer

    @property
    def n_words(self) -> int:
        return self.n_pad // PACK


class FlatState:
    """One flat buffer + its static :class:`FlatLayout`."""

    __slots__ = ("buf", "layout", "batch_dims")

    def __init__(self, buf: torch.Tensor, layout: FlatLayout,
                 batch_dims: int = 1):
        self.buf = buf
        self.layout = layout
        self.batch_dims = batch_dims

    def tree(self, cast: bool = True) -> PyTree:
        """The leaf views (slice/reshape of the buffer, no copy)."""
        return unflatten_tree(self.layout, self.buf,
                              batch_dims=self.batch_dims, cast=cast)

    def replace(self, buf: torch.Tensor) -> "FlatState":
        return FlatState(buf, self.layout, self.batch_dims)

    def __repr__(self):
        return (f"FlatState(buf={tuple(self.buf.shape)}, n={self.layout.n}, "
                f"n_pad={self.layout.n_pad}, batch_dims={self.batch_dims})")


def from_tree(tree: PyTree, batch_dims: int = 0) -> FlatState:
    """Lay out and flatten ``tree`` into a :class:`FlatState` in one
    call."""
    layout = make_layout(tree, batch_dims=batch_dims)
    return FlatState(flatten_tree(layout, tree, batch_dims=batch_dims),
                     layout, batch_dims)


def with_dtype(layout: FlatLayout, dtype: torch.dtype) -> FlatLayout:
    """The same coordinate layout, re-labeled for a buffer of ``dtype``
    (delta / EF buffers share the master's geometry)."""
    slots = tuple(dataclasses.replace(s, dtype=dtype) for s in layout.slots)
    return dataclasses.replace(layout, slots=slots, dtype=dtype)


def make_layout(tree: PyTree, batch_dims: int = 0,
                tile: int = TILE) -> FlatLayout:
    """Compute the static layout of ``tree`` (shapes and dtypes only).

    batch_dims: leading dims shared by every leaf (2 for ``[P, D, *leaf]``
    per-device gradients) that stay un-flattened.  Leaves are all float
    or all signed integer (a mixed promotion could corrupt ints)."""
    leaves, treedef = pytree.tree_flatten(tree)
    if not leaves:
        raise ValueError("cannot lay out an empty tree")
    kinds = set()
    for leaf in leaves:
        if leaf.dtype.is_floating_point:
            kinds.add("float")
        elif leaf.dtype in (torch.int8, torch.int16, torch.int32,
                            torch.int64):
            kinds.add("int")
        else:
            raise ValueError("flatbuf only buckets float / signed-int "
                             f"leaves, got {leaf.dtype}")
    if len(kinds) > 1:
        raise ValueError("flatbuf trees must not mix int and float leaves")
    slots, offset, dtype = [], 0, None
    for leaf in leaves:
        shape = tuple(leaf.shape[batch_dims:])
        size = int(functools.reduce(lambda a, b: a * b, shape, 1))
        padded = _ceil_to(max(size, 1), PACK)
        slots.append(LeafSlot(shape=shape, dtype=leaf.dtype, size=size,
                              padded=padded, offset=offset))
        offset += padded
        dtype = (leaf.dtype if dtype is None
                 else torch.promote_types(dtype, leaf.dtype))
    return FlatLayout(treedef=treedef, slots=tuple(slots),
                      n=sum(s.size for s in slots),
                      n_pad=_ceil_to(offset, tile), dtype=dtype)


def flatten_tree(layout: FlatLayout, tree: PyTree, batch_dims: int = 0,
                 dtype: torch.dtype | None = None) -> torch.Tensor:
    """tree -> a new ``[*batch, n_pad]`` buffer in the buffer dtype."""
    dtype = layout.dtype if dtype is None else dtype
    leaves = pytree.flatten_up_to(layout.treedef, tree)
    batch = tuple(leaves[0].shape[:batch_dims])
    buf = torch.zeros(batch + (layout.n_pad,), dtype=dtype,
                      device=leaves[0].device)
    for s, leaf in zip(layout.slots, leaves):
        buf[..., s.offset:s.offset + s.size] = leaf.reshape(
            batch + (s.size,)).to(dtype)
    return buf


def unflatten_tree(layout: FlatLayout, buf: torch.Tensor, batch_dims: int = 0,
                   cast: bool = True) -> PyTree:
    """``[*batch, n_pad]`` buffer -> tree of slice views.

    cast=True restores each leaf's dtype (a copy when it differs from the
    buffer's); cast=False keeps ``buf.dtype`` (e.g. int8 votes)."""
    batch = tuple(buf.shape[:batch_dims])
    leaves = []
    for s in layout.slots:
        leaf = buf[..., s.offset:s.offset + s.size].reshape(batch + s.shape)
        leaves.append(leaf.to(s.dtype) if cast else leaf)
    return pytree.tree_unflatten(layout.treedef, leaves)


def _with_mid_axes(x: torch.Tensor, batch_dims: int, target_batch: int):
    """[*b, n] -> [*b, 1...1, n] broadcastable against target_batch dims."""
    for _ in range(target_batch - batch_dims):
        x = x.unsqueeze(-2)
    return x


def pack_tree(layout: FlatLayout, tree: PyTree, batch_dims: int = 0,
              delta: PyTree | None = None, rho: float = 0.0,
              delta_batch_dims: int = 0) -> torch.Tensor:
    """Per-leaf (u + rho*delta) -> sign -> 1-bit pack, concatenated at the
    word level: ``[*batch, n_pad/32]`` int32.

    The correction is added in each leaf's own dtype, exactly like the
    per-leaf tree path, so the votes stay bit-identical to ``ag_packed``;
    the full-precision flat buffer never forms.  Tail words are all ones
    (+1 signs), matching ``pack_signs`` padding."""
    leaves = pytree.flatten_up_to(layout.treedef, tree)
    dl_leaves = (pytree.flatten_up_to(layout.treedef, delta)
                 if delta is not None else [None] * len(leaves))
    parts = []
    for slot, leaf, dl in zip(layout.slots, leaves, dl_leaves):
        batch = tuple(leaf.shape[:batch_dims])
        if slot.size == 0:       # an empty leaf still holds `words` words
            parts.append(torch.full(batch + (slot.words,), -1,
                                    dtype=torch.int32, device=leaf.device))
            continue
        u = leaf.reshape(batch + (slot.size,))
        if dl is not None and rho:
            dlf = dl.reshape(tuple(dl.shape[:delta_batch_dims])
                             + (slot.size,))
            dlf = _with_mid_axes(dlf, delta_batch_dims, batch_dims)
            u = u + scaled(dlf.to(u.dtype), rho)
        parts.append(signs.pack_signs(signs.sgn(u)))        # +1 tail bits
    words = torch.cat(parts, dim=-1)
    tail = layout.n_words - words.shape[-1]
    if tail:
        words = torch.cat([words, words.new_full(
            words.shape[:-1] + (tail,), -1)], dim=-1)
    return words
