"""Flat-buffer bucketization: one contiguous view of a parameter tree.

The JAX package's ``core/flatbuf.py``, slot for slot, its model-axis
sharded layouts included (below).  A static layout places every leaf
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

Model-axis sharded layouts (``make_layout(..., sharding=ModelSharding(
shards, "model", specs))``): the tree is laid out as ``shards`` equal
buckets, one a model rank.  A spec is a tuple over the leaf's dims of
None, an axis name or a tuple of names (or None for a replicated leaf).
A leaf whose spec names the axis on a nonzero dim contributes block m
of that dim (``LeafSlot.shard_dim``) to bucket m; an extent that does
not divide is zero-extended to ``shards * ceil(extent / shards)``
(``LeafSlot.shard_pad``, a don't-care tail like the tile padding).
Every other leaf is copied whole into every bucket.  Slots hold the
LOCAL (one bucket's) geometry; ``n_pad = shards * bucket_pad``, bucket
m the coordinates ``[m * bucket_pad, (m+1) * bucket_pad)``; and
``layout.bucket()`` is the ``shards=1`` layout of one bucket, which a
model rank uses on its own block (``core.shardflat``).  The global
(multi-bucket) ``flatten_tree`` / ``unflatten_tree`` / ``pack_tree``
here are the reference semantics a rank's bucket is held against.  A
sharding under which nothing shards normalises to ``shards=1``.
"""
from __future__ import annotations

import dataclasses
import functools
import warnings
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
    """Static placement of one leaf inside the flat buffer.  In a
    sharded layout the geometry is one bucket's: ``shape`` the block,
    ``offset`` within the bucket; ``shard_dim`` the leaf dim the model
    axis splits (None: a copy in every bucket) and ``shard_pad`` the
    zero rows that extend its global extent to a multiple of the
    shards (logical extent ``shape[shard_dim] * shards - shard_pad``)."""
    shape: tuple[int, ...]       # leaf dims (batch dims excluded)
    dtype: torch.dtype           # original leaf dtype (restored on unflatten)
    size: int                    # prod(shape)
    padded: int                  # size padded to a PACK multiple
    offset: int                  # coordinate offset; offset % PACK == 0
    shard_dim: int | None = None  # model-sharded leaf dim (sharded layouts)
    shard_pad: int = 0           # zero tail of the global shard_dim extent

    @property
    def word_offset(self) -> int:
        return self.offset // PACK

    @property
    def words(self) -> int:
        return self.padded // PACK

    def global_shape(self, shards: int) -> tuple[int, ...]:
        """The logical (unpadded) leaf shape this slot stores."""
        if self.shard_dim is None:
            return self.shape
        d = self.shard_dim
        return (self.shape[:d] + (self.shape[d] * shards - self.shard_pad,)
                + self.shape[d + 1:])

    def global_size(self, shards: int) -> int:
        """The real (logical) coordinates this slot stores."""
        return int(functools.reduce(lambda a, b: a * b,
                                    self.global_shape(shards), 1))

    def local_extent(self, shards: int, rank: int) -> int:
        """How many of model rank ``rank``'s ``shape[shard_dim]`` rows are
        logical (the rest is the zero tail)."""
        blk = self.shape[self.shard_dim]
        total = blk * shards - self.shard_pad
        return max(0, min(blk, total - rank * blk))


@dataclasses.dataclass(frozen=True)
class ModelSharding:
    """How the model axis divides a tree into buckets: ``specs`` is a
    tree of leaf specs (tuples over the leaf dims of None, an axis name
    or a tuple of names; None replicates), as ``ModelBundle.specs``.  A
    leaf shards on the first dim whose entry names ``axis`` and whose
    extent is nonzero."""
    shards: int
    axis: str
    specs: Any


@dataclasses.dataclass(frozen=True)
class FlatLayout:
    """Static layout of a tree as one tile-aligned flat buffer."""
    treedef: pytree.TreeDef
    slots: tuple[LeafSlot, ...]
    n: int                       # real coordinates
    n_pad: int                   # buffer length; n_pad % (shards*TILE) == 0
    dtype: torch.dtype           # promoted dtype of the flat buffer
    shards: int = 1              # model-axis buckets (1 = unsharded)

    @property
    def n_words(self) -> int:
        return self.n_pad // PACK

    @property
    def bucket_pad(self) -> int:
        """Coordinates a model-shard bucket (``n_pad`` when unsharded)."""
        return self.n_pad // self.shards

    @property
    def bucket_words(self) -> int:
        return self.bucket_pad // PACK

    def bucket(self) -> "FlatLayout":
        """The ``shards=1`` layout of ONE bucket (itself when unsharded):
        the same slot table over a ``bucket_pad``-long buffer."""
        if self.shards == 1:
            return self
        return dataclasses.replace(self, shards=1, n_pad=self.bucket_pad,
                                   n=sum(s.size for s in self.slots))

    def sharded(self, shards: int) -> "FlatLayout":
        """The inverse of :meth:`bucket`: the ``shards``-bucket layout
        whose bucket this is (itself when no slot shards)."""
        if shards == 1 or all(s.shard_dim is None for s in self.slots):
            return self
        n = sum(s.global_size(shards) for s in self.slots)
        return dataclasses.replace(self, shards=shards,
                                   n_pad=shards * self.n_pad, n=n)


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


def _leaf_keys(treedef: pytree.TreeDef, prefix: str = "") -> list[str]:
    """'/'-joined leaf paths in flatten order (the warning's names)."""
    if treedef.keys is None:
        return [prefix]
    out = []
    for k, c in zip(treedef.keys, treedef.children):
        out += _leaf_keys(c, f"{prefix}/{k}" if prefix else str(k))
    return out


@functools.lru_cache(maxsize=None)
def _warn_zero_copy(leaf_key: str, shape: tuple[int, ...], dim: int,
                    shards: int):
    warnings.warn(
        f"flatbuf sharded layout: leaf {leaf_key!r} (shape {shape}) is "
        f"model-sharded on zero-size dim {dim}; it carries no data, so "
        f"it is stored as a per-bucket COPY rather than {shards} padded "
        f"blocks.", stacklevel=3)


def _spec_shard_dim(spec, axis: str, shape: tuple[int, ...], shards: int,
                   leaf_key: str = "") -> int | None:
    """The leaf dim a spec shards over ``axis``: the first entry naming
    it, if that dim has a nonzero extent (an uneven extent shards too,
    as padded blocks); a zero-size dim warns and the leaf is a copy."""
    if spec is None:
        return None
    for i, entry in enumerate(spec):
        names = entry if isinstance(entry, tuple) else (entry,)
        if axis in names:
            if i < len(shape) and shape[i] > 0:
                return i
            if i < len(shape):
                _warn_zero_copy(leaf_key, shape, i, shards)
            return None
    return None


def make_layout(tree: PyTree, batch_dims: int = 0, tile: int = TILE,
                sharding: ModelSharding | None = None) -> FlatLayout:
    """Compute the static layout of ``tree`` (shapes and dtypes only).

    batch_dims: leading dims shared by every leaf (2 for ``[P, D, *leaf]``
    per-device gradients) that stay un-flattened.  Leaves are all float
    or all signed integer (a mixed promotion could corrupt ints).

    sharding: lay the tree out as model-shard buckets (the module
    docstring); it normalises to the unsharded layout when no leaf's
    spec names the axis on a nonzero dim."""
    leaves, treedef = pytree.tree_flatten(tree)
    if not leaves:
        raise ValueError("cannot lay out an empty tree")
    shards = sharding.shards if sharding is not None else 1
    spec_leaves = (pytree.flatten_up_to(treedef, sharding.specs)
                   if shards > 1 else [None] * len(leaves))
    keys = _leaf_keys(treedef)
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
    for leaf, spec, key in zip(leaves, spec_leaves, keys):
        shape = tuple(leaf.shape[batch_dims:])
        sd = (_spec_shard_dim(spec, sharding.axis, shape, shards, key)
              if shards > 1 else None)
        sp = 0
        if sd is not None:
            blk = -(-shape[sd] // shards)
            sp = blk * shards - shape[sd]
            shape = shape[:sd] + (blk,) + shape[sd + 1:]
        size = int(functools.reduce(lambda a, b: a * b, shape, 1))
        padded = _ceil_to(max(size, 1), PACK)
        slots.append(LeafSlot(shape=shape, dtype=leaf.dtype, size=size,
                              padded=padded, offset=offset, shard_dim=sd,
                              shard_pad=sp))
        offset += padded
        dtype = (leaf.dtype if dtype is None
                 else torch.promote_types(dtype, leaf.dtype))
    if shards > 1 and all(s.shard_dim is None for s in slots):
        shards = 1               # nothing shards: no M-way copies
    n = sum(s.global_size(shards) if s.shard_dim is not None else s.size
            for s in slots)
    return FlatLayout(treedef=treedef, slots=tuple(slots), n=n,
                      n_pad=shards * _ceil_to(offset, tile), dtype=dtype,
                      shards=shards)


def _pad_shard_tail(slot: LeafSlot, leaf: torch.Tensor,
                    batch_dims: int) -> torch.Tensor:
    """Zero-extend an uneven sharded leaf's shard_dim to blk * shards."""
    if slot.shard_dim is None or not slot.shard_pad:
        return leaf
    ax = batch_dims + slot.shard_dim
    shape = list(leaf.shape)
    shape[ax] = slot.shard_pad
    return torch.cat([leaf, leaf.new_zeros(shape)], dim=ax)


def pad_tree(layout: FlatLayout, tree: PyTree,
             batch_dims: int = 0) -> PyTree:
    """Logical tree -> the layout's padded-shard shapes (zero tails)."""
    leaves = pytree.flatten_up_to(layout.treedef, tree)
    return pytree.tree_unflatten(layout.treedef, [
        _pad_shard_tail(s, leaf, batch_dims)
        for s, leaf in zip(layout.slots, leaves)])


def unpad_tree(layout: FlatLayout, tree: PyTree,
               batch_dims: int = 0) -> PyTree:
    """Inverse of :func:`pad_tree`: each leaf cut back to its logical
    extent (the don't-care zero tail dropped; views)."""
    leaves = pytree.flatten_up_to(layout.treedef, tree)
    out = []
    for slot, leaf in zip(layout.slots, leaves):
        if slot.shard_dim is not None and slot.shard_pad:
            ax = batch_dims + slot.shard_dim
            leaf = leaf.narrow(ax, 0, leaf.shape[ax] - slot.shard_pad)
        out.append(leaf)
    return pytree.tree_unflatten(layout.treedef, out)


def slot_block(slot: LeafSlot, leaf: torch.Tensor, m: int, shards: int,
               batch_dims: int = 0) -> torch.Tensor:
    """Block m of a logical leaf along the slot's ``shard_dim`` (zero
    rows where it runs past the logical extent); a copy slot's leaf is
    returned whole."""
    if slot.shard_dim is None:
        return leaf
    ax = batch_dims + slot.shard_dim
    w = slot.shape[slot.shard_dim]
    keep = slot.local_extent(shards, m)
    block = leaf.narrow(ax, min(m * w, leaf.shape[ax]), keep)
    if keep < w:
        shape = list(block.shape)
        shape[ax] = w - keep
        block = torch.cat([block, block.new_zeros(shape)], dim=ax)
    return block


def bucket_tree(layout: FlatLayout, tree: PyTree, m: int,
                batch_dims: int = 0) -> PyTree:
    """Bucket m's local tree of a sharded layout: block m of every
    sharded leaf along its ``shard_dim`` (zero-extended where it runs
    past the logical extent) and the whole leaf for a copy -- what
    model rank m holds."""
    return pytree.tree_unflatten(layout.treedef, [
        slot_block(slot, leaf, m, layout.shards, batch_dims)
        for slot, leaf in zip(layout.slots, pytree.flatten_up_to(
            layout.treedef, tree))])


def bucket_trees(layout: FlatLayout, tree: PyTree,
                 batch_dims: int = 0) -> list[PyTree]:
    """Every bucket's local tree (:func:`bucket_tree`), in model order."""
    return [bucket_tree(layout, tree, m, batch_dims)
            for m in range(layout.shards)]


def flatten_tree(layout: FlatLayout, tree: PyTree, batch_dims: int = 0,
                 dtype: torch.dtype | None = None) -> torch.Tensor:
    """tree -> a new ``[*batch, n_pad]`` buffer in the buffer dtype.  A
    sharded layout builds each bucket from the blocks it owns."""
    if layout.shards > 1:
        bucket = layout.bucket()
        return torch.cat([flatten_tree(bucket, t, batch_dims, dtype)
                          for t in bucket_trees(layout, tree, batch_dims)],
                         dim=-1)
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
    buffer's); cast=False keeps ``buf.dtype`` (e.g. int8 votes).  A
    sharded layout concatenates each sharded leaf's blocks along its
    ``shard_dim`` and drops the zero tail (new tensors); a copy leaf is
    read from bucket 0."""
    if layout.shards > 1:
        bucket, bp = layout.bucket(), layout.bucket_pad
        parts = [pytree.flatten_up_to(bucket.treedef, unflatten_tree(
            bucket, buf[..., m * bp:(m + 1) * bp], batch_dims, cast))
            for m in range(layout.shards)]
        leaves = []
        for i, slot in enumerate(layout.slots):
            if slot.shard_dim is None:
                leaves.append(parts[0][i])
                continue
            ax = batch_dims + slot.shard_dim
            full = torch.cat([p[i] for p in parts], dim=ax)
            leaves.append(full.narrow(ax, 0, full.shape[ax]
                                      - slot.shard_pad))
        return pytree.tree_unflatten(layout.treedef, leaves)
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
    (+1 signs), matching ``pack_signs`` padding.  A sharded layout packs
    each bucket's blocks and concatenates the buckets' words."""
    if layout.shards > 1:
        bucket = layout.bucket()
        uts = bucket_trees(layout, tree, batch_dims)
        dts = (bucket_trees(layout, delta, delta_batch_dims)
               if delta is not None else [None] * layout.shards)
        return torch.cat([pack_tree(bucket, ut, batch_dims, dt, rho,
                                    delta_batch_dims)
                          for ut, dt in zip(uts, dts)], dim=-1)
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
