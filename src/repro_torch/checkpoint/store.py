"""Fault-tolerant checkpoint store (atomic, integrity-checked, keep-k).

The JAX package's ``checkpoint/store.py`` for the port's trees, in the
same format byte for byte, so a checkpoint of either package restores
into the other by its logical leaves.

Layout per checkpoint:
    <dir>/step_<N>.tmp-<pid>/   (written)   ->  <dir>/step_<N>/  (renamed)
        manifest.json           {step, crc32, leaves, flat_state}
        arrays.npz              flat leaves (key = leaf path)
    <dir>/LATEST                text file with the newest complete step

Atomicity: everything is written into a tmp dir and os.rename'd into
place (POSIX-atomic), LATEST updated last; a crash mid-write can never
corrupt an existing checkpoint.  ``restore_latest`` verifies CRCs (read
in chunks, so a checkpoint of many GB is never one ``bytes`` object) and
falls back to the previous checkpoint if the newest is damaged.

Keys are the JAX package's leaf paths: a dict key as it is, a list index
as its number, a NamedTuple field as ``.field``, joined by ``/`` -- a
``core.hier.TrainState`` saves ``.step`` (int32), ``.params/<leaf
path>`` (or ``.params`` for a flat buffer), ``.delta/...`` and ``.rng``;
None slots save nothing.  bfloat16 leaves are saved as float32 and cast
back on restore (exact).

The generator.  A JAX state's ``.rng`` is threefry key data, uint32[2].
The port's ``rng`` is a ``torch.Generator`` whose ``initial_seed()``
keys the QSGD streams; a port checkpoint saves that seed in the same
slot as uint32[2] ``[seed >> 32, seed & 0xffffffff]`` (the key data of
``jax.random.PRNGKey(seed)``) and lists the slot under the manifest's
``torch_seed``.  A checkpoint without that entry is JAX's: its ``.rng``
restores nothing -- the target's generator is kept, with a warning --
and every other slot restores as usual.

Flat state (``core.flatbuf.FlatState``): a FlatState node is saved as
its single buffer array plus a ``manifest["flat_state"]`` entry
recording the FlatLayout (slot table with per-slot LOGICAL global
shapes, n/n_pad, buffer dtype, model-shard count, per-slot shard dims
and uneven ``shard_pad`` tails; the port's layouts are unsharded).
Restore converts both ways: a flat checkpoint loads into a tree-state
``like`` (the buffer is sliced per slot -- sharded slots of a JAX
checkpoint reassemble their per-bucket blocks along ``shard_dim`` and
drop the uneven zero tail) and a tree checkpoint loads into a
flat-state ``like`` (the leaves are assembled into the buffer at their
slot offsets) -- in both directions only the real coordinates
transfer; tile/tail/shard padding is don't-care.  The slot table is
validated against the ``like`` layout; when the tables differ but every
logical leaf agrees (same keys, same global shapes -- e.g. a JAX
checkpoint of a model-sharded layout), restore goes through the tree
form.  Anything else raises naming the offending leaf and field.
"""
from __future__ import annotations

import json
import os
import pathlib
import shutil
import warnings
import zlib
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.core import flatbuf, pytree

PyTree = Any
SEP = "/"
CRC_CHUNK = 1 << 24                # bytes read at a time for the CRC


def _is_flat(x) -> bool:
    return isinstance(x, flatbuf.FlatState)


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _items_with_path(tree: PyTree, prefix: tuple = ()) -> list:
    """(path, leaf) pairs in the JAX package's leaf order: dict keys
    sorted, NamedTuple fields in order (``.field``), sequences by index;
    None holds no leaf; a FlatState is one leaf."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [kv for k in sorted(tree)
                for kv in _items_with_path(tree[k], prefix + (str(k),))]
    if _is_namedtuple(tree):
        return [kv for f in tree._fields
                for kv in _items_with_path(getattr(tree, f),
                                           prefix + (f".{f}",))]
    if isinstance(tree, (list, tuple)):
        return [kv for i, x in enumerate(tree)
                for kv in _items_with_path(x, prefix + (str(i),))]
    return [(prefix, tree)]


def _map(tree: PyTree, fn: Callable, prefix: tuple = ()) -> PyTree:
    """``fn(key, leaf)`` over the leaves of :func:`_items_with_path`,
    the structure kept."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _map(tree[k], fn, prefix + (str(k),)) for k in tree}
    if _is_namedtuple(tree):
        return type(tree)(*[_map(getattr(tree, f), fn, prefix + (f".{f}",))
                            for f in tree._fields])
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(x, fn, prefix + (str(i),))
                          for i, x in enumerate(tree))
    return fn(SEP.join(prefix), tree)


def _dtype_name(dtype) -> str:
    if isinstance(dtype, torch.dtype):
        return str(dtype).removeprefix("torch.")
    return str(np.dtype(dtype))


def _leaf_keys(layout: flatbuf.FlatLayout) -> list[str]:
    """Per-slot leaf path keys (relative to the FlatState node), in slot
    order -- the names the leaves would have been saved under in tree
    form, so conversion can match by KEY, not position."""
    skeleton = pytree.tree_unflatten(layout.treedef,
                                     list(range(len(layout.slots))))
    keys = [None] * len(layout.slots)
    for path, idx in _items_with_path(skeleton):
        keys[idx] = SEP.join(path)
    return keys


def _layout_meta(fs: flatbuf.FlatState) -> dict:
    """JSON-able FlatLayout record stored in the manifest (the JAX
    package's fields; the port's layouts hold one model shard)."""
    lay = fs.layout
    return {
        "n": lay.n,
        "n_pad": lay.n_pad,
        "shards": 1,
        "dtype": _dtype_name(lay.dtype),
        "batch_dims": fs.batch_dims,
        "slots": [{"key": key, "shape": list(s.shape),
                   "global_shape": list(s.shape),
                   "dtype": _dtype_name(s.dtype),
                   "size": s.size, "padded": s.padded, "offset": s.offset,
                   "shard_dim": None, "shard_pad": 0}
                  for key, s in zip(_leaf_keys(lay), lay.slots)],
    }


def _meta_global_shape(slot: dict, shards: int) -> tuple[int, ...]:
    """LOGICAL leaf shape a saved slot stores (old manifests lack the
    explicit ``global_shape``/``shard_pad`` fields -- derive it)."""
    if "global_shape" in slot:
        return tuple(slot["global_shape"])
    local = tuple(slot["shape"])
    sd = slot.get("shard_dim")
    if sd is None:
        return local
    sp = slot.get("shard_pad", 0)
    return local[:sd] + (local[sd] * shards - sp,) + local[sd + 1:]


def _slot_mismatch(meta: dict, like_fs: flatbuf.FlatState) -> str | None:
    """First difference between the saved slot table and the target's,
    as an actionable per-leaf message (None when they match exactly)."""
    layout = like_fs.layout
    if meta.get("shards", 1) != 1:
        return (f"shards: checkpoint has {meta.get('shards', 1)}, target "
                f"layout has 1")
    if meta["n_pad"] != layout.n_pad:
        return (f"n_pad: checkpoint has {meta['n_pad']}, target layout "
                f"has {layout.n_pad}")
    if meta["batch_dims"] != like_fs.batch_dims:
        return (f"batch_dims: checkpoint has {meta['batch_dims']}, "
                f"target has {like_fs.batch_dims}")
    if len(meta["slots"]) != len(layout.slots):
        return (f"slot count: checkpoint has {len(meta['slots'])} leaves, "
                f"target layout has {len(layout.slots)}")
    for key, slot, saved in zip(_leaf_keys(layout), layout.slots,
                                meta["slots"]):
        if saved["key"] != key:
            return (f"leaf {key!r}: checkpoint slot at the same position "
                    f"is keyed {saved['key']!r} (renamed/reordered leaf)")
        for field, ours, theirs in (
                ("shape", list(slot.shape), list(saved["shape"])),
                ("size", slot.size, saved["size"]),
                ("padded", slot.padded, saved["padded"]),
                ("offset", slot.offset, saved["offset"]),
                ("shard_dim", None, saved.get("shard_dim")),
                ("shard_pad", 0, saved.get("shard_pad", 0))):
            if ours != theirs:
                return (f"leaf {key!r}, field {field!r}: checkpoint has "
                        f"{theirs!r}, target layout has {ours!r}")
    return None


def _check_batch(arr_shape, like_fs: flatbuf.FlatState, where: str):
    """The saved buffer's leading (batch) dims must match the target's."""
    want = tuple(like_fs.buf.shape[:like_fs.batch_dims])
    got = tuple(arr_shape[:like_fs.batch_dims])
    if got != want:
        raise IOError(
            f"flat-state layout mismatch at {where!r}: checkpoint batch "
            f"shape {got}, target expects {want}")


def _to_numpy(x) -> np.ndarray:
    """A leaf as the numpy array it is saved as: bfloat16 widened to
    float32 (exact; restore casts back), a Python int as int32 where it
    fits (the JAX state's step counter is int32)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            x = x.to(torch.float32)
        return x.numpy()
    if isinstance(x, int) and -2**31 <= x < 2**31:
        return np.asarray(x, np.int32)
    return np.asarray(x)


def seed_words(seed: int) -> np.ndarray:
    """A generator's 64-bit seed as uint32[2], high word first (the key
    data of ``jax.random.PRNGKey(seed)``)."""
    return np.array([seed >> 32, seed & 0xFFFFFFFF], np.uint32)


def _flatten(tree: PyTree):
    """Storable dict: FlatState -> its buffer array (+ flat_state meta),
    a generator -> its seed words (+ the torch_seed key list)."""
    out, flat_meta, seeds = {}, {}, []
    for path, leaf in _items_with_path(tree):
        key = SEP.join(path)
        if _is_flat(leaf):
            flat_meta[key] = _layout_meta(leaf)
            leaf = leaf.buf
        if isinstance(leaf, torch.Generator):
            seeds.append(key)
            leaf = seed_words(leaf.initial_seed())
        out[key] = _to_numpy(leaf)
    return out, flat_meta, seeds


def to_host(tree: PyTree) -> PyTree:
    """Every tensor of ``tree`` copied to host memory, synchronously: the
    copy is complete when this returns, so a step that later overwrites
    the device buffers in place (the fused update) cannot reach it.  A
    host tensor is copied too, for the same reason."""
    def host(_key, x):
        if _is_flat(x):
            return x.replace(host(_key, x.buf))
        if isinstance(x, torch.Tensor):
            return x.detach().to("cpu", copy=True)
        return x
    return _map(tree, host)


def crc32_file(path: pathlib.Path) -> int:
    """``zlib.crc32`` of a file's bytes, read ``CRC_CHUNK`` at a time
    (the same value as over the whole file at once)."""
    crc = 0
    with open(path, "rb") as f:
        while chunk := f.read(CRC_CHUNK):
            crc = zlib.crc32(chunk, crc)
    return crc


def save(ckpt_dir: str | pathlib.Path, step: int, tree: PyTree,
         keep: int = 3) -> pathlib.Path:
    ckpt_dir = pathlib.Path(ckpt_dir)
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    final = ckpt_dir / f"step_{step:010d}"
    tmp = ckpt_dir / f"step_{step:010d}.tmp-{os.getpid()}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir()
    arrays, flat_meta, seeds = _flatten(tree)
    npz_path = tmp / "arrays.npz"
    np.savez(npz_path, **arrays)
    manifest = {
        "step": step,
        "crc32": crc32_file(npz_path),
        "leaves": {k: {"shape": list(v.shape), "dtype": str(v.dtype)}
                   for k, v in arrays.items()},
    }
    if flat_meta:
        manifest["flat_state"] = flat_meta
    if seeds:
        manifest["torch_seed"] = seeds
    (tmp / "manifest.json").write_text(json.dumps(manifest, indent=1))
    if final.exists():
        shutil.rmtree(final)
    os.rename(tmp, final)
    (ckpt_dir / "LATEST.tmp").write_text(str(step))
    os.rename(ckpt_dir / "LATEST.tmp", ckpt_dir / "LATEST")
    _gc(ckpt_dir, keep)
    return final


def _gc(ckpt_dir: pathlib.Path, keep: int):
    for s in available_steps(ckpt_dir)[:-keep]:
        shutil.rmtree(ckpt_dir / f"step_{s:010d}", ignore_errors=True)


def available_steps(ckpt_dir: str | pathlib.Path) -> list[int]:
    ckpt_dir = pathlib.Path(ckpt_dir)
    if not ckpt_dir.exists():
        return []
    return sorted(int(p.name.split("_")[1]) for p in ckpt_dir.glob(
        "step_*") if p.is_dir() and ".tmp" not in p.name)


def _verify(path: pathlib.Path) -> bool:
    try:
        manifest = json.loads((path / "manifest.json").read_text())
        return crc32_file(path / "arrays.npz") == manifest["crc32"]
    except Exception:
        return False


def _expand_flat_buf(buf: np.ndarray, meta: dict) -> dict:
    """Saved flat buffer -> {slot key: LOGICAL leaf array}, per its own
    manifest metadata: sharded slots reassemble their per-bucket blocks
    along ``shard_dim`` and drop the uneven ``shard_pad`` zero tail;
    per-bucket copies collapse to bucket 0 (bit-identical)."""
    bd = meta["batch_dims"]
    batch = tuple(buf.shape[:bd])
    shards = meta.get("shards", 1)
    bp = meta["n_pad"] // shards
    out = {}
    for slot in meta["slots"]:
        local = tuple(slot["shape"])
        sd = slot.get("shard_dim")
        off, size = slot["offset"], slot["size"]
        if sd is None:
            out[slot["key"]] = buf[..., off:off + size].reshape(
                batch + local)
            continue
        blocks = [buf[..., m * bp + off:m * bp + off + size
                      ].reshape(batch + local) for m in range(shards)]
        full = np.concatenate(blocks, axis=bd + sd)
        extent = _meta_global_shape(slot, shards)[sd]
        if full.shape[bd + sd] != extent:      # drop the shard zero tail
            full = full[(slice(None),) * (bd + sd) + (slice(0, extent),)]
        out[slot["key"]] = full
    return out


def _pack_flat_buf(arrs: dict, like_fs: flatbuf.FlatState,
                   where: str) -> np.ndarray:
    """{slot key: LOGICAL leaf array} -> the target layout's buffer.
    Raises naming the leaf on a missing key or a shape mismatch."""
    lay = like_fs.layout
    bd = like_fs.batch_dims
    batch = None
    parts = []
    for rel, slot in zip(_leaf_keys(lay), lay.slots):
        k = where + SEP + rel
        if rel not in arrs:
            raise IOError(
                f"checkpoint is missing leaf {k!r} for flat-state "
                f"target {where!r}")
        arr = arrs[rel]
        if tuple(arr.shape[bd:]) != tuple(slot.shape):
            raise IOError(
                f"flat-state leaf {k!r} has shape {arr.shape}, slot "
                f"expects {tuple(slot.shape)} after {bd} batch dims")
        _check_batch(arr.shape, like_fs, k)
        if batch is None:
            batch = arr.shape[:bd]
        parts.append((slot, arr))
    np_dtype = (np.float32 if lay.dtype == torch.bfloat16
                 else torch.empty(0, dtype=lay.dtype).numpy().dtype)
    buf = np.zeros(batch + (lay.n_pad,), np_dtype)
    for slot, arr in parts:
        buf[..., slot.offset:slot.offset + slot.size] = arr.reshape(
            batch + (slot.size,))
    return buf


def _assemble_flat(data, key: str, like_fs: flatbuf.FlatState) -> np.ndarray:
    """Tree checkpoint -> flat run: pack saved leaves into the buffer,
    matched BY KEY (``<key>/<leaf path>`` as the tree save wrote them),
    so a renamed or restructured leaf raises instead of silently landing
    in another slot's coordinates."""
    arrs = {rel: data[key + SEP + rel]
            for rel in _leaf_keys(like_fs.layout)
            if key + SEP + rel in data}
    return _pack_flat_buf(arrs, like_fs, key)


def _convert_flat(buf, meta: dict, key: str, like_fs: flatbuf.FlatState,
                  mismatch: str) -> np.ndarray:
    """Flat checkpoint whose layout differs from the flat target: go
    through the tree form.  Exact when every logical leaf agrees (same
    keys / global shapes) -- e.g. a JAX checkpoint of a model-sharded
    layout; anything else raises with the slot-level mismatch AND the
    leaf-level cause."""
    arrs = _expand_flat_buf(np.asarray(buf), meta)
    try:
        return _pack_flat_buf(arrs, like_fs, key)
    except IOError as e:
        raise IOError(
            f"flat-state layout mismatch at {key!r} ({mismatch}); "
            f"tree-form conversion also failed: {e}") from e


def _slice_flat(data, manifest: dict, like_keyed) -> dict:
    """Flat checkpoint -> tree run: slice saved buffers into leaf arrays.

    like_keyed: {key: leaf} of the target.  Saved flat buffers whose key
    is NOT a FlatState in the target are expanded under the slot keys
    the manifest recorded; the restore loop then matches the target's
    leaves by key, so renames/reorders fail loudly ("missing leaf")
    instead of shifting coordinates."""
    expanded = {}
    for q, meta in manifest.get("flat_state", {}).items():
        if _is_flat(like_keyed.get(q)):
            continue
        for rel, arr in _expand_flat_buf(data[q], meta).items():
            k = q + SEP + rel
            leaf = like_keyed.get(k)
            if leaf is not None and tuple(
                    getattr(leaf, "shape", arr.shape)) != arr.shape:
                raise IOError(
                    f"flat-state slot for {k!r} has shape {arr.shape}, "
                    f"target leaf expects {tuple(leaf.shape)}")
            expanded[k] = arr
    return expanded


def _tensor(arr: np.ndarray, like: torch.Tensor, key: str) -> torch.Tensor:
    """A saved array as a tensor of ``like``'s shape, dtype and device."""
    if tuple(arr.shape) != tuple(like.shape):
        raise IOError(f"leaf {key!r} has shape {tuple(arr.shape)}, target "
                      f"expects {tuple(like.shape)}")
    t = torch.from_numpy(np.ascontiguousarray(arr))
    return t.to(device=like.device, dtype=like.dtype)


def _put(arr, leaf, key: str, manifest: dict, where: pathlib.Path):
    if isinstance(leaf, torch.Generator):
        if key in manifest.get("torch_seed", ()):
            hi, lo = (int(x) for x in np.asarray(arr, np.uint64))
            return torch.Generator(device=leaf.device).manual_seed(
                (hi << 32) | lo)
        warnings.warn(
            f"{where}: {key!r} holds a jax.random key (a checkpoint of the "
            "JAX package), which has no torch counterpart; kept the "
            f"target's generator (seed {leaf.initial_seed()})", stacklevel=3)
        return leaf
    if isinstance(leaf, torch.Tensor):
        return _tensor(arr, leaf, key)
    if isinstance(leaf, int):
        return int(arr)
    return np.asarray(arr)


def _restore_verified(path: pathlib.Path, like: PyTree) -> PyTree:
    manifest = json.loads((path / "manifest.json").read_text())
    flat_meta = manifest.get("flat_state", {})
    keyed = [(SEP.join(p), leaf) for p, leaf in _items_with_path(like)]
    with np.load(path / "arrays.npz") as data:
        expanded = _slice_flat(data, manifest, dict(keyed))
        new = {}
        for key, leaf in keyed:
            if _is_flat(leaf):
                if key in flat_meta:              # flat -> flat
                    mismatch = _slot_mismatch(flat_meta[key], leaf)
                    if mismatch is None:
                        arr = data[key]
                        _check_batch(arr.shape, leaf, key)
                    else:                         # different flat layout:
                        arr = _convert_flat(      # go through the tree form
                            data[key], flat_meta[key], key, leaf, mismatch)
                else:                             # tree ckpt -> flat run
                    arr = _assemble_flat(data, key, leaf)
                new[key] = leaf.replace(_tensor(arr, leaf.buf, key))
            elif key in data.files and key not in flat_meta:
                new[key] = _put(data[key], leaf, key, manifest, path)
            elif key in expanded:                 # flat ckpt -> tree run
                new[key] = _put(expanded[key], leaf, key, manifest, path)
            else:
                raise IOError(f"checkpoint is missing leaf {key!r}")
    return _map(like, lambda key, _leaf: new[key])


def restore(ckpt_dir: str | pathlib.Path, step: int,
            like: PyTree) -> PyTree:
    """Restore into the structure, dtypes and devices of ``like``.

    ``like`` may mix tree- and flat-state (``flatbuf.FlatState``) nodes
    freely with respect to how the checkpoint was saved: flat <-> tree
    conversion happens here, validated against the manifest's FlatLayout
    metadata.  A flat checkpoint whose slot table differs from the flat
    target (a JAX checkpoint of a sharded layout, an old copy-style
    manifest) restores through the tree form when the logical leaves
    agree; a genuine structure mismatch raises naming the offending leaf
    and field."""
    path = pathlib.Path(ckpt_dir) / f"step_{step:010d}"
    if not _verify(path):
        raise IOError(f"checkpoint {path} failed integrity check")
    return _restore_verified(path, like)


def restore_latest(ckpt_dir: str | pathlib.Path, like: PyTree
                   ) -> tuple[int, PyTree] | None:
    """Newest intact checkpoint (skipping corrupted ones), or None."""
    for step in reversed(available_steps(ckpt_dir)):
        path = pathlib.Path(ckpt_dir) / f"step_{step:010d}"
        if _verify(path):
            return step, _restore_verified(path, like)
    return None
