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
corrupt an existing checkpoint.  ``restore_latest`` verifies CRCs and
falls back to the previous checkpoint if the newest is damaged.  A
restore reads ``arrays.npz`` once, into one host buffer, checks its
CRC there (a chunk at a time) and takes each stored member as a view
of that buffer (``_Members``): one pass over the file where the CRC's
read and ``np.load``'s chunked, CRC-checked member reads made three.

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
and uneven ``shard_pad`` tails: a mesh checkpoint's global buffer is
the sharded layout's, one bucket a model rank).
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

Under a process mesh (below :func:`restore_latest`) a run's checkpoint
is still one file, the JAX store's of the global state: rank 0 writes
it from the blocks the other ranks send it (:func:`gather_to_writer`,
``async_ckpt.AsyncSaver(..., topo=)``), and a restore is rank 0's
choice of step, each rank reading its block of the memory-mapped file
(:func:`restore_latest_mesh`, :func:`restore_block`).  The directory
must be one every rank reads: one host, or a file system they share.
"""
from __future__ import annotations

import concurrent.futures
import io
import json
import os
import pathlib
import shutil
import struct
import warnings
import zipfile
import zlib
from typing import Any, Callable

import numpy as np
import torch

from repro_torch import convert
from repro_torch.core import comm, flatbuf, pytree

PyTree = Any
SEP = "/"
CRC_CHUNK = 1 << 24                # bytes read at a time for the CRC
LANDING_THREADS = 8                # the mesh writer's copies of blocks


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
    package's fields: a mesh checkpoint's global multi-bucket layout
    records its model-shard count and each slot's shard dim, zero tail
    and logical global shape)."""
    lay = fs.layout
    return {
        "n": lay.n,
        "n_pad": lay.n_pad,
        "shards": lay.shards,
        "dtype": _dtype_name(lay.dtype),
        "batch_dims": fs.batch_dims,
        "slots": [{"key": key, "shape": list(s.shape),
                   "global_shape": list(s.global_shape(lay.shards)),
                   "dtype": _dtype_name(s.dtype),
                   "size": s.size, "padded": s.padded, "offset": s.offset,
                   "shard_dim": s.shard_dim, "shard_pad": s.shard_pad}
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
    if meta.get("shards", 1) != layout.shards:
        return (f"shards: checkpoint has {meta.get('shards', 1)}, target "
                f"layout has {layout.shards}")
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
                ("shard_dim", slot.shard_dim, saved.get("shard_dim")),
                ("shard_pad", slot.shard_pad, saved.get("shard_pad", 0))):
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


def _read_crc(path: pathlib.Path, out: np.ndarray | None = None) -> int:
    """``zlib.crc32`` of a file's bytes (the value over the whole file at
    once), read ``CRC_CHUNK`` at a time, each chunk's CRC taken on a
    helper thread while the next chunk is read (``zlib`` and the reads
    release the GIL): into ``out``, a uint8 array of the file's size,
    or through two buffers taken in turn."""
    spare = ([bytearray(CRC_CHUNK), bytearray(CRC_CHUNK)] if out is None
             else None)
    with open(path, "rb", buffering=0) as f, \
            concurrent.futures.ThreadPoolExecutor(1) as pool:
        size = os.fstat(f.fileno()).st_size
        futs = [pool.submit(int, 0)]
        for k, i in enumerate(range(0, size, CRC_CHUNK)):
            if out is None:
                if k >= 2:               # the buffer's last chunk is done
                    futs[k - 1].result()
                view = memoryview(spare[k % 2])
            else:
                view = memoryview(out)[i:i + CRC_CHUNK]
            n = f.readinto(view)
            futs.append(pool.submit(
                lambda v, prev: zlib.crc32(v, prev.result()), view[:n],
                futs[-1]))
        return futs[-1].result()


def crc32_file(path: pathlib.Path) -> int:
    """``zlib.crc32`` of a file's bytes, never the whole file in memory
    (:func:`_read_crc`)."""
    return _read_crc(path)


class _CrcWriter:
    """A file being written that keeps the CRC of the bytes written and
    cannot seek: ``zipfile`` then puts each member's sizes and CRC after
    its data (a data descriptor, which ``np.load`` and every zip reader
    take) instead of going back to its header, so the bytes written, in
    order, are the file and their CRC the file's -- ``np.savez``'s
    archive, without reading the file back for the CRC.  Each write's
    CRC is taken on ``pool``'s one thread while the file takes the
    bytes (``b`` is not changed until the save ends: a header's bytes
    or a view of a saved array)."""

    def __init__(self, f, pool):
        self._f, self._pos, self._pool = f, 0, pool
        self._crc = pool.submit(int, 0)

    def write(self, b) -> int:
        self._crc = self._pool.submit(
            lambda prev: zlib.crc32(b, prev.result()), self._crc)
        n = self._f.write(b)
        self._pos += n
        return n

    @property
    def crc(self) -> int:
        return self._crc.result()

    def tell(self) -> int:
        return self._pos

    def seek(self, *args):
        raise io.UnsupportedOperation("the checkpoint is written in order")

    def flush(self) -> None:
        self._f.flush()


def _write_member(z: zipfile.ZipFile, key: str, arr: np.ndarray) -> None:
    """``arr`` as the ``.npy`` member ``key``: ``np.save``'s bytes (a
    version 1.0 header), its data written from a view of the array
    ``CRC_CHUNK`` at a time, not copied first."""
    if not arr.flags.c_contiguous:
        arr = np.array(arr, order="C")
    with z.open(key + ".npy", "w", force_zip64=True) as fid:
        np.lib.format.write_array_header_1_0(
            fid, np.lib.format.header_data_from_array_1_0(arr))
        data = memoryview(arr.reshape(-1)).cast("B")
        for i in range(0, data.nbytes, CRC_CHUNK):
            fid.write(data[i:i + CRC_CHUNK])


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
    with open(tmp / "arrays.npz", "wb") as f, \
            concurrent.futures.ThreadPoolExecutor(1) as pool:
        out = _CrcWriter(f, pool)
        with zipfile.ZipFile(out, mode="w", compression=zipfile.ZIP_STORED,
                             allowZip64=True) as z:
            for key, arr in arrays.items():
                _write_member(z, key, arr)
        crc = out.crc
    manifest = {
        "step": step,
        "crc32": crc,
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


class _Members:
    """The arrays of an ``arrays.npz`` read into one host buffer, as
    ``np.load``'s ``NpzFile`` gives them (``files``, ``in``, ``[key]``):
    a stored member (this store and ``np.savez`` write no other) is a
    view of the buffer, others go through ``zipfile``.  A view whose
    data does not start on its dtype's alignment -- the zip's headers
    decide that -- is flagged unaligned; :func:`_tensor` moves it as
    bytes."""

    def __init__(self, path: pathlib.Path, buf: np.ndarray):
        self._buf, self._path = buf, path
        with zipfile.ZipFile(path) as z:
            infos = z.infolist()
        self._infos = {i.filename.removesuffix(".npy"): i for i in infos}
        self.files = list(self._infos)

    def __contains__(self, key) -> bool:
        return key in self._infos

    def __getitem__(self, key: str) -> np.ndarray:
        info = self._infos[key]
        if info.compress_type == zipfile.ZIP_STORED:
            arr = self._view(info)
            if arr is not None:
                return arr
        with zipfile.ZipFile(self._path) as z, z.open(info) as f:
            return np.lib.format.read_array(f)

    def _view(self, info: zipfile.ZipInfo) -> np.ndarray | None:
        off = info.header_offset
        name_len, extra_len = struct.unpack(
            "<HH", self._buf[off + 26:off + 30].tobytes())
        start = off + 30 + name_len + extra_len
        end = start + info.file_size
        head = io.BytesIO(self._buf[start:min(start + (1 << 16), end)]
                          .tobytes())
        version = np.lib.format.read_magic(head)
        read = {(1, 0): np.lib.format.read_array_header_1_0,
                (2, 0): np.lib.format.read_array_header_2_0}.get(version)
        if read is None:
            return None
        shape, fortran, dtype = read(head)
        if dtype.hasobject:
            return None
        count = int(np.prod(shape, dtype=np.int64))
        data = start + head.tell()
        if data + count * dtype.itemsize > end:
            raise IOError(f"{self._path}: member {info.filename!r} is "
                          "shorter than its header says")
        arr = np.frombuffer(self._buf, dtype=dtype, count=count, offset=data)
        return arr.reshape(shape, order="F" if fortran else "C")


def _read_verified(path: pathlib.Path):
    """``(manifest, members)`` of the checkpoint at ``path`` when its
    ``arrays.npz`` has the manifest's CRC, else None: the file read once
    into host memory and its CRC taken there, ``CRC_CHUNK`` at a time
    (the same value as :func:`crc32_file`'s)."""
    try:
        manifest = json.loads((path / "manifest.json").read_text())
        buf = np.empty(os.path.getsize(path / "arrays.npz"), np.uint8)
        crc = _read_crc(path / "arrays.npz", buf)
    except (OSError, ValueError):
        return None
    if crc != manifest.get("crc32"):
        return None
    return manifest, _Members(path / "arrays.npz", buf)


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
    """{slot key: LOGICAL leaf array} -> the target layout's buffer:
    zero-padded block per bucket for sharded slots, copies into every
    bucket otherwise.  Raises naming the leaf on a missing key or a
    global-shape mismatch."""
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
        want = slot.global_shape(lay.shards)
        if tuple(arr.shape[bd:]) != tuple(want):
            raise IOError(
                f"flat-state leaf {k!r} has shape {arr.shape}, slot "
                f"expects {tuple(want)} after {bd} batch dims")
        _check_batch(arr.shape, like_fs, k)
        if batch is None:
            batch = arr.shape[:bd]
        parts.append((slot, arr))
    np_dtype = (np.float32 if lay.dtype == torch.bfloat16
                else torch.empty(0, dtype=lay.dtype).numpy().dtype)
    buf = np.zeros(batch + (lay.n_pad,), np_dtype)
    bp = lay.bucket_pad
    for slot, arr in parts:
        if slot.shard_dim is None:    # a copy in every bucket
            blocks = [arr.reshape(batch + (slot.size,))] * lay.shards
        else:
            ax = bd + slot.shard_dim
            if slot.shard_pad:        # uneven: the zero shard tail
                pads = [(0, 0)] * arr.ndim
                pads[ax] = (0, slot.shard_pad)
                arr = np.pad(np.asarray(arr), pads)
            blocks = [b.reshape(batch + (slot.size,)) for b in np.split(
                arr, lay.shards, axis=ax)]
        for m, blk in enumerate(blocks):
            off = m * bp + slot.offset
            buf[..., off:off + slot.size] = blk
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
    if not arr.flags.aligned:      # a view of the read buffer
        if like.device.type == "cpu":
            arr = arr.copy()
        else:                      # its bytes cross, the card aligns them
            raw = torch.from_numpy(arr.reshape(-1).view(np.uint8))
            kind = torch.from_numpy(np.empty(0, arr.dtype)).dtype
            return raw.to(like.device).view(kind).reshape(arr.shape).to(
                dtype=like.dtype)
    t = torch.from_numpy(np.ascontiguousarray(arr))
    return t.to(device=like.device, dtype=like.dtype)


def _put(arr, leaf, key: str, manifest: dict, where: pathlib.Path,
         raw: bool = False):
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
        return _raw(arr, leaf, key) if raw else _tensor(arr, leaf, key)
    if isinstance(leaf, int):
        return int(arr)
    return np.asarray(arr)


def _raw(arr: np.ndarray, like: torch.Tensor, key: str) -> np.ndarray:
    """A saved array as it is (a view of the file where it can be),
    checked against ``like``'s shape."""
    if tuple(arr.shape) != tuple(like.shape):
        raise IOError(f"leaf {key!r} has shape {tuple(arr.shape)}, target "
                      f"expects {tuple(like.shape)}")
    return arr


def _restore_verified(path: pathlib.Path, like: PyTree, manifest: dict,
                      data: _Members, raw: bool = False) -> PyTree:
    """``like`` filled from the checkpoint; ``raw``: every tensor as the
    numpy array the checkpoint gives it (a view of the file, or what the
    layout conversion made), its shape checked, not yet a tensor."""
    flat_meta = manifest.get("flat_state", {})
    keyed = [(SEP.join(p), leaf) for p, leaf in _items_with_path(like)]
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
            new[key] = leaf.replace(_put(arr, leaf.buf, key, manifest,
                                         path, raw))
        elif key in data.files and key not in flat_meta:
            new[key] = _put(data[key], leaf, key, manifest, path, raw)
        elif key in expanded:                 # flat ckpt -> tree run
            new[key] = _put(expanded[key], leaf, key, manifest, path, raw)
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
    got = _read_verified(path)
    if got is None:
        raise IOError(f"checkpoint {path} failed integrity check")
    return _restore_verified(path, like, *got)


def restore_latest(ckpt_dir: str | pathlib.Path, like: PyTree
                   ) -> tuple[int, PyTree] | None:
    """Newest intact checkpoint (skipping corrupted ones), or None."""
    for step in reversed(available_steps(ckpt_dir)):
        path = pathlib.Path(ckpt_dir) / f"step_{step:010d}"
        got = _read_verified(path)
        if got is not None:
            return step, _restore_verified(path, like, *got)
    return None


# -- under a process mesh ---------------------------------------------------------
#
# A mesh run's checkpoint is the one file the JAX store writes for the
# global state: one writer (rank 0) assembles it on the host from the
# blocks the ranks send it and writes it; a restore's step is chosen by
# rank 0 and each rank reads only its block of the file.  The directory
# must be one every rank reads: one host, or a file system they share.


def gather_to_writer(state, topo, layout=None, master_specs=None):
    """The global state of a mesh run on the writer's host, for
    :func:`save`: a collective of every rank of ``topo.mesh``.  Each rank
    sends rank 0 only the blocks it alone holds (``convert.state_pieces``:
    the per-edge slots from data rank 0 of each pod, the per-voter slots
    from every rank, each model rank's bucket or block, under FSDP each
    data rank's shard), a chunk at a time through host memory
    (``comm.send_block``); rank 0 receives the rest from every rank at
    once while it copies its own from the card into the global host
    tensors, of ``global_like``'s shapes (bfloat16 widened to float32,
    as :func:`save` writes it: a block received in another dtype or
    into a non-contiguous view crosses through a host copy of its own),
    and returns the global ``TrainState`` with flat slots under their
    global (multi-bucket) layouts, its step and generator the rank's.
    Every other rank returns None: only the writer holds the global
    copy.
    ``layout``, ``master_specs``: as for ``convert.gather_train_state``."""
    glike = convert.global_like(state, topo, layout, master_specs)
    m = topo.mesh
    if m.rank != 0:
        for piece in convert.state_pieces(state, topo, glike, layout,
                                          master_specs):
            comm.send_block(topo, piece.block)
        return None

    def host(x):
        dt = torch.float32 if x.dtype == torch.bfloat16 else x.dtype
        return torch.empty(x.shape, dtype=dt)

    out = {"step": state.step, "rng": state.rng}
    for name in convert.SLOTS:
        g = getattr(glike, name)
        out[name] = (None if g is None
                     else g.replace(host(g.buf)) if _is_flat(g)
                     else pytree.tree_map(host, g))
    glob = type(state)(**out)

    def target(piece):
        g = getattr(glob, piece.slot)
        if piece.leaf is None:
            return g.buf[piece.index]
        return pytree.tree_flatten(g)[0][piece.leaf][piece.index]

    # every rank's blocks arrive side by side while rank 0 copies its own
    landing = [comm.recv_block(topo, target(piece), r, piece.block.dtype)
               for r in range(1, m.size)
               for piece in convert.state_pieces(
                   state, convert.rank_view(topo, r), glike, layout,
                   master_specs)]
    for piece in convert.state_pieces(state, topo, glike, layout,
                                      master_specs):
        target(piece).copy_(piece.block)
    # the received blocks land in the global tensors on several threads
    # (a cast or a strided copy each, the first touch of their pages)
    with concurrent.futures.ThreadPoolExecutor(LANDING_THREADS) as pool:
        list(pool.map(lambda land: land(), landing))
    return glob


def _verify(path: pathlib.Path) -> bool:
    """Whether the checkpoint at ``path`` has its manifest's CRC (the file
    read a chunk at a time, never whole)."""
    try:
        manifest = json.loads((path / "manifest.json").read_text())
        return crc32_file(path / "arrays.npz") == manifest.get("crc32")
    except (OSError, ValueError):
        return False


def restore_block(ckpt_dir: str | pathlib.Path, step: int, like, topo,
                  layout=None, master_specs=None):
    """This rank's block of checkpoint ``step``, in ``like``'s layout,
    dtypes and device (``like``: the rank's state of a mesh run, its
    ``init_fn``'s).  The file is memory-mapped, not read: where its
    layout is the run's global one (the same model-shard count and slot
    table, or a tree of the same leaves), only the rank's blocks are
    read (``convert.train_state_from_numpy``'s cuts).  Another layout
    -- another model-shard count, a one-process flat checkpoint into a
    run of model shards, a tree checkpoint into a flat run -- goes
    through the tree form, as :func:`restore` does: each converted slot
    is assembled whole on this rank's host (its global size, once a
    slot) before its block is cut.  The CRC is not checked here (rank 0
    checked it, :func:`restore_latest_mesh`)."""
    path = pathlib.Path(ckpt_dir) / f"step_{step:010d}"
    manifest = json.loads((path / "manifest.json").read_text())
    mapped = np.memmap(path / "arrays.npz", dtype=np.uint8, mode="r")
    glike = convert.global_like(like, topo, layout, master_specs)
    glob = _restore_verified(path, glike, manifest,
                             _Members(path / "arrays.npz", mapped), raw=True)
    state = convert.train_state_from_numpy(glob, like, topo, layout,
                                           master_specs)
    return state._replace(rng=glob.rng)


def restore_latest_mesh(ckpt_dir: str | pathlib.Path, like, topo,
                        layout=None, master_specs=None):
    """The mesh counterpart of :func:`restore_latest`, a collective of
    every rank: rank 0 checks the CRCs and chooses the newest intact
    step, every rank hears its choice (``comm.agree``), so no two ranks
    restore different steps, and each reads its block
    (:func:`restore_block`).  Returns ``(step, state)``, or None when no
    intact checkpoint exists.  The directory must be one every rank
    reads (one host, or a file system they share): a rank that cannot
    read the chosen step raises ``IOError`` naming its path, and so does
    every other rank, at once.  Drain every rank's saver before (the
    trainer does): a step still being written is not yet listed, but a
    restore should not race the next save."""
    chosen = -1
    if topo.mesh.rank == 0:
        for step in reversed(available_steps(ckpt_dir)):
            if _verify(pathlib.Path(ckpt_dir) / f"step_{step:010d}"):
                chosen = step
                break
    chosen = comm.agree(topo, [chosen])[0][0]
    if chosen < 0:
        return None
    path = pathlib.Path(ckpt_dir) / f"step_{chosen:010d}"
    err = None
    try:
        state = restore_block(ckpt_dir, chosen, like, topo, layout,
                              master_specs)
    except (OSError, ValueError) as e:
        err = e
    failed = [r for r, (bad,) in enumerate(comm.agree(topo, [err is not None]))
              if bad]
    if err is not None:
        raise IOError(f"rank {topo.mesh.rank} cannot restore {path}, the "
                      f"step rank 0 chose (is {ckpt_dir} on a file system "
                      f"every rank reads?): {err}") from err
    if failed:
        raise IOError(f"ranks {failed} cannot restore {path}, the step "
                      "rank 0 chose")
    return chosen, state
