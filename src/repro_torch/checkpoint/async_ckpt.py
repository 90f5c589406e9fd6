"""Async checkpointing: device->host copy on the caller, serialization on
a background thread, so training never blocks on disk I/O.

The JAX package's ``checkpoint/async_ckpt.py`` for the port's states.
Usage:
    saver = AsyncSaver(ckpt_dir, keep=3)
    saver.submit(step, state)     # returns once the host copy is done
    saver.wait()                  # drain (end of run / before restore)

``submit`` copies every tensor to host memory before it returns
(``store.to_host``: blocking copies, never ``non_blocking``): the port's
fused update overwrites the master buffer in place, so a copy still in
flight -- or device tensors handed to the thread -- would save a later
step's values.

Under a process mesh (``topo`` with a ``mesh``) the saver writes the
mesh run's one checkpoint, the JAX store's file of the global state:
``submit`` and ``wait`` are collectives (every rank calls them at the
same step), the ranks' blocks reach rank 0 on the callers' threads
(``store.gather_to_writer``), and only rank 0 -- the writer -- has a
thread that writes, renames, updates ``LATEST`` and collects old steps.
The writer first drains its previous save, so its host holds one global
copy at a time.  A failed save raises on every rank at the next
``submit`` or ``wait`` (rank 0's flag crosses with that call's first
collective); ranks whose generator seeds differ raise at ``submit``.
"""
from __future__ import annotations

import queue
import threading
import time

from repro_torch.checkpoint import store
from repro_torch.core import comm


class AsyncSaver:
    """A failed background save is NEVER silently dropped: the writer
    thread records any raised exception (``BaseException`` -- a dying
    thread must not look like a successful save) and the next
    ``submit()`` / ``wait()`` re-raises it on the caller.  The thread
    itself survives the failure and keeps serving later saves; the
    sentinel ``task_done()`` runs unconditionally so ``wait()`` can
    never deadlock on a crashed item.

    ``records`` holds one dict per submitted step: ``step``, the
    seconds ``submit`` took (``submit_s``: the host copy; under a mesh
    the exchange of blocks, on the writer after the drain of its
    previous save) and, once written, of the save (``save_s``) and the
    bytes of its ``arrays.npz`` -- under a mesh the last two on the
    writer only.

    ``topo``: a mesh run's topology (module docstring); ``layout`` and
    ``master_specs`` as ``convert.gather_train_state`` takes them (the
    master's sharded layout for a tree state over a model axis; an FSDP
    state's master specs).  Making the saver is then a collective too
    (``comm.host_group``)."""

    def __init__(self, ckpt_dir, keep: int = 3, topo=None, layout=None,
                 master_specs=None):
        self.ckpt_dir = ckpt_dir
        self.keep = keep
        self.records: list[dict] = []
        self._topo = topo if topo is not None and topo.mesh else None
        self._layout, self._specs = layout, master_specs
        self.writer = self._topo is None or self._topo.mesh.rank == 0
        self._q: queue.Queue = queue.Queue()
        self._err: BaseException | None = None
        self._t = None
        if self._topo is not None:
            comm.host_group(self._topo)
        if self.writer:
            self._t = threading.Thread(target=self._loop, daemon=True)
            self._t.start()

    def _loop(self):
        while True:
            item = self._q.get()
            if item is None:
                self._q.task_done()
                return
            try:
                step, host_tree, rec = item
                t0 = time.perf_counter()
                path = store.save(self.ckpt_dir, step, host_tree,
                                  keep=self.keep)
                rec["save_s"] = time.perf_counter() - t0
                rec["bytes"] = (path / "arrays.npz").stat().st_size
            except BaseException as e:  # surfaced on next submit/wait
                self._err = e
            finally:
                item = host_tree = None        # drop the host copy now
                self._q.task_done()

    def _raise_pending(self, extra=()):
        """Raise a failed save; under a mesh, on every rank: rank 0's
        flag (and ``extra``, this rank's further ints) cross in one
        ``comm.agree``, whose rows this returns."""
        rows = None
        if self._topo is not None:
            rows = comm.agree(self._topo, [self._err is not None, *extra])
            if rows[0][0] and self._err is None:
                raise RuntimeError(
                    f"background checkpoint save failed on the writer "
                    f"(rank 0; step dropped from {self.ckpt_dir})")
        if self._err is not None:
            err, self._err = self._err, None
            raise RuntimeError(
                f"background checkpoint save failed (step dropped from "
                f"{self.ckpt_dir})") from err
        return rows

    def submit(self, step: int, tree):
        dead = RuntimeError(
            "AsyncSaver writer thread is not running (closed or crashed); "
            "submitted steps would never reach disk")
        t0 = time.perf_counter()
        if self._topo is None:
            self._raise_pending()
            if not self._t.is_alive():
                raise dead
            # synchronous device->host copy (cheap vs serialization),
            # then hand off to the writer thread
            host = store.to_host(tree)
        else:
            if self.writer:
                self._q.join()         # one global host copy at a time
                if not self._t.is_alive():
                    self._err = self._err or dead
            seed = tree.rng.initial_seed()
            rows = self._raise_pending([seed >> 32, seed & 0xFFFFFFFF])
            seeds = {(hi << 32) | lo for _, hi, lo in rows}
            if len(seeds) > 1:
                raise ValueError(
                    f"the ranks' generator seeds differ ({sorted(seeds)}): "
                    "a mesh checkpoint holds one")
            host = store.gather_to_writer(tree, self._topo, self._layout,
                                          self._specs)
        rec = {"step": step, "submit_s": time.perf_counter() - t0}
        self.records.append(rec)
        if self.writer:
            self._q.put((step, host, rec))

    def wait(self):
        if self.writer:
            self._q.join()
        self._raise_pending()

    def close(self):
        try:
            self.wait()
        finally:
            # shut the thread down even when the last save failed, so a
            # raising close() cannot leak the worker
            if self._t is not None:
                self._q.put(None)
                self._t.join()
