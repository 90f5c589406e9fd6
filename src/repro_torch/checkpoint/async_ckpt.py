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
"""
from __future__ import annotations

import queue
import threading
import time

from repro_torch.checkpoint import store


class AsyncSaver:
    """A failed background save is NEVER silently dropped: the writer
    thread records any raised exception (``BaseException`` -- a dying
    thread must not look like a successful save) and the next
    ``submit()`` / ``wait()`` re-raises it on the caller.  The thread
    itself survives the failure and keeps serving later saves; the
    sentinel ``task_done()`` runs unconditionally so ``wait()`` can
    never deadlock on a crashed item.

    ``records`` holds one dict per submitted step: ``step``, the
    seconds of the host copy (``submit_s``) and, once written, of the
    save (``save_s``) and the bytes of its ``arrays.npz``."""

    def __init__(self, ckpt_dir, keep: int = 3):
        self.ckpt_dir = ckpt_dir
        self.keep = keep
        self.records: list[dict] = []
        self._q: queue.Queue = queue.Queue()
        self._err: BaseException | None = None
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

    def _raise_pending(self):
        if self._err is not None:
            err, self._err = self._err, None
            raise RuntimeError(
                f"background checkpoint save failed (step dropped from "
                f"{self.ckpt_dir})") from err

    def submit(self, step: int, tree):
        self._raise_pending()
        if not self._t.is_alive():
            raise RuntimeError(
                "AsyncSaver writer thread is not running (closed or "
                "crashed); submitted steps would never reach disk")
        # synchronous device->host copy (cheap vs serialization), then
        # hand off to the writer thread
        t0 = time.perf_counter()
        host = store.to_host(tree)
        rec = {"step": step, "submit_s": time.perf_counter() - t0}
        self.records.append(rec)
        self._q.put((step, host, rec))

    def wait(self):
        self._q.join()
        self._raise_pending()

    def close(self):
        try:
            self.wait()
        finally:
            # shut the thread down even when the last save failed, so a
            # raising close() cannot leak the worker
            self._q.put(None)
            self._t.join()
