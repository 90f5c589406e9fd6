"""All-gathers and all-to-alls among ranks of one host, through shared memory.

gloo moves a tensor between two processes over a TCP socket, also when
both run on one host, where the socket is the loopback device: in the
virtual machines of ``chip_smoke.py``'s runs over ranks (one H100, 8
cores) a rank received 0.2-0.5 GB/s that way (PERF.md), and a CUDA
tensor crosses host memory besides.  Ranks that share a host
-- as ranks that share one card do -- can instead meet in memory that
they all map.  A :class:`HostExchange` serves one process group: every
member owns one slot, a file of ``2 * piece`` bytes that every member
maps (shared), and an exchange moves a tensor ``piece`` bytes at a
time:

  1. each rank copies its next piece into one half of its own slot
     (for a CUDA tensor a device-to-host copy, which has landed when
     the copy returns);
  2. a barrier on the group: every rank's piece is in its slot;
  3. each rank copies every peer's piece out of the peer's slot (for a
     CUDA tensor a host-to-device copy, which has read the slot when
     it returns).

The pieces alternate between the slots' two halves, so one barrier a
piece is enough: a rank writes a half again only after the next
piece's barrier, which every peer reaches after it has read that half.
The counter of pieces lives as long as the exchange, so this holds
across calls, which every member makes in the same order (as it makes
any collective).  Bytes are copied, never combined: an all-gather or
an all-to-all gives the same bits as gloo's.  A sum stays gloo's
all-reduce (``core.comm``).

:func:`open_exchanges` makes a rank's exchanges for its groups: each
member creates its slot file in a directory that all the ranks see (on
Linux best ``/dev/shm``, which is memory), a barrier on the default
group, every member maps every slot of its groups, a second barrier,
and each removes its own file: the maps hold the memory until the
processes end, and nothing is left in the directory.  On CUDA each map
is registered with the driver (page-locked, so the copies go by DMA)
where the driver takes it; where it does not, the copies go through
the driver's staging buffers.
"""
from __future__ import annotations

import os
import pathlib

import torch
import torch.distributed as dist

PIECE = 32 << 20      # bytes a rank moves between two barriers


class HostExchange:
    """One process group's slots (see the module docstring): ``members``
    its global ranks in group order, ``me`` this rank's index among
    them, ``prefix`` the path of the slot files before ``.{index}``."""

    def __init__(self, group, members: list, me: int, prefix: str,
                 piece: int | None = None, device=None):
        piece = PIECE if piece is None else piece
        if piece < len(members):
            raise ValueError(f"piece {piece} B is smaller than the group "
                             f"({len(members)} ranks)")
        self.group, self.n, self.me = group, len(members), me
        self.piece, self.prefix = piece, prefix
        self.device = torch.device(device) if device is not None else None
        self.slots: list = []
        self.pinned = False
        self._count = 0
        with open(self._path(me), "wb") as f:
            f.truncate(2 * piece)

    def _path(self, i: int) -> str:
        return f"{self.prefix}.{i}"

    def map(self) -> None:
        """Map every member's slot (after every member created its
        file); register the maps with the driver on CUDA."""
        self.slots = [torch.from_file(self._path(i), shared=True,
                                      size=2 * self.piece,
                                      dtype=torch.uint8)
                      for i in range(self.n)]
        if self.device is not None and self.device.type == "cuda":
            try:
                cudart = torch.cuda.cudart()
                self.pinned = all(
                    int(cudart.cudaHostRegister(s.data_ptr(), s.numel(), 0))
                    == 0 for s in self.slots)
            except (RuntimeError, TypeError, AttributeError):
                self.pinned = False

    def unlink(self) -> None:
        """Remove this rank's own slot file (after every member mapped
        it)."""
        os.unlink(self._path(self.me))

    def _half(self) -> int:
        off = (self._count % 2) * self.piece
        self._count += 1
        return off

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """``[n, *x.shape]``: every member's ``x`` in group order (each
        member's of the same shape and dtype)."""
        x = x.contiguous()
        out = x.new_empty((self.n,) + tuple(x.shape))
        src = x.reshape(-1).view(torch.uint8)
        dst = out.view(self.n, -1).view(torch.uint8)
        total = src.numel()
        for off in range(0, total, self.piece):
            b = min(self.piece, total - off)
            h = self._half()
            self.slots[self.me][h:h + b].copy_(src[off:off + b])
            dist.barrier(group=self.group)
            for r in range(self.n):
                dst[r, off:off + b].copy_(
                    src[off:off + b] if r == self.me
                    else self.slots[r][h:h + b])
        return out

    def all_to_all(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` [n, ...] holds the rank's part for each member; returns
        ``out`` [n, ...] with ``out[i]`` member i's part for this rank
        (``all_to_all_single``'s result)."""
        x = x.contiguous()
        out = torch.empty_like(x)
        src = x.view(self.n, -1).view(torch.uint8)
        dst = out.view(self.n, -1).view(torch.uint8)
        part = src.shape[1]
        step = self.piece // self.n
        for off in range(0, part, step):
            b = min(step, part - off)
            h = self._half()
            self.slots[self.me][h:h + self.n * b].view(self.n, b).copy_(
                src[:, off:off + b])
            dist.barrier(group=self.group)
            lo = h + self.me * b
            for r in range(self.n):
                dst[r, off:off + b].copy_(
                    src[self.me, off:off + b] if r == self.me
                    else self.slots[r][lo:lo + b])
        return out


def open_exchanges(groups: dict, directory: str | pathlib.Path,
                   device, piece: int | None = None) -> dict:
    """This rank's exchanges, one a group: ``groups`` maps a name to
    ``(group, members, tag)`` -- the process group, its global ranks in
    group order and a tag every member passes alike and no other group
    of the run shares.  Every rank of the default group must call this,
    in the same order, with a directory all of them see; ``piece``
    defaults to :data:`PIECE`.  Returns ``{name: HostExchange}``."""
    rank = dist.get_rank()
    prefix = pathlib.Path(directory)
    out = {name: HostExchange(group, members, members.index(rank),
                              str(prefix / tag), piece, device)
           for name, (group, members, tag) in groups.items()}
    dist.barrier()
    for ex in out.values():
        ex.map()
    dist.barrier()
    for ex in out.values():
        ex.unlink()
    return out
