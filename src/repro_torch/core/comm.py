"""The collectives of the hierarchy over a process mesh.

The port's form of what GSPMD inserts where the JAX package constrains
a tensor to its mesh axes (``topo.constrain``, e.g. the data-axis
all-gather of the sign words in ``votes.py``): explicit
``torch.distributed`` calls on the topology's groups
(``core.topology.ProcessMesh``).

  * :func:`gather_devices` -- ``[P_loc, V_loc, ...]`` -> ``[P_loc, V,
    ...]``: the all-gather along dim 1 over the data group (an edge's
    voters, in global device order);
  * :func:`gather_pods` -- ``[P_loc, ...]`` -> ``[P, ...]``: the
    all-gather along dim 0 over the pod group (the edges, in pod
    order);
  * :func:`sum_devices` -- the integer sum over the data group (exact
    in any order).  Neither gloo nor NCCL sums int16, so an int16 tally
    crosses as int32 and is narrowed back: every partial sum lies in
    the tally's range, so the narrowing is exact.

Without a mesh (``topo`` None, or its ``mesh`` None, or on an axis of
size 1) each is the identity and no
process group is touched.  Each call adds the bytes this rank sent and
received to :data:`traffic` (per operation: calls, ``sent``,
``received``), so a run can put a step's uplink bytes beside
``signs.uplink_bits``; :func:`reset_traffic` sets it to zero.

The float means call these a chunk of coordinates at a time
(``votes.per_chunk``), so what they gather lives one chunk at a time.
On a gloo group a CUDA tensor goes to the collective as it is: gloo
copies it through host memory.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.core.topology import Topology

OPS = ("gather_devices", "gather_pods", "sum_devices")
traffic: dict = {}


def reset_traffic() -> None:
    for op in OPS:
        traffic[op] = {"calls": 0, "sent": 0, "received": 0}


reset_traffic()


def _mesh(topo: Topology | None):
    return None if topo is None else topo.mesh


def _count(op: str, x: torch.Tensor, peers: int) -> None:
    nbytes = x.numel() * x.element_size()
    rec = traffic[op]
    rec["calls"] += 1
    rec["sent"] += nbytes
    rec["received"] += nbytes * peers


def _gather(group, n: int, x: torch.Tensor, dim: int) -> torch.Tensor:
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim=dim)


def gather_devices(topo: Topology | None, x: torch.Tensor) -> torch.Tensor:
    """All-gather along dim 1 over the data group: the rank's voters
    ``[P_loc, V_loc, ...]`` -> its edges' whole voter axis ``[P_loc,
    V_loc * data, ...]``, rank by rank (so in global device order)."""
    m = _mesh(topo)
    if m is None or m.data == 1:
        return x
    _count("gather_devices", x, m.data - 1)
    return _gather(m.data_group, m.data, x, 1)


def gather_pods(topo: Topology | None, x: torch.Tensor) -> torch.Tensor:
    """All-gather along dim 0 over the pod group: the rank's edges
    ``[P_loc, ...]`` -> all ``[P, ...]``, in pod order."""
    m = _mesh(topo)
    if m is None or m.pods == 1:
        return x
    _count("gather_pods", x, m.pods - 1)
    return _gather(m.pod_group, m.pods, x, 0)


def sum_devices(topo: Topology | None, x: torch.Tensor) -> torch.Tensor:
    """The sum of an integer tensor over the data group (a new tensor
    of x's dtype; x itself is not written)."""
    m = _mesh(topo)
    if m is None or m.data == 1:
        return x
    if x.dtype.is_floating_point:
        raise ValueError("sum_devices takes integer tallies only: a float "
                         "sum over ranks would depend on their order")
    wire = torch.int32 if x.dtype == torch.int16 else x.dtype
    out = x.to(wire, copy=True)
    _count("sum_devices", out, m.data - 1)
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=m.data_group)
    return out.to(x.dtype)
