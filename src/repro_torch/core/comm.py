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
    the tally's range, so the narrowing is exact;
  * the model group's (tensor parallelism, ``core.shardflat``):
    :func:`sum_model` -- a float sum whose backward is the identity
    (Megatron's *g*: after a row-parallel product, the vocab-parallel
    loss's sums, QSGD's and EF's per-leaf sums); :func:`copy_to_model`
    -- the identity whose backward is that sum (Megatron's *f*: before
    a column-parallel product, and on a replicated leaf or activation
    that the rank's own shards use); :func:`max_model`, the
    vocab-parallel loss's max (no gradient); :func:`gather_model` --
    the model blocks of a tensor along one dim, for state and tests.
    A model sum is one all-reduce, in float32 for a narrower float
    (rounded back once).  Its order of addition is the algorithm's, not
    the one-process order, but every model rank gets the same bits:
    ring and tree all-reduces hand each rank the one reduced result
    (the tests and ``chip_smoke.py`` check every copy bitwise across
    the model group).

Without a mesh (``topo`` None, or its ``mesh`` None, or on an axis of
size 1) each is the identity and no process group is touched.  Each call adds the bytes this rank sent and
received to :data:`traffic` (per operation: calls, ``sent``,
``received``), so a run can put a step's uplink bytes beside
``signs.uplink_bits``; :func:`reset_traffic` sets it to zero.  An
all-reduce is counted as its contributions: the rank's tensor sent,
its peers' received (a ring moves about ``2 (n-1)/n`` of the tensor
each way instead).

The float means call these a chunk of coordinates at a time
(``votes.per_chunk``), so what they gather lives one chunk at a time.
On a gloo group a CUDA tensor goes to the collective as it is: gloo
copies it through host memory.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.core.topology import Topology

OPS = ("gather_devices", "gather_pods", "sum_devices", "sum_model",
       "copy_to_model", "max_model", "gather_model")
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


# -- the model group ------------------------------------------------------------

def _model(topo: Topology | None):
    m = _mesh(topo)
    return None if m is None or m.model == 1 else m


def _sum_over_model(m, op: str, x: torch.Tensor) -> torch.Tensor:
    """The all-reduced sum over the model group (float32 for a narrower
    float, rounded back once)."""
    _count(op, x, m.model - 1)
    wide = (torch.float32 if x.dtype in (torch.float16, torch.bfloat16)
            else x.dtype)
    out = x.to(wide, memory_format=torch.contiguous_format, copy=True)
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=m.model_group)
    return out.to(x.dtype)


class _SumModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, m):
        return _sum_over_model(m, "sum_model", x)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, m):
        ctx.m = m
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _sum_over_model(ctx.m, "copy_to_model", g), None


def sum_model(topo: Topology | None, x: torch.Tensor) -> torch.Tensor:
    """The sum of the model ranks' ``x`` (each rank's partial: a
    row-parallel product, a vocab shard's sums), on every rank; its
    backward hands the incoming gradient on unchanged."""
    m = _model(topo)
    return x if m is None else _SumModel.apply(x, m)


def copy_to_model(topo: Topology | None, x: torch.Tensor) -> torch.Tensor:
    """``x`` itself, whose gradient is summed over the model group: what
    every model rank holds whole but uses only through its own shards
    (the input of a column-parallel product, a replicated key/value
    head or norm that the rank's heads read)."""
    m = _model(topo)
    return x if m is None else _CopyToModel.apply(x, m)


def max_model(topo: Topology | None, x: torch.Tensor) -> torch.Tensor:
    """The elementwise max of the model ranks' ``x`` (no gradient)."""
    m = _model(topo)
    if m is None:
        return x
    x = x.detach().contiguous()
    _count("max_model", x, m.model - 1)
    out = x.clone()
    dist.all_reduce(out, op=dist.ReduceOp.MAX, group=m.model_group)
    return out


def gather_model(topo: Topology | None, x: torch.Tensor,
                 dim: int) -> torch.Tensor:
    """The model ranks' blocks of ``x`` concatenated along ``dim``, in
    model order (no gradient)."""
    m = _model(topo)
    if m is None:
        return x
    _count("gather_model", x, m.model - 1)
    return _gather(m.model_group, m.model, x.detach(), dim)
