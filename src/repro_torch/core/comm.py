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
  * the FSDP regime's two (``core.device_axis``, over the data group):
    :func:`gather_shards` -- the ranks' shards of a leaf concatenated
    along the dim its master spec shards (the lift's forward, and the
    correction its backward reads); :func:`scatter_shards` -- an
    all-to-all that hands each rank the part of every peer's tensor
    that belongs to its shard (the lift's sign words, or ``wmean``'s
    float terms): a rank receives ``data - 1`` shards' worth, where an
    all-gather and a slice would bring it ``data`` times that;
  * the model group's (tensor parallelism, ``core.shardflat``):
    :func:`sum_model` -- a float sum whose backward is the identity
    (Megatron's *g*: after a row-parallel product, the vocab-parallel
    loss's sums, QSGD's and EF's per-leaf sums); :func:`copy_to_model`
    -- the identity whose backward is that sum (Megatron's *f*: before
    a column-parallel product, and on a replicated leaf or activation
    that the rank's own shards use); :func:`max_model`, the
    vocab-parallel loss's max (no gradient); :func:`gather_model` --
    the model blocks of a tensor along one dim, for state and tests;
    :func:`all_gather_model` -- the same gather with a gradient, its
    backward chosen by the caller: the rank's own slice of the incoming
    gradient (``"slice"``: what follows the gather runs identically on
    every rank, so each holds the whole gradient already) or a
    reduce-scatter (``"sum"``: what follows reads the gathered tensor
    for the rank's own share of the output, so the ranks' gradients are
    partial -- an all-reduce, counted as ``reduce_scatter_model``, then
    the slice);
  * serving's (``launch.specs``, ``models.moe``): :func:`broadcast_pods`
    -- pod rank 0's tensor on every rank of the pod group (edge 0's
    bucket row, served by every pod); :func:`gather_batch` -- every
    batch rank's tensor (the pod and data ranks, over which the request
    rows are split) in batch order, pod-major (the MoE's top-k expert
    ids), an all-gather over the data group then one over the pod
    group, counted as ``gather_batch_data`` and ``gather_batch_pod``:
    the mesh has no batch group of its own, and these two compose it;
    over the data group, where the data ranks hold shards of the weights
    or of the cache's length (``models.build``'s gather layout and
    ``len_axis``): :func:`gather_shards` again, counted as
    ``gather_serve`` (each layer's shards gathered into its compute
    block at every call), and :func:`combine_softmax` -- the
    split-length attention's partial softmaxes gathered and folded in
    data order (``combine_data``), so every data rank holds the same
    bits.
    A model sum is one all-reduce, in float32 for a narrower float
    (rounded back once).  Its order of addition is the algorithm's, not
    the one-process order, but every model rank gets the same bits:
    ring and tree all-reduces hand each rank the one reduced result
    (the tests and ``chip_smoke.py`` check every copy bitwise across
    the model group).

A mesh checkpoint's (``checkpoint.store``), over every rank of the mesh
and through host memory: :func:`send_block` / :func:`recv_block` -- a
rank's block of the state to the one writer, ``CHUNK_BYTES`` at a time,
the writer receiving from every rank at once (counted ``checkpoint``:
sent by the others, received by the writer) --
and :func:`agree`, every rank's few integers on every rank (the saver's
error flag and generator seed, the restore's chosen step; counted
``checkpoint_control``).  They run on the default group where its
backend is gloo, else on a gloo group of every rank
(:func:`host_group`).

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
copies it through host memory.  Where the mesh has shared host memory
(``ProcessMesh.exchange``: ranks on one host,
``launch.mesh.make_host_topology(shared_dir=...)``), the all-gathers
and the all-to-all go through it instead (``core.host_exchange``, the
same bits) and the sums stay the backend's; :data:`traffic` counts the
same bytes either way.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.core.topology import Topology

OPS = ("gather_devices", "gather_pods", "sum_devices", "gather_shards",
       "scatter_shards", "sum_model", "copy_to_model", "max_model",
       "gather_model", "all_gather_model", "reduce_scatter_model",
       "gather_batch_data", "gather_batch_pod", "broadcast_pods",
       "gather_serve", "combine_data", "checkpoint", "checkpoint_control")
GROUPS = {"data": ("gather_devices", "sum_devices", "gather_shards",
                   "scatter_shards", "gather_batch_data", "gather_serve",
                   "combine_data"),
          "pod": ("gather_pods", "gather_batch_pod", "broadcast_pods"),
          "model": ("sum_model", "copy_to_model", "max_model",
                    "gather_model", "all_gather_model",
                    "reduce_scatter_model")}
traffic: dict = {}


def reset_traffic() -> None:
    for op in OPS:
        traffic[op] = {"calls": 0, "sent": 0, "received": 0}


reset_traffic()


def group_bytes() -> dict:
    """The bytes this rank sent and received on each group since the last
    :func:`reset_traffic`: ``{group: {"sent": n, "received": n}}``."""
    return {g: {k: sum(traffic[op][k] for op in ops)
                for k in ("sent", "received")}
            for g, ops in GROUPS.items()}


def _mesh(topo: Topology | None):
    return None if topo is None else topo.mesh


def _count(op: str, x: torch.Tensor, peers: int) -> None:
    nbytes = x.numel() * x.element_size()
    rec = traffic[op]
    rec["calls"] += 1
    rec["sent"] += nbytes
    rec["received"] += nbytes * peers


def _gather(m, axis: str, x: torch.Tensor, dim: int) -> torch.Tensor:
    """The ranks' ``x`` of ``axis``'s group (``"data"``, ``"pod"`` or
    ``"model"``) concatenated along ``dim``, in group order: through the
    mesh's shared host memory where it has it, else the backend's
    all-gather."""
    group = getattr(m, f"{axis}_group")
    n = m.pods if axis == "pod" else getattr(m, axis)
    x = x.contiguous()
    ex = (m.exchange or {}).get(axis)
    if ex is not None:
        out = ex.all_gather(x)
        return (out.view((n * x.shape[0],) + tuple(x.shape[1:])) if dim == 0
                else torch.cat(out.unbind(0), dim=dim))
    if dim == 0:        # the parts land in the result itself: no copy
        out = x.new_empty((n * x.shape[0],) + tuple(x.shape[1:]))
        dist.all_gather(list(out.chunk(n)), x, group=group)
        return out
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
    return _gather(m, "data", x, 1)


def gather_pods(topo: Topology | None, x: torch.Tensor) -> torch.Tensor:
    """All-gather along dim 0 over the pod group: the rank's edges
    ``[P_loc, ...]`` -> all ``[P, ...]``, in pod order."""
    m = _mesh(topo)
    if m is None or m.pods == 1:
        return x
    _count("gather_pods", x, m.pods - 1)
    return _gather(m, "pod", x, 0)


def broadcast_pods(topo: Topology | None, x: torch.Tensor) -> torch.Tensor:
    """Pod rank 0's ``x`` on every rank of the pod group: ``x`` itself on
    pod rank 0, a new tensor elsewhere (the backend's broadcast; no
    gradient).  Pod rank 0 counts the bytes as sent to each peer, the
    others as received."""
    m = _mesh(topo)
    if m is None or m.pods == 1:
        return x
    rec = traffic["broadcast_pods"]
    nbytes = x.numel() * x.element_size()
    rec["calls"] += 1
    if m.pod_rank == 0:
        y = x.detach().contiguous()
        rec["sent"] += nbytes * (m.pods - 1)
    else:
        y = torch.empty_like(x, memory_format=torch.contiguous_format)
        rec["received"] += nbytes
    dist.broadcast(y, src=m.data_rank * m.model + m.model_rank,
                   group=m.pod_group)
    return y


def gather_batch(topo: Topology | None, x: torch.Tensor) -> torch.Tensor:
    """Every batch rank's ``x`` stacked on a new dim 0, ``[pods * data,
    *x.shape]``, pod-major (the data group's all-gather, then the pod
    group's); ``x[None]`` without a mesh.  Serving's, with no
    gradient."""
    m = _mesh(topo)
    y = x[None]
    if m is None:
        return y
    if m.data > 1:
        _count("gather_batch_data", y, m.data - 1)
        y = _gather(m, "data", y, 0)
    if m.pods > 1:
        _count("gather_batch_pod", y, m.pods - 1)
        y = _gather(m, "pod", y, 0)
    return y


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


def gather_shards(topo: Topology | None, x: torch.Tensor, dim: int,
                  op: str = "gather_shards") -> torch.Tensor:
    """All-gather over the data group along ``dim``: the data ranks'
    shards of a leaf, in data order, side by side (no gradient); counted
    under ``op`` (``"gather_serve"`` when serving)."""
    m = _mesh(topo)
    if m is None or m.data == 1:
        return x
    _count(op, x, m.data - 1)
    return _gather(m, "data", x.detach(), dim)


def combine_softmax(topo: Topology | None, m_r: torch.Tensor,
                    l_r: torch.Tensor, o_r: torch.Tensor) -> torch.Tensor:
    """The softmax-weighted values over a length split across the data
    group, from each rank's partial softmax over its block: the row max
    ``m_r`` [..., 1], the sum ``l_r`` [..., 1] of ``exp(s - m_r)`` and the
    values weighted by those, ``o_r`` [..., e], all float32.  The three
    are all-gathered as one tensor and folded in data order, ``o = sum_r
    exp(m_r - M) o_r / sum_r exp(m_r - M) l_r`` with ``M`` the largest
    ``m_r``, so every data rank gets the same bits.  A rank with nothing
    to add hands in ``l_r`` and ``o_r`` zero, which adds exactly zero.
    Without a data group above one rank, ``o_r / l_r``."""
    m = _mesh(topo)
    if m is None or m.data == 1:
        return o_r / l_r
    part = torch.cat([m_r, l_r, o_r], dim=-1).to(torch.float32)[None]
    _count("combine_data", part, m.data - 1)
    parts = _gather(m, "data", part, 0)
    big = parts[..., :1].amax(0)
    num = den = None
    for r in range(m.data):
        scale = torch.exp(parts[r, ..., :1] - big)
        num = (scale * parts[r, ..., 2:] if num is None
               else num + scale * parts[r, ..., 2:])
        den = (scale * parts[r, ..., 1:2] if den is None
               else den + scale * parts[r, ..., 1:2])
    return num / den


def scatter_shards(topo: Topology | None, x: torch.Tensor) -> torch.Tensor:
    """The all-to-all over the data group: ``x`` [data, P_loc, V_loc,
    ...] holds, for each data rank r, the rank's part for r's shard
    (``x[r]``); each rank gets every rank's part for its own shard,
    ``[P_loc, data * V_loc, ...]`` -- the senders' voters in data order,
    so in global voter order."""
    m = _mesh(topo)
    if m is None or m.data == 1:
        return x[0]
    x = x.contiguous()
    rec = traffic["scatter_shards"]
    part = x[0].numel() * x.element_size()
    rec["calls"] += 1
    rec["sent"] += part * (m.data - 1)
    rec["received"] += part * (m.data - 1)
    ex = (m.exchange or {}).get("data")
    if ex is not None:
        out = ex.all_to_all(x)
    else:
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x, group=m.data_group)
    return out.transpose(0, 1).reshape((x.shape[1], -1) + x.shape[3:])


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
    return _gather(m, "model", x.detach(), dim)


class _AllGatherModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, m, dim, grad):
        ctx.m, ctx.dim, ctx.grad, ctx.n = m, dim, grad, x.shape[dim]
        _count("all_gather_model", x, m.model - 1)
        return _gather(m, "model", x, dim)

    @staticmethod
    def backward(ctx, g):
        if ctx.grad == "sum":
            g = _sum_over_model(ctx.m, "reduce_scatter_model", g)
        return (g.narrow(ctx.dim, ctx.m.model_rank * ctx.n, ctx.n),
                None, None, None)


def all_gather_model(topo: Topology | None, x: torch.Tensor, dim: int,
                     grad: str) -> torch.Tensor:
    """The model ranks' blocks of ``x`` concatenated along ``dim`` (in
    model order), with a gradient: ``grad="slice"`` hands the rank its
    own block of the incoming gradient (what follows runs identically on
    every rank), ``grad="sum"`` sums the incoming gradient over the model
    group first (what follows is the rank's own share: a reduce-scatter).
    Choosing wrong scales the gradient by the group's size or its
    inverse."""
    if grad not in ("slice", "sum"):
        raise ValueError(f"grad must be 'slice' or 'sum', not {grad!r}")
    m = _model(topo)
    return x if m is None else _AllGatherModel.apply(x, m, dim % x.dim(),
                                                     grad)


# -- the mesh checkpoint's, over every rank -------------------------------------

CHUNK_BYTES = 1 << 26            # a block crosses 64 MiB at a time
_host_groups: dict = {}


def host_group(topo: Topology):
    """The group a mesh checkpoint's host tensors cross: the default
    group (None) where its backend is gloo, else a gloo group of every
    rank, made on the first call for this mesh -- a collective, so every
    rank makes that call at the same point (``checkpoint.async_ckpt.
    AsyncSaver`` does, when it is made)."""
    m = topo.mesh
    if m.backend == "gloo":
        return None
    got = _host_groups.get(id(m))
    if got is None or got[0] is not m:
        got = _host_groups[id(m)] = (m, dist.new_group(backend="gloo"))
    return got[1]


def agree(topo: Topology, values: list) -> list:
    """Every rank's ``values`` (a few int64s, the same count on every
    rank) on every rank, in rank order: an all-gather over the host
    group."""
    m = topo.mesh
    t = torch.tensor([int(v) for v in values], dtype=torch.int64)
    _count("checkpoint_control", t, m.size - 1)
    parts = [torch.empty_like(t) for _ in range(m.size)]
    dist.all_gather(parts, t, group=host_group(topo))
    return [p.tolist() for p in parts]


def send_block(topo: Topology, x: torch.Tensor, dst: int = 0) -> None:
    """Send ``x`` (on any device) to rank ``dst``, its bytes
    ``CHUNK_BYTES`` at a time through host memory, the next chunk leaving
    the card while the last one is sent: this rank holds two chunks on
    the host at a time (and, for a non-contiguous ``x`` on the card, one
    contiguous copy of ``x`` there)."""
    raw = x.detach().contiguous().view(-1).view(torch.uint8)
    rec = traffic["checkpoint"]
    rec["calls"] += 1
    rec["sent"] += raw.numel()
    group = host_group(topo)
    pending = []
    for i in range(0, raw.numel(), CHUNK_BYTES):
        chunk = raw[i:i + CHUNK_BYTES].to("cpu")
        pending.append((dist.isend(chunk, dst, group=group), chunk))
        if len(pending) > 1:
            pending.pop(0)[0].wait()
    for work, _ in pending:
        work.wait()


def recv_block(topo: Topology, out: torch.Tensor, src: int,
               dtype: torch.dtype):
    """Post the receive of :func:`send_block`'s tensor of ``out``'s shape
    and the sender's ``dtype`` from rank ``src`` into the host tensor
    ``out`` (a view of a larger one, or of another dtype: then through
    one contiguous host copy, cast into ``out``), and return the call
    that waits for it and lands it.  Receives posted from several ranks
    before the first wait arrive side by side."""
    direct = out.is_contiguous() and out.dtype == dtype
    buf = out if direct else torch.empty(out.shape, dtype=dtype)
    raw = buf.view(-1).view(torch.uint8)
    rec = traffic["checkpoint"]
    rec["calls"] += 1
    rec["received"] += raw.numel()
    group = host_group(topo)
    works = [dist.irecv(raw[i:i + CHUNK_BYTES], src, group=group)
             for i in range(0, raw.numel(), CHUNK_BYTES)]

    def land():
        for work in works:
            work.wait()
        if not direct:
            out.copy_(buf)
    return land
