"""Process meshes: the hierarchy laid over ``torch.distributed`` ranks.

The counterpart of the JAX package's ``launch/mesh.py``.  There a mesh
axis is a set of chips; here it is a set of processes, and its
collectives are a process group's (``core.comm``):

  * ``data`` -- the devices of an edge: the 1-bit sign words cross it
    every local step;
  * ``pod``  -- the edges under the cloud: the edge models cross it
    every T_E steps;
  * ``model`` -- tensor parallelism: a leaf that the model's specs
    split is held in blocks, one a model rank (``core.shardflat``), and
    only the tensor-parallel forward's and backward's sums cross it.

:func:`make_host_topology` lays a ``pods x data x model`` grid over the
ranks of the initialised default group
(``torch.distributed.init_process_group``, its address, world size and
rank given by the caller or by ``torchrun``), numbered as the JAX mesh
lays out its devices: ``rank = (pod*data + data_rank)*model +
model_rank``.  :func:`make_production_mesh` gives the JAX package's
production grids (``(16, 16)`` over ``("data", "model")``, and ``(2,
16, 16)`` over ``("pod", "data", "model")`` with ``multi_pod``) and
:func:`make_topology` lays one over the default group's 256 or 512
ranks.  The backend is the caller's choice: ``"gloo"`` for the CPU and
for ranks that share one card (NCCL refuses two ranks on one GPU),
``"nccl"`` for one GPU a rank.

:func:`dry_topology` (and :func:`dry_grid` for any grid) is the dry
run's (``launch.dryrun``): the production grid laid over a *fake*
default group of 256 or 512 ranks in this one process, at the rank the
caller chooses -- torch's fake backend, whose collectives move nothing,
so every collective of the rank's step runs ``core.comm``'s normal path
and is counted in ``comm.traffic`` as a real run's is, while the
tensors it is given are fake (``torch._subclasses.FakeTensorMode``).
It refuses to start over a process group already initialised and
destroys its own when it ends; :func:`make_host_topology` refuses the
fake backend.
"""
from __future__ import annotations

import contextlib
import datetime
import math

import torch.distributed as dist

from repro_torch.core.topology import ProcessMesh, Topology

BACKENDS = ("gloo", "nccl")
FAKE_BACKEND = "fake"        # the dry run's alone (dry_grid)
TIMEOUT = datetime.timedelta(seconds=60)   # a peer that died fails a
                                           # collective within a minute
PRODUCTION = {False: ((16, 16), ("data", "model")),
              True: ((2, 16, 16), ("pod", "data", "model"))}


def make_production_mesh(*, multi_pod: bool = False):
    """The JAX package's production grid as ``(shape, axis names)``: no
    process group is touched."""
    return PRODUCTION[bool(multi_pod)]


def make_topology(*, multi_pod: bool = False, backend: str | None = None,
                  device="cuda") -> Topology:
    """The production grid laid over the default group's ranks (P = 2
    pods with ``multi_pod``, else 1; D = 16; a 16-way model axis; a
    [1, 1] block a rank).  The world must hold the grid's 512 (or 256)
    ranks, else ``ValueError``; ``backend`` defaults to NCCL on CUDA and
    gloo on the CPU."""
    shape, _ = make_production_mesh(multi_pod=multi_pod)
    need = math.prod(shape)
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != need:
        raise ValueError(
            f"make_topology(multi_pod={multi_pod}): the production grid "
            f"{' x '.join(map(str, shape))} needs {need} ranks, the default "
            f"group has {world}")
    pods, data, model = (1,) * (3 - len(shape)) + tuple(shape)
    if backend is None:
        backend = "gloo" if str(device).startswith("cpu") else "nccl"
    return make_host_topology(pods, data, model, backend=backend,
                              device=device)


def host_grid(world: int, pods: int, devices_per_pod: int) -> tuple:
    """The ``(pods, data)`` process grid for ``world`` ranks over P x D:
    the data axis takes ``gcd(D, world)`` ranks and the pod axis the
    rest, which must divide P."""
    data = math.gcd(devices_per_pod, world)
    mesh_pods = world // data
    if pods % mesh_pods:
        raise ValueError(
            f"{world} ranks do not tile P x D = {pods} x {devices_per_pod}: "
            f"the data axis takes gcd(D, ranks) = {data}, leaving "
            f"{mesh_pods} pod ranks for P = {pods}")
    return mesh_pods, data


def make_host_topology(pods: int, data: int, model: int = 1, *,
                       backend: str, device, block: tuple = (1, 1),
                       shared_dir=None) -> Topology:
    """The topology of this rank on a ``pods x data x model`` process
    grid: P = pods * block[0] edges, D = data * block[1] devices an
    edge, the rank ``(a*data + b)*model + m`` holding a block of
    ``block[0] x block[1]`` at ``(a, b)`` and model shard m.

    Every rank must call this, in the same order as its peers: each
    builds the ``pods * model`` data groups, the ``data * model`` pod
    groups and, with ``model > 1``, the ``pods * data`` model groups,
    every group with a 60 s timeout.  ``backend`` is explicit
    (``"gloo"`` or ``"nccl"``); ``device`` is this rank's device.
    ``shared_dir``, for ranks that share one host, is a directory all of
    them see (``/dev/shm`` or one under it): the ranks' all-gathers and
    all-to-alls then go through memory they share
    (``core.host_exchange``), not through the backend; the directory is
    left as it was found."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r} (choose from "
                         f"{', '.join(BACKENDS)})")
    return _lay_grid(pods, data, model, backend=backend, device=device,
                     block=block, shared_dir=shared_dir)


def _lay_grid(pods: int, data: int, model: int, *, backend: str, device,
              block: tuple = (1, 1), shared_dir=None) -> Topology:
    """:func:`make_host_topology` past its check of the backend."""
    if not dist.is_initialized():
        raise RuntimeError("make_host_topology needs the default process "
                           "group: call torch.distributed."
                           "init_process_group first")
    world, rank = dist.get_world_size(), dist.get_rank()
    if world != pods * data * model:
        raise ValueError(f"a {pods} x {data} x {model} mesh needs "
                         f"{pods * data * model} ranks, the default group "
                         f"has {world}")
    cell, model_rank = divmod(rank, model)
    pod_rank, data_rank = divmod(cell, data)

    def at(a, b, m):
        return (a * data + b) * model + m

    mine = {}

    def groups(name, members):
        """Create every group (every rank, one order); keep this rank's,
        with its ranks and a tag naming it among the run's groups."""
        for i, ranks in enumerate(members):
            g = dist.new_group(ranks, timeout=TIMEOUT, backend=backend)
            if rank in ranks:
                mine[name] = (g, ranks, f"{name}{i}")
        return mine[name][0]

    data_group = groups("data", [[at(a, b, m) for b in range(data)]
                                 for a in range(pods) for m in range(model)])
    pod_group = groups("pod", [[at(a, b, m) for a in range(pods)]
                               for b in range(data) for m in range(model)])
    model_group = (groups("model", [[at(a, b, m) for m in range(model)]
                                    for a in range(pods)
                                    for b in range(data)])
                   if model > 1 else None)
    exchange = None
    if shared_dir is not None:
        from repro_torch.core.host_exchange import open_exchanges
        exchange = open_exchanges(
            {name: g for name, g in mine.items() if len(g[1]) > 1},
            shared_dir, device)
    mesh = ProcessMesh(pods=pods, data=data, pod_rank=pod_rank,
                       data_rank=data_rank, pod_group=pod_group,
                       data_group=data_group, backend=backend, model=model,
                       model_rank=model_rank, model_group=model_group,
                       exchange=exchange)
    return Topology(pods * block[0], data * block[1], device, mesh=mesh)


def _register_fake_backend() -> None:
    """torch's fake process group ("fake"), registered by importing the
    module that defines it (once a process)."""
    try:
        import torch.testing._internal.distributed.fake_pg  # noqa: F401
    except ImportError as e:
        raise RuntimeError(f"this torch has no fake process group "
                           f"(torch.testing._internal.distributed.fake_pg): "
                           f"{e}") from e


@contextlib.contextmanager
def dry_grid(pods: int, data: int, model: int = 1, *, rank: int = 0,
             device="cuda"):
    """The topology of rank ``rank`` on a ``pods x data x model`` grid
    laid over a fake default group of ``pods * data * model`` ranks in
    this process (torch's fake backend: a collective on it moves nothing
    and writes nothing, and ``core.comm`` counts it as it counts a real
    one), a [1, 1] block a rank, for the ``with`` block; the group is
    destroyed when the block ends.  ``RuntimeError`` if a default group
    is already initialised: a dry run never runs on a real process
    group."""
    world = pods * data * model
    if not 0 <= rank < world:
        raise ValueError(f"rank {rank} is not on a {pods} x {data} x "
                         f"{model} grid of {world} ranks")
    if dist.is_initialized():
        raise RuntimeError(
            "a dry run lays its grid over a fake default group of its own, "
            "and a default process group is already initialised (backend "
            f"{dist.get_backend()!r}): run it in a process of its own")
    _register_fake_backend()
    dist.init_process_group(FAKE_BACKEND, store=dist.HashStore(), rank=rank,
                            world_size=world)
    try:
        yield _lay_grid(pods, data, model, backend=FAKE_BACKEND,
                        device=device)
    finally:
        dist.destroy_process_group()


def dry_topology(*, multi_pod: bool = False, rank: int = 0, device="cuda"):
    """:func:`dry_grid` of the production grid (:func:`make_topology`'s
    P = 1 or 2 pods x D = 16 x a 16-way model axis, a [1, 1] block a
    rank) over 256 or 512 fake ranks, at ``rank``: a context manager."""
    shape, _ = make_production_mesh(multi_pod=multi_pod)
    pods, data, model = (1,) * (3 - len(shape)) + tuple(shape)
    return dry_grid(pods, data, model, rank=rank, device=device)
