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
"""
from __future__ import annotations

import datetime
import math

import torch.distributed as dist

from repro_torch.core.topology import ProcessMesh, Topology

BACKENDS = ("gloo", "nccl")
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
                       backend: str, device, block: tuple = (1, 1)
                       ) -> Topology:
    """The topology of this rank on a ``pods x data x model`` process
    grid: P = pods * block[0] edges, D = data * block[1] devices an
    edge, the rank ``(a*data + b)*model + m`` holding a block of
    ``block[0] x block[1]`` at ``(a, b)`` and model shard m.

    Every rank must call this, in the same order as its peers: each
    builds the ``pods * model`` data groups, the ``data * model`` pod
    groups and, with ``model > 1``, the ``pods * data`` model groups,
    every group with a 60 s timeout.  ``backend`` is explicit
    (``"gloo"`` or ``"nccl"``); ``device`` is this rank's device."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r} (choose from "
                         f"{', '.join(BACKENDS)})")
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

    def groups(members):
        """Create every group (every rank, one order); keep this rank's."""
        mine = None
        for ranks in members:
            g = dist.new_group(ranks, timeout=TIMEOUT, backend=backend)
            if rank in ranks:
                mine = g
        return mine

    data_group = groups([[at(a, b, m) for b in range(data)]
                         for a in range(pods) for m in range(model)])
    pod_group = groups([[at(a, b, m) for a in range(pods)]
                        for b in range(data) for m in range(model)])
    model_group = (groups([[at(a, b, m) for m in range(model)]
                           for a in range(pods) for b in range(data)])
                   if model > 1 else None)
    mesh = ProcessMesh(pods=pods, data=data, pod_rank=pod_rank,
                       data_rank=data_rank, pod_group=pod_group,
                       data_group=data_group, backend=backend, model=model,
                       model_rank=model_rank, model_group=model_group)
    return Topology(pods * block[0], data * block[1], device, mesh=mesh)
