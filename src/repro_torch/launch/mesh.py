"""Process meshes: the hierarchy laid over ``torch.distributed`` ranks.

The counterpart of the JAX package's ``launch/mesh.py``.  There a mesh
axis is a set of chips; here it is a set of processes, and its
collectives are a process group's (``core.comm``):

  * ``data`` -- the devices of an edge: the 1-bit sign words cross it
    every local step;
  * ``pod``  -- the edges under the cloud: the edge models cross it
    every T_E steps;
  * ``model`` -- tensor parallelism.  Only ``model=1`` is ported: the
    16-way model axis of the production meshes, the sharded flat
    layouts and ``core/shardflat.py`` are ROADMAP item 17b.

:func:`make_host_topology` lays a ``pods x data`` grid over the ranks of
the initialised default group (``torch.distributed.init_process_group``,
its address, world size and rank given by the caller or by ``torchrun``).
The backend is the caller's choice: ``"gloo"`` for the CPU and for ranks
that share one card (NCCL refuses two ranks on one GPU), ``"nccl"`` for
one GPU a rank.
"""
from __future__ import annotations

import datetime
import math

import torch.distributed as dist

from repro_torch.core.topology import ProcessMesh, Topology

BACKENDS = ("gloo", "nccl")
TIMEOUT = datetime.timedelta(seconds=60)   # a peer that died fails a
                                           # collective within a minute


def _model_axis(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what}: the production meshes' 16-way model axis (tensor "
        "parallelism with core/shardflat.py and the sharded flat layouts) "
        "is ROADMAP item 17b; a process mesh has model=1")


def make_production_mesh(*, multi_pod: bool = False):
    raise _model_axis("make_production_mesh")


def make_topology(*, multi_pod: bool = False) -> Topology:
    raise _model_axis("make_topology" + (" (--multi_pod)" if multi_pod
                                         else ""))


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
    """The topology of this rank on a ``pods x data`` process grid: P =
    pods * block[0] edges, D = data * block[1] devices an edge, the rank
    at ``(rank // data, rank % data)`` holding a block of
    ``block[0] x block[1]``.

    Every rank must call this, in the same order as its peers: each
    builds the ``pods`` data groups (a pod row each) and the ``data``
    pod groups (a data column each), every group with a 60 s timeout.
    ``backend`` is explicit (``"gloo"`` or ``"nccl"``); ``device`` is
    this rank's device."""
    if model != 1:
        raise _model_axis(f"make_host_topology(model={model})")
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r} (choose from "
                         f"{', '.join(BACKENDS)})")
    if not dist.is_initialized():
        raise RuntimeError("make_host_topology needs the default process "
                           "group: call torch.distributed."
                           "init_process_group first")
    world, rank = dist.get_world_size(), dist.get_rank()
    if world != pods * data:
        raise ValueError(f"a {pods} x {data} mesh needs {pods * data} "
                         f"ranks, the default group has {world}")
    pod_rank, data_rank = divmod(rank, data)
    data_group = pod_group = None
    for a in range(pods):           # every rank creates every group
        g = dist.new_group([a * data + b for b in range(data)],
                           timeout=TIMEOUT, backend=backend)
        if a == pod_rank:
            data_group = g
    for b in range(data):
        g = dist.new_group([a * data + b for a in range(pods)],
                           timeout=TIMEOUT, backend=backend)
        if b == data_rank:
            pod_group = g
    mesh = ProcessMesh(pods=pods, data=data, pod_rank=pod_rank,
                       data_rank=data_rank, pod_group=pod_group,
                       data_group=data_group, backend=backend)
    return Topology(pods * block[0], data * block[1], device, mesh=mesh)
