"""The hierarchy: P edges x D devices, on one process or over a grid of them.

The JAX package maps edges and devices onto mesh axes; here both tiers
are the leading dims of every per-device tensor (``[P, D, ...]``) and
per-edge tensor (``[P, ...]``).  Without a process mesh one process
holds the whole ``[P, D]`` block on one device and no collective exists.

With a :class:`ProcessMesh` (``launch.mesh.make_host_topology``) the
``[P, D]`` grid is laid over ``pods x data x model`` processes: the
rank at coordinates ``(a, b, m)`` holds the block of edges ``[a*P_loc,
(a+1)*P_loc)`` and of their devices ``[b*D_loc, (b+1)*D_loc)``, with P
= pods * P_loc and D = data * D_loc, and model shard m of every leaf
that the model's specs split (tensor parallelism, ``core.shardflat``).
``pods`` and ``devices_per_pod`` stay the **global** P and D, as the
JAX ``Topology``'s are; the block is ``local_pods`` x
``local_devices`` at ``pod_offset`` / ``device_offset``.  The ranks
are numbered as the JAX mesh lays out its devices, ``rank = (a*data +
b)*model + m``.  The data group of a rank is the ranks ``(a, ., m)``
-- across which an edge's sign words travel --, its pod group the
ranks ``(., b, m)`` -- across which the edge models travel to the
cloud -- and its model group the ranks ``(a, b, .)``, across which
only the tensor-parallel forward's and backward's sums travel
(``core.comm``).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks for
    the CPU.  Asking for CUDA where there is none raises -- a run never
    carries on on the CPU.  On CUDA, TF32 is switched off for float32
    matmuls and convolutions, as the float32 reference arithmetic needs."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {device!r} requested but torch.cuda.is_available() "
                "is False; pass device='cpu' to run on the CPU")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r} (cuda or cpu)")
    return dev


@dataclasses.dataclass(frozen=True, eq=False)
class ProcessMesh:
    """A ``pods x data x model`` grid of processes and this rank's place
    in it: global rank ``(pod_rank * data + data_rank) * model +
    model_rank``.

    ``data_group``: the ranks of this rank's pod and model shard, in
    data order; ``pod_group``: the ranks of its data column and model
    shard, in pod order; ``model_group``: the ranks of its (pod, data)
    cell, in model order (``torch.distributed`` process groups, or None
    on an axis of size 1); ``backend``: ``"gloo"`` or ``"nccl"``."""
    pods: int
    data: int
    pod_rank: int
    data_rank: int
    pod_group: Any
    data_group: Any
    backend: str
    model: int = 1
    model_rank: int = 0
    model_group: Any = None

    @property
    def size(self) -> int:
        return self.pods * self.data * self.model

    @property
    def rank(self) -> int:
        return (self.pod_rank * self.data + self.data_rank) * self.model \
            + self.model_rank


@dataclasses.dataclass(frozen=True)
class Topology:
    """P edges x D devices: CUDA unless the caller passes
    ``device="cpu"`` (see :func:`resolve_device`); over a process mesh
    when ``mesh`` is given (P and D stay global, see the module
    docstring)."""
    pods: int                    # P edges (the T_E tier)
    devices_per_pod: int         # D devices per edge (the 1-bit tier)
    device: str | torch.device = "cuda"
    mesh: ProcessMesh | None = None

    def __post_init__(self):
        if self.pods < 1 or self.devices_per_pod < 1:
            raise ValueError(f"need pods, devices_per_pod >= 1: "
                             f"{self.pods}, {self.devices_per_pod}")
        m = self.mesh
        if m is not None and (self.pods % m.pods
                              or self.devices_per_pod % m.data):
            raise ValueError(
                f"P x D = {self.pods} x {self.devices_per_pod} does not "
                f"divide into the {m.pods} x {m.data} process mesh")
        object.__setattr__(self, "device", resolve_device(self.device))

    @property
    def model_shards(self) -> int:
        """The model axis: how many ranks split a sharded leaf (1
        without a mesh)."""
        return self.mesh.model if self.mesh else 1

    @property
    def model_rank(self) -> int:
        return self.mesh.model_rank if self.mesh else 0

    # -- this rank's block --------------------------------------------------
    @property
    def local_pods(self) -> int:
        return self.pods // (self.mesh.pods if self.mesh else 1)

    @property
    def local_devices(self) -> int:
        return self.devices_per_pod // (self.mesh.data if self.mesh else 1)

    @property
    def pod_offset(self) -> int:
        return self.mesh.pod_rank * self.local_pods if self.mesh else 0

    @property
    def device_offset(self) -> int:
        return self.mesh.data_rank * self.local_devices if self.mesh else 0

    @property
    def pod_rows(self) -> slice:
        """This rank's edges on the global P axis."""
        return slice(self.pod_offset, self.pod_offset + self.local_pods)

    def voter_cols(self, per_device: int = 1) -> slice:
        """This rank's voters on a global ``D * per_device`` axis (the
        merged ``D*K`` voter axis with ``per_device=K``)."""
        lo = self.device_offset * per_device
        return slice(lo, lo + self.local_devices * per_device)

    def block(self, tree, per_device: int = 1):
        """This rank's ``[P_loc, D_loc*per_device, ...]`` block of a tree
        of global ``[P, D*per_device, ...]`` arrays (views; the whole
        tree without a mesh)."""
        if self.mesh is None:
            return tree
        rows, cols = self.pod_rows, self.voter_cols(per_device)
        if isinstance(tree, dict):
            return {k: self.block(v, per_device) for k, v in tree.items()}
        return tree[rows, cols]
