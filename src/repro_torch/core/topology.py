"""The hierarchy on one card: P edges x D devices as leading tensor dims.

The JAX package maps edges and devices onto mesh axes; here both tiers
are the leading dims of every per-device tensor (``[P, D, ...]``) and
per-edge tensor (``[P, ...]``) on one device, so no collective exists
until the multi-device slice.
"""
from __future__ import annotations

import dataclasses

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


@dataclasses.dataclass(frozen=True)
class Topology:
    """P edges x D devices on one device: CUDA unless the caller passes
    ``device="cpu"`` (see :func:`resolve_device`)."""
    pods: int                    # P edges (the T_E tier)
    devices_per_pod: int         # D devices per edge (the 1-bit tier)
    device: str | torch.device = "cuda"

    def __post_init__(self):
        if self.pods < 1 or self.devices_per_pod < 1:
            raise ValueError(f"need pods, devices_per_pod >= 1: "
                             f"{self.pods}, {self.devices_per_pod}")
        object.__setattr__(self, "device", resolve_device(self.device))
