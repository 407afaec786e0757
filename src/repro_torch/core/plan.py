"""The device a compiled graph runs on.

The reference's :class:`~repro.core.plan.ShardingPlan` maps logical axes
onto a JAX mesh.  The port runs on one CUDA device (or, when the caller asks
for it, the CPU), so its plan is that device plus a one-device mesh whose
``shape`` is the dict ``{"data": 1}`` — the surface the compiler's
``place``/``_mesh_axis_size`` read, unchanged from the reference.  Sharded
plans over several devices are a later slice.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class TorchMesh:
    """A mesh of one device: hashable by value, so equal plans share the
    compiled-segment cache as equal JAX meshes do."""

    device: torch.device
    axis_names: Tuple[str, ...] = ("data",)

    @property
    def shape(self) -> Dict[str, int]:
        return {name: 1 for name in self.axis_names}


@dataclasses.dataclass(frozen=True)
class TorchPlan:
    mesh: TorchMesh

    @property
    def device(self) -> torch.device:
        return self.mesh.device


def resolve_device(device: Optional[Any] = None) -> torch.device:
    """``None`` means the first CUDA device, and raises without one: the
    CPU is used only when the caller names it."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: the port runs on the GPU by default; pass "
                "device=\"cpu\" to run it on the CPU")
        return torch.device("cuda", 0)
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", 0)
    return dev


def single_device_plan(device: Optional[Any] = None) -> TorchPlan:
    """A plan over one device: ``cuda:0`` unless ``device`` says otherwise
    (tests pass ``device="cpu"``)."""
    return TorchPlan(TorchMesh(resolve_device(device)))
