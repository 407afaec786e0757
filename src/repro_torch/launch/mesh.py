"""Mesh construction.

Port of ``src/repro/launch/mesh.py``.  Functions, not module-level state,
so importing this module touches no process group.  Inside a process
group (``core.spmd.launch``, ``torchrun``) a mesh whose size is the
world's is *live*: a ``DeviceMesh`` over the ranks, one sub-group per
axis.  Outside one, a mesh of one position runs on one device, and a
larger one is *abstract*: its shape and names compute specs (the
production meshes of the dry run) but no collective runs over it.
"""

from __future__ import annotations

import math
from typing import Any, Optional, Sequence

import torch.distributed as dist

from ..core import spmd
from ..core.plan import TorchMesh, resolve_device


def make_mesh(shape: Sequence[int], axes: Sequence[str],
              device: Optional[Any] = None,
              ranks: Optional[Sequence[int]] = None) -> Optional[TorchMesh]:
    """A mesh of ``shape`` named ``axes``: live over the process group when
    its size is the world's, on one device (``cuda:0`` unless ``device``
    says otherwise) when it has one position, else abstract.  With
    ``ranks`` (global ranks, row-major), a live mesh over those ranks of a
    larger world: every rank of the world must call it, and a rank outside
    ``ranks`` gets ``None``."""
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} for axes {axes}")
    n = math.prod(shape)
    if dist.is_initialized() and (ranks is not None
                                  or n == dist.get_world_size()):
        import torch
        from torch.distributed.device_mesh import DeviceMesh
        ranks = list(range(n)) if ranks is None else list(ranks)
        if len(ranks) != n:
            raise ValueError(f"{len(ranks)} ranks for a mesh of {n}")
        dev = spmd.current_device() or resolve_device(device)
        kind = "cuda" if spmd.backend() == "nccl" else "cpu"
        dm = DeviceMesh(kind, torch.tensor(ranks).reshape(shape),
                        mesh_dim_names=axes)
        if dist.get_rank() not in ranks:
            return None
        return TorchMesh(dev, axes, shape, device_mesh=dm)
    if dist.is_initialized() and n > 1:
        raise ValueError(f"a mesh of {n} positions over a world of "
                         f"{dist.get_world_size()} ranks")
    if n == 1:
        return TorchMesh(resolve_device(device), axes, shape)
    return abstract_mesh(shape, axes)


def make_host_mesh(data: int = 1, model: int = 1,
                   device: Optional[Any] = None) -> TorchMesh:
    """A small ``(data, model)`` mesh over however many ranks exist — used
    by tests, the launcher and the smoke run."""
    n = spmd.world()
    data = min(data, n)
    model = min(model, max(1, n // data))
    return make_mesh((data, model), ("data", "model"), device)


def make_production_mesh(*, multi_pod: bool = False) -> TorchMesh:
    """The 16 x 16 (``data``, ``model``) mesh, or 2 x 16 x 16 with a
    ``pod`` axis: live in a world of 256 or 512 ranks, else abstract."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    if dist.is_initialized() and dist.get_world_size() == math.prod(shape):
        return make_mesh(shape, axes)
    return abstract_mesh(shape, axes)


def abstract_mesh(shape: Sequence[int], axes: Sequence[str]) -> TorchMesh:
    """A shape and names with no ranks behind them."""
    return TorchMesh(None, tuple(axes), tuple(int(s) for s in shape))


__all__ = ["make_mesh", "make_host_mesh", "make_production_mesh",
           "abstract_mesh"]
