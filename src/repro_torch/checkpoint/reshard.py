"""Elastic resharding: restore any checkpoint onto any mesh.

Port of ``src/repro/checkpoint/reshard.py``.  Checkpoints store whole
(host-gathered) arrays — either package's (``checkpoint/ckpt.py``) — so
resharding is each rank taking its block of every leaf by the new plan's
:func:`~repro_torch.runtime.steps.state_shardings`: shrink or grow the
mesh without conversion tools.  :func:`host_state` reads a checkpoint as
memory-mapped arrays, so a rank reads only the blocks it keeps;
:func:`gather_state` is the way back, every rank's blocks assembled into
the whole state on the host.  For states whose *structure* depends on the
mesh (none of ours do — factored Adafactor stats are mesh-independent) a
transform hook is provided.
"""

from __future__ import annotations

import json
import pathlib
from typing import Callable, Optional

import numpy as np
import torch

from ..core.tree import jax_leaves, jax_unflatten, tree_map
from ..runtime.steps import state_shardings, state_structs


def host_state(directory, cfg, plan, step: Optional[int] = None,
               optimizer=None):
    """The train state of a checkpoint (the latest unless ``step``) as a
    tree of read-only memory-mapped numpy arrays (bf16 leaves as the
    checkpoint widened them, to fp32), in the structure of
    ``state_structs(cfg, plan)``."""
    from .ckpt import latest_step
    directory = pathlib.Path(directory)
    step = latest_step(directory) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoints in {directory}")
    d = directory / f"step_{step:08d}"
    manifest = json.loads((d / "manifest.json").read_text())
    like = state_structs(cfg, plan, optimizer)
    if manifest["n_leaves"] != len(jax_leaves(like)):
        raise ValueError(f"checkpoint {d} has {manifest['n_leaves']} "
                         f"leaves, the state {len(jax_leaves(like))}")
    arrays = [np.load(d / f"arr_{i}.npy", mmap_mode="r")
              for i in range(manifest["n_leaves"])]
    return jax_unflatten(like, arrays)


def _block(a, sharding, dtype: torch.dtype, device) -> torch.Tensor:
    a = sharding.local_block(np.asarray(a))
    t = torch.from_numpy(np.array(a, order="C"))     # a writable copy
    return t.to(device=device, dtype=dtype)


def reshard_state(cfg, old_state_host, new_plan, transform:
                  Optional[Callable] = None, optimizer=None):
    """``old_state_host``: the whole state on the host (numpy arrays or
    tensors, e.g. :func:`host_state` or ``load_checkpoint`` without a
    mesh).  Returns this rank's part of it on ``new_plan``'s mesh and
    device, each leaf in its ``state_structs`` type."""
    if transform is not None:
        old_state_host = transform(old_state_host)
    sh = state_shardings(cfg, new_plan, optimizer)
    st = state_structs(cfg, new_plan, optimizer)

    def place(a, s, t):
        if isinstance(a, torch.Tensor):
            a = a.detach().cpu().float().numpy() \
                if a.dtype == torch.bfloat16 else a.detach().cpu().numpy()
        return _block(a, s, t.dtype, new_plan.device)
    leaves = [place(a, s, t) for a, s, t in zip(
        jax_leaves(old_state_host), jax_leaves(sh), jax_leaves(st))]
    return jax_unflatten(st, leaves)


def gather_state(cfg, state, plan, optimizer=None):
    """The whole state on the host from every rank's part — the state on
    one rank again — as tensors in their own types."""
    sh = state_shardings(cfg, plan, optimizer)
    return tree_map(lambda t, s: s.gather(t).cpu(), state, sh)
