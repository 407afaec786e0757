"""Atomic, async checkpointing in the reference's on-disk layout.

Port of ``src/repro/checkpoint/ckpt.py`` (``save_checkpoint``,
``load_checkpoint``, ``latest_step``, ``CheckpointManager``) on one device.

Layout:  <dir>/step_<N>/
            manifest.json          step, leaf count, dtypes, shapes, extras
            arr_<i>.npy            one file per leaf, bf16 widened to fp32
         <dir>/step_<N>.tmp        staged then os.replace()'d — a crash mid-
                                   save never corrupts the latest checkpoint.

Leaves are numbered as ``jax.tree.flatten`` numbers them: dict keys in
sorted order (``core.tree.jax_leaves`` and ``jax_unflatten``; the port's
``tree_leaves`` follows insertion order), lists and tuples in order.
So a checkpoint written by either package restores into the other: the
manifest's ``treedef`` (the reference's serialized JAX tree) is ``None``
here, and neither loader reads it.

``save_async`` snapshots the leaves to host memory at once (the train step
updates the state in place) and writes the files on a background thread.
On restore, each array takes the dtype and device of the matching leaf of
``state_like``.
"""

from __future__ import annotations

import json
import os
import pathlib
import shutil
import threading
import time
from typing import Optional

import numpy as np
import torch

from ..core.tree import jax_leaves, jax_unflatten


def _host(leaf) -> np.ndarray:
    """A host copy of a leaf as numpy; bf16 widened to fp32 (exact)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.to("cpu", copy=True).numpy()
    return np.asarray(leaf)


def save_checkpoint(directory, step: int, state, extras: Optional[dict] = None,
                    keep: int = 3) -> pathlib.Path:
    directory = pathlib.Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    final = directory / f"step_{step:08d}"
    tmp = directory / f"step_{step:08d}.tmp"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    dtypes, shapes = [], []
    for i, leaf in enumerate(jax_leaves(state)):   # one host copy at a time
        a = _host(leaf)
        np.save(tmp / f"arr_{i}.npy", a)
        dtypes.append(str(a.dtype))
        shapes.append(list(a.shape))
    manifest = {
        "step": step,
        "treedef": None,
        "tree_repr": repr(_structure(state)),
        "n_leaves": len(dtypes),
        "dtypes": dtypes,
        "shapes": shapes,
        "extras": extras or {},
        "time": time.time(),
    }
    (tmp / "manifest.json").write_text(json.dumps(manifest))
    if final.exists():
        shutil.rmtree(final)
    os.replace(tmp, final)                       # atomic publish
    _gc_old(directory, keep)
    return final


def _structure(tree):
    if isinstance(tree, dict):
        return {k: _structure(tree[k]) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return [_structure(v) for v in tree]
    return "*"


def _gc_old(directory: pathlib.Path, keep: int) -> None:
    steps = sorted(p for p in directory.glob("step_????????")
                   if p.is_dir() and not p.name.endswith(".tmp"))
    for p in steps[:-keep]:
        shutil.rmtree(p, ignore_errors=True)


def latest_step(directory) -> Optional[int]:
    directory = pathlib.Path(directory)
    steps = sorted(p.name for p in directory.glob("step_????????"))
    if not steps:
        return None
    return int(steps[-1].split("_")[1])


def _like(a: np.ndarray, leaf):
    if isinstance(leaf, torch.Tensor):
        return torch.from_numpy(a).to(device=leaf.device, dtype=leaf.dtype)
    return a.astype(np.asarray(leaf).dtype)


def load_checkpoint(directory, state_like, step: Optional[int] = None):
    """Restore into the structure of ``state_like``: each array in the
    dtype and on the device of the matching leaf.  Returns (state,
    extras)."""
    directory = pathlib.Path(directory)
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {directory}")
    d = directory / f"step_{step:08d}"
    manifest = json.loads((d / "manifest.json").read_text())
    leaves = jax_leaves(state_like)
    if manifest["n_leaves"] != len(leaves):
        raise ValueError(f"checkpoint {d} has {manifest['n_leaves']} "
                         f"leaves, the state {len(leaves)}")
    arrays = [_like(np.load(d / f"arr_{i}.npy"), l)
              for i, l in enumerate(leaves)]
    return jax_unflatten(state_like, arrays), manifest.get("extras", {})


class CheckpointManager:
    """Background (async) saver, one save in flight, plus restore.
    ``save_seconds`` is the wall time of the last save: for ``save`` the
    whole of it, for ``save_async`` the snapshot the caller waits for."""

    def __init__(self, directory, keep: int = 3):
        self.directory = pathlib.Path(directory)
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self.last_saved: Optional[int] = None
        self.save_seconds: Optional[float] = None
        self.error: Optional[BaseException] = None

    def save_async(self, step: int, state, extras: Optional[dict] = None):
        self.wait()                          # one in flight at a time
        t0 = time.perf_counter()
        # snapshot to host NOW: the next step updates the state in place
        host_state = jax_unflatten(state,
                                   [_host(l) for l in jax_leaves(state)])
        self.save_seconds = time.perf_counter() - t0

        def work():
            try:
                save_checkpoint(self.directory, step, host_state, extras,
                                self.keep)
                self.last_saved = step
            except BaseException as e:       # noqa: BLE001 - raised in wait()
                self.error = e

        self._thread = threading.Thread(target=work, daemon=True,
                                        name="ckpt-saver")
        self._thread.start()

    def save(self, step: int, state, extras: Optional[dict] = None):
        t0 = time.perf_counter()
        save_checkpoint(self.directory, step, state, extras, self.keep)
        self.save_seconds = time.perf_counter() - t0
        self.last_saved = step

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self.error is not None:
            e, self.error = self.error, None
            raise e

    def restore(self, state_like, step: Optional[int] = None):
        return load_checkpoint(self.directory, state_like, step)

    def latest(self) -> Optional[int]:
        return latest_step(self.directory)
