"""Device-segment fusion — the pass between ``place`` and ``emit``.

Port of ``src/repro/core/fuse.py``.  The pass walks the placed stage list
and merges every maximal run of adjacent ``device`` placements into one
:class:`FusedSegment`, which ``emit`` lowers to a single
``_DeviceStageNode`` (hybrid graphs) or a single ``DeviceRunner`` part
(all-device graphs): one copy in and one copy out per microbatch, however
many stages composed into the run.  Inside a segment ``make_device_batched``
composes pipelines of pure stages into one batched function, folds farm and
``ffmap`` stages in, and runs ``all_to_all`` through the fused hop.

The module also owns the **segment cache**.  PyTorch runs eagerly, so
there is no trace to keep; :func:`jit_segment` keeps the batched callable
itself, keyed by (fused-stage identity, ``device_batch``, axis multiple,
mesh, capacity factor), so a second ``compile()`` of the same graph reuses
the first one's segment, as the reference reuses its jitted program.
"""

from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Any, List, Optional, Sequence, Tuple

from .graph import A2AG, FarmG, FFGraph, MapG, PipeG, SeqG


@dataclasses.dataclass
class FusedSegment:
    """A maximal run of contiguous device-placed top-level stages, lowered
    as ONE compiled program."""

    stages: List[Any]

    def describe(self) -> str:
        return " + ".join(s.describe() for s in self.stages)

    def subgraph(self) -> FFGraph:
        return FFGraph(self.stages[0] if len(self.stages) == 1
                       else PipeG(list(self.stages)))


def fuse_device_segments(stages: Sequence[Any], placements: Sequence[Any],
                         enable: bool = True) -> List[Tuple[Any, Any]]:
    """Group the placed stage list into ``(entry, placement)`` pairs where
    every maximal run of adjacent ``device`` placements becomes one
    :class:`FusedSegment` (its placement carries the widest width of the
    run).  ``enable=False`` degrades to one single-stage segment per device
    stage — the pre-fusion emit, kept for A/B benchmarks and parity tests."""
    out: List[Tuple[Any, Any]] = []
    run: List[Any] = []
    runp: List[Any] = []

    def close() -> None:
        if not run:
            return
        p = runp[0]
        if len(run) > 1:
            p = dataclasses.replace(
                p, width=max((q.width or 1) for q in runp),
                reason=f"fused run of {len(run)} device stages; " + p.reason)
        out.append((FusedSegment(list(run)), p))
        run.clear()
        runp.clear()

    for s, p in zip(stages, placements):
        if getattr(p, "target", "host") == "device":
            run.append(s)
            runp.append(p)
            if not enable:
                close()
        else:
            close()
            out.append((s, p))
    close()
    return out


# ---------------------------------------------------------------------------
# Segment cache
# ---------------------------------------------------------------------------
_JIT_CACHE: "OrderedDict[tuple, Any]" = OrderedDict()
_JIT_CACHE_MAX = 64
_hits = 0
_misses = 0


def _fingerprint(n: Any) -> Any:
    """Hashable identity of a device-lowerable IR node: the user callables
    (hashable by identity) plus the structure around them.  Raises TypeError
    for anything it cannot fingerprint — callers then skip caching."""
    if n is None:
        return None
    if isinstance(n, FFGraph):
        return ("graph", _fingerprint(n.root), n._wrap)
    if isinstance(n, SeqG):
        return ("seq", n.node, n.pure)
    if isinstance(n, PipeG):
        return ("pipe",) + tuple(_fingerprint(s) for s in n.stages)
    if isinstance(n, FarmG):
        return ("farm", n.fn, tuple(_fingerprint(w) for w in n.workers),
                _fingerprint(n.emitter), _fingerprint(n.collector), n.n_auto)
    if isinstance(n, MapG):
        return ("map", _fingerprint(n.splitter),
                tuple(_fingerprint(w) for w in n.workers),
                _fingerprint(n.composer))
    if isinstance(n, A2AG):
        return ("a2a", tuple(_fingerprint(x) for x in n.left),
                tuple(_fingerprint(x) for x in n.right), n.router)
    raise TypeError(f"no fingerprint for {type(n).__name__}")


def segment_key(sub: Any, device_batch: int, axis_mult: int, plan: Any,
                axis: str, a2a_capacity_factor: Optional[float] = None,
                feedback_steps: Optional[int] = None,
                feedback_cond: Optional[Any] = None) -> Optional[tuple]:
    """Cache key for a fused segment, or None when any component resists
    fingerprinting (unhashable callables, odd meshes) — an uncacheable
    segment is just built fresh, never an error.  ``feedback_cond``
    (the data-dependent loop predicate) keys by callable identity, like the
    stage callables themselves."""
    try:
        mesh = getattr(plan, "mesh", None)
        try:
            mesh_id: Any = hash(mesh) if mesh is not None else None
        except TypeError:
            mesh_id = id(mesh)
        key = (_fingerprint(sub), int(device_batch), int(axis_mult),
               mesh_id, axis, a2a_capacity_factor, feedback_steps,
               feedback_cond)
        hash(key)
        return key
    except TypeError:
        return None


def jit_segment(batched: Any, key: Optional[tuple]) -> Any:
    """The segment's batched callable through a bounded cross-compile cache:
    the same fused segment (same key) returns the SAME callable, so an
    identical graph compiled again reuses it."""
    global _hits, _misses
    if key is None:
        return batched
    f = _JIT_CACHE.get(key)
    if f is not None:
        _JIT_CACHE.move_to_end(key)
        _hits += 1
        return f
    _JIT_CACHE[key] = batched
    _misses += 1
    while len(_JIT_CACHE) > _JIT_CACHE_MAX:
        _JIT_CACHE.popitem(last=False)
    return batched


def segment_cache_info() -> dict:
    return {"size": len(_JIT_CACHE), "hits": _hits, "misses": _misses,
            "max": _JIT_CACHE_MAX}


def segment_cache_clear() -> None:
    global _hits, _misses
    _JIT_CACHE.clear()
    _hits = 0
    _misses = 0
