"""Building-blocks graph IR — the single front door to every skeleton.

Port of ``src/repro/core/graph.py``.  The IR (``seq``/``pipeline``/``farm``/
``ffmap``/``all_to_all`` building blocks, ``wrap_around`` feedback), the
``optimize()`` normal-form rewrites and the host runtime (:class:`HostRunner`
over the SPSC networks of core/queues.py) are the reference's, copied.  The
device lowering is PyTorch: :func:`_device_fn` composes the per-item torch
functions of a device-lowerable subgraph, and :class:`DeviceRunner` runs a
whole graph as batched calls (``torch.func.vmap``) on the plan's device,
behind a host<->device boundary that can keep a window of microbatches in
flight (CUDA side streams and events; synchronous on the CPU).
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import threading
import time
import traceback
import warnings
from typing import Any, Callable, List, Optional, Sequence

import torch

from .node import EOS, GO_ON, FFNode, FnNode, spawn_drainer
from .queues import MPMCQueue, MPSCQueue, SPMCQueue, SPSCQueue
from .skeletons import (AutoscaleLB, Farm, FFMap, LoadBalancer, Pipeline,
                        Skeleton, _CollectorRunner)
from .tree import stack_items, to_numpy, tree_leaves, tree_map


class GraphError(Exception):
    """Raised for malformed graphs or unlowerable target combinations."""


class Deliver:
    """Marks an item as a *result* even inside a feedback loop: with
    ``wrap_around()`` active, plain outputs re-enter the input stream while
    ``Deliver(x)`` escapes to ``load_result``."""

    __slots__ = ("value",)

    def __init__(self, value: Any):
        self.value = value


# ---------------------------------------------------------------------------
# IR nodes
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class SeqG:
    """A sequential building block: an FFNode/Skeleton instance, or a plain
    callable (``pure=True`` — assumed a stateless 1->1 map, which licenses
    the optimizer to move/compose it and the device path to batch it).

    ``cost``/``placement`` are filled in by the staged compiler's
    ``annotate``/``place`` passes (core/compiler.py) — None until compiled."""
    node: Any
    pure: bool = False
    cost: Any = None
    placement: Any = None

    def describe(self) -> str:
        name = self.node.__name__ if self.pure and hasattr(self.node, "__name__") \
            else type(self.node).__name__
        return f"seq({name})"


@dataclasses.dataclass
class PipeG:
    stages: List[Any]
    cost: Any = None
    placement: Any = None

    def describe(self) -> str:
        return "pipe(" + " -> ".join(s.describe() for s in self.stages) + ")"


@dataclasses.dataclass
class FarmG:
    workers: List[Any]
    emitter: Optional[Any] = None
    collector: Optional[Any] = None
    lb: Optional[LoadBalancer] = None
    ondemand: Optional[int] = None
    fn: Optional[Callable] = None    # set when built from one replicated pure fn
    n_auto: bool = False             # width left to the compiler's cost model
    autoscale: bool = False          # host workers grow/shrink from queue depth
    cost: Any = None
    placement: Any = None

    def describe(self) -> str:
        width = "auto" if self.n_auto else str(len(self.workers))
        bits = [f"farm[{width}]({self.workers[0].describe()})"]
        if self.emitter is not None:
            bits.insert(0, f"E:{self.emitter.describe()}")
        if self.collector is not None:
            bits.append(f"C:{self.collector.describe()}")
        return " ".join(bits)


@dataclasses.dataclass
class MapG:
    splitter: Any
    workers: List[Any]
    composer: Any
    cost: Any = None
    placement: Any = None

    def describe(self) -> str:
        return f"map[{len(self.workers)}]({self.workers[0].describe()})"


@dataclasses.dataclass
class A2AG:
    """FastFlow 3's ``ff_a2a``: every left-side worker may send each output
    to any right-side worker, selected by ``router(item, n_right)``."""
    left: List[Any]
    right: List[Any]
    router: Optional[Callable[[Any, int], int]] = None
    cost: Any = None
    placement: Any = None

    def describe(self) -> str:
        return f"a2a[{len(self.left)}x{len(self.right)}]"


def _to_g(obj: Any) -> Any:
    """Coerce user objects into IR nodes."""
    if isinstance(obj, FFGraph):
        if obj._wrap:
            raise GraphError(
                "wrap_around is only honored on the top-level graph: compose "
                "the unwrapped subgraph and call wrap_around() on the result")
        return obj.root
    if isinstance(obj, (SeqG, PipeG, FarmG, MapG, A2AG)):
        return obj
    if isinstance(obj, (FFNode, Skeleton)):
        return SeqG(obj, pure=False)
    if callable(obj):
        return SeqG(obj, pure=True)
    raise GraphError(f"cannot use {obj!r} as a graph building block")


# ---------------------------------------------------------------------------
# Constructors (the public building-blocks vocabulary)
# ---------------------------------------------------------------------------
def seq(obj: Any, *, pure: Optional[bool] = None) -> "FFGraph":
    g = _to_g(obj)
    if pure is not None:
        if not isinstance(g, SeqG):
            raise GraphError("pure= applies only to a single node/callable, "
                             f"not {type(g).__name__}")
        if pure and not callable(g.node):
            raise GraphError("pure=True requires a callable: lowering calls "
                             f"it as a function, and {type(g.node).__name__} "
                             "is not one")
        # copy before overriding: _to_g may alias a node owned by another
        # graph, whose purity must not silently change under it
        g = dataclasses.replace(g, pure=pure)
    return FFGraph(g)


def pipeline(*stages: Any) -> "FFGraph":
    if not stages:
        raise GraphError("empty pipeline")
    return FFGraph(PipeG([_to_g(s) for s in stages]))


def farm(workers: Any, n: Any = None, *, emitter: Any = None,
         collector: Any = None, lb: Optional[LoadBalancer] = None,
         ondemand: Optional[int] = None, autoscale: bool = False) -> "FFGraph":
    """``farm(fn, n)`` replicates a pure worker; ``farm([w0, w1, ...])``
    takes explicit (possibly stateful) workers.

    ``n="auto"`` leaves the width to the compiler's cost model (``place``
    picks it from the annotated per-item time, ``Placement(width=...)``
    overrides).  ``autoscale=True`` (replicated pure workers only) makes the
    host farm grow/shrink its active worker set at runtime from observed
    queue depth, between 1 and ``n`` (or ``os.cpu_count()`` when ``n`` is
    omitted)."""
    fn = None
    n_auto = n == "auto" or (n is None and autoscale)
    if n_auto:
        n = None
    if isinstance(workers, (FFNode, Skeleton, FFGraph, SeqG, PipeG, FarmG,
                            MapG, A2AG)):
        g = _to_g(workers)
        if isinstance(g, SeqG) and g.pure:   # pure blocks replicate freely
            fn = g.node
            ws = [SeqG(fn, pure=True) for _ in range(n if n is not None else 1)]
        else:
            ws = [g]                         # a single stateful worker
            if n is not None and n != 1:
                raise GraphError("cannot replicate a stateful worker; pass a "
                                 "list of instances or farm(fn, n=...)")
    elif callable(workers):
        if n is None and not n_auto:
            raise GraphError("farm(fn) needs n=<replicas> (or n=\"auto\" / "
                             "autoscale=True to let the compiler choose)")
        fn = workers
        ws = [SeqG(workers, pure=True) for _ in range(n if n is not None else 1)]
    else:
        try:
            ws = [_to_g(w) for w in list(workers)]
        except TypeError as e:
            raise GraphError(f"farm workers must be a callable, a node, or "
                             f"a sequence of them (got {workers!r})") from e
        if n is not None and n != len(ws):
            raise GraphError("n disagrees with explicit worker list")
    if not ws:
        raise GraphError("farm with no workers")
    if (autoscale or n_auto) and fn is None:
        raise GraphError("n=\"auto\"/autoscale farms need one replicated pure "
                         "worker: farm(fn, autoscale=True)")
    if autoscale and (lb is not None or ondemand is not None):
        raise GraphError("autoscale installs its own load balancer; "
                         "drop lb=/ondemand= or autoscale=")
    return FFGraph(FarmG(ws, emitter=None if emitter is None else _to_g(emitter),
                         collector=None if collector is None else _to_g(collector),
                         lb=lb, ondemand=ondemand, fn=fn, n_auto=n_auto,
                         autoscale=autoscale))


def ffmap(splitter: Any, workers: Sequence, composer: Any) -> "FFGraph":
    return FFGraph(MapG(_to_g(splitter), [_to_g(w) for w in workers],
                        _to_g(composer)))


def all_to_all(left: Sequence, right: Sequence,
               router: Optional[Callable[[Any, int], int]] = None) -> "FFGraph":
    ls = [_to_g(l) for l in left]
    rs = [_to_g(r) for r in right]
    for g in (*ls, *rs):
        # the a2a runtime drives ff_node workers (svc/svc_init/svc_end);
        # composite blocks have no such surface
        if not isinstance(g, SeqG) or isinstance(g.node, Skeleton):
            raise GraphError("all_to_all workers must be plain nodes or "
                             f"callables, not {g.describe()}")
    return FFGraph(A2AG(ls, rs, router))


# ---------------------------------------------------------------------------
# Host runtime for the all-to-all stage (over the L2 MPMC network)
# ---------------------------------------------------------------------------
class A2ASkeleton(Skeleton):
    """Host lowering of ``ff_a2a``: left workers route every output through an
    MPMC grid of SPSC lanes to a router-selected right worker; right outputs
    are gathered by a collector thread.  EOS fans out row-wise so each right
    worker terminates after seeing EOS from every left worker."""

    def __init__(self, left: Sequence[FFNode], right: Sequence[FFNode],
                 router: Optional[Callable[[Any, int], int]] = None,
                 capacity: int = 512):
        super().__init__()
        self._left = list(left)
        self._right = list(right)
        self._router = router
        self._cap = capacity
        self._threads: List[threading.Thread] = []
        self._col: Optional[_CollectorRunner] = None

    def _left_loop(self, i: int, node: FFNode, has_input: bool) -> None:
        nR = len(self._right)
        rr = [i % nR]                       # stagger round-robin per producer

        def send(y: Any) -> None:
            if self._router is not None:
                # int() so tensor/numpy-scalar-returning routers (shared
                # with the device lowering, where they must vmap) index the
                # grid
                j = int(self._router(y, nR)) % nR
            else:
                j, rr[0] = rr[0], (rr[0] + 1) % nR
            self._grid.push(i, j, y)

        input_eos = not has_input
        try:
            node._bind(send, i)
            if node.svc_init() < 0:
                raise RuntimeError("a2a left svc_init failed")
            while True:
                if has_input:
                    t = self._spmc.lanes[i].pop()
                    if t is EOS:
                        input_eos = True
                        break
                else:
                    t = None
                node.svc_calls += 1
                r = node.svc(t)
                if r is None or r is EOS:
                    break
                if r is not GO_ON:
                    send(r)
        except BaseException as e:          # noqa: BLE001
            node.error = e
            traceback.print_exc()
        finally:
            try:
                node.svc_end()
            finally:
                if not input_eos:
                    # early exit (voluntary or crash): hand the lane to a
                    # detached drainer FIRST — the grid EOS fan-out below can
                    # block on a dead right worker's full column, and the
                    # feeder must never wedge on this worker's input lane
                    # while that resolves
                    spawn_drainer(self._spmc.lanes[i].pop)
                for j in range(nR):
                    self._grid.push(i, j, EOS)

    def _right_loop(self, j: int, node: FFNode) -> None:
        nL = len(self._left)
        lane_out = self._mpsc.lane(j)
        eos_seen = 0
        try:
            node._bind(lane_out.push, j)
            if node.svc_init() < 0:
                raise RuntimeError("a2a right svc_init failed")
            while eos_seen < nL:
                item, _src = self._grid.pop(j)
                if item is EOS:
                    eos_seen += 1
                    continue
                node.svc_calls += 1
                r = node.svc(item)
                if r is None or r is EOS:
                    break
                if r is not GO_ON:
                    lane_out.push(r)
        except BaseException as e:          # noqa: BLE001
            node.error = e
            traceback.print_exc()
        finally:
            try:
                node.svc_end()
            finally:
                lane_out.push(EOS)
                if eos_seen < nL:
                    # early exit: keep the grid column draining so left
                    # producers never block on this dead worker's lanes
                    spawn_drainer(lambda: self._grid.pop(j)[0],
                                  nL - eos_seen)

    def _start(self, in_q: Optional[SPSCQueue]) -> None:
        nL, nR = len(self._left), len(self._right)
        self._grid = MPMCQueue(nL, nR, self._cap)
        self._mpsc = MPSCQueue(nR, self._cap)
        out = self._out if self._out is not None else (lambda item: None)
        self._col = _CollectorRunner(None, self._mpsc, out, nR)
        self._col.start()
        for j, node in enumerate(self._right):
            t = threading.Thread(target=self._right_loop, args=(j, node),
                                 daemon=True, name=f"a2a-right-{j}")
            t.start()
            self._threads.append(t)
        has_input = in_q is not None
        if has_input:
            self._spmc = SPMCQueue(nL, self._cap)
        for i, node in enumerate(self._left):
            t = threading.Thread(target=self._left_loop,
                                 args=(i, node, has_input), daemon=True,
                                 name=f"a2a-left-{i}")
            t.start()
            self._threads.append(t)
        if has_input:
            def feed() -> None:
                while True:
                    item = in_q.pop()
                    if item is EOS:
                        self._spmc.broadcast(EOS)
                        break
                    self._spmc.push_rr(item)
            t = threading.Thread(target=feed, daemon=True, name="a2a-feed")
            t.start()
            self._threads.append(t)

    def _join(self, timeout: Optional[float] = None) -> None:
        for t in self._threads:
            t.join(timeout)
        if self._col is not None:
            self._col.join(timeout)

    def _error(self) -> Optional[BaseException]:
        for n in (*self._left, *self._right):
            if n.error is not None:
                return n.error
        if self._col is not None:
            return self._col.error
        return None

    def _alive(self) -> bool:
        if any(t.is_alive() for t in self._threads):
            return True
        return self._col is not None and self._col.thread.is_alive()

    def stats(self) -> dict:
        grid = getattr(self, "_grid", None)
        return {"type": "a2a",
                "left": [n.node_stats() for n in self._left],
                "right": [n.node_stats() for n in self._right],
                "grid_max_depth": max(
                    (l.max_depth for row in grid.grid for l in row),
                    default=0) if grid is not None else 0}


# ---------------------------------------------------------------------------
# The graph
# ---------------------------------------------------------------------------
class FFGraph:
    def __init__(self, root: Any):
        self.root = root
        self._wrap = False

    def wrap_around(self) -> "FFGraph":
        """Feedback channel: the graph's output stream re-enters its input
        (paper Sec. 11); use :class:`Deliver` to emit true results."""
        self._wrap = True
        return self

    def describe(self) -> str:
        d = self.root.describe()
        return d + (" +feedback" if self._wrap else "")

    # -- normal form ---------------------------------------------------------
    def optimize(self) -> "FFGraph":
        g = FFGraph(_normalize(self.root))
        g._wrap = self._wrap
        return g

    # -- the staged compiler entry point -------------------------------------
    def compile(self, plan: Any = None, *, config: Any = None,
                **kwargs: Any) -> "Runner":
        """The staged compile pipeline ``normalize -> annotate -> place ->
        emit`` (core/compiler.py).

        The supported call shape is ``compile(config=CompileConfig(...))``;
        ``compile()`` and ``compile(plan)`` stay as-is (cost-driven auto
        placement); the old flat kwargs still work but emit one
        ``DeprecationWarning`` per call naming the CompileConfig spelling.

        * ``normalize`` — the :meth:`optimize` rewrites;
        * ``annotate`` — per-node :class:`~repro_torch.core.compiler.
          CostEstimate` from ``costs=``, ``ff_cost``/``ff_flops``
          attributes, or timing the node on ``sample=``;
        * ``place`` — host *threads*, host *processes* (``host_process``),
          host *remote* (``host_remote``) or the *device* per top-level
          stage, overridable via ``placements={stage_index_or_worker:
          ...}``;
        * ``emit`` — :class:`HostRunner`, the process runner (process farms
          over shared-memory rings), the remote runner (remote farms over
          TCP lanes), :class:`DeviceRunner`, or the hybrid runner (host
          stages over SPSC queues feeding fused device segments through
          device boundary nodes).

        ``feedback_steps=K`` lets a ``wrap_around`` graph lower onto the
        device through ``core.device.feedback_scan``; ``feedback_cond=pred``
        makes the loop data-dependent (``core.device.feedback_while``, with
        ``feedback_steps`` as an optional cap).  ``a2a_capacity_factor``
        bounds the device all_to_all expert lanes (default: lossless).
        ``mode`` forces placement: "host", "process", "remote", "device",
        or cost-driven "auto"; ``adaptive=True`` lowers eligible farms into
        stages a ``core.runtime.Supervisor`` re-places live.

        ``remote_workers=["host:port", ...]`` names a pool of
        ``python -m repro_torch.launch.worker`` worker pools (or
        :func:`~repro_torch.core.net.spawn_loopback_pool` addresses) and
        unlocks the ``host_remote`` target; ``net_credit`` bounds each
        network lane's in-flight window (back-pressure depth)."""
        from .compiler import CompileConfig, compile_graph
        if config is not None:
            if plan is not None:
                raise GraphError("compile(config=...) already carries the "
                                 "plan — drop the positional plan argument")
            if kwargs:
                raise GraphError("compile(config=...) does not mix with the "
                                 f"legacy kwargs {sorted(kwargs)} — set them "
                                 "on the CompileConfig instead")
            return compile_graph(self, config=config)
        if kwargs:
            known = {f.name for f in dataclasses.fields(CompileConfig)}
            unknown = sorted(k for k in kwargs if k not in known)
            if unknown:
                raise TypeError("compile() got unexpected keyword "
                                f"argument(s) {unknown}; see CompileConfig "
                                "for the supported knobs")
            warnings.warn(
                "FFGraph.compile(**kwargs) is deprecated — pass a "
                "CompileConfig: compile(config=CompileConfig("
                + ", ".join(f"{k}=..." for k in sorted(kwargs)) + "))",
                DeprecationWarning, stacklevel=2)
        return compile_graph(self, config=CompileConfig(plan=plan, **kwargs))

    def lower(self, plan: Any = None, *, capacity: int = 512,
              results_capacity: int = 4096, axis: str = "data") -> "Runner":
        """Compat wrapper over :meth:`compile`: ``plan=None`` forces every
        stage onto host threads (:class:`HostRunner`); a plan forces the
        whole graph onto its device (:class:`DeviceRunner`)."""
        from .compiler import compile_graph
        return compile_graph(self, plan,
                             mode="host" if plan is None else "device",
                             normalize=False, capacity=capacity,
                             results_capacity=results_capacity, axis=axis)


# ---------------------------------------------------------------------------
# optimize(): rewrite passes
# ---------------------------------------------------------------------------
def _compose(f: Callable, g: Callable) -> Callable:
    def fg(x):
        return g(f(x))
    fg.__name__ = "fused"
    return fg


def _is_pure_seq(n: Any) -> bool:
    return isinstance(n, SeqG) and n.pure


def _pure_of(n: Any) -> Optional[Callable]:
    """The per-item pure function a node computes, or None if stateful."""
    if _is_pure_seq(n):
        return n.node
    if isinstance(n, PipeG):
        fns = [_pure_of(s) for s in n.stages]
        if any(f is None for f in fns):
            return None
        out = fns[0]
        for f in fns[1:]:
            out = _compose(out, f)
        return out
    return None


def _fusable_farm(n: Any) -> bool:
    return (isinstance(n, FarmG) and n.emitter is None and n.collector is None
            and n.lb is None and n.ondemand is None
            and all(_pure_of(w) is not None for w in n.workers))


def _normalize(n: Any) -> Any:
    if isinstance(n, PipeG):
        # 1. flatten nested pipelines
        stages: List[Any] = []
        for s in n.stages:
            s = _normalize(s)
            if isinstance(s, PipeG):
                stages.extend(s.stages)
            else:
                stages.append(s)
        # 2. farm/pipeline fusion: pipe(farm(f), farm(g)) -> farm(pipe(f,g))
        fused: List[Any] = []
        for s in stages:
            prev = fused[-1] if fused else None
            if (_fusable_farm(s) and _fusable_farm(prev)
                    and len(prev.workers) == len(s.workers)):
                fn = (_compose(prev.fn, s.fn)
                      if prev.fn is not None and s.fn is not None else None)
                if (fn is None and (prev.n_auto or s.n_auto
                                    or prev.autoscale or s.autoscale)):
                    # an auto/autoscale width needs a replicable fn: fusing
                    # without one would silently pin the farm to width 1
                    fused.append(s)
                    continue
                workers = [PipeG([a, b])
                           for a, b in zip(prev.workers, s.workers)]
                fused[-1] = FarmG(workers, fn=fn,
                                  n_auto=prev.n_auto or s.n_auto,
                                  autoscale=prev.autoscale or s.autoscale)
                continue
            fused.append(s)
        # 3. collector-emitter collapse: absorb pure seq stages into the
        #    adjacent farm's emitter/collector (one thread + one queue less)
        out: List[Any] = []
        for s in fused:
            prev = out[-1] if out else None
            if (_is_pure_seq(s) and isinstance(prev, FarmG)
                    and (prev.collector is None or _is_pure_seq(prev.collector))):
                col = (s if prev.collector is None
                       else SeqG(_compose(prev.collector.node, s.node), pure=True))
                out[-1] = dataclasses.replace(prev, collector=col)
                continue
            if (isinstance(s, FarmG) and _is_pure_seq(prev) and len(out) > 1
                    and (s.emitter is None or _is_pure_seq(s.emitter))):
                # only absorb a *non-source* stage: the first pipeline stage
                # may be a generator driven with task=None
                em = (prev if s.emitter is None
                      else SeqG(_compose(prev.node, s.emitter.node), pure=True))
                out[-1] = dataclasses.replace(s, emitter=em)
                continue
            out.append(s)
        return out[0] if len(out) == 1 else PipeG(out)
    if isinstance(n, FarmG):
        return dataclasses.replace(n, workers=[_normalize(w) for w in n.workers])
    if isinstance(n, MapG):
        return dataclasses.replace(n, workers=[_normalize(w) for w in n.workers])
    if isinstance(n, A2AG):
        return dataclasses.replace(n, left=[_normalize(l) for l in n.left],
                                   right=[_normalize(r) for r in n.right])
    return n


# ---------------------------------------------------------------------------
# Host lowering
# ---------------------------------------------------------------------------
def _mark_single_use(node: Any) -> Any:
    """Stateful node instances carry consumed counters and dead threads after
    a run; building them into a second runner silently replays stale state,
    so re-lowering is an error — build a fresh instance/graph instead."""
    if getattr(node, "_ff_lowered", False):
        raise GraphError(f"{type(node).__name__} instance is already part of "
                         "a lowered runner; stateful nodes are single-use — "
                         "construct a fresh graph to run again")
    node._ff_lowered = True
    return node


def _build_host(n: Any, capacity: int) -> Any:
    if isinstance(n, SeqG):
        return FnNode(n.node) if n.pure else _mark_single_use(n.node)
    if isinstance(n, PipeG):
        return Pipeline(*[_build_host(s, capacity) for s in n.stages],
                        capacity=capacity)
    if isinstance(n, FarmG):
        workers, lb = n.workers, n.lb
        if n.autoscale:
            # materialize the max worker set; the balancer moves the active
            # boundary at runtime from observed lane depth
            max_w = (max(1, os.cpu_count() or 1) if n.n_auto
                     else max(1, len(n.workers)))
            workers = [SeqG(n.fn, pure=True) for _ in range(max_w)]
            lb = AutoscaleLB(max_workers=max_w)
        elif n.n_auto and len(n.workers) == 1:
            # width left to the compiler; emit() materializes the cost-chosen
            # width — this fallback covers direct lower() of an auto farm
            width = getattr(n.placement, "width", None) or (os.cpu_count() or 1)
            workers = [SeqG(n.fn, pure=True) for _ in range(max(1, width))]
        # a LoadBalancer binds to one farm's lanes at _start: sharing it
        # across lowerings would let one runner steal another's routing
        f = Farm([_build_host(w, capacity) for w in workers],
                 lb=lb if n.autoscale else
                 (None if lb is None else _mark_single_use(lb)),
                 capacity=capacity)
        if n.emitter is not None:
            f.add_emitter(_build_host(n.emitter, capacity))
        if n.collector is not None:
            f.add_collector(_build_host(n.collector, capacity))
        if n.ondemand is not None:
            f.set_scheduling_ondemand(n.ondemand)
        return f
    if isinstance(n, MapG):
        return FFMap(_build_host(n.splitter, capacity),
                     [_build_host(w, capacity) for w in n.workers],
                     _build_host(n.composer, capacity), capacity=capacity)
    if isinstance(n, A2AG):
        return A2ASkeleton([_build_host(l, capacity) for l in n.left],
                           [_build_host(r, capacity) for r in n.right],
                           router=n.router, capacity=capacity)
    raise GraphError(f"cannot host-lower {n!r}")


class StageHandle:
    """The uniform per-stage sample + reconfigure surface the adaptive
    runtime (``core/runtime.py``) consumes across every runner.

    The base handle is *read-only*: ``stats()`` snapshots the stage's
    runtime counters and the reconfigure operations refuse.  Adaptive farm
    stages (``compile(adaptive=True)``) return a reconfigurable subclass
    whose ``resize`` moves the active-worker routing boundary and whose
    ``migrate`` drains the stage to a quiescent boundary and hot-swaps its
    engine between the thread and process tiers."""

    reconfigurable = False

    def __init__(self, desc: str, target: Any = None,
                 stats_fn: Optional[Callable[[], dict]] = None,
                 tier: str = "host"):
        self.desc = desc
        self._target = target
        self._stats_fn = stats_fn
        self._tier = tier

    @property
    def tier(self) -> str:
        return self._tier

    def stats(self) -> dict:
        if self._stats_fn is not None:
            return self._stats_fn()
        from .skeletons import _stat_of
        return _stat_of(self._target)

    def can_migrate(self, target: str) -> bool:
        return False

    def resize(self, width: int) -> bool:
        raise GraphError(f"stage {self.desc!r} is not reconfigurable "
                         "(compile with adaptive=True for live resize)")

    def migrate(self, target: str) -> bool:
        raise GraphError(f"stage {self.desc!r} is not reconfigurable "
                         "(compile with adaptive=True for live migration)")


class Runner:
    """Common result surface of ``FFGraph.lower``/``FFGraph.compile``."""

    placements: List = []       # [(stage description, Placement)] from emit

    def run(self, stream: Optional[Sequence] = None) -> List[Any]:
        raise NotImplementedError

    def ffTime(self) -> float:
        return (self._t1 - self._t0) * 1e3

    def describe_placements(self) -> str:
        return "\n".join(f"  [{p.target:12s}] {desc}"
                         + (f" width={p.width}" if p.width else "")
                         + (f"  # {p.reason}" if p.reason else "")
                         for desc, p in self.placements)

    def stats(self) -> dict:
        """Runtime stats: per-node service-time EMA, items processed, max
        observed lane depth — populated while/after the graph runs."""
        return {}

    def stage_handles(self) -> List[StageHandle]:
        """One :class:`StageHandle` per top-level stage — the surface the
        adaptive supervisor samples (and, for adaptive stages, acts on)."""
        return []

    def replacement_events(self) -> List[Any]:
        """Re-placement events (tier migrations) recorded by adaptive stages
        — printed by the launchers' placement reports."""
        return []


class HostRunner(Runner):
    """Graph lowered onto host threads + SPSC queues, exposing both batch
    ``run`` and the paper's accelerator mode (the compat adapter behind
    accelerator-style usage)."""

    def __init__(self, graph: FFGraph, capacity: int = 512,
                 results_capacity: int = 4096,
                 feedback_cond: Optional[Callable] = None):
        built = _build_host(graph.root, capacity)
        if not isinstance(built, Skeleton):
            built = Pipeline(built, capacity=capacity)
        self._skel = built
        self._wrap = graph._wrap
        # data-dependent feedback: an item coming off the feedback edge
        # re-enters the loop only while cond(item) holds, and is delivered
        # as a result once it goes false (mirrors device feedback_while)
        self._feedback_cond = feedback_cond if graph._wrap else None
        self._cap = capacity
        self._results = SPSCQueue(results_capacity)
        self._in_q: Optional[SPSCQueue] = None
        # the input queue can see several producers (offload, the feedback
        # edge, wait()'s error unwind): serialise pushes so the SPSC
        # invariant holds
        self._push_lock = threading.Lock()
        self._fed = 0
        self._feed_done = False
        self._t0 = self._t1 = 0.0

    # -- wiring ---------------------------------------------------------------
    def _push_in(self, item: Any) -> None:
        # per-attempt locking (never a blocking push while holding the lock,
        # or wait()'s unwind could deadlock on it), and bail out once the
        # whole network has died — its results stream is already closed, so
        # blocking a producer on a queue nobody drains helps no one.  A
        # degraded-but-alive network keeps consuming (dead nodes drain their
        # inputs), so items are only dropped when no thread is left.
        while True:
            with self._push_lock:
                if self._in_q.try_push(item):
                    return
            if not self._skel._alive():   # terminated (cleanly or by error)
                return
            time.sleep(1e-5)

    def _route(self, item: Any) -> None:
        if item is EOS:
            self._results.push(EOS)
        elif isinstance(item, Deliver):
            self._results.push(item.value)
        elif self._wrap:
            if (self._feedback_cond is not None
                    and not bool(self._feedback_cond(item))):
                self._results.push(item)
            else:
                self._push_in(item)
        else:
            self._results.push(item)

    # -- accelerator mode (paper Sec. 9, verbatim names) ----------------------
    def run_then_freeze(self) -> int:
        self._t0 = time.perf_counter()
        self._in_q = self._skel._make_input(self._cap)
        self._skel._bind(self._route)
        self._skel._start(self._in_q)
        return 0

    def offload(self, task: Any) -> None:
        if self._in_q is None:
            raise RuntimeError("offload before run_then_freeze")
        self._push_in(task)

    def load_result(self, timeout: Optional[float] = None) -> tuple[bool, Any]:
        item = self._results.pop(timeout)
        return (False, None) if item is EOS else (True, item)

    def load_result_nb(self) -> tuple[bool, Any]:
        ok, item = self._results.try_pop()
        if not ok or item is EOS:
            return False, None
        return True, item

    def pending_inputs(self) -> int:
        """Items offloaded but not yet consumed by the first stage — lets
        callers implement admission back-pressure over the full backlog."""
        return 0 if self._in_q is None else len(self._in_q)

    def wait(self, timeout: Optional[float] = None) -> int:
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            if self.error() is not None and self._in_q is not None:
                # a stage died mid-network: stages upstream of the fault are
                # still blocked on their input queues — unwind them with EOS
                # so join() terminates and the error is reported instead of
                # hanging.  Non-blocking (retried each slice) so a full queue
                # whose consumer died cannot wedge the unwind itself.
                with self._push_lock:
                    self._in_q.try_push(EOS)
            slice_t = 0.1
            if deadline is not None:
                slice_t = min(slice_t, max(0.0, deadline - time.monotonic()))
            self._skel._join(slice_t)
            if not self._skel._alive():
                # terminated: feed one EOS to the input so any detached
                # drainer left by a self-terminated first stage can finish
                # instead of polling a dead queue for the process lifetime.
                # Retried briefly — a live drainer frees a slot of a full
                # queue within its 1ms backoff; with no consumer we give up.
                if self._in_q is not None:
                    for _ in range(100):
                        with self._push_lock:
                            if self._in_q.try_push(EOS):
                                break
                        time.sleep(1e-3)
                break
            if deadline is not None and time.monotonic() >= deadline:
                break
        self._t1 = time.perf_counter()
        return -1 if self.error() is not None else 0

    def error(self) -> Optional[BaseException]:
        return self._skel._error()

    # -- source / streaming mode ----------------------------------------------
    def start_stream(self) -> "HostRunner":
        """Start a source graph (first stage generates); results stream into
        the bounded results queue — back-pressure for prefetch pipelines."""
        self._t0 = time.perf_counter()
        if self._wrap:
            self._in_q = self._skel._make_input(self._cap)
        self._skel._bind(self._route)
        self._skel._start(self._in_q)
        return self

    def get(self, timeout: Optional[float] = None) -> Any:
        """Next streamed result; None at end-of-stream."""
        item = self._results.pop(timeout)
        return None if item is EOS else item

    # -- batch convenience -----------------------------------------------------
    def run_and_wait_end(self) -> int:
        """Run a source graph to completion.  There is no result consumer, so
        outputs are discarded (sinks act via side effects, as in the paper's
        run_and_wait_end) — the bounded results queue must not back-pressure
        a network nobody is draining."""
        self._t0 = time.perf_counter()
        if self._wrap:
            self._in_q = self._skel._make_input(self._cap)

            def route(item: Any) -> None:
                if item is not EOS and not isinstance(item, Deliver):
                    self._push_in(item)
            self._skel._bind(route)
        else:
            self._skel._bind(lambda item: None)
        self._skel._start(self._in_q)
        self._skel._join()
        self._t1 = time.perf_counter()
        return -1 if self.error() is not None else 0

    def run(self, stream: Optional[Sequence] = None,
            timeout: Optional[float] = None) -> List[Any]:
        """Feed ``stream`` (or let sources run) and collect all outputs.
        ``timeout`` bounds each blocking wait, not the whole run; on
        TimeoutError the feeder stops but node threads cannot be killed —
        discard the runner (graphs are single-use anyway)."""
        self._abandoned = False
        self._fed, self._feed_done = 0, False
        # a cond-terminated feedback graph delivers exactly one result per
        # fed item (each loops until its cond goes false) but no node ever
        # returns EOS — the collector below counts it out, then run() feeds
        # the terminating EOS itself
        counted = (stream is not None and self._wrap
                   and self._feedback_cond is not None)
        if stream is None:
            self.start_stream()
        else:
            self.run_then_freeze()

            def feed() -> None:
                # a separate feeder so collection below drains results while
                # offloading — a long stream must not fill every queue and
                # deadlock against an unread results queue
                for x in stream:
                    if self._abandoned:
                        return
                    self.offload(x)
                    self._fed += 1
                self._feed_done = True
                if not self._wrap:      # feedback graphs terminate themselves
                    self.offload(EOS)
            threading.Thread(target=feed, daemon=True,
                             name="ff-run-feeder").start()
        out = []
        try:
            last = time.monotonic()
            while True:
                if counted and self._feed_done and len(out) >= self._fed:
                    break
                if counted:
                    # bounded slices so the count-out condition above is
                    # rechecked after the feeder finishes (an unbounded pop
                    # could block forever once the last result is in)
                    try:
                        item = self._results.pop(0.05)
                    except TimeoutError:
                        if timeout is not None \
                                and time.monotonic() - last > timeout:
                            raise
                        continue
                    last = time.monotonic()
                else:
                    item = self._results.pop(timeout)
                if item is EOS:
                    break
                out.append(item)
        except BaseException:
            self._abandoned = True
            raise
        if counted:
            self.offload(EOS)
        if self.wait(timeout) != 0:
            raise self.error()
        return out

    def shutdown(self, timeout: float = 10.0) -> None:
        """Best-effort unwind for a runner being discarded before its
        stream ended (error, timeout, lost interest): feeds EOS so node
        threads terminate and process-farm stages release their worker
        processes and shared-memory segments.  Without this, a discarded
        mid-stream runner's daemon threads (and any shm segments) linger
        until interpreter exit."""
        self._abandoned = True
        if self._in_q is not None:
            with self._push_lock:
                self._in_q.try_push(EOS)
        self.wait(timeout)

    def stats(self) -> dict:
        return {"backend": type(self).__name__,
                "graph": self._skel.stats(),
                "results_max_depth": self._results.max_depth}

    def _top_members(self) -> List[Any]:
        skel = self._skel
        return list(skel._stages) if isinstance(skel, Pipeline) else [skel]

    def stage_handles(self) -> List[StageHandle]:
        handles = []
        for st in self._top_members():
            # a stage that builds its own handle (AdaptiveFarmNode,
            # net.RemoteFarmNode) knows its tier and reconfig surface
            if hasattr(st, "make_handle"):
                handles.append(st.make_handle())
            else:
                desc = getattr(st, "_label", None) or type(st).__name__
                handles.append(StageHandle(desc, st))
        return handles

    def replacement_events(self) -> List[Any]:
        out: List[Any] = []
        for st in self._top_members():
            out.extend(getattr(st, "migrations", ()) or ())
        return out


# ---------------------------------------------------------------------------
# Device lowering
# ---------------------------------------------------------------------------
def _device_fn(n: Any) -> tuple[Callable, bool]:
    """(per-item function, uses-farm?) for a device-lowerable subgraph."""
    if isinstance(n, SeqG):
        if not n.pure:
            raise GraphError("device lowering needs pure stages "
                             f"(got {type(n.node).__name__})")
        return n.node, False
    if isinstance(n, PipeG):
        fns = [_device_fn(s) for s in n.stages]
        fn = fns[0][0]
        for f, _ in fns[1:]:
            fn = _compose(fn, f)
        return fn, any(farm for _, farm in fns)
    if isinstance(n, FarmG):
        if n.lb is not None or n.ondemand is not None:
            # a custom balancer (e.g. BroadcastLB) changes which/how many
            # outputs exist; SPMD batch sharding is round-robin only
            raise GraphError("device farm lowering supports only the default "
                             "round-robin schedule (no lb/ondemand)")
        if n.fn is None and len(n.workers) > 1:
            # an explicit worker list may be heterogeneous; SPMD lowering
            # replicates ONE function, so silently picking workers[0] would
            # diverge from the host round-robin
            raise GraphError("device farm lowering is SPMD: build the farm "
                             "from one replicated worker (farm(fn, n=...))")
        fn = n.fn if n.fn is not None else _pure_of(n.workers[0])
        if fn is None:
            raise GraphError("device farm lowering needs pure workers")
        for part in (n.emitter, n.collector):
            if part is not None:
                if not _is_pure_seq(part):
                    raise GraphError("device farm lowering needs pure "
                                     "emitter/collector")
        if n.emitter is not None:
            fn = _compose(n.emitter.node, fn)
        if n.collector is not None:
            fn = _compose(fn, n.collector.node)
        return fn, True
    if isinstance(n, MapG):
        # ffmap folds in as a vmapped body: per item, the (pure) splitter
        # yields the worker parts — a tuple/list of len(workers), or an
        # array whose leading axis unstacks to one part per worker — each
        # worker maps its part, and the (pure) composer rebuilds from the
        # results tuple.  The data-parallel map over *items* then rides the
        # same farm_map/vmap path as a device farm.
        parts_fns = []
        for w in n.workers:
            f = _pure_of(w)
            if f is None:
                raise GraphError("device map lowering needs pure workers")
            parts_fns.append(f)
        split_fn = _pure_of(n.splitter)
        comp_fn = _pure_of(n.composer)
        if split_fn is None or comp_fn is None:
            raise GraphError(
                "device map lowering needs a pure splitter/composer "
                "(per item: splitter -> len(workers) parts, composer <- "
                "results tuple); stateful multi-emit splitters are "
                "host-only")

        def _map_fn(x, _split=split_fn, _comp=comp_fn,
                    _parts=tuple(parts_fns)):
            parts = _split(x)
            if not isinstance(parts, (tuple, list)):
                parts = tuple(parts[i] for i in range(len(_parts)))
            if len(parts) != len(_parts):
                raise GraphError(
                    f"device map splitter yielded {len(parts)} parts for "
                    f"{len(_parts)} workers")
            return _comp(tuple(f(p) for f, p in zip(_parts, parts)))

        return _map_fn, True
    raise GraphError(f"no device lowering for {type(n).__name__} here "
                     "(all_to_all/feedback lower only at the top level of the "
                     "graph via compile(); otherwise use the host path or "
                     "feedback_scan/tensor_map directly)")


def _to_device(items: List[Any], device: torch.device,
               stream: Optional[Any] = None) -> Any:
    """Stack per-item pytrees on the host (canonical dtypes, as
    ``jnp.asarray`` gives them) and move each leaf to ``device`` in one
    copy.  With a CUDA ``stream`` the copy runs there and the current
    stream waits for it, so it overlaps device work already queued."""
    host = stack_items(items)
    if device.type != "cuda":
        return tree_map(torch.from_numpy, host)
    if stream is None:
        return tree_map(lambda a: torch.from_numpy(a).to(device), host)
    compute = torch.cuda.current_stream(device)
    with torch.cuda.stream(stream):
        xs = tree_map(lambda a: torch.from_numpy(a).to(device,
                                                       non_blocking=True),
                      host)
    compute.wait_stream(stream)
    for t in tree_leaves(xs):
        t.record_stream(compute)
    return xs


class _Landing:
    """The host copy of one batch's outputs.  With a CUDA ``stream`` the
    device->host copy starts at once into pinned buffers on that stream,
    behind the compute that produces the outputs, and :meth:`wait` only
    waits for its event; otherwise :meth:`wait` copies synchronously."""

    def __init__(self, ys: Any, stream: Optional[Any] = None):
        self._ys = ys
        self._event = None
        if stream is None:
            return
        leaves = tree_leaves(ys)
        stream.wait_stream(torch.cuda.current_stream(leaves[0].device))
        with torch.cuda.stream(stream):
            self._ys = tree_map(
                lambda t: torch.empty(t.shape, dtype=t.dtype,
                                      pin_memory=True).copy_(
                                          t, non_blocking=True), ys)
        for t in leaves:
            t.record_stream(stream)
        self._event = torch.cuda.Event()
        self._event.record(stream)

    def wait(self) -> Any:
        """The outputs as a pytree of numpy batches."""
        if self._event is None:
            return tree_map(to_numpy, self._ys)
        self._event.synchronize()
        # copy out of the pinned buffers so they return to PyTorch's cache
        # for the next microbatch instead of living on in the results
        return tree_map(lambda t: to_numpy(t).copy(), self._ys)


def _copy_streams(device: torch.device, inflight: int) -> tuple:
    """(h2d, d2h) side streams for an overlapped CUDA boundary, else
    (None, None): the CPU and a window of one run synchronously."""
    if device.type != "cuda" or inflight <= 1:
        return None, None
    return torch.cuda.Stream(device), torch.cuda.Stream(device)


class DeviceRunner(Runner):
    """Graph lowered through core/device.py onto the plan's device: the
    stream is stacked into a batch, pure stages and farms run as one
    batched call (``torch.func.vmap`` of the per-item function),
    ``all_to_all`` stages go through ``core.device.a2a_dispatch``, and
    ``wrap_around`` graphs run ``feedback_steps`` turns through
    ``core.device.feedback_scan`` (or ``feedback_while`` with
    ``feedback_cond``).  Semantics match :class:`HostRunner` on pure graphs
    up to output ordering (the host farm collector is arrival-ordered).

    The whole graph runs as ONE part (the ``core/fuse.py`` device-segment
    fusion): one host->device copy in and one copy out per batch.
    ``fuse=False`` restores one part per top-level stage, each with its own
    copy out, for A/B runs and per-stage stats.

    ``microbatch=`` runs the stream as a software pipeline of microbatches
    through the overlapped boundary: each chunk's copy in, compute and copy
    out are queued without waiting (copies on side streams, ordered by CUDA
    events) and a chunk is retired FIFO once ``inflight`` newer chunks ride
    behind it.  Absolute per-chunk stream offsets keep ``all_to_all``
    routing identical to the whole-batch path; ``overlap=False`` (or
    ``inflight=1``) runs the same chunking synchronously.  On the CPU every
    call is synchronous and the window only defers the retirement.

    Over a plan whose mesh has ranks behind ``axis`` every rank runs the
    runner on the whole stream; a batch or chunk is padded to a multiple
    of the ranks by repeating its first item (dropped from the output),
    as the reference pads it, and every rank returns the whole output."""

    def __init__(self, graph: FFGraph, plan: Any, axis: str = "data",
                 feedback_steps: Optional[int] = None,
                 feedback_cond: Optional[Callable] = None,
                 a2a_capacity_factor: Optional[float] = None,
                 fuse: bool = True, overlap: bool = True,
                 microbatch: Optional[int] = None,
                 inflight: Optional[int] = None):
        from . import perf_model as pm
        from .compiler import _top_stages, make_device_batched
        from .fuse import jit_segment, segment_key
        self._device = plan.device
        self._mult = 1             # the batch a multiple of it (the ranks)
        self._t0 = self._t1 = 0.0
        self._items = 0
        self._batches = 0
        self._stats_lock = threading.Lock()
        # _parts: [desc, batched(xs, offset), svc_time_ema_s, items]
        self._parts: List[List[Any]] = []
        # a feedback loop runs its turns over the whole batch at once
        self._microbatch = None if graph._wrap else microbatch
        if inflight is None:
            rec = pm.lookup_autotuned("device_overlap:window")
            inflight = int(rec.get("inflight", 2)) if rec else 2
        self._inflight = max(1, int(inflight)) if overlap else 1
        # boundary accounting (cumulative seconds; under _stats_lock)
        self._b_h2d = 0.0      # host stack + copy-in submit
        self._b_submit = 0.0   # queueing the parts
        self._b_drain = 0.0    # copy-out wait (compute remainder + d2h)
        self._b_stall = 0.0    # drain share paid while the window was full
        self._chunks = 0

        def _add_part(sub: FFGraph, desc: str,
                      steps: Optional[int] = None,
                      cond: Optional[Callable] = None) -> None:
            batched, mult = make_device_batched(
                sub, plan, axis=axis, feedback_steps=steps,
                feedback_cond=cond,
                a2a_capacity_factor=a2a_capacity_factor)
            key = segment_key(sub, 0, mult, plan, axis,
                              a2a_capacity_factor, steps, cond)
            self._mult = max(self._mult, mult)
            self._parts.append([desc, jit_segment(batched, key), 0.0, 0])

        if graph._wrap:
            _add_part(graph, graph.describe(), steps=feedback_steps,
                      cond=feedback_cond)
        elif fuse:
            stages = _top_stages(graph)
            _add_part(graph, " + ".join(s.describe() for s in stages))
        else:
            for s in _top_stages(graph):
                _add_part(FFGraph(s), s.describe())

    def run(self, stream: Sequence) -> List[Any]:
        self._t0 = time.perf_counter()
        items = list(stream)
        if not items:
            return []
        device_ctx = (torch.cuda.device(self._device)
                      if self._device.type == "cuda" else contextlib.nullcontext())
        with device_ctx:
            if self._microbatch is not None:
                return self._run_pipelined(items)
            n = len(items)
            # stack on the host, then ONE copy in for the whole batch
            xs = _to_device(self._padded(items), self._device)
            for part in self._parts:
                t0 = time.perf_counter()
                xs = part[1](xs, 0)
                if self._device.type == "cuda":
                    torch.cuda.synchronize(self._device)
                per_item = (time.perf_counter() - t0) / n
                with self._stats_lock:
                    part[2] = per_item if part[3] == 0 \
                        else 0.5 * part[2] + 0.5 * per_item
                    part[3] += n
            self._t1 = time.perf_counter()
            with self._stats_lock:
                self._items += n
                self._batches += 1
            # ONE device->host copy per output leaf, then numpy slicing; a
            # per-item function may return a pytree
            host = tree_map(to_numpy, xs)
            return [tree_map(lambda t: t[i], host) for i in range(n)]

    def _padded(self, items: List[Any]) -> List[Any]:
        """``items`` padded to a multiple of the ranks with its first."""
        return items + items[:1] * ((-len(items)) % self._mult)

    def _run_pipelined(self, items: List[Any]) -> List[Any]:
        """The overlapped boundary: chunk the stream into microbatches and
        keep a depth-K window of them in flight.  Nothing waits at dispatch
        — the oldest chunk is only awaited (FIFO, so order is exact) once
        the window is full; bytes match the whole-batch path because each
        chunk runs the same parts at its absolute stream offset."""
        import collections
        B = max(1, int(self._microbatch))
        out: List[Any] = []
        window = collections.deque()   # FIFO of (k, landing) in flight
        h2d, d2h = _copy_streams(self._device, self._inflight)

        def retire(k: int, landing: _Landing, stalled: bool) -> None:
            t0 = time.perf_counter()
            host = landing.wait()
            dt = time.perf_counter() - t0
            with self._stats_lock:
                self._b_drain += dt
                if stalled:
                    self._b_stall += dt
            out.extend(tree_map(lambda t, i=i: t[i], host)
                       for i in range(k))

        n = len(items)
        for start in range(0, n, B):
            chunk = items[start:start + B]
            k = len(chunk)
            t0 = time.perf_counter()
            xs = _to_device(self._padded(chunk), self._device, h2d)
            t1 = time.perf_counter()
            # every part at this chunk's absolute stream offset (all_to_all
            # routing parity with the host feeder)
            ys = xs
            for part in self._parts:
                ys = part[1](ys, start)
            landing = _Landing(ys, d2h)
            t2 = time.perf_counter()
            with self._stats_lock:
                self._b_h2d += t1 - t0
                self._b_submit += t2 - t1
                self._chunks += 1
                per_item = (t2 - t0) / k / max(1, len(self._parts))
                for part in self._parts:
                    # submit-side attribution only: the drain below is a
                    # boundary property, not any one part's service time
                    part[2] = per_item if part[3] == 0 \
                        else 0.5 * part[2] + 0.5 * per_item
                    part[3] += k
            if self._inflight <= 1:
                retire(k, landing, stalled=False)   # the synchronous boundary
                continue
            window.append((k, landing))
            while len(window) > self._inflight:
                retire(*window.popleft(), stalled=True)
        while window:
            retire(*window.popleft(), stalled=False)
        self._t1 = time.perf_counter()
        with self._stats_lock:
            self._items += n
            self._batches += 1
        return out

    def stats(self) -> dict:
        with self._stats_lock:
            stages = [{"node": f"device[{desc}]", "backend": "device",
                       "items": it, "svc_time_ema_s": ema}
                      for desc, _fn, ema, it in self._parts]
            drain = self._b_drain
            return {"backend": "DeviceRunner", "items": self._items,
                    "batches": self._batches,
                    "svc_time_ema_s": sum(s["svc_time_ema_s"]
                                          for s in stages),
                    "boundary": {
                        "mode": ("overlapped" if self._microbatch is not None
                                 and self._inflight > 1 else "sync"),
                        "microbatch": self._microbatch or 0,
                        "inflight": self._inflight, "chunks": self._chunks,
                        "h2d_s": round(self._b_h2d, 6),
                        "submit_s": round(self._b_submit, 6),
                        "drain_s": round(drain, 6),
                        "stall_s": round(self._b_stall, 6),
                        "stall_frac": round(self._b_stall / drain, 4)
                        if drain > 0 else 0.0,
                    },
                    "stages": stages}

    def stage_handles(self) -> List[StageHandle]:
        def snap(part):
            with self._stats_lock:
                return {"node": f"device[{part[0]}]", "backend": "device",
                        "items": part[3], "svc_time_ema_s": part[2]}
        return [StageHandle(p[0], stats_fn=(lambda p=p: snap(p)),
                            tier="device") for p in self._parts]

