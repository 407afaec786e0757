"""L3 — streaming-network patterns (FastFlow Secs. 2, 4-12).

Host-side, paper-faithful skeletons: ``Pipeline`` and ``Farm`` (with emitter /
collector / custom load balancers / on-demand scheduling / broadcast), the
``wrap_around`` feedback channel, arbitrary nesting (farms of pipelines,
pipelines of farms), and the *accelerator* usage mode
(``run_then_freeze`` / ``offload`` / ``load_result`` / ``FF_EOS`` / ``wait``).

These host skeletons run real threads over the SPSC networks of
core/queues.py and carry the data pipeline and the serving front-end of the
framework.  Their device-side lowering (the same patterns expressed as
batched PyTorch programs on a CUDA device) lives in core/device.py.

This module is the port's own copy of the reference host skeletons,
``ThreadFarmNode`` (the thread-tier engine of the adaptive runtime's
``AdaptiveFarmNode``) included.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, List, Optional, Sequence

from .node import EOS, GO_ON, FFNode, FnNode, spawn_drainer
from .queues import MPSCQueue, QueueClosed, SPMCQueue, SPSCQueue

FF_EOS = EOS  # paper's name for the end-of-stream mark


# ---------------------------------------------------------------------------
# Load balancers (paper Sec. 8.3)
# ---------------------------------------------------------------------------
class LoadBalancer:
    """FastFlow ``ff_loadbalancer``: decides the worker for each task.

    Subclass and override ``selectworker`` for custom policies, or call
    ``set_victim(i)`` from an emitter right before ``ff_send_out`` (Sec. 8.3).
    ``BROADCAST`` sends the task to every worker (Sec. 8.3.1 / MISD).
    """

    BROADCAST = -1

    def __init__(self):
        self._victim: Optional[int] = None
        self.nworkers: int = 0
        self._lanes: Optional[SPMCQueue] = None

    def _attach(self, lanes: SPMCQueue) -> None:
        self._lanes = lanes
        self.nworkers = len(lanes.lanes)

    def getnworkers(self) -> int:
        return self.nworkers

    def set_victim(self, idx: int) -> None:
        self._victim = idx

    def broadcast_task(self, task: Any) -> None:
        self._lanes.broadcast(task)

    def selectworker(self, task: Any) -> int:
        raise NotImplementedError

    def route(self, task: Any) -> None:
        if self._victim is not None:
            idx, self._victim = self._victim, None
        else:
            idx = self.selectworker(task)
        if idx == self.BROADCAST:
            self._lanes.broadcast(task)
        else:
            self._lanes.push_to(idx, task)


class RoundRobinLB(LoadBalancer):
    """Default farm scheduling (paper Sec. 8)."""

    def __init__(self):
        super().__init__()
        self._next = 0

    def selectworker(self, task: Any) -> int:
        i = self._next
        self._next = (self._next + 1) % self.nworkers
        return i


class OnDemandLB(LoadBalancer):
    """Auto-scheduling approximation (paper Sec. 8.3.2): first worker whose
    queue length is <= threshold."""

    def __init__(self, threshold: int = 1):
        super().__init__()
        self.threshold = threshold

    def route(self, task: Any) -> None:
        if self._victim is not None:
            idx, self._victim = self._victim, None
            self._lanes.push_to(idx, task)
        else:
            self._lanes.push_ondemand(task, self.threshold)

    def selectworker(self, task: Any) -> int:  # pragma: no cover
        return 0


class BroadcastLB(LoadBalancer):
    """Every task goes to every worker (MISD farm, Sec. 8.3.1)."""

    def selectworker(self, task: Any) -> int:
        return self.BROADCAST


class AutoscaleLB(LoadBalancer):
    """Autoscaling farm schedule: grow/shrink the *active* worker set from
    observed queue depth.

    All workers exist from the start (a parked worker blocked on an empty
    lane costs nothing — FastFlow's blocking mode); scaling moves the
    round-robin routing boundary between ``min_workers`` and
    ``max_workers``.  Every ``adjust_every`` routed tasks the balancer looks
    at the mean depth of the active lanes: above ``hi`` it activates one
    more worker, below ``lo`` it retires the last one (items already queued
    on a retired lane still get processed — the worker only stops receiving
    new work).

    The balancer is backend-agnostic: it only needs an attached lane bundle
    with a ``lanes`` list of ``len()``-able queues.  The thread farm
    attaches its ``SPMCQueue``; the process farm
    (``core.process.ProcessFarmNode`` with ``autoscale=True``) attaches its
    ``ShmSPMCQueue``, so the same depth signal scales OS-process workers
    parked on their shm idle gates — no process is ever forked at
    runtime."""

    def __init__(self, min_workers: int = 1, max_workers: Optional[int] = None,
                 hi: float = 2.0, lo: float = 0.25, adjust_every: int = 16):
        super().__init__()
        self.min_workers = max(1, min_workers)
        self.max_workers = max_workers
        self.hi = hi
        self.lo = lo
        self.adjust_every = max(1, adjust_every)
        self.cur = self.min_workers
        self.grown = 0
        self.shrunk = 0
        self._routed = 0
        self._next = 0

    def _attach(self, lanes: SPMCQueue) -> None:
        super()._attach(lanes)
        if self.max_workers is None:
            self.max_workers = self.nworkers
        self.max_workers = min(self.max_workers, self.nworkers)
        self.cur = min(max(self.cur, self.min_workers), self.max_workers)

    def _adjust(self) -> None:
        depth = sum(len(self._lanes.lanes[i]) for i in range(self.cur)) / self.cur
        if depth > self.hi and self.cur < self.max_workers:
            self.cur += 1
            self.grown += 1
        elif depth < self.lo and self.cur > self.min_workers:
            self.cur -= 1
            self.shrunk += 1

    def selectworker(self, task: Any) -> int:
        self._routed += 1
        if self._routed % self.adjust_every == 0:
            self._adjust()
        i = self._next % self.cur
        self._next = (i + 1) % self.cur
        return i


# ---------------------------------------------------------------------------
# Skeleton base: anything that can sit in a streaming network
# ---------------------------------------------------------------------------
class Skeleton:
    """Common protocol so skeletons nest arbitrarily (paper Sec. 10)."""

    def __init__(self):
        self._out: Optional[Callable[[Any], None]] = None
        self._in_q: Optional[SPSCQueue] = None
        self._running = False
        self._t0 = 0.0
        self._t1 = 0.0
        self._wrap = False

    # wiring -----------------------------------------------------------------
    def _bind(self, out_fn: Optional[Callable[[Any], None]], node_id: int = -1) -> None:
        self._out = out_fn

    def _make_input(self, capacity: int = 512) -> SPSCQueue:
        if self._in_q is None:
            self._in_q = SPSCQueue(capacity)
        return self._in_q

    def wrap_around(self) -> None:
        """Feedback channel (paper Sec. 11): route this skeleton's output
        stream back to its own input.  Only valid for the outermost skeleton."""
        self._wrap = True

    # lifecycle ----------------------------------------------------------------
    def _start(self, in_q: Optional[SPSCQueue]) -> None:
        raise NotImplementedError

    def _join(self, timeout: Optional[float] = None) -> None:
        raise NotImplementedError

    def _error(self) -> Optional[BaseException]:
        raise NotImplementedError

    def _alive(self) -> bool:
        raise NotImplementedError

    # paper API ---------------------------------------------------------------
    def run_and_wait_end(self) -> int:
        self._t0 = time.perf_counter()
        if self._wrap:
            q = self._make_input()
            self._bind_feedback(q)
        self._start(self._in_q)
        self._join()
        self._t1 = time.perf_counter()
        return -1 if self._error() is not None else 0

    def run_then_freeze(self) -> int:
        """Accelerator mode (paper Sec. 9): start with an externally fed
        input stream; offload() pushes tasks, FF_EOS terminates."""
        self._t0 = time.perf_counter()
        q = self._make_input()
        self._results: SPSCQueue = SPSCQueue(4096)
        if self._out is None:
            self._bind(lambda item: self._results.push(item))
        self._start(q)
        self._running = True
        return 0

    def offload(self, task: Any) -> None:
        if self._in_q is None:
            raise RuntimeError("offload before run_then_freeze")
        self._in_q.push(task)

    def load_result(self, timeout: Optional[float] = None) -> tuple[bool, Any]:
        """Blocking result retrieval; returns (False, None) at end-of-stream."""
        item = self._results.pop(timeout)
        if item is EOS:
            return False, None
        return True, item

    def load_result_nb(self) -> tuple[bool, Any]:
        ok, item = self._results.try_pop()
        if not ok:
            return False, None
        if item is EOS:
            return False, None
        return True, item

    def wait(self, timeout: Optional[float] = None) -> int:
        self._join(timeout)
        self._t1 = time.perf_counter()
        self._running = False
        return -1 if self._error() is not None else 0

    def _bind_feedback(self, q: SPSCQueue) -> None:
        def feed(item: Any) -> None:
            if item is not EOS:
                q.push(item)
        self._bind(feed)

    def ffTime(self) -> float:
        """Milliseconds spent in the skeleton run (paper Sec. 14)."""
        return (self._t1 - self._t0) * 1e3

    def ffStats(self) -> dict:
        return {}

    def stats(self) -> dict:
        """Structured runtime stats (per-node service-time EMA, items
        processed, max observed lane depth) for ``runner.stats()``."""
        return {"type": type(self).__name__.lower()}


def _stat_of(x: Any) -> dict:
    """Stats for one network member: an FFNode or a nested Skeleton."""
    if isinstance(x, FFNode):
        return x.node_stats()
    if isinstance(x, Skeleton):
        return x.stats()
    return {}


def _as_runnable(obj) -> "Skeleton | FFNode":
    if isinstance(obj, (Skeleton, FFNode)):
        return obj
    if callable(obj):
        return FnNode(obj)
    raise TypeError(f"cannot use {obj!r} as a streaming-network node")


def _start_runnable(r, in_q, out_fn, node_id=0):
    r._bind(out_fn, node_id)
    r._start(in_q)


# ---------------------------------------------------------------------------
# Pipeline (paper Secs. 4-6)
# ---------------------------------------------------------------------------
class Pipeline(Skeleton):
    def __init__(self, *stages, capacity: int = 512):
        super().__init__()
        self._stages: List = [_as_runnable(s) for s in stages]
        self._cap = capacity
        self._qs: List[SPSCQueue] = []

    def add_stage(self, stage) -> "Pipeline":
        self._stages.append(_as_runnable(stage))
        return self

    def _start(self, in_q: Optional[SPSCQueue]) -> None:
        if not self._stages:
            raise RuntimeError("empty pipeline")
        n = len(self._stages)
        self._qs = [SPSCQueue(self._cap) for _ in range(n - 1)]
        out = self._out if self._out is not None else (lambda item: None)
        for i, st in enumerate(self._stages):
            stage_in = in_q if i == 0 else self._qs[i - 1]
            if i == n - 1:
                stage_out = out
            else:
                q = self._qs[i]
                stage_out = q.push
            _start_runnable(st, stage_in, stage_out, node_id=i)

    def _join(self, timeout: Optional[float] = None) -> None:
        for st in self._stages:
            st._join(timeout)

    def _error(self) -> Optional[BaseException]:
        for st in self._stages:
            e = st.error if isinstance(st, FFNode) else st._error()
            if e is not None:
                return e
        return None

    def _alive(self) -> bool:
        return any(st._alive() for st in self._stages)

    def ffStats(self) -> dict:
        return {f"stage{i}": getattr(s, "svc_calls", None)
                for i, s in enumerate(self._stages)}

    def stats(self) -> dict:
        return {"type": "pipeline",
                "stages": [_stat_of(s) for s in self._stages],
                "lane_max_depth": [q.max_depth for q in self._qs]}


# ---------------------------------------------------------------------------
# Farm (paper Secs. 8-9)
# ---------------------------------------------------------------------------
class _CollectorRunner:
    """Runs the collector node: drains worker lanes fairly, counts EOS from
    every worker before terminating (FastFlow collector semantics)."""

    def __init__(self, node: Optional[FFNode], mpsc: MPSCQueue,
                 out_fn: Callable[[Any], None], n_workers: int):
        import threading
        self.node = node
        self.mpsc = mpsc
        self.out = out_fn
        self.n_workers = n_workers
        self.error: Optional[BaseException] = None
        self.thread = threading.Thread(target=self._run, daemon=True,
                                       name="ff-collector")

    def _run(self) -> None:
        eos_seen = 0
        try:
            if self.node is not None and self.node.svc_init() < 0:
                raise RuntimeError("collector svc_init failed")
            while eos_seen < self.n_workers:
                item, _lane = self.mpsc.pop_any()
                if item is EOS:
                    eos_seen += 1
                    continue
                if self.node is None:
                    self.out(item)
                    continue
                self.node.svc_calls += 1
                res = self.node.svc(item)
                if res is EOS:
                    break
                if res is not GO_ON and res is not None:
                    self.out(res)
        except BaseException as e:  # noqa: BLE001
            self.error = e
            import traceback
            traceback.print_exc()
        finally:
            try:
                if self.node is not None:
                    self.node.svc_end()
            finally:
                self.out(EOS)
                # after closing the output stream, drain remaining worker
                # output until every EOS arrives so no worker wedges on this
                # collector's full lanes — whether it died or self-terminated
                if eos_seen < self.n_workers:
                    spawn_drainer(lambda: self.mpsc.pop_any()[0],
                                  self.n_workers - eos_seen)

    def start(self) -> None:
        self.thread.start()

    def join(self, timeout=None) -> None:
        self.thread.join(timeout)


class Farm(Skeleton):
    """Farm skeleton: optional emitter -> workers -> optional collector.

    - no collector: workers consolidate results in memory (paper Sec. 8.2);
    - ``set_scheduling_ondemand()``: auto-scheduling (Sec. 8.3.2);
    - pass a LoadBalancer subclass for custom policies (Sec. 8.3);
    - ``wrap_around()``: feedback for divide&conquer (Sec. 11);
    - accelerator usage via ``run_then_freeze``/``offload`` (Sec. 9).
    """

    def __init__(self, workers: Sequence = (), lb: Optional[LoadBalancer] = None,
                 capacity: int = 512):
        super().__init__()
        self._workers: List = [_as_runnable(w) for w in workers]
        self._emitter: Optional[FFNode] = None
        self._collector: Optional[FFNode] = None
        self._lb = lb or RoundRobinLB()
        self._cap = capacity
        self._col_runner: Optional[_CollectorRunner] = None

    # construction API (paper names) -----------------------------------------
    def add_workers(self, workers: Sequence) -> "Farm":
        self._workers.extend(_as_runnable(w) for w in workers)
        return self

    def add_emitter(self, node) -> "Farm":
        self._emitter = _as_runnable(node)
        return self

    def add_collector(self, node) -> "Farm":
        self._collector = _as_runnable(node)
        return self

    def set_scheduling_ondemand(self, threshold: int = 1) -> "Farm":
        self._lb = OnDemandLB(threshold)
        return self

    def getlb(self) -> LoadBalancer:
        return self._lb

    # runtime -----------------------------------------------------------------
    def _start(self, in_q: Optional[SPSCQueue]) -> None:
        if not self._workers:
            raise RuntimeError("farm with no workers")
        nw = len(self._workers)
        self._spmc = SPMCQueue(nw, self._cap)
        self._mpsc = MPSCQueue(nw, self._cap)
        self._lb._attach(self._spmc)
        out = self._out if self._out is not None else (lambda item: None)

        # collector side: always run a runner so EOS bookkeeping is uniform
        self._col_runner = _CollectorRunner(self._collector, self._mpsc, out, nw)
        self._col_runner.start()

        # workers: worker i reads lane i, writes mpsc lane i
        for i, w in enumerate(self._workers):
            lane_out = self._mpsc.lane(i)
            _start_runnable(w, self._spmc.lanes[i], lane_out.push, node_id=i)

        # emitter side
        def route(item: Any) -> None:
            if item is EOS:
                self._spmc.broadcast(EOS)
            else:
                self._lb.route(item)

        if self._emitter is not None:
            _start_runnable(self._emitter, in_q, route, node_id=-2)
        elif in_q is not None:
            # headless farm fed by an input stream: a tiny forwarder thread
            fwd = FnNode(lambda t: t)
            _start_runnable(fwd, in_q, route, node_id=-2)
            self._fwd = fwd
        else:
            raise RuntimeError("farm needs an emitter or an input stream")

    def _join(self, timeout: Optional[float] = None) -> None:
        if self._emitter is not None:
            self._emitter._join(timeout)
        for w in self._workers:
            w._join(timeout)
        if self._col_runner is not None:
            self._col_runner.join(timeout)

    def _error(self) -> Optional[BaseException]:
        nodes = [self._emitter, *self._workers]
        for n in nodes:
            if n is None:
                continue
            e = n.error if isinstance(n, FFNode) else n._error()
            if e is not None:
                return e
        if self._col_runner is not None and self._col_runner.error is not None:
            return self._col_runner.error
        if self._collector is not None and isinstance(self._collector, FFNode) \
                and self._collector.error is not None:
            return self._collector.error
        return None

    def _alive(self) -> bool:
        parts = [self._emitter, getattr(self, "_fwd", None), *self._workers]
        if any(p is not None and p._alive() for p in parts):
            return True
        return (self._col_runner is not None
                and self._col_runner.thread.is_alive())

    def ffStats(self) -> dict:
        return {
            "workers": len(self._workers),
            "svc_calls": [getattr(w, "svc_calls", None) for w in self._workers],
            "emitter_calls": getattr(self._emitter, "svc_calls", None),
            "collector_calls": getattr(self._collector, "svc_calls", None),
        }

    def stats(self) -> dict:
        out = {"type": "farm",
               "workers": [_stat_of(w) for w in self._workers]}
        if self._emitter is not None:
            out["emitter"] = _stat_of(self._emitter)
        if self._collector is not None:
            out["collector"] = _stat_of(self._collector)
        spmc = getattr(self, "_spmc", None)
        mpsc = getattr(self, "_mpsc", None)
        out["lane_max_depth"] = \
            [l.max_depth for l in spmc.lanes] if spmc else []
        out["result_lane_max_depth"] = \
            [l.max_depth for l in mpsc.lanes] if mpsc else []
        return out


# ---------------------------------------------------------------------------
# Map skeleton on the farm template (paper Sec. 12.1)
# ---------------------------------------------------------------------------
class FFMap(Skeleton):
    """map = farm(Split -> workers -> Compose): the splitter partitions each
    input collection; the composer rebuilds the result.  Mirrors the paper's
    ``ff_map`` class."""

    def __init__(self, splitter: FFNode, workers: Sequence, composer: FFNode,
                 lb: Optional[LoadBalancer] = None, capacity: int = 512):
        super().__init__()
        self._exec = Farm(workers, lb=lb, capacity=capacity)
        self._exec.add_emitter(splitter)
        self._exec.add_collector(composer)

    def _bind(self, out_fn, node_id: int = -1) -> None:
        super()._bind(out_fn, node_id)
        self._exec._bind(out_fn, node_id)

    def _start(self, in_q):
        if self._exec._out is None and self._out is not None:
            self._exec._bind(self._out)
        self._exec._start(in_q)

    def _join(self, timeout=None):
        self._exec._join(timeout)

    def _error(self):
        return self._exec._error()

    def _alive(self) -> bool:
        return self._exec._alive()

    def _make_input(self, capacity: int = 512):
        q = super()._make_input(capacity)
        return q

    def run_then_freeze(self) -> int:
        q = self._make_input()
        self._results = SPSCQueue(4096)
        self._exec._bind(lambda item: self._results.push(item))
        self._exec._start(q)
        self._t0 = time.perf_counter()
        self._running = True
        return 0

    def offload(self, task):
        self._in_q.push(task)

    def wait(self, timeout=None) -> int:
        self._exec._join(timeout)
        self._t1 = time.perf_counter()
        return -1 if self._exec._error() is not None else 0

    def stats(self) -> dict:
        return {"type": "map", **{k: v for k, v in self._exec.stats().items()
                                  if k != "type"}}


# ---------------------------------------------------------------------------
# Thread-tier farm-as-one-node: the drainable/resizable engine behind the
# adaptive runtime (core/runtime.py)
# ---------------------------------------------------------------------------
class _WorkerFailure:
    """A worker-thread exception shipped through the result lanes (the
    thread-tier twin of ``shm.ShmError``)."""

    __slots__ = ("error",)

    def __init__(self, error: BaseException):
        self.error = error


class ThreadFarmNode(FFNode):
    """A farm stage embedded as ONE host node: worker *threads* over
    SPMC/MPSC lanes with a sequence-ordered collector — the thread-tier twin
    of :class:`~repro_torch.core.process.ProcessFarmNode`, sharing its surface
    (``svc`` routes, a collector thread reorders by sequence number and
    forwards via ``ff_send_out``, ``svc_end`` drains to a quiescent
    boundary).

    The shared surface is what makes live tier migration possible: the
    adaptive runtime (``core/runtime.py``) hot-swaps one of these for a
    ``ProcessFarmNode`` (or back) behind the node's boundary queues.
    Output order follows *input* order — stricter than the arrival-ordered
    ``Farm`` collector, matching the process and device lowerings, so a
    migration can never reorder the stream.

    ``set_active(k)`` moves the round-robin routing boundary between 1 and
    the built width (the :class:`AutoscaleLB` mechanism, driven externally):
    an inactive worker parks on the blocking pop of its empty lane.  Workers
    measure both wall and CPU time per call (``time.thread_time``), so
    ``node_stats`` exposes a ``gil_ratio`` — CPU/wall, ~1 when calls truly
    run in parallel, ~1/width when they serialize on the GIL — the signal
    the supervisor's thread->process migration policy keys on."""

    def __init__(self, fns: List[Callable], pre: Optional[Callable] = None,
                 post: Optional[Callable] = None, capacity: int = 64,
                 label: str = "thread_farm",
                 active: Optional[int] = None):
        super().__init__()
        if not fns:
            raise ValueError("thread farm with no workers")
        self._fns = list(fns)
        self._pre = pre
        self._post = post
        self._n = len(self._fns)
        self._label = label
        self._active = min(active or self._n, self._n)
        self._spmc = SPMCQueue(self._n, capacity)
        self._mpsc = MPSCQueue(self._n, capacity)
        self._seq = 0
        self._delivered = 0
        self._routed = [0] * self._n
        self._fn_calls = 0
        self._wall_warm: List[float] = []
        self._cpu_warm: List[float] = []
        self._wall_ema = 0.0
        self._cpu_ema = 0.0
        self._hop_ema = 0.0
        self._gap_ema = 0.0
        self._last_delivery: Optional[float] = None
        self._threads: List[threading.Thread] = []
        self._collector: Optional[threading.Thread] = None
        self._started = False

    @property
    def width(self) -> int:
        return self._n

    @property
    def active_workers(self) -> int:
        return self._active

    def set_active(self, k: int) -> None:
        """Move the routing boundary: new items go to workers [0, k)."""
        self._active = max(1, min(int(k), self._n))

    # -- worker / collector threads -----------------------------------------
    def _record_fn_time(self, wall: float, cpu: float) -> None:
        with self._stats_lock:
            self._fn_calls += 1
            if len(self._wall_warm) < 5:
                self._wall_warm.append(wall)
                self._cpu_warm.append(cpu)
                self._wall_ema = \
                    sorted(self._wall_warm)[len(self._wall_warm) // 2]
                self._cpu_ema = \
                    sorted(self._cpu_warm)[len(self._cpu_warm) // 2]
            else:
                self._wall_ema = 0.8 * self._wall_ema + 0.2 * wall
                self._cpu_ema = 0.8 * self._cpu_ema + 0.2 * cpu

    def _worker_loop(self, i: int, fn: Callable) -> None:
        lane = self._spmc.lanes[i]
        out = self._mpsc.lane(i)
        early = False
        try:
            while True:
                got = lane.pop()
                if got is EOS:
                    break
                seq, item = got
                w0 = time.perf_counter()
                c0 = time.thread_time()
                try:
                    y = fn(item)
                except BaseException as e:     # noqa: BLE001 - to the parent
                    out.push((seq, _WorkerFailure(e)))
                    early = True
                    break
                self._record_fn_time(time.perf_counter() - w0,
                                     time.thread_time() - c0)
                out.push((seq, y))
        except QueueClosed:
            early = True
        finally:
            try:
                out.push(EOS)
            except QueueClosed:
                pass
            if early:
                # keep the input lane draining so the emitter can never
                # wedge on a dead worker's full lane
                spawn_drainer(lane.pop)

    def _collect(self) -> None:
        hold = {}
        nxt = 0
        eos_seen = 0
        try:
            while eos_seen < self._n:
                item, _lane = self._mpsc.pop_any()
                if item is EOS:
                    eos_seen += 1
                    continue
                seq, y = item
                if isinstance(y, _WorkerFailure):
                    if self.error is None:
                        self.error = y.error
                    continue
                hold[seq] = y
                while nxt in hold:
                    res = hold.pop(nxt)
                    nxt += 1
                    if self._post is not None:
                        res = self._post(res)
                    now = time.perf_counter()
                    with self._stats_lock:
                        if self._last_delivery is not None:
                            gap = now - self._last_delivery
                            self._gap_ema = gap if self._gap_ema == 0.0 \
                                else 0.8 * self._gap_ema + 0.2 * gap
                        self._last_delivery = now
                        self._delivered += 1
                    self.ff_send_out(res)
        except BaseException as e:             # noqa: BLE001
            if self.error is None:
                self.error = e

    # -- node protocol --------------------------------------------------------
    def svc_init(self) -> int:
        if self._started:
            return 0
        self._started = True
        self._collector = threading.Thread(
            target=self._collect, daemon=True, name=f"{self._label}-collector")
        self._collector.start()
        for i, fn in enumerate(self._fns):
            t = threading.Thread(target=self._worker_loop, args=(i, fn),
                                 daemon=True, name=f"{self._label}-{i}")
            t.start()
            self._threads.append(t)
        return 0

    def svc(self, item: Any) -> Any:
        if self.error is not None:
            raise self.error
        if self._pre is not None:
            item = self._pre(item)
        with self._stats_lock:
            seq = self._seq
            self._seq += 1
        idx = seq % max(1, min(self._active, self._n))
        t0 = time.perf_counter()
        if self._spmc.lanes[idx].try_push((seq, item)):
            # the hop EMA is the *channel* cost: only uncontended pushes
            # count (a wait on a full lane measures back-pressure instead)
            hop = time.perf_counter() - t0
            with self._stats_lock:
                self._routed[idx] += 1
                self._hop_ema = hop if self._hop_ema == 0.0 \
                    else 0.9 * self._hop_ema + 0.1 * hop
        else:
            self._spmc.lanes[idx].push((seq, item))
            with self._stats_lock:
                self._routed[idx] += 1
        return GO_ON

    def svc_end(self) -> None:
        """Drain to a quiescent boundary: EOS to every worker lane, join
        workers and the collector — every accepted item is delivered (or the
        error surfaced) before this returns, which is the barrier live
        migration relies on.  A worker that refuses to quiesce (fn wedged on
        a lock / IO past the join timeout) surfaces as an error rather than
        silently returning with the barrier broken — a migration must abort
        instead of letting a zombie worker's late output interleave with the
        replacement engine's stream."""
        try:
            self._spmc.broadcast(EOS)
        except QueueClosed:
            pass
        for t in self._threads:
            t.join(timeout=30.0)
        if self._collector is not None:
            self._collector.join(timeout=30.0)
        stuck = [t.name for t in self._threads if t.is_alive()]
        if self._collector is not None and self._collector.is_alive():
            stuck.append(self._collector.name)
        if stuck and self.error is None:
            self.error = RuntimeError(
                f"{self._label}: drain did not quiesce within 30s "
                f"(stuck: {', '.join(stuck)})")

    # -- stats ---------------------------------------------------------------
    def node_stats(self) -> dict:
        from .perf_model import fn_key
        depths = [len(l) for l in self._spmc.lanes]
        with self._stats_lock:
            wall, cpu = self._wall_ema, self._cpu_ema
            return {
                "node": self._label,
                "backend": "thread",
                "workers": self._n,
                "active": self._active,
                "items": self._seq,
                "delivered": self._delivered,
                "routed_per_worker": list(self._routed),
                "svc_time_ema_s": wall,
                "svc_wall_ema_s": wall,
                "svc_cpu_ema_s": cpu,
                "gil_ratio": (cpu / wall) if wall > 0.0 else None,
                "hop_ema_s": self._hop_ema,
                "delivery_gap_ema_s": self._gap_ema,
                "lane_depths": depths,
                "max_lane_depth": max(
                    (l.max_depth for l in self._spmc.lanes), default=0),
                "fn_key": fn_key(self._fns[0]),
            }
