"""The process-backed host tier: farm workers as OS processes over the
shared-memory rings of ``core/shm.py``.

CPython threads share one GIL, so the thread-backed host farm of
``core/skeletons.py`` only parallelizes stages that release it (I/O, large
BLAS calls, jitted device steps).  This module is FastFlow's actual
multicore claim: a farm whose workers are *processes*, wired emitter ->
workers -> collector over true shared-memory SPSC lanes, so CPU-bound
Python/numpy ``svc`` stages scale with cores.

:class:`ProcessFarmNode` is the bridge into the thread tier: it is itself an
``ff_node`` that sits in an ordinary host streaming network.  Its ``svc``
routes items round-robin onto per-worker shm lanes (the SPMC side); a
collector thread drains the per-worker result lanes (the MPSC side),
restores input order from sequence numbers, and forwards downstream via
``ff_send_out``.  Worker processes receive their (picklable) ``svc``
callable once at startup and then only raw items.  A worker that raises
ships an error record back; a worker that *dies* (crash, kill) is detected
by liveness polling — either way the surrounding runner surfaces the error
instead of wedging.

With ``autoscale=True`` the farm reuses the thread tier's
:class:`~repro_torch.core.skeletons.AutoscaleLB` over its *shm* lanes: the full
worker set forks once at build time, and scaling moves the round-robin
routing boundary from observed lane depth.  An inactive worker is parked on
its idle gate — the blocking ``pop`` on its empty input lane (microsecond
backoff capped at 1 ms) — so growing the active set never forks a process,
it just starts routing to a parked one.

:class:`ProcessA2ANode` is the same bridge for FastFlow 3's ``ff_a2a``: left
worker processes apply their ``svc`` callable and route each result through
an :class:`~repro_torch.core.shm.ShmMPMCGrid` lane selected by the graph's
router; right worker processes drain their grid column fairly and ship
results back over per-worker result lanes.  Sequence numbers ride the slot
headers (the grid's routing is data-dependent, so arrival order alone
cannot restore stream order), the parent reorders, EOS fans out row-wise
(each right worker terminates after one EOS per left worker), and crashes
on either side surface as :class:`WorkerCrashed`.

This module is the PyTorch port's copy of the reference package's
``core/process.py``, and it stays torch-free as the reference's is
JAX-free.  The parent has imported torch, may have initialised CUDA and may
have started torch's OpenMP pool before a farm forks its workers.  A forked
child that touched CUDA would fail ("Cannot re-initialize CUDA in forked
subprocess"), and one that ran a torch CPU op could hang in libgomp, whose
pool does not survive a fork.  So worker callables run on numpy and Python
objects: items cross the rings as numpy arrays or pickles, and the
parent's device stage (the device boundary node, the data pipeline's device
put) turns them into tensors.
"""

from __future__ import annotations

import collections
import contextlib
import multiprocessing as mp
import os
import pickle
import threading
import time
import traceback
import warnings
from typing import Any, Callable, Dict, List, Optional

from .node import EOS, FFNode, GO_ON
from .queues import QueueClosed
from .shm import (BatchedLaneWriter, ShmError, ShmMPMCGrid, ShmMPSCQueue,
                  ShmSPMCQueue, ShmSPSCQueue, ShmUSPSCQueue, TransportConfig,
                  WorkerStats, as_transport)
from .skeletons import AutoscaleLB

# ship a WorkerStats CPU-time record back every this many processed items
# (plus one final record before EOS, so short streams still report)
_STATS_EVERY = 32

# fork keeps worker start cheap and lets closures ride along; spawn is the
# fallback where fork does not exist (the callables must then pickle by
# reference, which place() already checks before choosing this tier)
_START_METHOD = "fork" if "fork" in mp.get_all_start_methods() else "spawn"


def _mp_context():
    return mp.get_context(_START_METHOD)


@contextlib.contextmanager
def _quiet_fork():
    # Python warns on any fork from a multithreaded process, and a parent
    # that imported torch always has threads (torch's intra-op pool, the
    # CUDA driver's, the runner's nodes); our children never touch torch or
    # the card (they run pure-python/numpy svc callables), so the warning
    # is noise here
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message=r"This process .* is "
                                r"multi-threaded, use of fork\(\)",
                                category=DeprecationWarning)
        yield


def fn_picklable(fn: Callable) -> bool:
    """Can this callable be shipped to a worker process at startup?"""
    try:
        pickle.dumps(fn)
        return True
    except Exception:   # noqa: BLE001 - unpicklable closures, lambdas (spawn)
        return _START_METHOD == "fork" and callable(fn)


class WorkerCrashed(RuntimeError):
    """A farm worker process exited without finishing its stream."""


_NUMA_SYSFS = "/sys/devices/system/node"
_numa_cache: Optional[List[List[int]]] = None


def _parse_cpulist(text: str) -> List[int]:
    """Kernel cpulist format: ``0-3,8-11`` -> [0,1,2,3,8,9,10,11]."""
    cpus: List[int] = []
    for part in text.strip().split(","):
        if not part:
            continue
        if "-" in part:
            lo, hi = part.split("-", 1)
            cpus.extend(range(int(lo), int(hi) + 1))
        else:
            cpus.append(int(part))
    return cpus


def _numa_topology(refresh: bool = False) -> List[List[int]]:
    """CPU ids per NUMA node from sysfs, or ``[]`` when the topology is
    unreadable or trivial (a single node — e.g. the 2-vCPU CI container),
    in which case every NUMA-aware path degrades to the plain behaviour."""
    global _numa_cache
    if _numa_cache is not None and not refresh:
        return _numa_cache
    nodes: List[List[int]] = []
    try:
        for entry in sorted(os.listdir(_NUMA_SYSFS)):
            if not (entry.startswith("node") and entry[4:].isdigit()):
                continue
            with open(os.path.join(_NUMA_SYSFS, entry, "cpulist")) as f:
                cpus = _parse_cpulist(f.read())
            if cpus:
                nodes.append(cpus)
    except OSError:
        nodes = []
    _numa_cache = nodes if len(nodes) >= 2 else []
    return _numa_cache


def _pin(idx: int) -> None:
    # FastFlow pins its farm threads round-robin onto cores
    # (ff_mapping_utils); do the same for worker processes — schedulers
    # on shared hosts otherwise stack them onto one core.  With a readable
    # multi-node NUMA topology, spread workers round-robin across nodes
    # first (one memory controller each, matching their lanes' first-touch
    # placement), then round-robin cores within the node.
    try:
        nodes = _numa_topology()
        if nodes:
            cpus = sorted(nodes[idx % len(nodes)])
            os.sched_setaffinity(0, {cpus[(idx // len(nodes)) % len(cpus)]})
        else:
            os.sched_setaffinity(0, {idx % (os.cpu_count() or 1)})
    except (AttributeError, OSError):
        pass


@contextlib.contextmanager
def _node_affinity(cpus: Optional[List[int]]):
    """Temporarily bind the calling (parent) process to one NUMA node's
    CPUs while it creates and first-touches a worker's lane segments, so
    the pages land on the node the worker will be pinned to.  No-op when
    ``cpus`` is falsy or affinity syscalls are unavailable."""
    if not cpus:
        yield
        return
    try:
        prev = os.sched_getaffinity(0)
        os.sched_setaffinity(0, set(cpus))
    except (AttributeError, OSError):
        yield
        return
    try:
        yield
    finally:
        try:
            os.sched_setaffinity(0, prev)
        except OSError:
            pass


def _first_touch(lane: Any) -> None:
    """Write one byte per page of a lane's segments so the (tmpfs) pages
    are allocated now, on the creating thread's current node, instead of
    wherever the first pushing process happens to run."""
    bufs = []
    for seg in (lane, getattr(lane, "_w", None)):
        buf = getattr(seg, "_buf", None)
        if buf is not None:
            bufs.append(buf)
    arena = getattr(lane, "_arena", None)
    if arena is not None and arena._buf is not None:
        bufs.append(arena._buf)
    for buf in bufs:
        for off in range(0, len(buf), 4096):
            buf[off] = 0


def _worker_main(idx: int, fn: Callable, in_lane, out_lane,
                 batch: int = 16, flush_s: float = 2e-3) -> None:
    """Child process body: pop a *batch* of items, push a batch of results.

    Items ride the lanes bare — each lane is FIFO, so the parent matches
    results to sequence numbers by arrival order and nothing extra crosses
    the wire (bare ndarrays keep the raw-slab / arena fast path). The loop
    is vectored end to end: ``pop_many`` takes whatever the emitter has
    published (one head write for the lot — naturally latency-adaptive,
    batch size tracks the backlog), results buffer in a
    :class:`~repro_torch.core.shm.BatchedLaneWriter` that flushes on
    batch-full, on the ``flush_s`` age timeout, and always before this
    worker would block on an empty input lane — so a stalled stream never
    strands results in the buffer. Every ``_STATS_EVERY`` items (and once
    more before EOS) the worker also ships a
    :class:`~repro_torch.core.shm.WorkerStats` record — true per-item CPU
    seconds from ``time.thread_time`` — which the parent collector folds
    into its stats *without* consuming a sequence slot. EOS (or a closed
    input lane) terminates; an exception in ``fn`` ships an error record
    (after flushing results already computed) followed by EOS so the parent
    collector both surfaces the error and stops waiting on this lane."""
    _pin(idx)
    writer = BatchedLaneWriter(out_lane, batch=batch, flush_s=flush_s)
    done = 0
    cpu_ema = 0.0
    eos = False
    try:
        while not eos:
            got = in_lane.try_pop_many(batch)
            if not got:
                # going idle: ship buffered results before parking on the
                # lane (the EOS/timeout side of the adaptive flush)
                try:
                    writer.flush()
                except QueueClosed:
                    break
                try:
                    got = in_lane.pop_many(batch)
                except QueueClosed:                 # parent unwound the farm
                    break
            for item, _seq in got:
                if item is EOS:
                    eos = True
                    break
                try:
                    c0 = time.thread_time()
                    out = fn(item)
                    cpu = time.thread_time() - c0
                except BaseException as e:  # noqa: BLE001 - to the parent
                    writer.push_err(ShmError(idx, repr(e),
                                             traceback.format_exc()))
                    return
                writer.put(out)
                done += 1
                cpu_ema = cpu if cpu_ema == 0.0 \
                    else 0.9 * cpu_ema + 0.1 * cpu
                if done % _STATS_EVERY == 0:
                    # rides the result batch; consumes no sequence slot
                    writer.put(WorkerStats(idx, done, cpu_ema))
                writer.maybe_flush()
    finally:
        try:
            if done:
                writer.put(WorkerStats(idx, done, cpu_ema))
            writer.push_eos()       # flushes pending results first
        except BaseException:   # noqa: BLE001 - parent may be gone
            pass
        in_lane.detach()
        out_lane.detach()


class ProcessFarmNode(FFNode):
    """A farm stage whose workers are processes, embedded as one host node.

    ``fns`` is one picklable per-item callable per worker (a replicated pure
    farm passes the same function N times).  ``pre``/``post`` are the pure
    emitter/collector callables the graph normal form absorbed into the farm
    — they run in the parent, around the shm hop.  Output order follows
    *input* order (a sequence-number reorder buffer), which is stricter than
    the thread farm's arrival order and matches the device lowering.

    ``autoscale=True`` routes through an :class:`AutoscaleLB` over the shm
    input lanes: every worker process forks at build time and parks on its
    idle gate (the blocking pop on an empty lane); the balancer grows or
    shrinks the *active* round-robin set from observed lane depth, so
    scaling up never forks — it resumes a parked worker."""

    def __init__(self, fns: List[Callable], pre: Optional[Callable] = None,
                 post: Optional[Callable] = None, capacity: int = 64,
                 slot_bytes: int = 1 << 16, label: str = "process_farm",
                 autoscale: bool = False, min_workers: int = 1,
                 transport: Optional[TransportConfig] = None):
        super().__init__()
        if not fns:
            raise ValueError("process farm with no workers")
        tc = as_transport(transport)
        if transport is not None:
            # explicit transport knobs clamp/override the legacy params
            capacity = max(2, min(capacity, tc.ring_slots))
            slot_bytes = tc.slot_bytes
        self._fns = list(fns)
        self._pre = pre
        self._post = post
        self._label = label
        self._n = len(self._fns)
        self._batch = tc.batch
        self._flush_s = tc.flush_s
        # lanes build one worker at a time so each pair's pages can
        # first-touch on the node the worker will be pinned to (a no-op
        # without a readable multi-node topology — e.g. the CI container)
        nodes = _numa_topology()
        in_lanes: List[Any] = []
        out_lanes: List[Any] = []
        for i in range(self._n):
            with _node_affinity(nodes[i % len(nodes)] if nodes else None):
                if tc.bounded:
                    in_lane: Any = ShmSPSCQueue(capacity, slot_bytes,
                                                arena_bytes=tc.arena_bytes)
                else:
                    in_lane = ShmUSPSCQueue(max(capacity, 4), slot_bytes,
                                            arena_bytes=tc.arena_bytes)
                out_lane = ShmSPSCQueue(capacity, slot_bytes,
                                        arena_bytes=tc.arena_bytes)
                if nodes:
                    _first_touch(in_lane)
                    _first_touch(out_lane)
            in_lanes.append(in_lane)
            out_lanes.append(out_lane)
        self._spmc = ShmSPMCQueue.from_lanes(in_lanes)
        self._mpsc = ShmMPSCQueue.from_lanes(out_lanes)
        self._lb: Optional[AutoscaleLB] = None
        if autoscale:
            self._lb = AutoscaleLB(min_workers=min_workers,
                                   max_workers=self._n)
            self._lb._attach(self._spmc)    # shm lanes expose the same
            #                                 len()-able lane surface
        ctx = _mp_context()
        # workers spawn at build time (before the runner's thread network and
        # any device work start) and park on their empty input lanes
        self._procs = [
            ctx.Process(target=_worker_main,
                        args=(i, fn, self._spmc.lanes[i], self._mpsc.lanes[i],
                              self._batch, self._flush_s),
                        daemon=True, name=f"ff-proc-worker-{i}")
            for i, fn in enumerate(self._fns)]
        with _quiet_fork():
            for p in self._procs:
                p.start()
        self._seq = 0
        self._delivered = 0
        self._routed = [0] * self._n
        self._active = self._n      # routing boundary when no balancer
        self._hop_ema = 0.0         # parent-side per-item shm push cost
        self._gap_ema = 0.0         # collector-side inter-delivery gap
        self._last_delivery: Optional[float] = None
        # lane i is FIFO, so its results map to these seqs in arrival order
        # (deque append/popleft from opposite ends is GIL-atomic)
        self._lane_seqs = [collections.deque() for _ in range(self._n)]
        self._worker_cpu: Dict[int, tuple] = {}   # idx -> (items, cpu_ema_s)
        self._eos_seen = [False] * self._n
        self._collector: Optional[threading.Thread] = None
        self._destroyed = False

    @property
    def width(self) -> int:
        return self._n

    @property
    def active_workers(self) -> int:
        return self._lb.cur if self._lb is not None else self._active

    def set_active(self, k: int) -> None:
        """Move the routing boundary: new items go to workers [0, k).  The
        full worker set forked at build time; an inactive worker parks on
        the blocking pop of its empty shm lane, so growing the active set
        never forks — it resumes a parked worker.  This is the AutoscaleLB
        mechanism exposed to an external policy (the adaptive supervisor)."""
        k = max(1, min(int(k), self._n))
        if self._lb is not None:
            self._lb.cur = min(max(k, self._lb.min_workers),
                               self._lb.max_workers or self._n)
        self._active = k

    # -- parent-side emitter -------------------------------------------------
    def _push_alive(self, idx: int, payload: Any) -> bool:
        """Blocking push to worker ``idx`` that fails over instead of
        wedging when the worker process has died with a full lane — or when
        the collector has already flagged the farm as failed (a live worker
        blocked on its full result lane never drains its input again)."""
        lane = self._spmc.lanes[idx]
        delay = 1e-6
        self._push_waited = False
        while not lane.try_push(payload):
            self._push_waited = True
            if self.error is not None:
                return False
            # liveness only once the lane stays full for ~1ms (a waitpid
            # syscall per spin would otherwise dominate the hop cost)
            if delay >= 1e-3 and not self._procs[idx].is_alive():
                return False
            time.sleep(delay)
            delay = min(delay * 2, 1e-3)
        return True

    def svc(self, item: Any) -> Any:
        if self.error is not None:      # collector flagged a failed farm
            raise self.error
        if self._pre is not None:
            item = self._pre(item)
        with self._stats_lock:
            seq = self._seq
            self._seq += 1
        # autoscale: the balancer picks within the active set (and adjusts
        # it from lane depth); the failover scan below may route past the
        # active boundary, but only when the chosen worker has died
        start = self._lb.selectworker(item) if self._lb is not None \
            else seq % max(1, min(self._active, self._n))
        t0 = time.perf_counter()
        for off in range(self._n):
            idx = (start + off) % self._n
            # record the seq before publishing the item: lane FIFO order is
            # the seq order, and the collector must never see an unmapped
            # result
            self._lane_seqs[idx].append(seq)
            if self._push_alive(idx, item):
                hop = time.perf_counter() - t0
                with self._stats_lock:
                    self._routed[idx] += 1
                    # the hop EMA is the *channel* cost — a push that waited
                    # on a full lane measured back-pressure, not the hop
                    if not self._push_waited:
                        self._hop_ema = hop if self._hop_ema == 0.0 \
                            else 0.9 * self._hop_ema + 0.1 * hop
                return GO_ON
            self._lane_seqs[idx].pop()  # un-record the failed attempt
        # every worker is gone; the collector (or this) surfaces the crash
        if self.error is None:
            self.error = WorkerCrashed(
                f"{self._label}: all {self._n} worker processes died")
        raise self.error

    # -- parent-side collector ----------------------------------------------
    def _collect(self) -> None:
        hold: Dict[int, Any] = {}       # out-of-order results by sequence
        nxt = 0
        delay = 1e-6
        last_liveness = time.monotonic()
        while not all(self._eos_seen):
            # vectored drain: one head publish per visited lane, the whole
            # published backlog in one call
            batch = self._mpsc.try_pop_any_many(4 * self._batch)
            if not batch:
                # adaptive backoff: a hard poll here steals CPU from the
                # very workers it waits on (they share the machine's cores)
                now = time.monotonic()
                if now - last_liveness > 0.05:
                    last_liveness = now
                    if self._check_crashed():
                        self._fail()
                        return
                time.sleep(delay)
                delay = min(delay * 2, 1e-3)
                continue
            delay = 1e-6
            for got, lane, _seq in batch:
                if got is EOS:
                    self._eos_seen[lane] = True
                    continue
                if isinstance(got, ShmError):
                    self.error = WorkerCrashed(
                        f"{self._label}: worker {got.worker} raised "
                        f"{got.exc}\n{got.tb}")
                    self._fail()
                    return
                if isinstance(got, WorkerStats):
                    # a stats record, not a stream item: it consumed no
                    # sequence slot, so fold it in *before* touching the
                    # lane's seq map
                    with self._stats_lock:
                        self._worker_cpu[got.worker] = (got.items,
                                                        got.cpu_ema_s)
                    continue
                hold[self._lane_seqs[lane].popleft()] = got
                while nxt in hold:
                    out = hold.pop(nxt)
                    nxt += 1
                    if self._post is not None:
                        out = self._post(out)
                    now = time.perf_counter()
                    with self._stats_lock:
                        if self._last_delivery is not None:
                            gap = now - self._last_delivery
                            self._gap_ema = gap if self._gap_ema == 0.0 \
                                else 0.8 * self._gap_ema + 0.2 * gap
                        self._last_delivery = now
                        self._delivered += 1
                    self.ff_send_out(out)

    def _check_crashed(self) -> bool:
        for i, p in enumerate(self._procs):
            if not self._eos_seen[i] and not p.is_alive() \
                    and self._mpsc.lanes[i].empty():
                self.error = WorkerCrashed(
                    f"{self._label}: worker {i} died "
                    f"(exitcode={p.exitcode}) before end of stream")
                return True
        return False

    def _fail(self) -> None:
        """Unwind a failed farm without wedging: stop accepting input
        (``svc`` raises once ``self.error`` is set), release workers parked
        on their input lanes (closing them makes their ``pop`` raise after
        the drain), and keep the result lanes draining so a worker blocked
        mid-push can reach its EOS and exit."""
        self._spmc.close_all()
        deadline = time.monotonic() + 10.0
        while not all(self._eos_seen) and time.monotonic() < deadline:
            ok, got, lane = self._mpsc.try_pop_any()
            if ok:
                if got is EOS:
                    self._eos_seen[lane] = True
                continue
            if all(self._eos_seen[i] or not p.is_alive()
                   for i, p in enumerate(self._procs)):
                break
            time.sleep(1e-4)

    # -- lifecycle -----------------------------------------------------------
    def svc_init(self) -> int:
        self._collector = threading.Thread(target=self._collect, daemon=True,
                                           name=f"{self._label}-collector")
        self._collector.start()
        return 0

    def svc_end(self) -> None:
        if self._destroyed:             # idempotent: already drained
            return
        try:
            for i in range(self._n):
                if self._procs[i].is_alive() or not self._spmc.lanes[i].empty():
                    try:
                        self._spmc.lanes[i].push_eos(timeout=2.0)
                    except (TimeoutError, QueueClosed):
                        pass
            if self._collector is not None:
                self._collector.join(timeout=30.0)
            for p in self._procs:
                p.join(timeout=5.0)
                if p.is_alive():
                    p.terminate()
        finally:
            # errors stay on self.error (the runner's _error() walk finds
            # them); raising here would only kill the node thread noisily
            self._destroy()

    def _destroy(self) -> None:
        if not self._destroyed:
            self._destroyed = True
            self._spmc.destroy()
            self._mpsc.destroy()

    def __del__(self):
        # a compiled-but-never-run or abandoned (e.g. run() timed out and
        # the runner was discarded) node must still release its segments
        try:
            if self._destroyed:
                return
            self._spmc.close_all()      # parked workers drain, then exit
            for p in self._procs:
                p.join(timeout=1.0)
                if p.is_alive():
                    p.terminate()
            self._destroy()
        except Exception:   # noqa: BLE001 - interpreter teardown
            pass

    # -- stats ---------------------------------------------------------------
    def node_stats(self) -> dict:
        from .perf_model import fn_key
        # after the run the shm segments are released: report empty lanes
        # (max_depth is a process-local attribute and stays valid)
        depths = [0] * self._n if self._destroyed \
            else [len(l) for l in self._spmc.lanes]
        with self._stats_lock:
            cpu_recs = list(self._worker_cpu.values())
            total = sum(i for i, _ in cpu_recs)
            s = {
                "node": self._label,
                "backend": "process",
                "workers": self._n,
                "active": self.active_workers,
                "items": self._seq,
                "delivered": self._delivered,
                "routed_per_worker": list(self._routed),
                "svc_time_ema_s": self.svc_time_ema,
                # items-weighted worker-side CPU seconds per item (true
                # service time, measured in the children); 0.0 until the
                # first WorkerStats record lands
                "svc_cpu_ema_s": (sum(i * c for i, c in cpu_recs) / total
                                  if total else 0.0),
                "hop_ema_s": self._hop_ema,
                "delivery_gap_ema_s": self._gap_ema,
                "lane_depths": depths,
                "max_lane_depth": max(
                    (l.max_depth for l in self._spmc.lanes), default=0),
                "fn_key": fn_key(self._fns[0]),
            }
        if self._lb is not None:
            s["autoscale"] = {"active": self._lb.cur,
                              "grown": self._lb.grown,
                              "shrunk": self._lb.shrunk}
        return s


def _a2a_left_main(idx: int, fn: Callable,
                   router: Optional[Callable[[Any, int], int]],
                   in_lane: ShmSPSCQueue,
                   row_lanes: List[ShmSPSCQueue]) -> None:
    """Left-side a2a child: pop ``(item, seq)``, push ``fn(item)`` onto the
    grid lane the router selects, seq riding the slot header.

    Every exit path fans EOS out row-wise (one mark per right worker) and
    leaves with exit code 0; only an *abnormal* death (crash, kill) skips
    the fan-out, which is exactly what the parent's liveness poll keys on.
    A graceful-but-early exit (an exception in ``fn``) first ships an error
    record through the grid — a right worker relays it to the parent."""
    _pin(idx)
    nR = len(row_lanes)
    rr = idx % nR                   # stagger round-robin per producer,
    #                                 matching the thread A2ASkeleton
    try:
        while True:
            try:
                got, seq = in_lane.pop_seq()
            except QueueClosed:                 # parent unwound the a2a
                break
            if got is EOS:
                break
            try:
                y = fn(got)
                if router is not None:
                    # int() so numpy-scalar routers (shared with the
                    # device lowering) index the grid
                    j = int(router(y, nR)) % nR
                else:
                    j, rr = rr, (rr + 1) % nR
            except BaseException as e:  # noqa: BLE001 - relayed to parent
                try:
                    row_lanes[idx % nR].push_err(
                        ShmError(idx, repr(e), traceback.format_exc()),
                        timeout=5.0)
                except BaseException:   # noqa: BLE001 - dead/closed column
                    pass
                break
            try:
                row_lanes[j].push(y, seq=seq)
            except QueueClosed:                 # parent unwound the a2a
                break
    finally:
        for lane in row_lanes:
            try:
                lane.push_eos()
            except BaseException:   # noqa: BLE001 - closed lane on unwind
                pass
        in_lane.detach()
        for lane in row_lanes:
            lane.detach()


def _a2a_right_main(idx: int, pin_idx: int, fn: Callable,
                    col_lanes: List[ShmSPSCQueue],
                    out_lane: ShmSPSCQueue) -> None:
    """Right-side a2a child: drain the grid column fairly, push ``fn(item)``
    (seq preserved) onto this worker's result lane.  Terminates after one
    EOS per left worker; relays left-side error records unchanged."""
    _pin(pin_idx)
    nL = len(col_lanes)
    eos = [False] * nL
    nxt = 0
    delay = 1e-6
    try:
        while not all(eos):
            got = None
            for off in range(nL):
                i = (nxt + off) % nL
                if eos[i]:
                    continue
                ok, item, seq = col_lanes[i].try_pop_seq()
                if ok:
                    nxt = (i + 1) % nL
                    got = (item, seq, i)
                    break
            if got is None:
                if all(eos[i] or col_lanes[i].drained() for i in range(nL)):
                    break               # parent unwound the a2a
                time.sleep(delay)
                delay = min(delay * 2, 1e-3)
                continue
            delay = 1e-6
            item, seq, lane = got
            if item is EOS:
                eos[lane] = True
                continue
            if isinstance(item, ShmError):      # left-side failure: relay
                out_lane.push_err(item, timeout=5.0)
                return
            try:
                z = fn(item)
            except BaseException as e:  # noqa: BLE001 - shipped to parent
                try:
                    out_lane.push_err(ShmError(idx, repr(e),
                                               traceback.format_exc()),
                                      timeout=5.0)
                except BaseException:   # noqa: BLE001 - parent may be gone
                    pass
                return
            out_lane.push(z, seq=seq)
    finally:
        try:
            out_lane.push_eos()
        except BaseException:   # noqa: BLE001 - parent may be gone
            pass
        for lane in col_lanes:
            lane.detach()
        out_lane.detach()


class ProcessA2ANode(FFNode):
    """FastFlow 3's ``ff_a2a`` on the process tier, embedded as one host node.

    ``left_fns``/``right_fns`` are picklable per-item callables, one per
    worker process on each side.  The parent's ``svc`` round-robins inputs
    onto the left workers' shm lanes; each left worker routes its result
    through the :class:`~repro_torch.core.shm.ShmMPMCGrid` lane chosen by
    ``router(y, n_right)`` (default: per-producer staggered round-robin,
    matching the thread :class:`~repro_torch.core.graph.A2ASkeleton`); right
    workers drain their column fairly and ship results back.  Sequence
    numbers ride the slot headers end to end, so output order follows
    *input* order — stricter than the thread a2a's arrival order and
    matching the process farm / device lowerings.

    Crash surfacing mirrors :class:`ProcessFarmNode`: exceptions ship back
    as error records (left-side ones relayed through a right worker); a
    killed worker on either side is caught by exit-code liveness polling.
    Failure unwinds by closing the input lanes *and* the grid — the
    process-tier equivalent of the thread a2a's drainer fix: a dead right
    worker's full column can no longer wedge the EOS fan-out, because a
    closed lane makes the fan-out push raise instead of spin."""

    def __init__(self, left_fns: List[Callable], right_fns: List[Callable],
                 router: Optional[Callable[[Any, int], int]] = None,
                 capacity: int = 64, slot_bytes: int = 1 << 16,
                 label: str = "process_a2a",
                 transport: Optional[TransportConfig] = None):
        super().__init__()
        if not left_fns or not right_fns:
            raise ValueError("process a2a needs workers on both sides")
        tc = as_transport(transport)
        if transport is not None:
            capacity = max(2, min(capacity, tc.grid_slots))
            slot_bytes = tc.slot_bytes
        self._nL = len(left_fns)
        self._nR = len(right_fns)
        self._label = label
        self._spmc = ShmSPMCQueue(self._nL, capacity, slot_bytes,
                                  arena_bytes=tc.arena_bytes)
        self._grid = ShmMPMCGrid(self._nL, self._nR, capacity, slot_bytes,
                                 arena_bytes=tc.arena_bytes)
        self._mpsc = ShmMPSCQueue(self._nR, capacity, slot_bytes,
                                  arena_bytes=tc.arena_bytes)
        ctx = _mp_context()
        self._left_procs = [
            ctx.Process(target=_a2a_left_main,
                        args=(i, fn, router, self._spmc.lanes[i],
                              self._grid.row(i)),
                        daemon=True, name=f"ff-a2a-left-{i}")
            for i, fn in enumerate(left_fns)]
        self._right_procs = [
            ctx.Process(target=_a2a_right_main,
                        args=(j, self._nL + j, fn, self._grid.col(j),
                              self._mpsc.lanes[j]),
                        daemon=True, name=f"ff-a2a-right-{j}")
            for j, fn in enumerate(right_fns)]
        with _quiet_fork():
            for p in (*self._left_procs, *self._right_procs):
                p.start()
        self._seq = 0
        self._delivered = 0
        self._routed = [0] * self._nL
        self._eos_seen = [False] * self._nR
        self._collector: Optional[threading.Thread] = None
        self._destroyed = False

    @property
    def width(self) -> int:
        return self._nL + self._nR

    # -- parent-side emitter -------------------------------------------------
    def _push_alive(self, idx: int, payload: Any, seq: int) -> bool:
        lane = self._spmc.lanes[idx]
        delay = 1e-6
        while not lane.try_push(payload, seq=seq):
            if self.error is not None:
                return False
            if delay >= 1e-3 and not self._left_procs[idx].is_alive():
                return False
            time.sleep(delay)
            delay = min(delay * 2, 1e-3)
        return True

    def svc(self, item: Any) -> Any:
        if self.error is not None:      # collector flagged a failed a2a
            raise self.error
        with self._stats_lock:
            seq = self._seq
            self._seq += 1
        for off in range(self._nL):
            idx = (seq + off) % self._nL
            if self._push_alive(idx, item, seq):
                self._routed[idx] += 1
                return GO_ON
        if self.error is None:
            self.error = WorkerCrashed(
                f"{self._label}: all {self._nL} left worker processes died")
        raise self.error

    # -- parent-side collector ----------------------------------------------
    def _collect(self) -> None:
        hold: Dict[int, Any] = {}       # out-of-order results by sequence
        nxt = 0
        delay = 1e-6
        last_liveness = time.monotonic()
        while not all(self._eos_seen):
            ok, got, lane, seq = self._mpsc.try_pop_any_seq()
            if not ok:
                now = time.monotonic()
                if now - last_liveness > 0.05:
                    last_liveness = now
                    if self._check_crashed():
                        self._fail()
                        return
                time.sleep(delay)
                delay = min(delay * 2, 1e-3)
                continue
            delay = 1e-6
            if got is EOS:
                self._eos_seen[lane] = True
                continue
            if isinstance(got, ShmError):
                self.error = WorkerCrashed(
                    f"{self._label}: worker {got.worker} raised "
                    f"{got.exc}\n{got.tb}")
                self._fail()
                return
            hold[seq] = got
            while nxt in hold:
                with self._stats_lock:
                    self._delivered += 1
                self.ff_send_out(hold.pop(nxt))
                nxt += 1
        # completeness invariant: on a clean end of stream every routed item
        # must have produced exactly one output.  A gap means a worker died
        # without its error record reaching us (e.g. a push_err that timed
        # out on a wedged column was swallowed) — surface it rather than
        # returning a silently truncated stream.
        if self.error is None and self._delivered < self._seq:
            self.error = WorkerCrashed(
                f"{self._label}: stream truncated — only {self._delivered} "
                f"of {self._seq} items delivered (a worker failed without "
                "its error record reaching the collector)")

    def _check_crashed(self) -> bool:
        # every graceful exit path in the worker mains ends with exit code 0
        # (normal EOS, closed lanes on unwind, an exception shipped as an
        # error record); a nonzero/signal exit therefore means a real crash
        for i, p in enumerate(self._left_procs):
            if not p.is_alive() and p.exitcode != 0:
                self.error = WorkerCrashed(
                    f"{self._label}: left worker {i} died "
                    f"(exitcode={p.exitcode}) before end of stream")
                return True
        for j, p in enumerate(self._right_procs):
            if not self._eos_seen[j] and not p.is_alive() \
                    and p.exitcode != 0:
                self.error = WorkerCrashed(
                    f"{self._label}: right worker {j} died "
                    f"(exitcode={p.exitcode}) before end of stream")
                return True
        return False

    def _fail(self) -> None:
        """Unwind a failed a2a without wedging: refuse new input (``svc``
        raises once ``self.error`` is set), close the left input lanes
        (parked left workers' pops raise) and the whole grid (left workers
        blocked pushing into a dead right worker's column raise instead of
        spinning; right workers see closed-and-drained columns and exit),
        then keep the result lanes draining so every survivor reaches its
        EOS."""
        self._spmc.close_all()
        self._grid.close_all()
        deadline = time.monotonic() + 10.0
        while not all(self._eos_seen) and time.monotonic() < deadline:
            ok, got, lane, _seq = self._mpsc.try_pop_any_seq()
            if ok:
                if got is EOS:
                    self._eos_seen[lane] = True
                continue
            if all(self._eos_seen[j] or not p.is_alive()
                   for j, p in enumerate(self._right_procs)):
                break
            time.sleep(1e-4)

    # -- lifecycle -----------------------------------------------------------
    def svc_init(self) -> int:
        self._collector = threading.Thread(target=self._collect, daemon=True,
                                           name=f"{self._label}-collector")
        self._collector.start()
        return 0

    def svc_end(self) -> None:
        try:
            for i in range(self._nL):
                if self._left_procs[i].is_alive() \
                        or not self._spmc.lanes[i].empty():
                    try:
                        # generous timeout: a full input lane drains as long
                        # as the grid is moving, and the collector is
                        # concurrently draining the far end
                        self._spmc.lanes[i].push_eos(timeout=10.0)
                    except (TimeoutError, QueueClosed):
                        pass
            if self._collector is not None:
                self._collector.join(timeout=30.0)
            for p in (*self._left_procs, *self._right_procs):
                p.join(timeout=5.0)
                if p.is_alive():
                    p.terminate()
        finally:
            self._destroy()

    def _destroy(self) -> None:
        if not self._destroyed:
            self._destroyed = True
            self._spmc.destroy()
            self._grid.destroy()
            self._mpsc.destroy()

    def __del__(self):
        # a compiled-but-never-run or abandoned node must still release its
        # workers and segments (same contract as ProcessFarmNode)
        try:
            if self._destroyed:
                return
            self._spmc.close_all()
            self._grid.close_all()
            for p in (*self._left_procs, *self._right_procs):
                p.join(timeout=1.0)
                if p.is_alive():
                    p.terminate()
            self._destroy()
        except Exception:   # noqa: BLE001 - interpreter teardown
            pass

    # -- stats ---------------------------------------------------------------
    def node_stats(self) -> dict:
        with self._stats_lock:
            return {
                "node": self._label,
                "backend": "process",
                "left_workers": self._nL,
                "right_workers": self._nR,
                "items": self._seq,
                "delivered": self._delivered,
                "routed_per_left_worker": list(self._routed),
                "svc_time_ema_s": self.svc_time_ema,
                # grid high-water marks are producer-local (they live in the
                # left children), so only the parent-fed input lanes report
                "max_lane_depth": max(
                    (l.max_depth for l in self._spmc.lanes), default=0),
            }
