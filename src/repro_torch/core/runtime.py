"""Adaptive runtime — close the stats -> placement loop at runtime.

Port of ``src/repro/core/runtime.py``.  The staged compiler
(core/compiler.py) chooses farm widths and thread/process/device placement
ONCE, at ``compile()``, from startup-calibrated constants; every runner
exposes ``stats()`` (per-node service-time EMA, items, lane depths).  This
module is the consumer — the FastFlow accelerator picture (paper Sec. 9)
taken to its conclusion: a running streaming network is a *service* whose
configuration is continuously re-derived from what the service actually
observes, while the device stages behind it keep running their CUDA
kernels.

Three mechanisms, composed:

- :class:`AdaptiveFarmNode` — the reconfigurable farm stage
  ``compile(adaptive=True)`` emits for every eligible farm.  ONE host node
  whose *engine* is either a thread-tier farm
  (:class:`~repro_torch.core.skeletons.ThreadFarmNode`) or the process-tier
  :class:`~repro_torch.core.process.ProcessFarmNode` — both
  sequence-ordered, both drainable — behind the node's ordinary boundary
  queues.  Its reconfigure ops: ``set_active`` (live width change: moves
  the routing boundary between 1 and the built width, the AutoscaleLB
  mechanism driven externally) and ``migrate`` (live tier change: drain the
  current engine to a quiescent boundary with an EOS-style barrier on its
  lanes, hot-swap the engine for the other tier's lowering — reusing the
  ProcessFarmNode build path, no new worker machinery — and resume; the
  stream back-pressures on the node's bounded input lane meanwhile, and
  output order is exactly input order on both sides of the swap).  A
  process engine forks its workers when it is built, from a parent that
  may have initialised CUDA; they run numpy callables only
  (``core/process.py``).

- :class:`Supervisor` — samples the uniform
  :class:`~repro_torch.core.graph.StageHandle` surface across a runner's
  stages every ``interval`` seconds and acts on the reconfigurable ones:

  * **width policy** (the AutoscaleLB thresholds, generalized to any
    adaptive farm on either tier): mean active-lane depth above ``hi``
    activates one more worker, below ``lo`` retires one;
  * **migration policy**: a thread-placed farm whose workers are
    demonstrably serializing on the GIL (``gil_ratio`` = CPU/wall of the
    worker calls well below 1 under >=2 concurrently active workers) and
    whose process-tier estimate ``max(cpu_ema / width, hop)`` beats the
    observed per-item delivery time past a hysteresis margin migrates
    thread -> process; a process-placed farm whose observed per-item time
    has collapsed into the shm hop (hop-dominated: the channel costs more
    than it buys) migrates back to threads;
  * **SLO and boundary policies**: pressure levels pushed to the serving
    engine's admission stage (:class:`SLOPolicy`), and the in-flight
    window of an overlapped device boundary retuned from its stall share;
  * **cost-model refinement**: snapshots feed
    :func:`~repro_torch.core.perf_model.observe`, so measured service
    times, GIL signals and hop costs flow back into the calibration cache
    and the *next* ``compile()``'s ``place()`` starts from history instead
    of a fresh sample probe.

Disabled (no supervisor started, ``adaptive=False``), nothing here runs and
compiled graphs behave exactly as before.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any, Callable, Dict, List, Optional

from . import perf_model as pm
from .graph import GraphError, Runner, StageHandle
from .node import FFNode
from .process import ProcessFarmNode
from .skeletons import ThreadFarmNode

_TIERS = ("host", "host_process")


@dataclasses.dataclass
class ReplacementEvent:
    """One supervisor/stage action, for reports and tests."""

    t: float                    # wall-clock time of the event
    stage: str                  # stage label
    kind: str                   # "migrate" | "grow" | "shrink" |
    #                             "retune" | "degrade" | "shed" | "restore"
    detail: str                 # human-readable what/why
    latency_ms: Optional[float] = None

    def __str__(self) -> str:
        lat = f" ({self.latency_ms:.1f}ms)" if self.latency_ms else ""
        return f"[{self.kind}] {self.stage}: {self.detail}{lat}"


@dataclasses.dataclass
class SLOPolicy:
    """Overload policy for SLO-controllable stages (the serving engine's
    admission stage): how hard to push back as backlog approaches capacity,
    instead of queueing unboundedly.

    Pressure is the backlog/capacity ratio of the stage's ``stats()["slo"]``
    block.  Below ``degrade_at`` the stage runs unconstrained (level 0); in
    [``degrade_at``, ``shed_at``) it *degrades* (level 1: new requests'
    ``max_new_tokens`` capped at ``degrade_tokens``, early-exit thresholds
    tightened by ``exit_margin``); at ``shed_at`` and above it *sheds*
    (level 2: new submissions rejected with a typed ``Overloaded`` result).
    The controlled stage always enforces its own hard cap inline — the
    supervisor policy moves the soft thresholds below it."""

    degrade_at: float = 0.5
    shed_at: float = 0.9
    degrade_tokens: int = 8
    exit_margin: float = 0.5

    def level(self, backlog: int, capacity: int) -> int:
        ratio = backlog / max(1, capacity)
        if ratio >= self.shed_at:
            return 2
        if ratio >= self.degrade_at:
            return 1
        return 0


class AdaptiveFarmNode(FFNode):
    """A farm stage that can be re-placed *while the stream runs*.

    To the surrounding network this is one ordinary host node (like
    :class:`~repro_torch.core.process.ProcessFarmNode`); internally it
    delegates to a tier *engine* —
    :class:`~repro_torch.core.skeletons.ThreadFarmNode` or
    :class:`~repro_torch.core.process.ProcessFarmNode` — that shares one
    surface: ``svc`` routes an item in, a collector thread delivers
    sequence-ordered results via the node's output, ``svc_end`` drains
    every accepted item (or surfaces the error) before returning,
    ``set_active`` moves the routing boundary.

    ``migrate(tier)`` is the hot swap: take the node lock (pausing intake —
    upstream back-pressures on the node's bounded input queue), drain the
    current engine to its quiescent boundary via ``svc_end`` (the EOS-style
    barrier), build the other tier's engine through its normal constructor,
    bind it to the same output, and resume.  Output order is globally
    input order because both engines are sequence-ordered and the drain is
    a full barrier.  A worker crash during the drain aborts the swap and
    surfaces exactly as it would mid-stream (``WorkerCrashed`` et al.)."""

    ff_adaptive = True
    _engine: Optional[FFNode] = None

    def __init__(self, fn: Callable, width: int,
                 pre: Optional[Callable] = None,
                 post: Optional[Callable] = None, tier: str = "host",
                 capacity: int = 64, slot_bytes: int = 1 << 16,
                 label: str = "adaptive_farm", can_process: bool = True,
                 transport=None):
        super().__init__()
        if tier not in _TIERS:
            raise GraphError(f"adaptive tier must be one of {_TIERS}")
        if tier == "host_process" and not can_process:
            raise GraphError(f"{label}: worker is not process-eligible but "
                             "was placed on the process tier")
        self._fn = fn
        self._width = max(1, int(width))
        self._pre = pre
        self._post = post
        self._cap = capacity
        self._slot_bytes = slot_bytes
        self._transport = transport
        self._label = label
        self._can_process = can_process
        self._tier = tier
        self._reconf_lock = threading.RLock()
        self._ended = False
        self.migrations: List[ReplacementEvent] = []
        self._error_: Optional[BaseException] = None
        self._engine = self._build_engine(tier, self._width)

    # surface the engine's asynchronous failures (its collector thread sets
    # engine.error) through the node's own error attribute, which is what
    # the runner's _error() walk and svc-raise path consume
    @property
    def error(self) -> Optional[BaseException]:
        if self._error_ is not None:
            return self._error_
        eng = self._engine
        return eng.error if eng is not None else None

    @error.setter
    def error(self, e: Optional[BaseException]) -> None:
        self._error_ = e

    @property
    def tier(self) -> str:
        return self._tier

    @property
    def width(self) -> int:
        return self._width

    @property
    def active_workers(self) -> int:
        eng = self._engine
        return eng.active_workers if eng is not None else 0

    def _build_engine(self, tier: str, active: int) -> FFNode:
        fns = [self._fn] * self._width
        if tier == "host_process":
            eng = ProcessFarmNode(fns, pre=self._pre, post=self._post,
                                  capacity=self._cap,
                                  slot_bytes=self._slot_bytes,
                                  transport=self._transport,
                                  label=f"{self._label}/process")
        else:
            eng = ThreadFarmNode(fns, pre=self._pre, post=self._post,
                                 capacity=self._cap,
                                 label=f"{self._label}/thread")
        eng.set_active(active)
        return eng

    # -- node protocol --------------------------------------------------------
    def svc_init(self) -> int:
        with self._reconf_lock:
            self._engine._bind(self._out, self._id)
            return self._engine.svc_init()

    def svc(self, item: Any) -> Any:
        # the lock is the migration barrier: an item is either fully handed
        # to the old engine (and drained before the swap) or routed to the
        # new one — never dropped between engines
        with self._reconf_lock:
            if self._error_ is not None:
                raise self._error_
            return self._engine.svc(item)

    def svc_end(self) -> None:
        with self._reconf_lock:
            self._ended = True
            eng = self._engine
            if eng is not None:
                eng.svc_end()
                if self._error_ is None and eng.error is not None:
                    self._error_ = eng.error

    # -- reconfigure ops ------------------------------------------------------
    def set_active(self, k: int) -> None:
        with self._reconf_lock:
            self._engine.set_active(k)

    def can_migrate(self, target: str) -> bool:
        return target in _TIERS and (target != "host_process"
                                     or self._can_process)

    def migrate(self, target: str) -> bool:
        """Drain-and-swap to ``target`` ("host" | "host_process"); returns
        True when a swap happened, False when already there.  Raises the
        stage's error when a worker failed before/while draining — the swap
        is aborted and the error surfaces exactly as a mid-stream failure
        would."""
        if target not in _TIERS:
            raise GraphError(f"migrate target must be one of {_TIERS} "
                             f"(got {target!r})")
        if target == "host_process" and not self._can_process:
            raise GraphError(f"{self._label}: worker fn is not picklable — "
                             "cannot migrate to the process tier")
        with self._reconf_lock:
            if self._error_ is not None:
                raise self._error_
            if target == self._tier:
                return False
            if self._ended:
                # the stream finished (svc_end drained and released the
                # engine) while this migrate was queued on the lock: there
                # is nothing left to re-place
                return False
            t0 = time.perf_counter()
            old = self._engine
            old.svc_end()             # the EOS-style barrier: drain + join
            if old.error is not None:
                # crash during the drain: abort the swap, surface the error
                self._error_ = old.error
                raise self._error_
            active = old.active_workers
            eng = self._build_engine(target, active)
            eng._bind(self._out, self._id)
            if eng.svc_init() < 0:
                raise RuntimeError(f"{self._label}: engine svc_init failed")
            self._engine = eng
            from_tier, self._tier = self._tier, target
            dt_ms = (time.perf_counter() - t0) * 1e3
            self.migrations.append(ReplacementEvent(
                time.time(), self._label, "migrate",
                f"{from_tier} -> {target}", dt_ms))
            return True

    # -- stats ----------------------------------------------------------------
    def node_stats(self) -> dict:
        with self._reconf_lock:
            s = self._engine.node_stats()
            s["node"] = self._label
            s["tier"] = self._tier
            s["adaptive"] = True
            s["max_width"] = self._width
            s["migrations"] = len(self.migrations)
            return s

    def make_handle(self, desc: Optional[str] = None) -> "AdaptiveStageHandle":
        return AdaptiveStageHandle(desc or self._label, self)


class AdaptiveStageHandle(StageHandle):
    """Reconfigurable :class:`~repro_torch.core.graph.StageHandle` over an
    :class:`AdaptiveFarmNode`: live ``resize`` and ``migrate``."""

    reconfigurable = True

    def __init__(self, desc: str, node: AdaptiveFarmNode):
        super().__init__(desc, node)
        self.node = node

    @property
    def tier(self) -> str:
        return self.node.tier

    @property
    def max_width(self) -> int:
        return self.node.width

    @property
    def events(self) -> List[ReplacementEvent]:
        return self.node.migrations

    def stats(self) -> dict:
        return self.node.node_stats()

    def can_migrate(self, target: str) -> bool:
        return self.node.can_migrate(target)

    def resize(self, width: int) -> bool:
        self.node.set_active(width)
        return True

    def migrate(self, target: str) -> bool:
        return self.node.migrate(target)


class Supervisor:
    """Sample every stage of a runner; resize/migrate the adaptive ones;
    feed the cost model.

    ``start()`` spawns a daemon sampling thread; ``stop()`` joins it and
    persists what was learned into the calibration cache
    (``perf_model.observe(write=True)``).  All policies are per-stage and
    carry hysteresis + a per-stage cooldown so the supervisor cannot flap.
    A supervisor over a runner with no adaptive stages is a pure observer —
    useful on its own, since the observations refine later compiles.
    Overlapped device boundaries (``boundary_tunable`` handles) get their
    in-flight window depth retuned live from observed boundary stall stats
    (``_boundary_act``).

    Policy knobs (defaults chosen to act within a few sampling windows
    without reacting to one noisy sample): ``hi``/``lo`` are the
    AutoscaleLB-style mean-lane-depth thresholds for growing/shrinking the
    active worker set; ``gil_threshold`` is the CPU/wall ratio below which
    thread workers count as GIL-serialized; ``hysteresis`` is the margin the
    other tier's estimate must win by; ``hop_factor`` marks a process stage
    hop-dominated when its observed per-item time falls under ``hop_factor
    * hop``."""

    def __init__(self, runner: Runner, interval: float = 0.05,
                 resize: bool = True, migrate: bool = True,
                 observe: bool = True, hi: float = 2.0, lo: float = 0.25,
                 gil_threshold: float = 0.8, hysteresis: float = 0.8,
                 hop_factor: float = 3.0, cooldown_s: float = 1.0,
                 min_window_items: int = 4, observe_every: int = 10,
                 slo: Optional[SLOPolicy] = None):
        self.runner = runner
        self.handles: List[StageHandle] = list(runner.stage_handles())
        self.slo = slo or SLOPolicy()
        self._slo_levels: Dict[int, int] = {}
        self._observed_final = False
        self.interval = interval
        self.resize_enabled = resize
        self.migrate_enabled = migrate
        self.observe_enabled = observe
        self.hi = hi
        self.lo = lo
        self.gil_threshold = gil_threshold
        self.hysteresis = hysteresis
        self.hop_factor = hop_factor
        self.cooldown_s = cooldown_s
        self.min_window_items = min_window_items
        self.observe_every = max(1, observe_every)
        self.events: List[ReplacementEvent] = []
        self.samples = 0
        self.observed_facts = 0
        self.loop_time_s = 0.0          # supervisor overhead accounting
        self._win: Dict[int, tuple] = {}
        self._bwin: Dict[int, tuple] = {}   # boundary stall windows
        self._cooldown: Dict[int, float] = {}
        self._ticks = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- lifecycle ------------------------------------------------------------
    def start(self) -> "Supervisor":
        if self._thread is not None:
            raise RuntimeError("supervisor already started")
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="ff-supervisor")
        self._thread.start()
        return self

    def stop(self, timeout: float = 10.0) -> None:
        """Stop the sampling loop and flush the final observation.
        Idempotent: a second (or concurrent) stop joins nothing and does not
        re-observe — callers may stop unconditionally, whether or not the
        supervisor was ever started."""
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout)
        if self.observe_enabled and not self._observed_final:
            self._observed_final = True
            snaps = []
            for h in self.handles:
                try:
                    snaps.append(h.stats())
                except Exception:       # noqa: BLE001 - stage already gone
                    pass
            self.observed_facts += pm.observe({"stages": snaps}, write=True)

    def _loop(self) -> None:
        while not self._stop.wait(self.interval):
            t0 = time.perf_counter()
            try:
                self._tick()
            except Exception:           # noqa: BLE001 - never kill sampling
                pass
            self.loop_time_s += time.perf_counter() - t0

    # -- one sampling tick ----------------------------------------------------
    def _tick(self) -> None:
        snaps = []
        for i, h in enumerate(self.handles):
            try:
                s = h.stats()
            except Exception:           # noqa: BLE001 - stage already gone
                continue
            snaps.append(s)
            self.samples += 1
            if h.reconfigurable:
                self._act(i, h, s)
            if getattr(h, "slo_controllable", False):
                self._slo_act(i, h, s)
            if getattr(h, "boundary_tunable", False):
                self._boundary_act(i, h, s)
        self._ticks += 1
        if self.observe_enabled and self._ticks % self.observe_every == 0:
            self.observed_facts += pm.observe({"stages": snaps})

    def _record(self, stage: str, kind: str, detail: str,
                latency_ms: Optional[float] = None) -> None:
        self.events.append(ReplacementEvent(time.time(), stage, kind, detail,
                                            latency_ms))

    def _slo_act(self, i: int, h: StageHandle, s: dict) -> None:
        """Overload policy for SLO-controllable stages: derive the pressure
        level from the stage's backlog-vs-capacity ratio and push it down
        through ``set_pressure`` — 0 unconstrained, 1 degrade (cap tokens,
        tighten early exit), 2 shed (reject new submissions with
        ``Overloaded``).  The stage's own inline hard cap stays the
        backstop; this moves the soft thresholds under it."""
        slo = s.get("slo") or {}
        backlog = int(slo.get("backlog", 0) or 0)
        capacity = int(slo.get("capacity", 0) or 0)
        if capacity <= 0:
            return
        level = self.slo.level(backlog, capacity)
        prev = self._slo_levels.get(i, 0)
        if level == prev:
            return
        self._slo_levels[i] = level
        try:
            h.set_pressure(level, self.slo)
        except Exception:               # noqa: BLE001 - stage already gone
            return
        kind = {0: "restore", 1: "degrade", 2: "shed"}[level]
        self._record(s.get("node", h.desc), kind,
                     f"backlog {backlog}/{capacity} "
                     f"({backlog / max(1, capacity):.0%}): pressure "
                     f"{prev} -> {level}")

    def _boundary_act(self, i: int, h: StageHandle, s: dict) -> None:
        """Window policy for overlapped device boundaries
        (:class:`~repro_torch.core.compiler.DeviceBoundaryHandle`): watch the
        *stall* share of the boundary's drain time over the sampling
        window — drain paid while the in-flight window was full means the
        host had to wait for device work that a deeper window would have
        hidden, so grow ``inflight``; a window that never stalls is deeper
        than the pipeline needs, so shrink it back.  Same hysteresis
        discipline as the tier policies: per-stage cooldown, a minimum
        number of retired items per window, and a dead band between the
        grow and shrink thresholds so the depth cannot flap."""
        b = s.get("boundary") or {}
        if b.get("mode") != "overlapped":
            return
        now = time.monotonic()
        retired = int(b.get("retired", 0) or 0)
        stall = float(b.get("stall_s", 0.0) or 0.0)
        drain = float(b.get("drain_s", 0.0) or 0.0)
        prev = self._bwin.get(i)
        self._bwin[i] = (now, retired, stall, drain)
        if prev is None or now < self._cooldown.get(i, 0.0):
            return
        d_items = retired - prev[1]
        d_stall, d_drain = stall - prev[2], drain - prev[3]
        if d_items < self.min_window_items or d_drain <= 0.0:
            return
        frac = d_stall / d_drain
        k = int(b.get("inflight", 2) or 2)
        stage = s.get("node", h.desc)
        if frac > 0.5 and k < 8:
            h.set_window(inflight=k + 1)
            self._record(stage, "retune",
                         f"boundary stalled {frac:.0%} of drain over "
                         f"{d_items} items: inflight {k} -> {k + 1}")
        elif frac < 0.05 and k > 2:
            h.set_window(inflight=k - 1)
            self._record(stage, "retune",
                         f"boundary never stalls ({frac:.0%}): inflight "
                         f"{k} -> {k - 1}")
        else:
            return
        self._cooldown[i] = now + self.cooldown_s
        self._bwin.pop(i, None)         # the old window spans two depths

    def _act(self, i: int, h: StageHandle, s: dict) -> None:
        now = time.monotonic()
        # observed per-item delivery time over the sampling window
        delivered = int(s.get("delivered", 0) or 0)
        prev = self._win.get(i)
        self._win[i] = (now, delivered)
        t_obs = None
        if prev is not None and delivered - prev[1] >= self.min_window_items:
            t_obs = (now - prev[0]) / (delivered - prev[1])
        active = int(s.get("active", 0) or 0)
        depths = s.get("lane_depths") or []
        depth = (sum(depths[:active]) / active) if active and depths else 0.0
        stage = s.get("node", h.desc)
        max_w = getattr(h, "max_width", active)
        # -- width policy (AutoscaleLB generalized) ------------------------
        if self.resize_enabled and active:
            if depth > self.hi and active < max_w:
                h.resize(active + 1)
                self._record(stage, "grow",
                             f"mean lane depth {depth:.1f} > {self.hi}: "
                             f"active {active} -> {active + 1}")
            elif depth < self.lo and active > 1:
                h.resize(active - 1)
                self._record(stage, "shrink",
                             f"mean lane depth {depth:.2f} < {self.lo}: "
                             f"active {active} -> {active - 1}")
        # -- migration policy ----------------------------------------------
        if not self.migrate_enabled or t_obs is None \
                or now < self._cooldown.get(i, 0.0):
            return
        calib = pm.get_calibration(measure=False)
        tier = s.get("tier")
        if tier == "host" and h.can_migrate("host_process"):
            cpu = float(s.get("svc_cpu_ema_s", 0.0) or 0.0)
            ratio = s.get("gil_ratio")
            # the farm lanes batch their hops, so charge the amortized cost
            hop = calib.proc_hop_effective_s()
            proc_est = max(cpu / max(1, max_w), hop)
            # the GIL-serialization evidence, either form: (a) worker calls'
            # CPU/wall ratio well below 1 under >=2 concurrently active
            # workers (they wait on the GIL, not on work), or (b) observed
            # per-item throughput no better than one worker's serial CPU
            # time even though the stage could go wider — threads are
            # buying nothing
            serialized = (ratio is not None and active >= 2
                          and ratio < self.gil_threshold) \
                or (max_w >= 2 and t_obs >= 0.8 * cpu)
            # migrate only when the work is also (c) substantively
            # CPU-bound — not blocking/IO, whose low CPU/wall ratio looks
            # like GIL wait but gains nothing from processes, (d)
            # backlogged (the stage is the bottleneck), and (e) predicted
            # to win past the hysteresis margin
            if (cpu > 5.0 * hop and serialized
                    and depth >= 1.0
                    and proc_est < self.hysteresis * t_obs):
                self._migrate(i, h, "host_process",
                              f"GIL-serialized (cpu/wall "
                              f"{ratio if ratio is None else round(ratio, 2)}"
                              f", observed {t_obs*1e6:.0f}us/item vs cpu "
                              f"{cpu*1e6:.0f}us): proc est "
                              f"{proc_est*1e6:.0f}us wins")
                # the decision was costed at full width: grant it, the
                # depth policy will shrink an over-provisioned farm later
                if h.tier == "host_process":
                    h.resize(max_w)
        elif tier == "host_process":
            hop = float(s.get("hop_ema_s", 0.0) or 0.0) \
                or calib.proc_hop_effective_s()
            cpu = float(s.get("svc_cpu_ema_s", 0.0) or 0.0)
            if cpu > 0.0:
                # true-service-time comparison: the workers now ship their
                # own CPU clocks back over the result lanes (WorkerStats),
                # so the policy compares what a thread farm would actually
                # cost — serial cpu per item, floored by the thread-queue
                # hop — against observed delivery, past the same hysteresis
                # margin the forward policy uses
                thread_est = max(cpu, calib.queue_hop_s)
                if thread_est < self.hysteresis * t_obs:
                    self._migrate(i, h, "host",
                                  f"worker cpu {cpu*1e6:.0f}us/item: thread "
                                  f"est {thread_est*1e6:.0f}us beats "
                                  f"observed {t_obs*1e6:.0f}us/item")
                return
            # no worker CPU record yet (short stream, stats in flight):
            # fall back to the hop-domination heuristic.  Per-WORKER
            # service time, not per-item delivery gap: a wide,
            # well-parallelized farm delivers every t_task/width — frequent
            # deliveries alone must not read as "hop-dominated" (that would
            # ping-pong against the forward policy above, which only fires
            # for cpu > 5x hop; this fires only below hop_factor x hop)
            per_worker = t_obs * max(1, active)
            if per_worker < self.hop_factor * hop:
                self._migrate(i, h, "host",
                              f"hop-dominated: {per_worker*1e6:.0f}us/item "
                              f"per worker < {self.hop_factor:.0f}x shm hop "
                              f"{hop*1e6:.0f}us")

    def _migrate(self, i: int, h: StageHandle, target: str,
                 why: str) -> None:
        stage = h.desc
        t0 = time.perf_counter()
        try:
            moved = h.migrate(target)
        except Exception as e:          # noqa: BLE001 - error surfaces on the
            #                             stage/runner; record and stand down
            self._record(stage, "migrate",
                         f"-> {target} failed: {e!r}")
            self._cooldown[i] = time.monotonic() + 10.0 * self.cooldown_s
            return
        if moved:
            self._record(stage, "migrate", f"-> {target}: {why}",
                         (time.perf_counter() - t0) * 1e3)
        self._cooldown[i] = time.monotonic() + self.cooldown_s
        self._win.pop(i, None)          # the old window spans two tiers

    # -- reporting ------------------------------------------------------------
    def stats(self) -> dict:
        return {"samples": self.samples, "ticks": self._ticks,
                "events": len(self.events),
                "observed_facts": self.observed_facts,
                "loop_time_s": self.loop_time_s}
