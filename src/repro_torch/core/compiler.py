"""The staged graph compiler: ``normalize -> annotate -> place -> emit``.

Port of ``src/repro/core/compiler.py`` for the host-thread, host-process,
host-remote and device tiers:

1. **normalize** — the :meth:`FFGraph.optimize` normal-form rewrites;
2. **annotate** — a :class:`CostEstimate` per IR node from the paper's
   Sec. 13 algebra (``core/perf_model.py``): per-item host time from
   ``costs=``, ``ff_cost``/``ff_flops``/``ff_bytes`` attributes, or timing
   the node on a ``sample`` item; device time from the H100 roofline when
   FLOPs are declared;
3. **place** — a :class:`Placement` per top-level stage: host *threads*,
   host *processes* (``host_process``: a farm of GIL-bound workers when true
   parallelism over the calibrated shared-memory hop beats threads), host
   *remote* (``host_remote``: a worker pool on other hosts reached over the
   TCP lanes of ``core/net.py``, unlocked by ``compile(remote_workers=
   [...])``, when parallelism over the calibrated network hop beats both),
   or the *device*, from the roofline comparison (with the dispatch
   amortized over each run of adjacent device candidates), overridable per
   node;
4. **emit** — remote-placed farms first become
   :class:`~repro_torch.core.net.RemoteFarmNode` boundary nodes (workers on
   other hosts over credit-windowed TCP lanes, sequence-ordered), then
   process-placed farm and ``all_to_all`` stages
   :class:`~repro_torch.core.process.ProcessFarmNode` /
   :class:`~repro_torch.core.process.ProcessA2ANode` boundary nodes (OS
   processes over the shared-memory rings of ``core/shm.py``), host stages
   to the rest of emit; then all-host -> :class:`ProcessRunner` (with
   process stages) or :class:`~repro_torch.core.graph.HostRunner`;
   all-device -> :class:`~repro_torch.core.graph.DeviceRunner`; mixed ->
   :class:`HybridRunner`, host stages over SPSC queues feeding fused device
   segments through :class:`_DeviceStageNode` boundary nodes.  An all-host
   graph with a remote farm runs in a :class:`RemoteRunner`.

With ``adaptive=True`` emit first lowers every eligible farm into a
:class:`~repro_torch.core.runtime.AdaptiveFarmNode`, whose thread or
process engine a :class:`~repro_torch.core.runtime.Supervisor` can resize
and migrate while the stream runs.

Process workers fork from the parent, which may have initialised CUDA: they
run numpy callables and never touch torch (``core/process.py``); so do the
remote tier's worker pools (``core/net.py``).
"""

from __future__ import annotations

import collections
import dataclasses
import os
import pickle
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from . import perf_model as pm
from .fuse import FusedSegment, fuse_device_segments, segment_key
from .graph import (A2AG, DeviceRunner, FarmG, FFGraph, GraphError,
                    HostRunner, MapG, PipeG, SeqG, StageHandle, _copy_streams,
                    _device_fn, _is_pure_seq, _Landing, _pure_of, _to_device)
from .net import RemoteFarmNode
from .node import GO_ON, FFNode
from .process import ProcessA2ANode, ProcessFarmNode, fn_picklable
from .runtime import AdaptiveFarmNode
from .skeletons import ThreadFarmNode
from .tree import tree_leaves, tree_map

# Baked-in cost-model fallbacks, used until perf_model.calibrate() has run
# (see perf_model.DEFAULT_CALIBRATION).
DEVICE_DISPATCH_S = 2e-5
DEFAULT_T_TASK_S = 5e-5

_TARGETS = ("host", "host_process", "host_remote", "device")


@dataclasses.dataclass
class CompileConfig:
    """Every compile-time knob of the staged pipeline in one value.

    ``FFGraph.compile(config=CompileConfig(...))`` is the supported spelling.
    The fields keep the reference's meaning (see its ``CompileConfig``):
    ``feedback_steps``/``feedback_cond`` bound a ``wrap_around`` loop on the
    device, ``a2a_capacity_factor`` bounds the all_to_all expert lanes
    (default lossless), ``fuse=False`` lowers one device part per stage.

    The overlapped device boundary.  ``overlap=True`` (the default) makes
    every :class:`_DeviceStageNode` software-pipeline its microbatches
    through a depth-K in-flight window: microbatch *i*'s copy in, compute
    and copy out are queued on the card without waiting (copies on side
    streams into pinned host buffers, ordered by CUDA events), and its
    results are only awaited once *K-1* newer microbatches ride behind it.
    ``overlap=False`` restores the synchronous boundary; results are
    byte-identical either way.  ``microbatch=`` overrides the stacking depth
    (default 8), ``inflight=`` the window depth K (default: the autotuned
    ``device_overlap:window`` record, else 2).  Feedback (``wrap_around``)
    graphs always compile the synchronous boundary.

    The process tier: ``transport`` (a
    :class:`~repro_torch.core.shm.TransportConfig` or a dict of its fields)
    tunes every shared-memory lane a process stage builds — ring depths,
    slot size, arena size, bounded or uSPSC lanes, the batch flush policy;
    without it ``shm_slot_bytes`` sizes the slots and the rest takes the
    defaults (see :func:`emit`).

    ``adaptive=True`` lowers every eligible farm (one replicated pure
    worker, pure-or-absent emitter/collector, the default schedule) into an
    :class:`~repro_torch.core.runtime.AdaptiveFarmNode` whose collector is
    sequence-ordered on both tiers; attach a
    :class:`~repro_torch.core.runtime.Supervisor` to re-place it live.

    The remote tier: ``remote_workers=["host:port", ...]`` names worker
    pools (``python -m repro_torch.launch.worker`` or
    :func:`~repro_torch.core.net.spawn_loopback_pool`) and unlocks the
    ``host_remote`` target; ``net_credit`` bounds each network lane's
    in-flight window."""

    plan: Any = None
    mode: str = "auto"
    costs: Optional[Dict] = None
    sample: Any = None
    placements: Optional[Dict] = None
    capacity: int = 512
    results_capacity: int = 4096
    axis: str = "data"
    feedback_steps: Optional[int] = None
    feedback_cond: Optional[Callable] = None
    device_batch: Optional[int] = None
    a2a_capacity_factor: Optional[float] = None
    normalize: bool = True
    shm_slot_bytes: int = 1 << 16
    adaptive: bool = False
    remote_workers: Optional[Sequence] = None
    net_credit: int = 32
    transport: Any = None
    fuse: bool = True
    overlap: bool = True
    microbatch: Optional[int] = None
    inflight: Optional[int] = None


@dataclasses.dataclass
class CostEstimate:
    """Per-node cost, in host-seconds per item plus declared work terms.

    ``releases_gil`` is the GIL-sensitivity signal: ``True`` when the node's
    work runs concurrently under CPython threads, ``False`` when it
    serializes on the GIL (the process tier's reason to exist), ``None``
    when undeclared and unmeasured."""

    t_task: float = DEFAULT_T_TASK_S
    flops: float = 0.0
    bytes: float = 0.0
    source: str = "default"  # default | declared | given | observed |
    #                           measured | derived
    releases_gil: Optional[bool] = None

    def host_time(self, width: int = 1) -> float:
        """Per-item service time on a ``width``-worker *thread* farm.  A
        GIL-bound task gains nothing from extra threads."""
        if self.releases_gil is False:
            return self.t_task
        return self.t_task / max(1, width)

    def process_time(self, width: int = 1, hop_s: float = 2e-4) -> float:
        """Per-item service time on a ``width``-worker *process* farm: true
        parallelism, floored by the shared-memory lane hop."""
        return max(self.t_task / max(1, width), hop_s)

    def remote_time(self, width: int = 1, hop_s: float = 5e-4) -> float:
        """Per-item service time on a ``width``-worker *remote* farm: true
        parallelism across hosts, floored by the network-lane hop."""
        return self.process_time(width, hop_s)

    def device_time(self, n_chips: int = 1,
                    dispatch_s: float = DEVICE_DISPATCH_S) -> Optional[float]:
        """Roofline per-item time on the card (H100), or None when no work
        terms are declared (an unmeasurable node never wins a device
        slot)."""
        if self.flops <= 0:
            return None
        terms = pm.roofline(self.flops, self.bytes, 0.0, max(1, n_chips))
        return terms.step_time_s + dispatch_s


@dataclasses.dataclass
class Placement:
    """Where one top-level stage runs.  ``width`` is the farm worker count
    (threads, processes, or the device count); ``reason`` records the
    cost-model comparison for reports/tests."""

    target: str = "host"    # "host" | "host_process" | "host_remote" |
    #                         "device"
    width: Optional[int] = None
    reason: str = ""


def _as_placement(v: Any) -> Placement:
    if isinstance(v, Placement):
        if v.target not in _TARGETS:
            raise GraphError(f"Placement target must be one of {_TARGETS} "
                             f"(got {v.target!r})")
        return v
    if v in _TARGETS:
        return Placement(target=v, reason="override")
    raise GraphError(f"placement override must be one of {_TARGETS} or a "
                     f"Placement (got {v!r})")


# ---------------------------------------------------------------------------
# Stage 2: annotate
# ---------------------------------------------------------------------------
def _measure(fn: Callable, sample: Any, repeat: int = 3) -> float:
    best = float("inf")
    for _ in range(repeat):
        t0 = time.perf_counter()
        fn(sample)
        best = min(best, time.perf_counter() - t0)
    return max(best, 1e-9)


def _probe_gil_release(fn: Callable, sample: Any,
                       solo: float) -> Optional[bool]:
    """Does ``fn`` run concurrently under CPython threads?  Time it under
    two concurrent threads: a GIL-bound task's per-call time stays ~solo
    (the threads serialize), a GIL-releasing one drops toward solo/2.
    Returns None when the task is too fast (noise) or too slow (probe cost)
    to measure."""
    import threading
    if solo < 1e-4 or solo > 0.25 or (os.cpu_count() or 1) < 2:
        return None
    k = max(2, min(16, int(2e-3 / solo) + 1))

    def loop() -> None:
        for _ in range(k):
            fn(sample)

    threads = [threading.Thread(target=loop) for _ in range(2)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    per_call = (time.perf_counter() - t0) / (2 * k)
    return per_call < 0.75 * solo


def _estimate(key: Any, costs: Dict, sample: Any) -> CostEstimate:
    """Cost for one worker object: explicit ``costs=`` entry > declared
    ``ff_cost``/``ff_flops`` attributes > the observed-cost table
    (``perf_model.observe``) > timing on ``sample`` > default.  The GIL
    signal comes from a declared ``ff_releases_gil`` attribute, the observed
    table, or — when the node was timed on a sample anyway — from the
    two-thread concurrency probe."""
    if key is not None:
        rg = getattr(key, "ff_releases_gil", None)
        if rg is not None:
            rg = bool(rg)
        try:
            given = costs.get(key)
        except TypeError:           # unhashable worker object
            given = None
        if given is not None:
            if isinstance(given, CostEstimate):
                return given
            return CostEstimate(t_task=float(given), source="given",
                                releases_gil=rg)
        fl = float(getattr(key, "ff_flops", 0.0) or 0.0)
        by = float(getattr(key, "ff_bytes", 0.0) or 0.0)
        t = getattr(key, "ff_cost", None)
        if t is not None:
            return CostEstimate(float(t), fl, by, "declared",
                                releases_gil=rg)
        if fl > 0.0:
            peak = pm.get_calibration(measure=False).peak_flops
            return CostEstimate(fl / peak, fl, by, "declared",
                                releases_gil=rg)
        if callable(key):
            # runtime history beats a fresh sample probe: the adaptive
            # supervisor's perf_model.observe() feeds measured service
            # times + GIL signals back per callable, so re-compiling a
            # previously-run worker needs no sample= at all
            obs = pm.lookup_observed(pm.fn_key(key))
            if obs is not None:
                org = rg if rg is not None else obs.get("releases_gil")
                return CostEstimate(float(obs["t_task"]), source="observed",
                                    releases_gil=org)
        if sample is not None and callable(key):
            try:
                solo = _measure(key, sample)
                if rg is None:
                    rg = _probe_gil_release(key, sample, solo)
                return CostEstimate(solo, source="measured", releases_gil=rg)
            except Exception:       # noqa: BLE001 - sample may not fit the fn
                pass
        if rg is not None:
            return CostEstimate(source="default", releases_gil=rg)
    return CostEstimate()


def annotate(graph: FFGraph, costs: Optional[Dict] = None,
             sample: Any = None) -> FFGraph:
    """Attach a :class:`CostEstimate` to every IR node (in place).

    Leaf costs come from :func:`_estimate`; composites follow the paper's
    algebra — a pipeline worker's per-item time is the sum of its stages, a
    farm node carries its *worker's* per-item time (the farm service time is
    width-dependent and belongs to ``place``)."""
    costs = costs or {}
    memo: Dict[int, CostEstimate] = {}    # replicated workers share one fn

    def merge_gil(subs: List[CostEstimate]) -> Optional[bool]:
        gs = [c.releases_gil for c in subs]
        if any(g is False for g in gs):
            return False
        if gs and all(g is True for g in gs):
            return True
        return None

    def est(key: Any, smp: Any) -> CostEstimate:
        k = id(key)
        if k not in memo:
            memo[k] = _estimate(key, costs, smp)
        return memo[k]

    def visit(n: Any) -> CostEstimate:
        if isinstance(n, SeqG):
            n.cost = est(n.node, sample if n.pure else None)
        elif isinstance(n, PipeG):
            subs = [visit(s) for s in n.stages]
            n.cost = CostEstimate(t_task=sum(c.t_task for c in subs),
                                  flops=sum(c.flops for c in subs),
                                  bytes=sum(c.bytes for c in subs),
                                  source="derived",
                                  releases_gil=merge_gil(subs))
        elif isinstance(n, FarmG):
            subs = [visit(w) for w in n.workers]
            key = n.fn if n.fn is not None else None
            c = est(key, sample) if key is not None else subs[0]
            if c.source == "default" and subs[0].source != "default":
                c = subs[0]
            for part in (n.emitter, n.collector):
                if part is not None:
                    visit(part)
            n.cost = c
        elif isinstance(n, A2AG):
            ls = [visit(x) for x in n.left]
            rs = [visit(x) for x in n.right]
            n.cost = CostEstimate(
                t_task=(sum(c.t_task for c in ls) / len(ls)
                        + sum(c.t_task for c in rs) / len(rs)),
                flops=sum(c.flops for c in (*ls, *rs)),
                bytes=sum(c.bytes for c in (*ls, *rs)),
                source="derived", releases_gil=merge_gil([*ls, *rs]))
        elif isinstance(n, MapG):
            for x in (n.splitter, *n.workers, n.composer):
                visit(x)
            n.cost = CostEstimate(source="default")
        else:
            return CostEstimate()
        return n.cost

    visit(graph.root)
    return graph


# ---------------------------------------------------------------------------
# Stage 3: place
# ---------------------------------------------------------------------------
def _top_stages(graph: FFGraph) -> List[Any]:
    return list(graph.root.stages) if isinstance(graph.root, PipeG) \
        else [graph.root]


def _device_eligible(n: Any) -> bool:
    """Can this stage lower onto the device at all?"""
    if isinstance(n, A2AG):
        return all(_is_pure_seq(x) for x in (*n.left, *n.right))
    try:
        _device_fn(n)
        return True
    except GraphError:
        return False


def _process_ineligible_reason(n: Any) -> Optional[str]:
    """Why this stage cannot run on the process tier (None when it can).

    The process tier ships each worker's ``svc`` callable to a child once at
    startup, so it needs pure (stateless-callable) workers: a farm with
    pure-or-absent emitter/collector and the default round-robin schedule
    (``autoscale`` is fine — the process farm carries its own AutoscaleLB
    over the shm lanes), or an ``all_to_all`` whose left/right workers and
    router all pickle."""
    if isinstance(n, A2AG):
        fns = [_pure_of(x) for x in (*n.left, *n.right)]
        if any(f is None for f in fns):
            return "a2a workers must be pure callables to ship to a process"
        if not all(fn_picklable(f) for f in fns):
            return "a2a worker callable is not picklable for process startup"
        if n.router is not None and not fn_picklable(n.router):
            return "a2a router is not picklable for process startup"
        return None
    if not isinstance(n, FarmG):
        return "only farm and all_to_all stages process-lower"
    if n.lb is not None or n.ondemand is not None:
        return "custom lb/ondemand schedules are thread-tier only"
    fns = [n.fn] if n.fn is not None else [_pure_of(w) for w in n.workers]
    if any(f is None for f in fns):
        return "stateful workers cannot ship to a worker process"
    for part in (n.emitter, n.collector):
        if part is not None and _pure_of(part) is None:
            return "process farm needs pure emitter/collector"
    if not all(fn_picklable(f) for f in fns):
        return "worker callable is not picklable for process startup"
    return None


def _net_picklable(fn: Callable) -> bool:
    # the remote tier ships the callable over TCP (tag FN), so it must
    # pickle *by value or importable reference* for real — the fork-based
    # leniency of fn_picklable() does not cross a host boundary
    try:
        pickle.dumps(fn)
        return True
    except Exception:   # noqa: BLE001 - closures, lambdas, local defs
        return False


def _remote_ineligible_reason(n: Any,
                              pool: Optional[Sequence]) -> Optional[str]:
    """Why this stage cannot run on the remote tier (None when it can).

    The remote tier ships each worker's ``svc`` callable over a network lane
    (tag ``FN``) to a worker pool from ``compile(remote_workers=[...])``, so
    beyond the process tier's purity requirements the callable must
    genuinely pickle (fork cannot carry a closure across hosts) and a pool
    must exist to connect to.  Farms only — the a2a grid stays on-box."""
    if not isinstance(n, FarmG):
        return "only farm stages remote-lower"
    if not pool:
        return "no remote worker pool (pass compile(remote_workers=[...]))"
    if n.lb is not None or n.ondemand is not None:
        return "custom lb/ondemand schedules are thread-tier only"
    fns = [n.fn] if n.fn is not None else [_pure_of(w) for w in n.workers]
    if any(f is None for f in fns):
        return "stateful workers cannot ship to a remote worker"
    for part in (n.emitter, n.collector):
        if part is not None and _pure_of(part) is None:
            return "remote farm needs pure emitter/collector"
    if not all(_net_picklable(f) for f in fns):
        return "worker callable does not pickle for the network handshake"
    return None


def _mesh_axis_size(plan: Any, axis: str) -> int:
    return int(dict(plan.mesh.shape).get(axis, 1))


def _spans_ranks(plan: Any, axis: str) -> bool:
    """The plan's mesh has ranks behind more than one position of
    ``axis``: each rank runs the graph, and the device segments span
    them."""
    return plan is not None and getattr(plan.mesh, "live", False) \
        and _mesh_axis_size(plan, axis) > 1


def _ordered_farm(s: Any) -> Any:
    """A host farm stage as a sequence-ordered
    :class:`~repro_torch.core.skeletons.ThreadFarmNode`: over ranks every
    rank's device segment must stack the same items in the same order, and
    the thread farm's collector delivers in arrival order, which differs
    between ranks.  Other stages as they are."""
    if not isinstance(s, FarmG):
        return s
    if s.lb is not None or s.ondemand is not None:
        raise GraphError("over ranks a host farm must deliver in sequence "
                         "order: custom lb/ondemand schedules cannot")
    width = max(1, getattr(s.placement, "width", None) or len(s.workers))
    fns = [s.fn] * width if s.fn is not None else \
        [_pure_of(w) for w in s.workers]
    parts = [_pure_of(x) if x is not None else None
             for x in (s.emitter, s.collector)]
    if any(f is None for f in fns) or any(
            x is not None and f is None
            for x, f in zip((s.emitter, s.collector), parts)):
        raise GraphError("over ranks a host farm must deliver in sequence "
                         "order: its workers, emitter and collector must be "
                         "pure functions")
    return SeqG(ThreadFarmNode(fns, pre=parts[0], post=parts[1],
                               label=f"ordered_farm[{width}]"))


def _boundary_batch(graph: FFGraph, plan: Any, axis: str,
                    device_batch: Optional[int],
                    microbatch: Optional[int]) -> int:
    """Items one device microbatch stacks, as :func:`emit` sizes it: one
    in a feedback loop, else 8 per card on ``axis``; ``microbatch``
    overrides both."""
    if microbatch is not None:
        return max(1, int(microbatch))
    if device_batch is not None:
        return max(1, int(device_batch))
    if graph._wrap:
        return 1
    return 8 * (_mesh_axis_size(plan, axis) if plan is not None else 1)


def device_item_time(c: CostEstimate, calib: Any, run: int, n_chips: int,
                     batch: int) -> Optional[float]:
    """Per-item cost :func:`place` charges a device stage inside a fused
    run of ``run`` stages behind the overlapped boundary, or None when the
    stage declares no work.  The boundary dispatches a microbatch of
    ``batch`` items at once, each stage of the eager segment launching
    once, so ``device_dispatch_s / run + fused_segment_s`` is spread over
    the microbatch; the item's bytes cross the boundary once a fused run,
    each way; the overlapped boundary pays ``max(transfer, compute)`` and
    the unhidden remainder (``calib.boundary_time``)."""
    run = max(1, run)
    dispatch = (calib.device_dispatch_s / run + calib.fused_segment_s) \
        / max(1, batch)
    dev_t = c.device_time(n_chips, dispatch)
    if dev_t is None:
        return None
    xfer = (c.bytes / run) * (1.0 / (calib.h2d_bw_gbs * 1e9)
                              + 1.0 / (calib.d2h_bw_gbs * 1e9)) \
        if c.bytes > 0 else 0.0
    return calib.boundary_time(xfer, dev_t)


def place(graph: FFGraph, plan: Any = None, overrides: Optional[Dict] = None,
          axis: str = "data", feedback_steps: Optional[int] = None,
          feedback_cond: Optional[Callable] = None, mode: str = "auto",
          remote_pool: Optional[Sequence] = None,
          device_batch: Optional[int] = None,
          microbatch: Optional[int] = None) -> FFGraph:
    """Assign each top-level stage a :class:`Placement` (in place).

    A stage goes to the *device* when it can lower there, a plan was given,
    and the roofline estimate beats the best host service time; a farm (or
    ``all_to_all``) of GIL-bound workers goes to the *process* tier when
    true parallelism over the calibrated shared-memory hop beats
    GIL-serialized threads, or a farm to the *remote* tier
    (``host_remote``) when a worker pool (``remote_pool``, the compile
    call's ``remote_workers=``) is wide enough that parallelism over the
    calibrated network hop beats both; everything else runs on host
    *threads*.  Widths come from
    :func:`~repro_torch.core.perf_model.choose_farm_width` over the
    calibrated channel costs.  ``overrides`` maps a stage index or worker
    object to a :class:`Placement` (or ``"host"``/``"host_process"``/
    ``"host_remote"``/``"device"``).  A ``wrap_around`` graph places on the
    device only as a whole and only when ``feedback_steps`` or
    ``feedback_cond`` bounds the loop.  ``device_batch``/``microbatch``
    (as :func:`emit` takes them) give the items a device microbatch
    stacks, over which a device candidate's per-microbatch boundary costs
    are spread (:func:`device_item_time`)."""
    overrides = overrides or {}
    stages = _top_stages(graph)
    n_cpu = max(1, os.cpu_count() or 1)
    n_chips = _mesh_axis_size(plan, axis) if plan is not None else 1

    # calibrated channel constants: the (one-time, disk-cached) measurement
    # only triggers when a decision could use the process or remote tier —
    # a stage must be eligible for one AND measurably GIL-bound (the tiers
    # are unreachable on an unknown signal); otherwise the cached-or-default
    # lookup suffices
    def _gil_bound(s: Any) -> bool:
        c = s.cost
        return isinstance(c, CostEstimate) and c.releases_gil is False

    need_measure = mode in ("process", "remote") or (
        mode == "auto" and not graph._wrap
        and any((_process_ineligible_reason(s) is None
                 or _remote_ineligible_reason(s, remote_pool) is None)
                and _gil_bound(s) for s in stages))
    calib = pm.get_calibration(measure=need_measure)
    n_pool = len(remote_pool) if remote_pool else 0
    batch = _boundary_batch(graph, plan, axis, device_batch, microbatch)

    def override_for(i: int, s: Any) -> Optional[Placement]:
        # keys are stage indices or the hashable user objects a stage wraps
        # (IR dataclasses themselves are mutable and unhashable)
        for key in (i, getattr(s, "node", None), getattr(s, "fn", None)):
            if key is None:
                continue
            try:
                if key in overrides:
                    return _as_placement(overrides[key])
            except TypeError:
                continue
        return None

    # a feedback graph runs its loop through one target: device only when
    # the whole graph lowers there and the loop is bounded
    wrap_device_ok = (graph._wrap and plan is not None
                      and (feedback_steps is not None
                           or feedback_cond is not None)
                      and not any(isinstance(s, A2AG) for s in stages)
                      and all(_device_eligible(s) for s in stages))

    # fused-run lengths: adjacent device stages share ONE boundary, so a
    # stage inside a candidate run of length L pays device_dispatch_s / L
    # plus the fused_segment_s marginal, each once a microbatch
    def _device_candidate(i: int, s: Any) -> bool:
        ov = override_for(i, s)
        if ov is not None:
            return ov.target == "device"
        if plan is None or graph._wrap or mode not in ("auto", "device"):
            return False
        if isinstance(s, FarmG) and s.autoscale:
            return False
        c = s.cost if isinstance(s.cost, CostEstimate) else CostEstimate()
        return _device_eligible(s) and c.flops > 0

    run_len = [1] * len(stages)
    i = 0
    while i < len(stages):
        if _device_candidate(i, stages[i]):
            j = i
            while j < len(stages) and _device_candidate(j, stages[j]):
                j += 1
            for k in range(i, j):
                run_len[k] = j - i
            i = j
        else:
            i += 1

    for i, s in enumerate(stages):
        ov = override_for(i, s)
        c = s.cost if isinstance(s.cost, CostEstimate) else CostEstimate()
        proc_reason = _process_ineligible_reason(s)
        if isinstance(s, FarmG) and not s.autoscale:
            t_emit = getattr(getattr(s.emitter, "cost", None), "t_task", 0.0)
            t_coll = getattr(getattr(s.collector, "cost", None), "t_task", 0.0)
            host_width = (len(s.workers) if not s.n_auto else
                          pm.choose_farm_width(c.t_task, n_cpu,
                                               t_emit=t_emit,
                                               t_collect=t_coll,
                                               overhead=calib.queue_hop_s))
            proc_width = (len(s.workers) if not s.n_auto else
                          pm.choose_farm_width(
                              c.t_task, n_cpu, t_emit=t_emit,
                              t_collect=t_coll,
                              overhead=calib.proc_hop_effective_s()))
        elif isinstance(s, FarmG):
            host_width = len(s.workers) if not s.n_auto else n_cpu
            proc_width = host_width
        elif isinstance(s, A2AG):
            # both sides' widths are fixed by the graph; "width" reports the
            # total worker-process count of the stage
            host_width = 1
            proc_width = len(s.left) + len(s.right)
        else:
            host_width = 1
            proc_width = 1
        remote_reason = _remote_ineligible_reason(s, remote_pool)
        # a replicated farm spreads over the whole pool; a fixed worker
        # list caps at its own width (one pool address per callable)
        remote_width = 0 if not isinstance(s, FarmG) else (
            n_pool if (s.n_auto or s.fn is not None)
            else min(len(s.workers), n_pool))
        if ov is not None:
            if ov.target == "host_process" and proc_reason is not None:
                raise GraphError(f"stage {i} ({s.describe()}) cannot be "
                                 f"process-placed: {proc_reason}")
            if ov.target == "host_remote" and remote_reason is not None:
                raise GraphError(f"stage {i} ({s.describe()}) cannot be "
                                 f"remote-placed: {remote_reason}")
            if ov.width is None:
                w = {"device": n_chips, "host_process": proc_width,
                     "host_remote": remote_width,
                     "host": host_width}[ov.target]
                ov = dataclasses.replace(ov, width=w)
            s.placement = ov
            continue
        if mode == "host":
            s.placement = Placement("host", host_width, "forced host")
            continue
        if mode == "process":
            if proc_reason is None:
                s.placement = Placement("host_process", proc_width,
                                        "forced process")
            else:
                s.placement = Placement("host", host_width,
                                        f"forced process, but {proc_reason}")
            continue
        if mode == "remote":
            if remote_reason is None:
                s.placement = Placement("host_remote", remote_width,
                                        "forced remote")
            else:
                s.placement = Placement("host", host_width,
                                        f"forced remote, but {remote_reason}")
            continue
        if mode == "device":
            s.placement = Placement("device", n_chips, "forced device")
            continue
        if graph._wrap:
            target = "device" if wrap_device_ok else "host"
            s.placement = Placement(
                target, n_chips if target == "device" else host_width,
                "feedback loop lowers as one unit")
            continue
        # -- cost-driven three-way decision --------------------------------
        # autoscale is a host-runtime request (grow/shrink the active worker
        # set from observed lane depth): a device farm has no lanes to
        # observe, so autoscale drops the device candidate but keeps the
        # thread-vs-process comparison
        autoscale = isinstance(s, FarmG) and s.autoscale
        host_t = max(c.host_time(host_width), calib.queue_hop_s)
        dev_t = (device_item_time(c, calib, run_len[i], n_chips, batch)
                 if plan is not None and not autoscale
                 and _device_eligible(s) else None)
        # the process tier only pays off for demonstrably GIL-bound work
        # wide enough to parallelize (an unknown signal stays on threads),
        # and only past a hysteresis margin over the thread estimate — a
        # candidate inside the margin drops out entirely rather than
        # vetoing the host/device comparison
        proc_t = None
        if proc_reason is None and c.releases_gil is False \
                and proc_width >= 2:
            if isinstance(s, A2AG):
                # the two sides pipeline across the shm grid: service time
                # is the slower side over its width, floored by the hops
                nL, nR = len(s.left), len(s.right)
                t_l = sum(getattr(x.cost, "t_task", DEFAULT_T_TASK_S)
                          for x in s.left) / nL
                t_r = sum(getattr(x.cost, "t_task", DEFAULT_T_TASK_S)
                          for x in s.right) / nR
                # the farm/a2a lanes are batched (push_many/pop_many), so
                # the amortized hop is the honest per-item price here
                t = pm.a2a_service_time(t_l, t_r, nL, nR,
                                        calib.proc_hop_effective_s())
            else:
                t = c.process_time(proc_width, calib.proc_hop_effective_s())
            if t < 0.8 * host_t:
                proc_t = t
        # the remote tier competes on the same terms: GIL-bound work wide
        # enough to amortize the (much larger) network hop, past the same
        # hysteresis margin — and it must also beat the on-box process tier
        remote_t = None
        if remote_reason is None and c.releases_gil is False \
                and remote_width >= 2:
            t = c.remote_time(remote_width, calib.net_hop_s)
            if t < 0.8 * host_t and (proc_t is None or t < proc_t):
                remote_t = t
        candidates = {"host": host_t}
        if dev_t is not None:
            candidates["device"] = dev_t
        if proc_t is not None:
            candidates["host_process"] = proc_t
        if remote_t is not None:
            candidates["host_remote"] = remote_t
        target = min(candidates, key=candidates.get)
        if target == "device":
            s.placement = Placement(
                "device", n_chips,
                f"roofline {dev_t*1e6:.1f}us < host {host_t*1e6:.1f}us"
                + (f" (dispatch amortized over fused run of {run_len[i]})"
                   if run_len[i] > 1 else ""))
        elif target == "host_remote":
            s.placement = Placement(
                "host_remote", remote_width,
                ("autoscale on the remote tier: " if autoscale else "")
                + f"GIL-bound: {remote_width} remote workers "
                f"{remote_t*1e6:.1f}us < threads {host_t*1e6:.1f}us "
                f"(calibrated net hop {calib.net_hop_s*1e6:.1f}us, "
                f"{calib.source})")
        elif target == "host_process":
            s.placement = Placement(
                "host_process", proc_width,
                ("autoscale on the process tier: " if autoscale else "")
                + f"GIL-bound: {proc_width} processes {proc_t*1e6:.1f}us < "
                f"threads {host_t*1e6:.1f}us "
                f"(calibrated hop {calib.proc_hop_effective_s()*1e6:.1f}us, "
                f"{calib.source})")
        else:
            host_reason = "autoscale requested (host runtime)" \
                if autoscale else ("stateful/host-only"
                    if plan is not None and not _device_eligible(s) else (
                        "no declared FLOPs"
                        if dev_t is None and plan is not None
                        else ("no plan" if plan is None else
                              f"host {host_t*1e6:.1f}us <= roofline "
                              f"{dev_t*1e6:.1f}us")))
            s.placement = Placement("host", host_width, host_reason)
    return graph


# ---------------------------------------------------------------------------
# Stage 4: emit
# ---------------------------------------------------------------------------
def make_device_batched(graph: FFGraph, plan: Any, axis: str = "data",
                        feedback_steps: Optional[int] = None,
                        feedback_cond: Optional[Callable] = None,
                        a2a_capacity_factor: Optional[float] = None,
                        ) -> Tuple[Callable, int]:
    """Build the batch-level device function for a graph (or subgraph).

    Returns ``(batched(xs, offset), axis_multiple)``: ``xs`` is the stacked
    batch (a pytree of tensors on the device), ``offset`` the absolute
    stream index of its first item (position matters to ``all_to_all``
    routing parity with the host feeder), and the batch length must be a
    multiple of ``axis_multiple`` (1 on one device).

    Per-item stage functions are batched with ``torch.func.vmap``.
    ``a2a_capacity_factor`` bounds the all_to_all expert lanes via
    ``expert_capacity`` (over-capacity items are dropped); the default
    ``None`` is lossless, at the price of nR-fold redundant expert
    compute."""
    from . import device as dev

    if plan is None:
        raise GraphError("device lowering needs a plan (compile mode/override "
                         "asked for the device with plan=None)")
    mesh_axis = _mesh_axis_size(plan, axis)
    if mesh_axis > 1 and not getattr(plan.mesh, "live", False):
        raise GraphError(
            f"the plan's {axis!r} axis has {mesh_axis} positions but no ranks"
            " behind them: a device segment over a mesh runs one process per"
            " rank (core.spmd.launch), never on one rank")
    vmap = torch.func.vmap

    if graph._wrap:
        if feedback_steps is None and feedback_cond is None:
            raise GraphError(
                "device feedback needs a bound: pass feedback_steps=K "
                "(lowers through core.device.feedback_scan) or "
                "feedback_cond=pred (lowers through "
                "core.device.feedback_while) to compile(), or use the host "
                "path")
        fn, uses_farm = _device_fn(graph.root)
        step = vmap(fn)

        if feedback_cond is not None:
            # data-dependent turn count: each lane freezes once its own
            # cond goes false, feedback_steps an optional hard cap
            cond = vmap(feedback_cond)

            def run(xs):
                final, _ = dev.feedback_while(
                    lambda s: (step(s), None), xs, cond,
                    max_steps=feedback_steps)
                return final
        else:
            def run(xs):
                final, _ = dev.feedback_scan(lambda s: (step(s), None), xs,
                                             feedback_steps, collect=False)
                return final

        if uses_farm:
            inner = dev.farm_map(run, plan.mesh, axis=axis)
            return (lambda xs, offset: inner(xs)), mesh_axis
        return (lambda xs, offset: run(xs)), 1

    stages = _top_stages(graph)
    parts: List[Tuple[str, Callable]] = []    # ("map", f(xs)) | ("a2a", f(xs, t))
    mult = 1
    seg: List[Any] = []

    def close_seg() -> None:
        nonlocal mult
        if not seg:
            return
        sub = seg[0] if len(seg) == 1 else PipeG(list(seg))
        fn, uses_farm = _device_fn(sub)
        if uses_farm:
            parts.append(("map", dev.farm_map(vmap(fn), plan.mesh,
                                              axis=axis)))
            mult = max(mult, mesh_axis)
        else:
            parts.append(("map", vmap(fn)))
        seg.clear()

    for s in stages:
        if isinstance(s, A2AG):
            if not all(_is_pure_seq(x) for x in (*s.left, *s.right)):
                raise GraphError("device all_to_all lowering needs pure "
                                 "(callable) left/right workers")
            close_seg()
            parts.append(("a2a", dev.a2a_dispatch(
                [x.node for x in s.left], [x.node for x in s.right],
                router=s.router,
                mesh=plan.mesh if mesh_axis > 1 else None, axis=axis,
                capacity_factor=a2a_capacity_factor)))
            mult = max(mult, mesh_axis)
        else:
            seg.append(s)
    close_seg()

    def batched(xs, offset):
        # items may be pytrees (e.g. dict batches); a2a stages need tensors
        leaf = tree_leaves(xs)[0]
        t_idx = offset + torch.arange(leaf.shape[0], dtype=torch.int32,
                                      device=leaf.device)
        for kind, f in parts:
            xs = f(xs) if kind == "map" else f(xs, t_idx)
        return xs

    return batched, mult


class _DeviceStageNode(FFNode):
    """The device boundary node: one host pipeline stage that stacks a
    microbatch, copies it to the device, runs the fused segment, and streams
    the unstacked results downstream.  The SPSC queues around it are
    FastFlow's bounded lanes — the device never waits on the host unless
    the host truly falls behind.

    With ``overlap`` (the default) the boundary is *software-pipelined*
    through a depth-K in-flight window, the double-buffered SPSC hand-off
    of the 2009 TR applied to the most expensive hop in the system: the copy
    in runs on a side stream, the segment's kernels are queued behind it on
    the compute stream, the copy out into pinned host buffers is queued on
    another side stream behind the kernels — and nothing waits until *K-1*
    newer microbatches have been dispatched behind this one.  Retirement is
    FIFO, so exact input order is preserved; the bytes are identical to the
    synchronous boundary because the same computation sees the same inputs
    — only the synchronization point moves.  ``inflight=1`` (or
    ``overlap=False``) is the strictly synchronous copy -> compute -> copy
    path, and so is every boundary on the CPU.  The node runs on its own
    host thread and makes its device that thread's current device.

    Over a plan whose mesh has ranks (``axis_mult`` > 1, one process per
    rank, each running the same graph on the whole stream) every rank's
    node stacks the same microbatch; the segment's ``farm_map`` and
    ``a2a_dispatch`` lowerings hand each rank its block and assemble the
    whole output on every rank, so each rank's node emits the whole stream
    in order.  A partial microbatch is padded to a multiple of
    ``axis_mult`` by repeating its first item, as the reference pads it,
    and the pad is dropped on retirement."""

    def __init__(self, batched: Callable, axis_mult: int, device_batch: int,
                 plan: Any, label: str = "device",
                 jit_key: Optional[tuple] = None, overlap: bool = True,
                 inflight: int = 2):
        super().__init__()
        from .fuse import jit_segment
        # through the segment cache: re-compile() of the same graph reuses
        # the segment instead of building a fresh closure
        self._batched = jit_segment(batched, jit_key)
        self._mult = max(1, axis_mult)
        self._B = max(int(device_batch), self._mult)
        self._device = plan.device
        self._label = label
        self._buf: List[Any] = []
        self._off = 0
        self._flushes = 0
        self._inflight = max(1, int(inflight)) if overlap else 1
        self._window = collections.deque()   # FIFO of (n, landing) in flight
        self._streams: Tuple[Any, Any] = (None, None)
        self._abandoned = False
        # boundary accounting (cumulative seconds; under _stats_lock):
        # host-side submit (stack + copy in + queueing the segment), copy-out
        # wait (compute remainder + d2h), and the share of that wait paid
        # while the window was full
        self._t_submit = 0.0
        self._t_drain = 0.0
        self._t_stall = 0.0
        self._retired = 0

    def svc_init(self) -> int:
        if self._device.type == "cuda":
            torch.cuda.set_device(self._device)
        return 0

    def svc(self, item: Any) -> Any:
        if self._abandoned:
            return GO_ON            # shutdown: drop instead of dispatching
        self._buf.append(item)
        if len(self._buf) >= self._B:
            self._dispatch()
        return GO_ON

    def svc_end(self) -> None:
        try:
            if self._buf and not self._abandoned:
                self._dispatch()    # the final partial microbatch
            while self._window:     # drain the in-flight window, in order
                self._retire(*self._window.popleft())
        except BaseException as e:   # noqa: BLE001
            # svc_end runs outside the svc try-block: record the error
            # ourselves and never leave submitted work unawaited
            if self.error is None:
                self.error = e
            self._window.clear()
            self._buf = []
            raise

    def abandon(self) -> None:
        """Shutdown path (:meth:`HybridRunner.shutdown`): drop the partial
        buffer and stop emitting.  The node's own thread still *retires*
        every in-flight microbatch in ``svc_end`` but discards the results
        instead of pushing them at a consumer that is gone."""
        self._abandoned = True
        self._buf = []

    def _copy_streams(self) -> Tuple[Any, Any]:
        if self._streams[0] is None and self._inflight > 1:
            self._streams = _copy_streams(self._device, self._inflight)
        return self._streams if self._inflight > 1 else (None, None)

    def _dispatch(self) -> None:
        t0 = time.perf_counter()
        items, self._buf = self._buf, []
        n = len(items)
        items = items + items[:1] * ((-n) % self._mult)
        h2d, d2h = self._copy_streams()
        xs = _to_device(items, self._device, h2d)
        landing = _Landing(self._batched(xs, self._off), d2h)
        self._off += n
        self._flushes += 1
        with self._stats_lock:
            self._t_submit += time.perf_counter() - t0
        if self._inflight <= 1:
            # the synchronous boundary (overlap off): await in place
            self._retire(n, landing)
            return
        self._window.append((n, landing))
        while len(self._window) > self._inflight:
            t1 = time.perf_counter()
            self._retire(*self._window.popleft())
            with self._stats_lock:
                self._t_stall += time.perf_counter() - t1

    def _retire(self, n: int, landing: _Landing) -> None:
        t0 = time.perf_counter()
        # ONE device->host copy per output leaf, then numpy slicing
        host = landing.wait()
        with self._stats_lock:
            self._t_drain += time.perf_counter() - t0
            self._retired += n
        if self._abandoned:
            return
        for i in range(n):
            self.ff_send_out(tree_map(lambda t: t[i], host))

    def set_window(self, inflight: Optional[int] = None,
                   microbatch: Optional[int] = None) -> None:
        """Live boundary retune.  Both take effect at the next dispatch on
        the node's own thread: growing the window lets more microbatches
        ride in flight, shrinking it retires eagerly until the window fits
        again."""
        if microbatch is not None:
            self._B = max(int(microbatch), self._mult)
        if inflight is not None:
            self._inflight = max(1, int(inflight))

    def make_handle(self, desc: Optional[str] = None) -> "DeviceBoundaryHandle":
        return DeviceBoundaryHandle(desc or f"device[{self._label}]", self)

    def node_stats(self) -> dict:
        s = super().node_stats()
        s["node"] = f"device[{self._label}]"
        s["backend"] = "device"
        s["flushes"] = self._flushes
        with self._stats_lock:
            drain = self._t_drain
            s["boundary"] = {
                "mode": "overlapped" if self._inflight > 1 else "sync",
                "microbatch": self._B, "inflight": self._inflight,
                "window": len(self._window), "retired": self._retired,
                "submit_s": round(self._t_submit, 6),
                "drain_s": round(drain, 6),
                "stall_s": round(self._t_stall, 6),
                "stall_frac": round(self._t_stall / drain, 4) if drain > 0
                else 0.0,
            }
        return s


class DeviceBoundaryHandle(StageHandle):
    """:class:`~repro_torch.core.graph.StageHandle` over a
    :class:`_DeviceStageNode`: read-only stats (including the ``boundary``
    block — submit/drain/stall split) plus the in-flight window retune
    surface (``set_window``) the Supervisor's boundary policy drives.  Not
    ``reconfigurable`` — the boundary has no tier to migrate or farm width
    to resize; ``boundary_tunable`` is its own capability flag."""

    boundary_tunable = True

    def __init__(self, desc: str, node: _DeviceStageNode):
        super().__init__(desc, node, tier="device")
        self._node = node

    def stats(self) -> dict:
        return self._node.node_stats()

    def set_window(self, inflight: Optional[int] = None,
                   microbatch: Optional[int] = None) -> None:
        self._node.set_window(inflight=inflight, microbatch=microbatch)


class HybridRunner(HostRunner):
    """A mixed-placement graph: host stages over SPSC queues feeding device
    segments through :class:`_DeviceStageNode` boundary nodes (and
    possibly process farms through
    :class:`~repro_torch.core.process.ProcessFarmNode`).  Same surface as :class:`HostRunner`; ``placements`` records the
    compiler's per-stage decisions."""

    def shutdown(self, timeout: float = 10.0) -> None:
        """Best-effort unwind of a mid-stream hybrid runner: abandon every
        device boundary FIRST — their ``svc`` drops instead of dispatching
        and their ``svc_end`` still awaits (then discards) every in-flight
        microbatch, so dispatched device work is drained rather than leaked
        and the boundary thread can never wedge pushing results at a
        results queue nobody reads — then run the normal host unwind (EOS
        feed + join)."""
        for st in self._top_members():
            if isinstance(st, _DeviceStageNode):
                st.abandon()
        super().shutdown(timeout)


class ProcessRunner(HostRunner):
    """A host network whose process-placed farm stages run their workers as
    OS processes over the shared-memory SPSC rings of ``core/shm.py`` — the
    multicore-true host tier.  Same surface as :class:`HostRunner`; thread
    stages and process farms share one streaming network."""


class RemoteRunner(HostRunner):
    """A host network whose remote-placed farm stages run their workers on
    other hosts over the TCP network lanes of ``core/net.py`` — the
    distributed tier.  Same surface as :class:`HostRunner`; thread stages,
    process farms, and remote farms share one streaming network."""


def _lower_remote_stage(s: Any, p: Placement,
                        remote_pool: Optional[Sequence],
                        credit: int = 32) -> SeqG:
    """Replace a remote-placed farm with its boundary node
    (:class:`~repro_torch.core.net.RemoteFarmNode`): to the rest of the
    (thread-tier) network it is one ordinary host stage whose workers
    happen to answer over TCP."""
    reason = _remote_ineligible_reason(s, remote_pool)
    if reason is not None:
        raise GraphError(f"cannot remote-lower {s.describe()}: {reason}")
    n_pool = len(remote_pool)
    width = max(1, min(p.width or n_pool, n_pool))
    fns = [s.fn] * width if s.fn is not None \
        else [_pure_of(w) for w in s.workers][:width]
    pre = _pure_of(s.emitter) if s.emitter is not None else None
    post = _pure_of(s.collector) if s.collector is not None else None
    node = RemoteFarmNode(
        fns, list(remote_pool)[:len(fns)], pre=pre, post=post,
        credit=credit, autoscale=s.autoscale,
        label=f"remote_farm[{len(fns)}]"
        + ("@autoscale" if s.autoscale else ""))
    return SeqG(node)


def _lower_process_stage(s: Any, p: Placement, capacity: int,
                         transport: Any) -> SeqG:
    """Replace a process-placed farm or all_to_all with its boundary node:
    to the rest of the (thread-tier) network it is one ordinary host
    stage.  ``transport`` (a :class:`~repro_torch.core.shm.TransportConfig`)
    caps the ring depths (``ring_slots`` per farm lane, ``grid_slots`` per
    a2a grid segment — the grid is nL x nR eagerly allocated, so shallower)
    and sizes the slots and the slab arena."""
    reason = _process_ineligible_reason(s)
    if reason is not None:
        raise GraphError(f"cannot process-lower {s.describe()}: {reason}")
    if isinstance(s, A2AG):
        lfns = [_pure_of(x) for x in s.left]
        rfns = [_pure_of(x) for x in s.right]
        node = ProcessA2ANode(
            lfns, rfns, router=s.router,
            capacity=capacity, transport=transport,
            label=f"process_a2a[{len(lfns)}x{len(rfns)}]")
        return SeqG(node)
    width = max(1, p.width or len(s.workers))
    fns = [s.fn] * width if s.fn is not None \
        else [_pure_of(w) for w in s.workers]
    pre = _pure_of(s.emitter) if s.emitter is not None else None
    post = _pure_of(s.collector) if s.collector is not None else None
    node = ProcessFarmNode(
        fns, pre=pre, post=post,
        capacity=capacity, transport=transport,
        autoscale=s.autoscale,
        label=f"process_farm[{len(fns)}]"
        + ("@autoscale" if s.autoscale else ""))
    return SeqG(node)


def _maybe_adaptive_node(s: Any, p: Placement, capacity: int,
                         slot_bytes: int,
                         transport: Any = None) -> Optional[Any]:
    """``compile(adaptive=True)``: lower an eligible farm stage to an
    :class:`~repro_torch.core.runtime.AdaptiveFarmNode` — one host boundary
    node whose engine (thread farm / process farm) the runtime supervisor
    can resize and migrate live.  Eligible = a farm built from one
    replicated pure worker with pure-or-absent emitter/collector and the
    default schedule (the same shape ``autoscale`` requires); anything else
    returns None and lowers exactly as without ``adaptive``.

    Note the semantics opt-in: an adaptive farm's collector is
    sequence-ordered on BOTH tiers (output order == input order, matching
    the process/device lowerings and making migration order-safe), which is
    stricter than the plain thread farm's arrival order."""
    if not isinstance(s, FarmG) or p.target in ("device", "host_remote"):
        return None
    if s.fn is None or s.lb is not None or s.ondemand is not None:
        return None
    for part in (s.emitter, s.collector):
        if part is not None and _pure_of(part) is None:
            return None
    can_proc = _process_ineligible_reason(s) is None
    width = max(1, p.width or len(s.workers))
    return AdaptiveFarmNode(
        s.fn, width,
        pre=_pure_of(s.emitter) if s.emitter is not None else None,
        post=_pure_of(s.collector) if s.collector is not None else None,
        tier=("host_process" if (p.target == "host_process" and can_proc)
              else "host"),
        # SHALLOW engine lanes on purpose: a migration drains whatever is
        # already inside the engine on the OLD tier, so bounding in-flight
        # work keeps the drain (and reconfig latency) cheap — the rest of
        # the backlog waits in the node's input queue, which survives the
        # swap.  A few items per lane is all throughput needs.
        capacity=max(2, min(capacity, 8)), slot_bytes=slot_bytes,
        transport=transport,
        label=f"adaptive_farm[{width}]", can_process=can_proc)


def _materialize_widths(n: Any) -> None:
    """Host-side auto farms get their cost-chosen width before building."""
    if isinstance(n, PipeG):
        for s in n.stages:
            _materialize_widths(s)
    elif isinstance(n, FarmG):
        if (n.n_auto and not n.autoscale and n.fn is not None
                and getattr(n.placement, "width", None)):
            n.workers = [SeqG(n.fn, pure=True)
                         for _ in range(max(1, n.placement.width))]
        for w in n.workers:
            _materialize_widths(w)


def emit(graph: FFGraph, plan: Any = None, *, capacity: int = 512,
         results_capacity: int = 4096, axis: str = "data",
         feedback_steps: Optional[int] = None,
         feedback_cond: Optional[Callable] = None,
         device_batch: Optional[int] = None,
         a2a_capacity_factor: Optional[float] = None,
         shm_slot_bytes: int = 1 << 16, adaptive: bool = False,
         remote_workers: Optional[Sequence] = None, net_credit: int = 32,
         transport: Any = None, fuse: bool = True, overlap: bool = True,
         microbatch: Optional[int] = None,
         inflight: Optional[int] = None) -> Any:
    """Build the runner for a placed graph (stage 4).

    Device placements go through the :mod:`~repro_torch.core.fuse` pass
    first: every maximal run of adjacent device-placed stages lowers as ONE
    segment behind a single :class:`_DeviceStageNode` boundary (hybrid
    graphs) or as a single :class:`~repro_torch.core.graph.DeviceRunner`
    part (all-device graphs).  ``fuse=False`` lowers one segment per device
    stage.  ``overlap``/``microbatch``/``inflight`` shape the boundary those
    segments run behind; see :class:`CompileConfig`.

    ``adaptive=True`` lowers eligible farms first, into
    :class:`~repro_torch.core.runtime.AdaptiveFarmNode` stages (see
    :func:`_maybe_adaptive_node`).  Remote-placed farms lower next, into
    :class:`~repro_torch.core.net.RemoteFarmNode` stages over
    ``remote_workers`` with a ``net_credit``-deep window per lane; then
    process-placed stages, into boundary nodes that the rest of emit sees
    as host stages.  ``transport`` (a
    :class:`~repro_torch.core.shm.TransportConfig`, or a dict of its fields)
    tunes every shared-memory lane they build: ``ring_slots`` (farm-lane
    depth cap, default 64), ``grid_slots`` (a2a grid-segment depth cap,
    default 32), ``slot_bytes`` (fixed slot payload, default 64 KiB),
    ``arena_bytes`` (slab arena for oversize ndarrays, default 4 MiB),
    ``bounded`` (False grows uSPSC segment chains instead of
    back-pressuring), and ``batch``/``flush_s`` (vectored-lane flush
    policy).  When omitted, ``shm_slot_bytes`` sizes the slots and
    everything else takes the defaults."""
    from .shm import TransportConfig, as_transport
    tc = (as_transport(transport) if transport is not None
          else TransportConfig(slot_bytes=shm_slot_bytes))
    stages = _top_stages(graph)
    placements = [s.placement if isinstance(s.placement, Placement)
                  else Placement("host") for s in stages]
    report = list(zip([s.describe() for s in stages], placements))

    # adaptive mode lowers eligible farms FIRST, into AdaptiveFarmNode
    # boundary stages that carry their own (re-placeable) tier engine; the
    # rest of emit sees them as plain host stages
    adaptive_proc = False
    if adaptive:
        lowered = []
        for i, (s, p) in enumerate(zip(stages, placements)):
            node = _maybe_adaptive_node(s, p, capacity, tc.slot_bytes,
                                        transport=tc)
            if node is None:
                lowered.append(s)
                continue
            lowered.append(SeqG(node))
            adaptive_proc = adaptive_proc or node.tier == "host_process"
            reason = (p.reason + "; adaptive").lstrip("; ")
            report[i] = (report[i][0], dataclasses.replace(p, reason=reason))
            placements[i] = dataclasses.replace(p, target="host")
        g2 = FFGraph(lowered[0] if len(lowered) == 1 else PipeG(lowered))
        g2._wrap = graph._wrap
        graph, stages = g2, lowered

    # remote-placed farms lower next, into RemoteFarmNode boundary stages
    # (workers on other hosts over TCP lanes): from here on the rest of
    # emit sees them as host stages
    has_remote = any(p.target == "host_remote" for p in placements)
    if has_remote:
        lowered = [(_lower_remote_stage(s, p, remote_workers, net_credit)
                    if p.target == "host_remote" else s)
                   for s, p in zip(stages, placements)]
        g2 = FFGraph(lowered[0] if len(lowered) == 1 else PipeG(lowered))
        g2._wrap = graph._wrap
        graph, stages = g2, lowered
        placements = [dataclasses.replace(p, target="host")
                      if p.target == "host_remote" else p
                      for p in placements]

    # process-placed farms and a2a stages lower next, into
    # ProcessFarmNode / ProcessA2ANode boundary stages: from here on the
    # rest of emit sees them as host stages, which is what lets thread ->
    # process -> device -> remote programs compose freely
    has_process = any(p.target == "host_process" for p in placements)
    if has_process:
        lowered = [(_lower_process_stage(s, p, capacity, tc)
                    if p.target == "host_process" else s)
                   for s, p in zip(stages, placements)]
        g2 = FFGraph(lowered[0] if len(lowered) == 1 else PipeG(lowered))
        g2._wrap = graph._wrap
        graph, stages = g2, lowered
        placements = [dataclasses.replace(p, target="host")
                      if p.target == "host_process" else p
                      for p in placements]
    targets = {p.target for p in placements}

    if targets == {"device"}:
        runner = DeviceRunner(graph, plan, axis=axis,
                              feedback_steps=feedback_steps,
                              feedback_cond=feedback_cond,
                              a2a_capacity_factor=a2a_capacity_factor,
                              fuse=fuse, overlap=overlap,
                              microbatch=microbatch, inflight=inflight)
    elif targets == {"host"}:
        _materialize_widths(graph.root)
        cls = RemoteRunner if has_remote else (
            ProcessRunner if (has_process or adaptive_proc) else HostRunner)
        runner = cls(graph, capacity=capacity,
                     results_capacity=results_capacity,
                     feedback_cond=feedback_cond)
    else:
        # in a feedback loop items circulate one at a time: a buffering
        # boundary node would starve the loop waiting for a full microbatch
        # — and an in-flight window holding results back would deadlock it
        # outright, so wrap graphs force the sync boundary
        device_batch = _boundary_batch(graph, plan, axis, device_batch,
                                       microbatch)
        if graph._wrap:
            overlap = False
        if inflight is None:
            rec = pm.lookup_autotuned("device_overlap:window")
            inflight = int(rec.get("inflight", 2)) if rec else 2
        new_stages: List[Any] = []
        ranked = 0                   # segments that span the mesh's ranks
        ordered = _spans_ranks(plan, axis)
        for entry, p in fuse_device_segments(stages, placements,
                                             enable=fuse):
            if not isinstance(entry, FusedSegment):
                new_stages.append(_ordered_farm(entry) if ordered
                                  else entry)
                continue
            sub = entry.subgraph()
            batched, mult = make_device_batched(
                sub, plan, axis=axis,
                a2a_capacity_factor=a2a_capacity_factor)
            if mult > 1:
                ranked += 1
            if ranked > 1:
                raise GraphError(
                    "over ranks a graph holds one device segment that spans"
                    " the mesh: two boundary threads would issue their "
                    "collectives in orders that differ between ranks")
            new_stages.append(SeqG(
                _DeviceStageNode(batched, mult, device_batch, plan,
                                 label=entry.describe(),
                                 jit_key=segment_key(
                                     sub, device_batch, mult, plan, axis,
                                     a2a_capacity_factor),
                                 overlap=overlap, inflight=inflight)))
        _materialize_widths(PipeG(new_stages))
        hg = FFGraph(new_stages[0] if len(new_stages) == 1
                     else PipeG(new_stages))
        hg._wrap = graph._wrap
        runner = HybridRunner(hg, capacity=capacity,
                              results_capacity=results_capacity,
                              feedback_cond=feedback_cond)
    runner.placements = report
    return runner


# ---------------------------------------------------------------------------
# The pipeline driver
# ---------------------------------------------------------------------------
def compile_graph(graph: FFGraph, plan: Any = None, *,
                  config: Optional[CompileConfig] = None,
                  **kwargs: Any) -> Any:
    """Run the staged pipeline: normalize -> annotate -> place -> emit.

    ``compile_graph(g, config=c)`` is the canonical call; the flat spelling
    ``compile_graph(g, plan, mode=..., capacity=...)`` folds the kwargs into
    a config (unknown names raise ``TypeError``).  Stage-index keys in
    ``placements=`` refer to the *normalized* graph's top-level stages;
    worker objects survive the rewrites and are the stabler key.

    ``remote_workers=["host:port", ...]`` (or ``(host, port)`` tuples)
    names a pool of :func:`~repro_torch.core.net.worker_main` worker pools
    and unlocks the ``host_remote`` target: ``place`` costs eligible farms
    against the calibrated network hop (``mode="remote"`` forces it), and
    ``emit`` lowers them to :class:`~repro_torch.core.net.RemoteFarmNode`
    boundary stages with a ``net_credit``-deep in-flight window per lane.
    A pool that cannot be reached fails the compile with its address."""
    if config is not None:
        if plan is not None or kwargs:
            raise GraphError("compile_graph(config=...) does not combine "
                             "with a positional plan or extra kwargs — put "
                             "everything on the CompileConfig")
        cfg = config
    else:
        try:
            cfg = CompileConfig(plan=plan, **kwargs)
        except TypeError as e:
            raise TypeError(f"compile_graph(): {e}; see CompileConfig for "
                            "the supported knobs") from None
    if cfg.mode not in ("auto", "host", "process", "remote", "device"):
        raise GraphError(f"unknown compile mode {cfg.mode!r}")
    if cfg.mode == "device" and cfg.plan is None:
        raise GraphError("compile(mode=\"device\") needs a plan "
                         "(core.plan.single_device_plan())")
    if cfg.mode == "remote" and not cfg.remote_workers:
        raise GraphError("compile(mode=\"remote\") needs remote_workers="
                         "[\"host:port\", ...]")
    g = graph.optimize() if cfg.normalize else graph
    # forced modes still need costs for width selection (n="auto" farms),
    # so annotate runs whenever the caller supplied cost information
    if cfg.mode == "auto" or cfg.costs or cfg.sample is not None:
        annotate(g, costs=cfg.costs, sample=cfg.sample)
    place(g, cfg.plan, overrides=cfg.placements, axis=cfg.axis,
          feedback_steps=cfg.feedback_steps,
          feedback_cond=cfg.feedback_cond, mode=cfg.mode,
          remote_pool=cfg.remote_workers, device_batch=cfg.device_batch,
          microbatch=cfg.microbatch)
    return emit(g, cfg.plan, capacity=cfg.capacity,
                results_capacity=cfg.results_capacity, axis=cfg.axis,
                feedback_steps=cfg.feedback_steps,
                feedback_cond=cfg.feedback_cond,
                device_batch=cfg.device_batch,
                a2a_capacity_factor=cfg.a2a_capacity_factor,
                shm_slot_bytes=cfg.shm_slot_bytes, adaptive=cfg.adaptive,
                remote_workers=cfg.remote_workers,
                net_credit=cfg.net_credit, transport=cfg.transport,
                fuse=cfg.fuse, overlap=cfg.overlap,
                microbatch=cfg.microbatch, inflight=cfg.inflight)
