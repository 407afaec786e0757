"""The port's adaptive runtime against the reference's, on the CPU.

Twins of ``tests/test_runtime.py``: ``compile(adaptive=True)`` emits
``AdaptiveFarmNode`` stages that give the static path's output, a live
migration in each direction keeps the exact input order past the engine
lanes' capacity, a crash during the drain surfaces as ``WorkerCrashed``,
the Supervisor's width policy grows and shrinks a live farm and its
migration policy moves a GIL-bound farm to processes, and
``perf_model.observe`` shifts the next compile's placement.

Where a decision can be compared it is held to the reference's: the port's
``Supervisor`` and the reference's are fed the same scripted stats through
a fake stage handle built on each package's own ``StageHandle``, with the
clock of each runtime module replaced, and must make the same calls and
record the same events step for step; both packages' ``observe`` must
build the same table from the same stats.  No throughput bar: the
reference's GIL-flip test is the suite's known flake under xdist.  Each
forking test keeps to at most 3 worker processes."""

import os
import signal
import threading
import time
import types

import numpy as np
import pytest
import torch

import repro.core as J
import repro.core.graph as jgraph
import repro.core.perf_model as jpm
import repro.core.runtime as jrt
import repro_torch.core as T
import repro_torch.core.graph as tgraph
import repro_torch.core.perf_model as pm
import repro_torch.core.runtime as rt
from repro_torch.core.compiler import _top_stages, annotate, place

torch.set_num_threads(1)

pytestmark = pytest.mark.runtime

TIMEOUT = 60.0            # seconds any one run may take before it fails

# the constants both packages' policies read, set alike in both
CALIB = dict(peak_flops=5e10, queue_hop_s=2e-5, proc_hop_s=1e-4,
             device_dispatch_s=2e-5, shm_batched_hop_s=5e-5)


@pytest.fixture(autouse=True)
def _isolated_cache(tmp_path, monkeypatch):
    """A private cache directory for both packages: what a Supervisor
    observes must not leak into other tests' placements."""
    monkeypatch.setenv("REPRO_FF_CACHE", str(tmp_path))
    monkeypatch.delenv("REPRO_FF_CALIB_CACHE", raising=False)
    for m in (pm, jpm):
        m.reset_calibration()
        m.reset_observed()
    yield
    for m in (pm, jpm):
        m.reset_calibration()
        m.reset_observed()


def _same_calibration(monkeypatch):
    for m in (pm, jpm):
        monkeypatch.setattr(m, "_calibration",
                            m.HostCalibration(**CALIB, source="cached"))


class Gen(T.FFNode):
    def __init__(self, n):
        super().__init__()
        self.i, self.n = 0, n

    def svc(self, _):
        self.i += 1
        return float(self.i) if self.i <= self.n else None


def _double(x):
    return x * 2.0


def _sleepy(x):
    time.sleep(0.002)
    return x + 1.0


def _gil_bound(x):
    """Pure-Python arithmetic: holds the GIL for ~1-3 ms an item."""
    s = 0.0
    for i in range(30000):
        s += (x * i) % 7.3
    return x * 2.0


def _observed_worker(x):
    return x


def _collect(r, got: list, done: threading.Event) -> None:
    while True:
        ok, item = r.load_result(timeout=TIMEOUT)
        if not ok:
            break
        got.append(item)
    done.set()


def _feed(r, xs) -> None:
    for x in xs:
        r.offload(x)
    r.offload(T.EOS)


# ---------------------------------------------------------------------------
# the Supervisor's decisions, held to the reference's step for step
# ---------------------------------------------------------------------------
def _fake_handle(base, case: dict):
    """A stage handle over the case's scripted stats, on ``base`` (one
    package's StageHandle), recording every call the Supervisor makes."""

    class Fake(base):
        reconfigurable = case.get("reconfigurable", False)
        slo_controllable = case.get("slo", False)
        boundary_tunable = case.get("boundary", False)

        def __init__(self):
            super().__init__("stage", tier=case.get("tier", "host"))
            self.max_width = 4
            self.calls = []
            self.step = 0

        def stats(self):
            s = dict(case["script"][self.step])
            if self.reconfigurable:
                s["tier"] = self._tier
            return s

        def can_migrate(self, target):
            return self.reconfigurable

        def resize(self, width):
            self.calls.append(("resize", width))
            return True

        def migrate(self, target):
            self.calls.append(("migrate", target))
            if case.get("fail_migrate"):
                raise RuntimeError("drain hit a crashed worker")
            moved, self._tier = target != self._tier, target
            return moved

        def set_pressure(self, level, policy=None):
            self.calls.append(("set_pressure", level,
                               policy.degrade_at, policy.shed_at))

        def set_window(self, inflight=None, microbatch=None):
            self.calls.append(("set_window", inflight, microbatch))

    return Fake()


def _drive(runtime, base, case: dict, monkeypatch):
    h = _fake_handle(base, case)
    clock = [1000.0]
    monkeypatch.setattr(runtime, "time", types.SimpleNamespace(
        monotonic=lambda: clock[0], perf_counter=time.perf_counter,
        time=time.time))
    sup = runtime.Supervisor(
        types.SimpleNamespace(stage_handles=lambda: [h]), observe=False,
        **case.get("knobs", {}))
    for i in range(len(case["script"])):
        h.step = i
        sup._tick()
        clock[0] += case["dt"]
    stats = sup.stats()
    return (h.calls, [(e.stage, e.kind, e.detail) for e in sup.events],
            (stats["samples"], stats["ticks"], stats["events"]))


def _lanes(active, depth, delivered, **kw):
    return dict(active=active, delivered=delivered,
                lane_depths=[depth] * active + [0] * (4 - active), **kw)


SUPERVISOR_CASES = {
    # mean lane depth above hi grows, below lo shrinks, within the width
    "width": dict(reconfigurable=True, dt=0.1, knobs={"migrate": False},
                  script=[_lanes(2, 5, 0), _lanes(3, 3, 10), _lanes(4, 0, 20),
                          _lanes(3, 1, 30), _lanes(1, 0, 40),
                          _lanes(4, 9, 50), _lanes(2, 0.1, 60)]),
    # GIL-serialized threads -> processes (granted the full width), then,
    # past the cooldown, cheap process workers -> threads
    "migration": dict(reconfigurable=True, dt=0.5, knobs={"resize": False},
                      script=[
                          _lanes(2, 2, 0, svc_cpu_ema_s=2e-3, gil_ratio=0.4),
                          _lanes(2, 2, 20, svc_cpu_ema_s=2e-3, gil_ratio=0.4),
                          _lanes(4, 2, 40, svc_cpu_ema_s=2e-3),
                          _lanes(4, 2, 60, svc_cpu_ema_s=1e-5),
                          _lanes(2, 2, 80, svc_cpu_ema_s=1e-5,
                                 gil_ratio=0.95),
                          _lanes(2, 2, 100, svc_cpu_ema_s=1e-5,
                                 gil_ratio=0.95)]),
    # a process farm with no worker CPU record yet whose items cost less
    # than hop_factor shm hops a worker goes back to threads
    "hop_dominated": dict(reconfigurable=True, tier="host_process", dt=0.5,
                          knobs={"resize": False},
                          script=[_lanes(2, 1, 0, hop_ema_s=1e-2),
                                  _lanes(2, 1, 1000, hop_ema_s=1e-2),
                                  _lanes(2, 1, 2000, hop_ema_s=1e-2)]),
    # a failed migration is recorded and stands the stage down
    "migration_failure": dict(reconfigurable=True, dt=0.5, fail_migrate=True,
                              knobs={"resize": False},
                              script=[_lanes(2, 2, 20 * i, svc_cpu_ema_s=2e-3,
                                             gil_ratio=0.4)
                                      for i in range(6)]),
    # backlog/capacity -> degrade, shed, restore
    "slo": dict(slo=True, dt=0.1,
                script=[{"slo": {"backlog": b, "capacity": 8}}
                        for b in (0, 4, 5, 8, 9, 3, 3, 0)]),
    # the boundary's stall share over a window: grow above 0.5, shrink
    # below 0.05, nothing in the dead band, nothing on a thin window or a
    # synchronous boundary
    "boundary": dict(boundary=True, dt=0.5, script=[
        {"boundary": dict(mode="overlapped", retired=r, stall_s=s,
                          drain_s=d, inflight=k)}
        for r, s, d, k in ((0, 0.0, 0.0, 2), (10, 0.6, 1.0, 2),
                           (20, 0.6, 1.5, 3), (30, 0.7, 2.5, 3),
                           (40, 0.7, 3.5, 3), (50, 0.7, 4.5, 2),
                           (52, 0.7, 5.5, 2), (70, 1.7, 6.5, 2))]
        + [{"boundary": dict(mode="sync", retired=90, stall_s=9.0,
                             drain_s=9.5, inflight=1)}]),
}


@pytest.mark.parametrize("name", sorted(SUPERVISOR_CASES))
def test_supervisor_makes_the_references_calls(name, monkeypatch):
    case = SUPERVISOR_CASES[name]
    _same_calibration(monkeypatch)
    want = _drive(jrt, jgraph.StageHandle, case, monkeypatch)
    got = _drive(rt, tgraph.StageHandle, case, monkeypatch)
    assert got == want
    calls, events = got[0], got[1]
    kinds = [e[1] for e in events]
    assert calls, "the script must make the policy act"
    if name == "width":
        assert kinds == ["grow", "grow", "shrink", "shrink"]
    elif name == "migration":
        assert calls == [("migrate", "host_process"), ("resize", 4),
                         ("migrate", "host")]
    elif name == "migration_failure":
        assert kinds == ["migrate"] and "failed" in events[0][2]
        assert calls == [("migrate", "host_process")]   # stood down after
    elif name == "slo":
        assert kinds == ["degrade", "shed", "restore"]
    elif name == "boundary":
        assert [c[1] for c in calls] == [3, 2, 3]


# ---------------------------------------------------------------------------
# perf_model.observe: the same table from the same stats
# ---------------------------------------------------------------------------
OBSERVED_TREE = {"backend": "HybridRunner", "graph": {"stages": [
    {"node": "a", "backend": "thread", "fn_key": "m.f", "items": 64,
     "svc_cpu_ema_s": 4e-3, "gil_ratio": 0.5, "active": 2},
    {"node": "b", "backend": "process", "fn_key": "m.g", "items": 32,
     "svc_cpu_ema_s": 1e-3, "hop_ema_s": 9e-4},
    [{"backend": "thread", "fn_key": "m.h", "items": 16,
      "svc_cpu_ema_s": 2e-4, "gil_ratio": 0.95, "active": 3}],
    {"backend": "thread", "fn_key": "m.thin", "items": 2,
     "svc_cpu_ema_s": 1e-3},
    {"backend": "process", "items": 64},
    {"backend": "device", "items": 64, "svc_time_ema_s": 1e-3},
    {"backend": "thread", "fn_key": "m.f", "items": 80,
     "svc_cpu_ema_s": 2e-3, "gil_ratio": 0.8, "active": 1}]}}


def test_observe_builds_the_references_table(monkeypatch):
    _same_calibration(monkeypatch)
    keys = ("m.f", "m.g", "m.h", "m.thin")
    tables = []
    for m in (jpm, pm):
        absorbed = [m.observe(OBSERVED_TREE), m.observe(OBSERVED_TREE,
                                                        write=True)]
        c = m.get_calibration(measure=False)
        m.reset_observed()          # the second fold persisted the table
        tables.append((absorbed, [m.lookup_observed(k) for k in keys],
                       c.proc_hop_s, c.source))
    assert tables[1] == tables[0]
    absorbed, recs, hop, source = tables[1]
    assert absorbed == [5, 5] and recs[3] is None
    assert recs[0]["releases_gil"] is False and recs[2]["releases_gil"]
    assert source == "observed" and CALIB["proc_hop_s"] < hop < 9e-4


def test_observe_ignores_thin_or_foreign_records():
    assert pm.observe({"stages": [
        {"backend": "thread", "fn_key": "x.y", "items": 2,
         "svc_cpu_ema_s": 1e-3},                  # too few items
        {"backend": "process", "items": 64},      # no hop measured
        {"unrelated": True},
    ]}) == 0


def test_calibrate_keeps_the_observed_table():
    key = pm.fn_key(_observed_worker)
    pm.observe({"stages": [{"backend": "thread", "fn_key": key,
                            "items": 64, "svc_cpu_ema_s": 4e-3}]},
               write=True)
    assert pm.calibrate(cache=True).source == "measured"
    pm.reset_observed()
    pm.reset_calibration()
    assert pm.lookup_observed(key)["t_task"] == 4e-3
    assert pm.get_calibration(measure=False).source == "cached"


def test_record_autotuned_persists_beside_the_observed_table(monkeypatch):
    """``record_autotuned`` merges and writes as the reference's does, and
    the one cache file keeps both tables."""
    _same_calibration(monkeypatch)
    key = pm.fn_key(_observed_worker)
    entries = {"device_overlap:window": {"inflight": 3}, "bad": 7}
    for m in (jpm, pm):
        m.observe({"stages": [{"backend": "thread", "fn_key": key,
                               "items": 64, "svc_cpu_ema_s": 4e-3}]})
        assert m.record_autotuned(entries) == 1
        m.reset_autotuned()
        m.reset_observed()
        assert m.lookup_autotuned("device_overlap:window") == \
            {"inflight": 3}
        assert m.lookup_observed(key)["t_task"] == 4e-3
    assert pm.record_autotuned({}) == 0


def test_observe_shifts_subsequent_placement(monkeypatch):
    _same_calibration(monkeypatch)

    def farm_stage(core, annotate_, place_, top):
        class Source(core.FFNode):       # a stateful head, as Gen
            def svc(self, _):
                return None

        g = core.pipeline(Source(),
                          core.farm(_observed_worker, n=4)).optimize()
        annotate_(g)
        place_(g)
        return top(g)[1]

    from repro.core.compiler import _top_stages as jtop, annotate as jann, \
        place as jplace
    before = farm_stage(T, annotate, place, _top_stages)
    assert (before.placement.target, before.cost.source) == ("host",
                                                             "default")
    # a runtime observation: 4 ms an item of CPU, GIL-serialized
    for m in (jpm, pm):
        assert m.observe({"stages": [{
            "backend": "thread", "fn_key": m.fn_key(_observed_worker),
            "items": 64, "delivered": 64, "svc_cpu_ema_s": 4e-3,
            "svc_wall_ema_s": 8e-3, "gil_ratio": 0.5, "active": 2}]},
            write=True) == 1
    # the next compile reads the history: same graph, no costs= or
    # sample=, and the reference's placement
    got = farm_stage(T, annotate, place, _top_stages)
    want = farm_stage(J, jann, jplace, jtop)
    assert (got.cost.source, got.cost.releases_gil) == ("observed", False)
    assert got.cost.t_task == want.cost.t_task == 4e-3
    assert (got.placement.target, got.placement.width) == \
        (want.placement.target, want.placement.width)
    assert got.placement.target == "host_process"


# ---------------------------------------------------------------------------
# adaptive=True on live runners
# ---------------------------------------------------------------------------
def test_supervisor_disabled_is_static_behavior():
    def build():
        return T.pipeline(Gen(64), T.farm(_double, n=2))

    r_static = build().compile(config=T.CompileConfig(mode="host"))
    out_static = r_static.run(timeout=TIMEOUT)
    assert not any(getattr(st, "ff_adaptive", False)
                   for st in r_static._top_members())
    assert all(not h.reconfigurable for h in r_static.stage_handles())
    r_adaptive = build().compile(config=T.CompileConfig(mode="host",
                                                        adaptive=True))
    assert any(isinstance(st, T.AdaptiveFarmNode)
               for st in r_adaptive._top_members())
    farm_p = [p for d, p in r_adaptive.placements if "farm" in d][0]
    assert "adaptive" in farm_p.reason
    out_adaptive = r_adaptive.run(timeout=TIMEOUT)
    # the adaptive farm's collector is sequence-ordered
    assert out_adaptive == sorted(out_static) == \
        [2.0 * i for i in range(1, 65)]
    assert r_adaptive.replacement_events() == []


def test_non_reconfigurable_handle_refuses():
    r = T.pipeline(Gen(4), T.farm(_double, n=2)).compile(
        config=T.CompileConfig(mode="host"))
    h = r.stage_handles()[1]
    with pytest.raises(T.GraphError):
        h.resize(2)
    with pytest.raises(T.GraphError):
        h.migrate("host_process")
    r.run(timeout=TIMEOUT)


@pytest.mark.shm
def test_migration_preserves_order_beyond_ring_capacity():
    """host -> host_process and back mid-stream: 400 items through
    engine lanes at most 8 deep, exact input order on both swaps."""
    n = 400

    def work(x):
        time.sleep(0.001)            # keeps the stream alive across swaps
        return x * 2.0

    r = T.farm(work, n=2).compile(config=T.CompileConfig(
        mode="host", adaptive=True, capacity=16))
    r.run_then_freeze()
    h = r.stage_handles()[0]
    got, done = [], threading.Event()
    threading.Thread(target=_collect, args=(r, got, done),
                     daemon=True).start()
    threading.Thread(target=_feed, args=(r, [float(i) for i in range(n)]),
                     daemon=True).start()
    time.sleep(0.02)
    assert h.migrate("host_process") is True       # mid-stream swap out ...
    assert h.tier == "host_process"
    time.sleep(0.05)
    h.migrate("host")                              # ... and back
    assert done.wait(2 * TIMEOUT)
    assert r.wait(30.0) == 0
    assert got == [2.0 * i for i in range(n)]
    kinds = [(e.kind, e.detail) for e in r.replacement_events()]
    assert kinds[0] == ("migrate", "host -> host_process")


@pytest.mark.shm
def test_worker_crash_during_drain_swap_surfaces_error():
    r = T.farm(_sleepy, n=2).compile(config=T.CompileConfig(
        mode="process", adaptive=True))
    assert isinstance(r, T.ProcessRunner)
    r.run_then_freeze()
    h = r.stage_handles()[0]
    assert h.tier == "host_process"
    for i in range(4):
        r.offload(float(i))
    time.sleep(0.3)
    for p in h.node._engine._procs:                # crash both workers
        os.kill(p.pid, signal.SIGKILL)
    with pytest.raises(T.WorkerCrashed):
        h.migrate("host")                          # the drain hits it
    # the runner unwinds instead of wedging, and the error is kept
    assert r.wait(30.0) == -1
    assert isinstance(r.error(), T.WorkerCrashed)


def test_supervisor_resizes_active_workers_from_lane_depth():
    r = T.farm(_sleepy, n=2).compile(config=T.CompileConfig(
        mode="host", adaptive=True))
    r.run_then_freeze()
    sup = T.Supervisor(r, interval=0.01, migrate=False).start()
    got, done = [], threading.Event()
    threading.Thread(target=_collect, args=(r, got, done),
                     daemon=True).start()
    # trickle: the lanes stay empty -> the supervisor retires a worker
    for i in range(12):
        r.offload(float(i))
        time.sleep(0.02)
    deadline = time.monotonic() + 10.0
    while not any(e.kind == "shrink" for e in sup.events) \
            and time.monotonic() < deadline:
        time.sleep(0.01)
    # burst: deep lanes -> the supervisor reactivates it (0.6 s of work
    # for one worker: many sampling intervals, even on a loaded host)
    n = 300
    for i in range(12, n):
        r.offload(float(i))
    r.offload(T.EOS)
    assert done.wait(TIMEOUT)
    assert r.wait(30.0) == 0
    sup.stop()
    sup.stop()                                     # idempotent
    kinds = {e.kind for e in sup.events}
    assert {"shrink", "grow"} <= kinds, [str(e) for e in sup.events]
    assert got == [i + 1.0 for i in range(n)]      # sequence-ordered


@pytest.mark.shm
def test_supervisor_migrates_a_gil_bound_farm_to_processes():
    """The migration policy live: two threads convoy on the GIL, the
    Supervisor moves the farm to two processes mid-stream, the output keeps
    the input order and the observed cost lands in the table."""
    n = 300
    r = T.farm(_gil_bound, n=2).compile(config=T.CompileConfig(
        mode="host", adaptive=True))
    r.run_then_freeze()
    sup = T.Supervisor(r, interval=0.02, resize=False).start()
    got, done = [], threading.Event()
    threading.Thread(target=_collect, args=(r, got, done),
                     daemon=True).start()
    _feed(r, [float(i) for i in range(n)])
    assert done.wait(2 * TIMEOUT)
    assert r.wait(30.0) == 0
    sup.stop()
    migrations = [e for e in sup.events if e.kind == "migrate"]
    assert migrations and "-> host_process: GIL-serialized" in \
        migrations[0].detail, [str(e) for e in sup.events]
    assert got == [2.0 * i for i in range(n)]
    assert sup.stats()["loop_time_s"] > 0.0
    assert pm.lookup_observed(pm.fn_key(_gil_bound)) is not None


def test_stats_consistent_midstream():
    r = T.pipeline(Gen(300), T.farm(_sleepy, n=2)).compile(
        config=T.CompileConfig(mode="host", adaptive=True))
    errors, stop = [], threading.Event()

    def hammer():
        handles = r.stage_handles()
        while not stop.is_set():
            try:
                for h in handles:
                    s = h.stats()
                    if "delivered" in s:
                        assert s["delivered"] <= s["items"]
                r.stats()
            except Exception as e:       # noqa: BLE001
                errors.append(e)
                return

    t = threading.Thread(target=hammer, daemon=True)
    t.start()
    out = r.run(timeout=2 * TIMEOUT)
    stop.set()
    t.join(10.0)
    assert not t.is_alive() and not errors
    assert out == [i + 1.0 for i in range(1, 301)]


def test_adaptive_farm_feeds_the_device_boundary_in_order():
    """The shape chip_smoke.py drives on the card: an adaptive farm of
    numpy workers in front of a device segment (here on the CPU), under a
    Supervisor, in stream order (a static thread farm's collector is
    arrival-ordered: the same items as a multiset)."""
    from repro_torch.core.plan import single_device_plan
    xs = [np.full(4, i, np.float32) for i in range(64)]

    def build():
        return T.pipeline(T.farm(np.negative, n=2),
                          T.seq(lambda x: x * 3.0, pure=True))

    cfg = dict(plan=single_device_plan("cpu"),
               placements={0: "host", 1: "device"}, microbatch=8,
               inflight=2, normalize=False)
    static = build().compile(config=T.CompileConfig(**cfg)).run(
        xs, timeout=TIMEOUT)
    want = [np.negative(x) * 3.0 for x in xs]
    assert sorted(g.tobytes() for g in static) == \
        sorted(w.tobytes() for w in want)
    r = build().compile(config=T.CompileConfig(adaptive=True, **cfg))
    assert isinstance(r, T.HybridRunner)
    assert [h.tier for h in r.stage_handles()][0] == "host"
    sup = rt.Supervisor(r, interval=0.01).start()
    got = r.run(xs, timeout=TIMEOUT)
    sup.stop()
    assert [g.tobytes() for g in got] == [w.tobytes() for w in want]
