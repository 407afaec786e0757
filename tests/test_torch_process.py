"""The port's process tier against the reference's, on the CPU.

``repro_torch.core.shm`` and ``repro_torch.core.process`` are copies of the
reference's modules: a ring written by one package is read by the other,
and the graphs of ``tests/test_process_runner.py`` and
``tests/test_process_a2a.py`` give the same results through the port's
thread, process and device (``device="cpu"``) runners as through the
reference's process runner.  The data pipeline's process-placed compute
farm (``compute_workers > 1``) delivers the batches that one compute stage
and the reference's pipeline deliver, and the ``--tuned`` preset computes
its environment.  Each forking test keeps to at most 3 workers and a short
stream, and bounds every wait with a timeout of its own.
"""

import os
import signal

import numpy as np
import pytest
import torch

import repro.core as J
import repro.core.shm as jshm
import repro_torch.core as T
import repro_torch.core.shm as tshm
from repro.data.pipeline import DataPipeline as JDataPipeline
from repro.data.sources import SyntheticLMSource as JSource
from repro_torch.core import perf_model as pm
from repro_torch.core.compiler import CostEstimate
from repro_torch.core.plan import single_device_plan
from repro_torch.data import DataPipeline, SyntheticLMSource

torch.set_num_threads(1)

TIMEOUT = 60.0            # seconds any one run may take before it fails


class Gen(T.FFNode):
    def __init__(self, n):
        super().__init__()
        self.i, self.n = 0, n

    def svc(self, _):
        self.i += 1
        return np.float32(self.i) if self.i <= self.n else None


class JGen(J.FFNode):
    def __init__(self, n):
        super().__init__()
        self.i, self.n = 0, n

    def svc(self, _):
        self.i += 1
        return np.float32(self.i) if self.i <= self.n else None


def _heavy(x):
    return x * 2.0 + 1.0


_heavy.ff_flops = 1e9     # declared work: auto placement takes the device


def _l_scale(x):
    return x * 10.0


def _l_shift(x):
    return x + 1.0


def _r_dec(y):
    return y - 1.0


def _r_double(y):
    return y * 2.0


def _route_by_value(y, n_right):
    # numpy in the process workers, a torch tensor under the device
    # lowering's vmap
    if isinstance(y, torch.Tensor):
        return y.to(torch.int32) % n_right
    return y.astype("int32") % n_right


def _kill_on_five(x):
    if int(x) == 5:
        os.kill(os.getpid(), signal.SIGKILL)
    return float(x)


def _floats(out):
    return [float(v) for v in out]


# -- the rings: one layout, both packages --------------------------------------
@pytest.mark.parametrize("writer,reader", [(jshm, tshm), (tshm, jshm)],
                         ids=["reference_to_port", "port_to_reference"])
def test_a_ring_of_either_package_reads_the_others(writer, reader):
    from multiprocessing import resource_tracker
    q = writer.ShmSPSCQueue(capacity=8, slot_bytes=256, arena_bytes=1 << 16)
    r = reader.ShmSPSCQueue(8, 256, name=q.name, _create=False,
                            arena_bytes=q._arena.data_size,
                            arena_name=q._arena.name)
    # attaching unregisters the segments from this process's tracker, as a
    # worker process does; here the creator is this process, which unlinks
    for name in (q.name, q._arena.name):
        resource_tracker.register("/" + name, "shared_memory")
    try:
        small = np.arange(12, dtype=np.float32).reshape(3, 4)   # ARR
        big = np.arange(4096, dtype=np.int32)                    # ARN
        obj = {"a": [1, 2.5, "x"], "b": (None, True)}             # PKL
        for item in (small, big, obj):
            assert q.try_push(item)
        q.push_many([1, "two", 3.0], timeout=TIMEOUT)             # BATCH
        q.push_eos(timeout=TIMEOUT)
        got = [r.pop(timeout=TIMEOUT) for _ in range(7)]
        np.testing.assert_array_equal(got[0], small)
        assert got[0].dtype == small.dtype
        np.testing.assert_array_equal(got[1], big)
        assert got[2] == obj and got[3:6] == [1, "two", 3.0]
        eos = J.EOS if reader is jshm else T.EOS
        assert got[6] is eos
        assert q.arena_pushes == 1 and r.empty()
    finally:
        r.detach()
        q.destroy()


# -- graphs: thread, process and device runs against the reference -------------
def test_farm_parity_thread_process_device():
    """tests/test_process_runner.py::test_farm_parity_thread_process_device
    on the port, held to the reference's process run."""
    n = 11
    want = _floats(J.pipeline(JGen(n), J.farm(_heavy, n=2)).compile(
        mode="process").run(timeout=TIMEOUT))
    assert want == pytest.approx([i * 2.0 + 1.0 for i in range(1, n + 1)])
    host = T.pipeline(Gen(n), T.farm(_heavy, n=2)).compile(
        config=T.CompileConfig(mode="host")).run(timeout=TIMEOUT)
    r = T.pipeline(Gen(n), T.farm(_heavy, n=2)).compile(
        config=T.CompileConfig(mode="process"))
    assert isinstance(r, T.ProcessRunner)
    assert [p.target for _, p in r.placements] == ["host", "host_process"]
    proc = r.run(timeout=TIMEOUT)
    dev = T.pipeline(Gen(n), T.farm(_heavy, n=2)).compile(
        config=T.CompileConfig(plan=single_device_plan("cpu"),
                               device_batch=4)).run(timeout=TIMEOUT)
    # the process farm reorders by sequence number and the device path is
    # batch-ordered: both in input order; the thread farm's collector is
    # arrival-ordered: the same multiset
    assert _floats(proc) == want
    assert _floats(dev) == want
    assert sorted(_floats(host)) == want


@pytest.mark.parametrize("router", [_route_by_value, None],
                         ids=["routed", "round_robin"])
def test_a2a_parity_thread_process_device(router):
    """tests/test_process_a2a.py's heterogeneous all_to_all on the port,
    cut to one left worker (three processes in all): the process run
    (ProcessA2ANode over the shm grid) equals the reference's in input
    order, the thread and device runs as multisets."""
    lefts, rights = [_l_scale], [_r_dec, _r_double]
    xs = [np.float32(i) for i in range(1, 15)]
    want = _floats(J.all_to_all(lefts, rights, router=router).compile(
        mode="process").run(xs, timeout=TIMEOUT))
    r = T.all_to_all(lefts, rights, router=router).compile(
        config=T.CompileConfig(mode="process"))
    assert isinstance(r, T.ProcessRunner)
    assert [p.target for _, p in r.placements] == ["host_process"]
    assert [p.width for _, p in r.placements] == [3]
    assert _floats(r.run(xs, timeout=TIMEOUT)) == want
    host = T.all_to_all(lefts, rights, router=router).compile(
        config=T.CompileConfig(mode="host")).run(xs, timeout=TIMEOUT)
    assert sorted(_floats(host)) == sorted(want)
    if router is not None:     # the device lowering needs a router
        dev = T.all_to_all(lefts, rights, router=router).compile(
            config=T.CompileConfig(plan=single_device_plan("cpu"),
                                   mode="device")).run(xs)
        assert sorted(_floats(dev)) == sorted(want)


def test_a_crashed_worker_raises_worker_crashed():
    r = T.pipeline(T.farm(_kill_on_five, n=2)).compile(
        config=T.CompileConfig(mode="process"))
    with pytest.raises(T.WorkerCrashed):
        r.run([np.float32(i) for i in range(10)], timeout=TIMEOUT)


def test_process_placement_follows_the_calibrated_hop(tmp_path, monkeypatch):
    """A farm declared GIL-bound goes to processes when its work dwarfs the
    measured shm hop; the calibration has measured the hop, per item and
    batched, and the arena's bandwidth."""
    monkeypatch.setenv("REPRO_FF_CACHE", str(tmp_path))
    pm.reset_calibration()
    try:
        g = T.pipeline(T.farm(_heavy, n=3))
        r = g.compile(config=T.CompileConfig(costs={
            _heavy: CostEstimate(t_task=2e-2, releases_gil=False)}))
        p = r.placements[0][1]
        assert type(r).__name__ == "ProcessRunner"
        assert (p.target, p.width) == ("host_process", 3), p
        c = pm.get_calibration(measure=False)
        assert c.source == "measured"
        assert 0 < c.proc_hop_effective_s() <= c.proc_hop_s < 2e-2
        assert c.shm_batched_hop_s > 0 and c.arena_bw_gbs > 0
        assert r.run([np.float32(i) for i in range(6)], timeout=TIMEOUT) \
            == [i * 2.0 + 1.0 for i in range(6)]
        # a thread-friendly farm stays on threads
        g = T.pipeline(T.farm(_heavy, n=3))
        r = g.compile(config=T.CompileConfig(costs={
            _heavy: CostEstimate(t_task=2e-2, releases_gil=True)}))
        assert r.placements[0][1].target == "host"
    finally:
        pm.reset_calibration()


# -- the data pipeline's compute farm ------------------------------------------
def _augment(batch):
    # numpy only: the worker processes never touch torch
    t = batch["tokens"]
    return {"tokens": (t * 3 + 1) % 50,
            "mask": (t % 2).astype(np.float32)}


def _drain(pipe, n):
    out = [pipe.get(timeout=TIMEOUT) for _ in range(n)]
    assert pipe.get(timeout=TIMEOUT) is None
    return [{k: v.numpy() for k, v in b.items()} for b in out]


def test_pipeline_compute_workers_deliver_the_same_batches():
    n = 6
    farm = DataPipeline(SyntheticLMSource(50, 16, 2, seed=3), "cpu",
                        n_batches=n, compute=_augment,
                        compute_workers=2).start()
    assert [p.target for _, p in farm.placements][1] == "host_process"
    one = DataPipeline(SyntheticLMSource(50, 16, 2, seed=3), "cpu",
                       n_batches=n, compute=_augment).start()
    ref = JDataPipeline(JSource(50, 16, 2, seed=3), n_batches=n,
                        compute=_augment, compute_workers=2).start()
    got, want = _drain(farm, n), _drain(one, n)
    jwant = [{k: np.asarray(v) for k, v in ref.get(timeout=TIMEOUT).items()}
             for _ in range(n)]
    for a, b, c in zip(got, want, jwant):
        assert a.keys() == b.keys() == c.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype == c[k].dtype
            np.testing.assert_array_equal(a[k], b[k])
            np.testing.assert_array_equal(a[k], c[k])


# -- the tuned preset -----------------------------------------------------------
def test_tuned_env_sets_one_thread_and_is_idempotent(monkeypatch):
    from repro_torch.launch import tuned
    delta = tuned.tuned_env({})
    assert delta["OMP_NUM_THREADS"] == "1" == delta["MKL_NUM_THREADS"]
    assert not any("XLA" in k for k in delta)
    assert "OMP_NUM_THREADS" not in tuned.tuned_env(
        {"OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1"})
    monkeypatch.setenv(tuned._GUARD, "1")   # the re-exec'd pass
    assert tuned.apply_tuned() is False


def test_train_launcher_runs_tuned(tmp_path, capsys, monkeypatch):
    from repro_torch.launch import tuned
    from repro_torch.launch.train import main
    monkeypatch.setenv(tuned._GUARD, "1")   # as after the one re-exec
    main(["--device", "cpu", "--tuned", "--steps", "2", "--batch", "2",
          "--seq", "16", "--ckpt-dir", str(tmp_path)])
    assert "final step 2" in capsys.readouterr().out
