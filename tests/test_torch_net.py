"""The port's remote tier against the reference's, on the CPU.

Twins of ``tests/test_net.py``, case for case, on the port's modules: the
frame codec's robustness, ``NetLane``'s credit window and heartbeats,
remote farms over loopback worker pools (exact input order past the credit
window, absorbed emitter/collector, an item the wire cannot carry, a killed
worker, autoscaling and the Supervisor's cluster autoscaling), the worker
CLI (``python -m repro_torch.launch.worker``), the ``host_remote`` target's
refusals and its pickle fallback, and the net hop's calibration and
``observe`` feedback.

Where a result can be compared it is held to the reference's: both codecs
give the same bytes and each reads the other's frames; both packages'
``place`` give the same targets, widths and reasons on the same graph,
costs, calibration and pool; both ``observe`` fold a remote record alike.
The version-3 calibration cache carries the net hop and the device
boundary's four constants, a version-2 file misses, and without a card the
boundary measurements return their defaults.

Beyond the twins: the port's one change to the lane (a grant or heartbeat
that fails to send after the peer's EOS loses no result, and a silent peer
still crashes the lane), a worker pool that imports no torch, and the
device candidate of ``place`` spreading the boundary's per-microbatch costs
over the microbatch.

Each test that starts a pool uses at most 3 forked processes, terminates
them in a ``finally`` and bounds every wait (a run ``timeout`` of 60 s)."""

import contextlib
import json
import os
import pathlib
import signal
import socket
import struct
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

import repro.core as J
import repro.core.compiler as jcomp
import repro.core.net as jnet
import repro.core.perf_model as jpm
import repro_torch.core as T
import repro_torch.core.compiler as tcomp
import repro_torch.core.net as tnet
from repro_torch.core import (EOS, FFNode, GraphError, HostRunner, NetLane,
                              RemoteFarmNode, RemoteRunner, WorkerCrashed,
                              farm, perf_model as pm, pipeline,
                              spawn_loopback_pool)
from repro_torch.core.net import (FrameError, MAX_FRAME_BYTES, TAG_ARR,
                                  TAG_CREDIT, TAG_EOS, TAG_HB, TAG_PKL,
                                  _SLOT_FMT, _SLOT_HDR, decode_payload,
                                  encode_frame, encode_item, parse_addr,
                                  read_frame)
from repro_torch.core.runtime import Supervisor
from repro_torch.core.shm import WorkerStats

torch.set_num_threads(1)

pytestmark = pytest.mark.net

TIMEOUT = 60.0            # seconds any one wait of a run may take


def _cfg(**kw):
    return T.CompileConfig(**kw)


# -- module-level workers (must pickle across the wire) ------------------------
class _Gen(FFNode):
    def __init__(self, n):
        super().__init__()
        self.i, self.n = 0, n

    def svc(self, _):
        self.i += 1
        return np.float32(self.i) if self.i <= self.n else None


class _ArrGen(FFNode):
    def __init__(self, n):
        super().__init__()
        self.i, self.n = 0, n

    def svc(self, _):
        if self.i >= self.n:
            return None
        self.i += 1
        return np.arange(8, dtype=np.float32) + np.float32(self.i)


class _GenUnpicklable(FFNode):
    def __init__(self):
        super().__init__()
        self.done = False

    def svc(self, _):
        if self.done:
            return None
        self.done = True
        return (i for i in range(3))    # generators cannot pickle


def _double(x):
    return x * 2.0


def _sleepy(x):
    time.sleep(0.01)
    return x + 1.0


def _kill_on_seven(x):
    if int(x) == 7:
        os.kill(os.getpid(), signal.SIGKILL)
    return float(x)


@contextlib.contextmanager
def _pool(n, **kw):
    addrs, procs = spawn_loopback_pool(n, **kw)
    try:
        yield addrs, procs
    finally:
        for p in procs:
            p.terminate()
        for p in procs:
            p.join(timeout=10.0)


def _roundtrip(item):
    frame = encode_item(item)
    length, tag, seq = struct.unpack(_SLOT_FMT, frame[:_SLOT_HDR])
    assert length == len(frame) - _SLOT_HDR
    return tag, decode_payload(tag, frame[_SLOT_HDR:])


# -- frame codec ---------------------------------------------------------------
def test_parse_addr_forms():
    assert parse_addr("127.0.0.1:7001") == ("127.0.0.1", 7001)
    assert parse_addr(("10.0.0.2", 80)) == ("10.0.0.2", 80)
    with pytest.raises(ValueError):
        parse_addr("no-port-here")


def test_contiguous_array_rides_raw_fast_path_byte_identical():
    a = np.random.default_rng(0).standard_normal((5, 7)).astype(np.float32)
    tag, b = _roundtrip(a)
    assert tag == TAG_ARR
    assert b.dtype == a.dtype and b.shape == a.shape
    assert b.tobytes() == a.tobytes()


def test_0d_forder_and_noncontiguous_arrays_roundtrip():
    z = np.array(3.5, dtype=np.float64)             # 0-d
    tag, b = _roundtrip(z)
    assert tag == TAG_ARR and b.shape == () and float(b) == 3.5

    f = np.asfortranarray(np.arange(12, dtype=np.int32).reshape(3, 4))
    tag, b = _roundtrip(f)                          # F-order: made contiguous
    assert tag == TAG_ARR
    np.testing.assert_array_equal(b, f)

    s = np.arange(20, dtype=np.float32)[::3]        # strided view
    tag, b = _roundtrip(s)
    assert tag == TAG_ARR
    np.testing.assert_array_equal(b, s)


def test_structured_object_and_pytree_fall_back_to_pickle():
    rec = np.zeros(3, dtype=[("a", "f4"), ("b", "i8")])
    tag, b = _roundtrip(rec)
    assert tag == TAG_PKL
    np.testing.assert_array_equal(b, rec)

    obj = np.array([{"k": 1}, None, (2, 3)], dtype=object)
    tag, b = _roundtrip(obj)
    assert tag == TAG_PKL and b[0] == {"k": 1}

    tree = {"x": np.float32(2.0), "y": [1, "two"]}
    tag, b = _roundtrip(tree)
    assert tag == TAG_PKL and b == tree


def test_oversized_payload_rejected_on_both_sides():
    big = np.zeros(1024, dtype=np.uint8)
    with pytest.raises(FrameError):
        encode_frame(TAG_ARR, big, max_frame=64)    # encode side
    a, b = socket.socketpair()
    try:
        # a length word past the lane limit is rejected before allocation
        a.sendall(struct.pack(_SLOT_FMT, MAX_FRAME_BYTES + 1, TAG_PKL, 0))
        with pytest.raises(FrameError, match="oversized"):
            read_frame(b)
    finally:
        a.close()
        b.close()


def test_partial_reads_reassemble_truncation_raises_clean_eof_is_none():
    frame = encode_item(np.arange(64, dtype=np.float32), seq=9)

    a, b = socket.socketpair()
    try:
        def drip():
            for i in range(0, len(frame), 7):       # 7-byte chunks
                a.sendall(frame[i:i + 7])
                time.sleep(0.001)
        t = threading.Thread(target=drip, daemon=True)
        t.start()
        tag, payload, seq = read_frame(b)
        t.join(timeout=TIMEOUT)
        assert not t.is_alive()
        assert (tag, seq) == (TAG_ARR, 9)
        np.testing.assert_array_equal(decode_payload(tag, payload),
                                      np.arange(64, dtype=np.float32))
    finally:
        a.close()
        b.close()

    a, b = socket.socketpair()
    try:
        a.sendall(frame[:_SLOT_HDR + 10])           # truncated mid-payload
        a.close()
        with pytest.raises(FrameError, match="truncated"):
            read_frame(b)
    finally:
        b.close()

    a, b = socket.socketpair()
    try:
        a.close()                                   # clean EOF at a boundary
        assert read_frame(b) is None
    finally:
        b.close()


def test_corrupt_ndarray_meta_raises_frame_error():
    frame = encode_item(np.arange(8, dtype=np.float32))
    payload = bytearray(frame[_SLOT_HDR:])
    payload[0] = 7                                  # lie about ndim
    with pytest.raises(FrameError):
        decode_payload(TAG_ARR, bytes(payload))


# the codec against the reference's: the same bytes, and each package reads
# the other's frames
CODEC_ITEMS = {
    "arr": np.random.default_rng(1).standard_normal((5, 7)).astype(
        np.float32),
    "arr_0d": np.array(3.5, dtype=np.float64),
    "arr_forder": np.asfortranarray(
        np.arange(12, dtype=np.int32).reshape(3, 4)),
    "arr_strided": np.arange(20, dtype=np.float32)[::3],
    "pkl": {"x": 2.5, "y": [1, "two", (3, None)]},
}
CONTROL_FRAMES = {"eos": (TAG_EOS, 0), "credit": (TAG_CREDIT, 5),
                  "hb": (TAG_HB, 0)}


def _decoded_equal(got, want) -> bool:
    if isinstance(want, np.ndarray):
        return (isinstance(got, np.ndarray) and got.dtype == want.dtype
                and got.shape == want.shape
                and got.tobytes() == np.asarray(want, order="C").tobytes())
    return got == want


@pytest.mark.parametrize("name", sorted(CODEC_ITEMS))
def test_item_frames_equal_the_references_bytes(name):
    item = CODEC_ITEMS[name]
    for seq in (0, 7, 2 ** 40):
        mine = tnet.encode_item(item, seq)
        theirs = jnet.encode_item(item, seq)
        assert mine == theirs
        tag = struct.unpack(_SLOT_FMT, mine[:_SLOT_HDR])[1]
        assert tag == (TAG_PKL if name == "pkl" else TAG_ARR)
        payload = mine[_SLOT_HDR:]
        # each package decodes the other's frame to the item
        assert _decoded_equal(tnet.decode_payload(tag, payload), item)
        assert _decoded_equal(jnet.decode_payload(tag, payload), item)


@pytest.mark.parametrize("name", sorted(CONTROL_FRAMES))
def test_control_frames_equal_the_references_bytes(name):
    tag, seq = CONTROL_FRAMES[name]
    mine = tnet.encode_frame(tag, None, seq)
    assert mine == jnet.encode_frame(tag, None, seq)
    assert len(mine) == _SLOT_HDR
    assert struct.unpack(_SLOT_FMT, mine) == (0, tag, seq)
    want = (T.EOS, J.EOS) if tag == TAG_EOS else (None, None)
    assert tnet.decode_payload(tag, b"") is want[0]
    assert jnet.decode_payload(tag, b"") is want[1]
    assert (tnet.TAG_CREDIT, tnet.TAG_HB, tnet.TAG_FN) == \
        (jnet.TAG_CREDIT, jnet.TAG_HB, jnet.TAG_FN)


# -- NetLane: credit window + liveness ----------------------------------------
def _lane_pair(credit=4, **kw):
    a, b = socket.socketpair()
    kw.setdefault("hb_interval", 5.0)               # quiet heartbeats
    return (NetLane(a, credit=credit, label="A", **kw),
            NetLane(b, credit=credit, label="B", **kw))


def test_credit_window_backpressures_and_pop_regrants():
    A, B = _lane_pair(credit=4)
    try:
        for i in range(4):
            assert A.try_push(np.float32(i), seq=i)
        assert not A.try_push(np.float32(99), seq=99)   # window exhausted
        assert len(A) >= 4

        item, seq = B.pop_seq(timeout=10.0)             # pop grants a credit
        assert (float(item), seq) == (0.0, 0)
        A.push(np.float32(4), timeout=10.0, seq=4)      # ... which re-opens
        for want in (1, 2, 3, 4):
            item, seq = B.pop_seq(timeout=10.0)
            assert seq == want
    finally:
        A.shutdown()
        B.shutdown()


def test_stream_longer_than_window_arrives_in_exact_order():
    A, B = _lane_pair(credit=4)
    n = 64
    try:
        def feed():
            for i in range(n):
                A.push(np.float32(i), timeout=30.0, seq=i)
            A.push_eos()
        t = threading.Thread(target=feed, daemon=True)
        t.start()
        seqs, vals = [], []
        while True:
            item, seq = B.pop_seq(timeout=30.0)
            if item is EOS:
                break
            seqs.append(seq)
            vals.append(float(item))
        t.join(timeout=TIMEOUT)
        assert not t.is_alive()
        assert seqs == list(range(n))
        assert vals == [float(i) for i in range(n)]
        assert A.max_depth <= 4                         # window held
    finally:
        A.shutdown()
        B.shutdown()


def test_heartbeat_timeout_marks_silent_peer_dead():
    a, b = socket.socketpair()
    lane = NetLane(a, hb_interval=0.05, hb_timeout=0.25, label="hb")
    try:
        deadline = time.monotonic() + 5.0
        while lane.peer_dead is None and time.monotonic() < deadline:
            time.sleep(0.01)
        assert lane.peer_dead is not None
        assert "heartbeat" in lane.peer_dead
        with pytest.raises(WorkerCrashed):
            lane.push(np.float32(1.0), timeout=1.0)
    finally:
        lane.shutdown()
        b.close()


def test_eof_mid_stream_marks_dead_and_pop_raises():
    a, b = socket.socketpair()
    lane = NetLane(a, hb_interval=5.0, label="eof")
    try:
        b.close()                                   # peer vanishes, no EOS
        with pytest.raises(WorkerCrashed):
            lane.pop_seq(timeout=5.0)
        assert "closed" in lane.peer_dead
    finally:
        lane.shutdown()


# The port's one change to the reference's lane: a credit grant or heartbeat
# that fails to send does not mark the lane dead; the reader judges the end
# of the stream, and the silence watch stays on.
def test_results_popped_after_the_peer_closed_all_come_back():
    n = 6
    a, b = socket.socketpair()
    A = NetLane(a, credit=n, hb_interval=0.05, hb_timeout=0.25, label="A")
    B = NetLane(b, credit=n, hb_interval=5.0, label="B")
    try:
        for i in range(n):
            B.push(np.float32(i), timeout=5.0, seq=i)
        B.push_eos()
        B.shutdown()                    # the worker closes right after EOS
        deadline = time.monotonic() + 5.0
        while not A.saw_eos and time.monotonic() < deadline:
            time.sleep(0.01)
        assert A.saw_eos
        time.sleep(0.5)         # heartbeats fail to send, silence > timeout
        got = []
        while True:             # each pop's grant fails to send
            item, seq = A.pop_seq(timeout=5.0)
            if item is EOS:
                break
            got.append((float(item), seq))
        assert got == [(float(i), i) for i in range(n)]
        assert A.peer_dead is None
    finally:
        A.shutdown()
        B.shutdown()


def test_peer_that_closes_without_eos_still_crashes_the_lane():
    a, b = socket.socketpair()
    A = NetLane(a, credit=4, hb_interval=0.05, hb_timeout=0.25, label="A")
    B = NetLane(b, credit=4, hb_interval=5.0, label="B")
    try:
        B.push(np.float32(7), timeout=5.0, seq=0)
        B.shutdown()                                # no EOS
        item, seq = A.pop_seq(timeout=5.0)          # its grant fails
        assert (float(item), seq) == (7.0, 0)
        with pytest.raises(WorkerCrashed):
            A.pop_seq(timeout=5.0)
        assert A.peer_dead is not None
    finally:
        A.shutdown()
        B.shutdown()


def test_silence_is_watched_after_a_heartbeat_send_failed():
    # the peer stops reading (so heartbeats fail to send) and sends nothing,
    # yet keeps its end open: the heartbeat timeout still marks it dead
    a, b = socket.socketpair()
    b.shutdown(socket.SHUT_RD)
    lane = NetLane(a, hb_interval=0.05, hb_timeout=0.25, label="half")
    try:
        with pytest.raises(WorkerCrashed, match="heartbeat timeout"):
            lane.pop_seq(timeout=5.0)
    finally:
        lane.shutdown()
        b.close()


def test_the_worker_pool_imports_no_torch():
    code = ("import sys, repro_torch.launch.worker\n"
            "print(sorted(m for m in sys.modules if m == 'torch'))\n")
    src = str(pathlib.Path(__file__).resolve().parents[1] / "src")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=60,
                         env={"PYTHONPATH": src, "PATH": "/usr/bin:/bin"})
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "[]"


# -- loopback cluster: remote farms -------------------------------------------
def test_remote_farm_parity_exact_order_past_credit_window():
    n = 64                                          # stream >> credit window
    expected = [(np.arange(8, dtype=np.float32) + np.float32(i)) * 2.0
                for i in range(1, n + 1)]
    with _pool(2) as (addrs, _):
        r = pipeline(_ArrGen(n), farm(_double, n=2)).compile(config=_cfg(
            mode="remote", remote_workers=addrs, net_credit=8))
        assert isinstance(r, RemoteRunner)
        farm_p = [p for d, p in r.placements if "farm" in d][0]
        assert farm_p.target == "host_remote" and farm_p.width == 2
        out = r.run(timeout=TIMEOUT)
    # byte-identical AND exactly input-ordered, past the credit window
    assert len(out) == n
    for got, want in zip(out, expected):
        assert got.dtype == want.dtype and got.tobytes() == want.tobytes()

    host = pipeline(_ArrGen(n), farm(_double, n=2)).compile(
        config=_cfg(mode="host")).run()
    assert sorted(a.tobytes() for a in host) \
        == sorted(a.tobytes() for a in expected)


def test_remote_farm_with_absorbed_emitter_collector():
    n = 10
    with _pool(2) as (addrs, _):
        r = pipeline(_Gen(n), lambda x: x + 0.5, farm(_double, n=2),
                     lambda y: y - 1.0).compile(config=_cfg(
                         mode="remote", remote_workers=addrs))
        assert isinstance(r, RemoteRunner)
        out = [float(v) for v in r.run(timeout=TIMEOUT)]
    assert out == pytest.approx(
        [(i + 0.5) * 2.0 - 1.0 for i in range(1, n + 1)])


def test_unencodable_item_surfaces_item_error_not_cluster_death():
    # an item the wire cannot carry is the item's fault: the farm must
    # surface the encode error (like the shm tier's oversized-slot raise),
    # not misreport "all workers are gone" while every worker is alive
    with _pool(2) as (addrs, procs):
        r = pipeline(_GenUnpicklable(), farm(_double, n=2)).compile(
            config=_cfg(mode="remote", remote_workers=addrs))
        with pytest.raises(Exception) as ei:
            r.run(timeout=TIMEOUT)
        assert not isinstance(ei.value, WorkerCrashed)
        assert "gone" not in str(ei.value)
        assert all(p.is_alive() for p in procs)


def test_killed_remote_worker_surfaces_crash_not_wedge():
    with _pool(2) as (addrs, _):
        r = pipeline(_Gen(40), farm(_kill_on_seven, n=2)).compile(
            config=_cfg(mode="remote", remote_workers=addrs))
        t0 = time.monotonic()
        with pytest.raises(WorkerCrashed):
            r.run(timeout=TIMEOUT)
        assert time.monotonic() - t0 < TIMEOUT
        assert isinstance(r.error(), WorkerCrashed)


def test_autoscale_remote_farm_grows_active_set_from_lane_depth():
    n = 80
    with _pool(2) as (addrs, _):
        r = pipeline(_Gen(n), farm(_sleepy, n=2, autoscale=True)).compile(
            config=_cfg(mode="remote", remote_workers=addrs))
        node = [s for s in r._skel._stages
                if isinstance(s, RemoteFarmNode)][0]
        out = [float(v) for v in r.run(timeout=TIMEOUT)]
        assert out == pytest.approx([i + 1.0 for i in range(1, n + 1)])
        st = node.node_stats()
        assert st["autoscale"]["grown"] >= 1        # 1-wide start, grew
        assert sum(st["routed_per_worker"]) == n
        assert st["svc_cpu_ema_s"] >= 0.0           # WorkerStats folded


def test_supervisor_drives_cluster_autoscaling_from_lane_depth():
    """The Supervisor over a remote farm: trickle retires a remote worker,
    a burst reactivates it — cluster autoscaling through the same width
    policy the on-box tiers use, order preserved throughout."""
    with _pool(3) as (addrs, _):
        r = farm(_sleepy, n=3).compile(config=_cfg(mode="remote",
                                                   remote_workers=addrs))
        handles = r.stage_handles()
        assert [h.tier for h in handles] == ["host_remote"]
        assert handles[0].can_migrate("host") is False
        r.run_then_freeze()
        sup = Supervisor(r, interval=0.01, migrate=False).start()
        got = []
        done = threading.Event()

        def collect():
            while True:
                ok, item = r.load_result(timeout=TIMEOUT)
                if not ok:
                    break
                got.append(item)
            done.set()

        threading.Thread(target=collect, daemon=True).start()
        try:
            # trickle: lanes idle -> the supervisor retires remote workers
            for i in range(12):
                r.offload(float(i))
                time.sleep(0.02)
            deadline = time.monotonic() + 10.0
            while not any(e.kind == "shrink" for e in sup.events) \
                    and time.monotonic() < deadline:
                time.sleep(0.01)
            # burst: deep lanes -> it grows the active remote set back
            for i in range(12, 120):
                r.offload(float(i))
            r.offload(EOS)
            assert done.wait(TIMEOUT)
            assert r.wait(30.0) == 0
        finally:
            sup.stop()
        kinds = {e.kind for e in sup.events}
        assert "shrink" in kinds and "grow" in kinds
        assert got == [i + 1.0 for i in range(120)]  # seq-ordered throughout


def test_worker_cli_serves_a_lane_end_to_end():
    """python -m repro_torch.launch.worker --listen 127.0.0.1:0 comes up,
    prints its bound port, serves the FN handshake + a short stream, ships
    its WorkerStats CPU record, and answers EOS."""
    env = dict(os.environ)
    src = str(pathlib.Path(__file__).resolve().parents[1] / "src")
    env["PYTHONPATH"] = src + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.worker",
         "--listen", "127.0.0.1:0"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
    try:
        line = proc.stdout.readline().strip()
        assert line.startswith("listening "), line
        host, port = parse_addr(line.split()[1])
        from repro_torch.launch.worker import demo_fn
        lane = NetLane.connect(host, port, timeout=30.0)
        try:
            lane.push_fn(demo_fn)
            for i in range(5):
                lane.push(float(i), timeout=10.0, seq=i)
            lane.push_eos()
            got, stats = {}, None
            while True:
                item, seq = lane.pop_seq(timeout=TIMEOUT)
                if item is EOS:
                    break
                if isinstance(item, WorkerStats):
                    stats = item
                    continue
                got[seq] = item
            assert got == {i: float(i) * float(i) for i in range(5)}
            assert stats is not None and stats.items == 5
            assert stats.cpu_ema_s >= 0.0
        finally:
            lane.shutdown()
    finally:
        proc.terminate()
        proc.wait(timeout=10.0)


def test_unreachable_worker_fails_with_its_address():
    # a pool that cannot be reached fails the build with its address; it
    # never leaves the farm to run elsewhere
    s = socket.create_server(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()                                       # nothing listens here
    with pytest.raises(WorkerCrashed, match=f"127.0.0.1:{port}"):
        RemoteFarmNode([_double], [("127.0.0.1", port)],
                       connect_timeout=0.5)


# -- placement: the host_remote target ----------------------------------------
def test_mode_remote_without_pool_rejected():
    with pytest.raises(GraphError, match="remote_workers"):
        pipeline(_Gen(3), farm(_double, n=2)).compile(
            config=_cfg(mode="remote"))


def test_host_remote_override_without_pool_rejected():
    with pytest.raises(GraphError):
        pipeline(_Gen(3), farm(_double, n=2)).compile(
            config=_cfg(placements={1: "host_remote"}))


def test_forced_remote_with_unpicklable_worker_falls_back_to_host():
    # a lambda cannot cross hosts even though fork-based processes take it
    r = pipeline(_Gen(3), farm(lambda x: x + 1.0, n=2)).compile(config=_cfg(
        mode="remote", remote_workers=["127.0.0.1:1", "127.0.0.1:2"]))
    assert isinstance(r, HostRunner) and not isinstance(r, RemoteRunner)
    p = [p for d, p in r.placements if "farm" in d][0]
    assert p.target == "host" and "pickle" in p.reason


# the reference's place() and the port's on the same graph, costs,
# calibration and pool: the same targets, widths and reasons
CALIB = dict(peak_flops=5e10, queue_hop_s=2e-5, proc_hop_s=1e-4,
             device_dispatch_s=2e-5, net_hop_s=3e-4, fused_segment_s=4e-6,
             shm_batched_hop_s=5e-5, arena_bw_gbs=2.0, h2d_bw_gbs=12.0,
             d2h_bw_gbs=10.0, overlap_eff=0.6)
POOL = ["127.0.0.1:7001", "127.0.0.1:7002", "127.0.0.1:7003"]


def _heavy(x):
    return x * 3.0


class _JGen(J.FFNode):
    def __init__(self, n):
        super().__init__()
        self.i, self.n = 0, n

    def svc(self, _):
        self.i += 1
        return np.float32(self.i) if self.i <= self.n else None


# name -> (worker is a lambda, farm width, releases_gil, compile mode)
PLACE_CASES = {
    "gil_bound_wide": (False, 2, False, "auto"),
    "gil_free": (False, 2, True, "auto"),
    "lambda_auto": (True, 2, False, "auto"),
    "lambda_remote": (True, 2, False, "remote"),
    "forced_remote": (False, 2, None, "remote"),
}


def _placed(core, comp, case):
    lam, n, gil, mode = PLACE_CASES[case]
    fn = (lambda x: x * 3.0) if lam else _heavy
    g = core.pipeline(_Gen(3) if core is T else _JGen(3),
                      core.farm(fn, n=n)).optimize()
    comp.annotate(g, costs={fn: comp.CostEstimate(t_task=2e-2,
                                                  releases_gil=gil)})
    comp.place(g, None, mode=mode, remote_pool=POOL)
    return [(s.placement.target, s.placement.width, s.placement.reason)
            for s in comp._top_stages(g)]


@pytest.mark.parametrize("case", sorted(PLACE_CASES))
def test_place_gives_the_references_remote_decisions(case, monkeypatch):
    for m in (pm, jpm):
        monkeypatch.setattr(m, "_calibration",
                            m.HostCalibration(**CALIB, source="measured"))
    got = _placed(T, tcomp, case)
    assert got == _placed(J, jcomp, case)
    target = got[1][0]                  # stage 0 is the source
    assert target == {"gil_bound_wide": "host_remote", "gil_free": "host",
                      "lambda_auto": "host_process", "lambda_remote": "host",
                      "forced_remote": "host_remote"}[case], got
    if case == "lambda_remote":
        assert "pickle" in got[1][2]


# -- calibration + observe feedback --------------------------------------------
BOUNDARY = ("_measure_fused_segment", "_measure_h2d_bw", "_measure_d2h_bw",
            "_measure_overlap_eff")
FAST = {"_measure_peak_flops": 1e9, "_measure_queue_hop": 1e-4,
        "_measure_proc_hop": 1e-4, "_measure_shm_batched_hop": 1e-4,
        "_measure_arena_bw": 3.0, "measure_cuda_dispatch": 1e-4,
        "_measure_net_hop": 1e-4, "_measure_fused_segment": 6e-6,
        "_measure_h2d_bw": 11.5, "_measure_d2h_bw": 9.5,
        "_measure_overlap_eff": 0.7}


def _fast_measures(monkeypatch, skip=()):
    for name, value in FAST.items():
        if name not in skip:
            monkeypatch.setattr(pm, name, lambda *a, _v=value, **k: _v)


@pytest.fixture
def _private_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_FF_CACHE", str(tmp_path))
    monkeypatch.delenv("REPRO_FF_CALIB_CACHE", raising=False)
    for m in (pm, jpm):
        m.reset_calibration()
        m.reset_observed()
    yield tmp_path
    for m in (pm, jpm):
        m.reset_calibration()
        m.reset_observed()


def test_calibrate_measures_net_hop_and_caches(_private_cache, monkeypatch):
    _fast_measures(monkeypatch, skip=("_measure_net_hop",))
    c = pm.calibrate()
    assert c.source == "measured"
    assert 0 < c.net_hop_s < 0.1                    # loopback-measured
    pm.reset_calibration()
    c2 = pm.get_calibration(measure=False)
    assert c2.source == "cached"
    assert c2.net_hop_s == pytest.approx(c.net_hop_s)


def test_unwritable_cache_dir_degrades_with_warning(monkeypatch):
    """A read-only cache location (a sealed or remote container)
    keeps the measured constants in memory instead of raising."""
    monkeypatch.setenv("REPRO_FF_CACHE", "/proc/ff-denied")
    _fast_measures(monkeypatch)
    pm.reset_calibration()
    try:
        with pytest.warns(RuntimeWarning, match="not writable"):
            c = pm.calibrate()
        assert c.source == "measured"               # still usable in-process
    finally:
        pm.reset_calibration()


def test_observe_absorbs_remote_hop_and_true_service_time(_private_cache):
    c0 = pm.get_calibration(measure=False)
    absorbed = pm.observe({"stages": [{
        "node": "remote_farm[2]", "backend": "remote", "tier": "host_remote",
        "fn_key": "tests.fake_remote_fn", "items": 16,
        "svc_cpu_ema_s": 2e-3, "hop_ema_s": 4e-3}]})
    assert absorbed == 2                            # hop fact + cost fact
    c1 = pm.get_calibration(measure=False)
    assert c1.source == "observed"
    assert c1.net_hop_s == pytest.approx(0.75 * c0.net_hop_s + 0.25 * 4e-3)
    assert c1.proc_hop_s == c0.proc_hop_s           # untouched
    rec = pm.lookup_observed("tests.fake_remote_fn")
    assert rec is not None and rec["t_task"] == pytest.approx(2e-3)


REMOTE_RECORD = {"stages": [
    {"node": "remote_farm[3]", "backend": "remote", "tier": "host_remote",
     "fn_key": "tests.fake_remote_fn", "items": 40, "svc_cpu_ema_s": 3e-3,
     "hop_ema_s": 7e-4},
    {"node": "remote_farm[3]", "backend": "remote", "tier": "host_remote",
     "fn_key": "tests.fake_remote_fn", "items": 80, "svc_cpu_ema_s": 1e-3,
     "hop_ema_s": 2e-4}]}


def test_observe_folds_a_remote_record_as_the_reference_does(
        _private_cache, monkeypatch):
    folded = []
    for m in (jpm, pm):
        monkeypatch.setattr(m, "_calibration",
                            m.HostCalibration(**CALIB, source="cached"))
        absorbed = m.observe(REMOTE_RECORD, write=True)
        c = m.get_calibration(measure=False)
        m.reset_observed()                # the fold persisted the table
        folded.append((absorbed, c.net_hop_s, c.proc_hop_s, c.source,
                       m.lookup_observed("tests.fake_remote_fn")))
    assert folded[1] == folded[0]
    absorbed, net_hop, proc_hop, source, rec = folded[1]
    assert absorbed == 4 and source == "observed"
    assert proc_hop == CALIB["proc_hop_s"] and net_hop != CALIB["net_hop_s"]
    assert rec["items"] == 80


NEW_FIELDS = ("net_hop_s", "fused_segment_s", "h2d_bw_gbs", "d2h_bw_gbs",
              "overlap_eff")


def test_version_3_cache_round_trips_the_new_constants(_private_cache,
                                                       monkeypatch):
    _fast_measures(monkeypatch)
    c = pm.calibrate()
    d = json.loads((_private_cache / "torch_calibration.json").read_text())
    assert d["version"] == 3
    assert {f: d[f] for f in NEW_FIELDS} == \
        {"net_hop_s": 1e-4, "fused_segment_s": 6e-6, "h2d_bw_gbs": 11.5,
         "d2h_bw_gbs": 9.5, "overlap_eff": 0.7}
    pm.reset_calibration()
    cached = pm.get_calibration(measure=False)
    assert cached.source == "cached"
    assert {f: getattr(cached, f) for f in NEW_FIELDS} == \
        {f: getattr(c, f) for f in NEW_FIELDS}


def test_version_2_cache_misses(_private_cache):
    fields = dict(pm.DEFAULT_CALIBRATION.as_dict(), source="measured")
    fields.update(net_hop_s=1e-5, overlap_eff=0.9)
    (_private_cache / "torch_calibration.json").write_text(json.dumps(
        {**fields, "version": 2, "cpu_count": os.cpu_count(),
         "observed": {}, "autotune": {}}))
    c = pm.get_calibration(measure=False)
    assert c is pm.DEFAULT_CALIBRATION and c.source == "default"


@pytest.mark.parametrize("name", BOUNDARY)
def test_boundary_measurements_keep_their_defaults_without_a_card(
        name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    field = {"_measure_fused_segment": "fused_segment_s",
             "_measure_h2d_bw": "h2d_bw_gbs", "_measure_d2h_bw": "d2h_bw_gbs",
             "_measure_overlap_eff": "overlap_eff"}[name]
    assert getattr(pm, name)() == getattr(pm.DEFAULT_CALIBRATION, field)


# -- the device candidate: per-microbatch boundary costs spread per item -------
def _device_reasons(monkeypatch, **place_kw):
    from repro_torch.core.plan import single_device_plan
    monkeypatch.setattr(pm, "_calibration", pm.HostCalibration(
        **dict(CALIB, device_dispatch_s=3e-4, fused_segment_s=1e-4),
        source="measured"))
    g = pipeline(_Gen(3), T.seq(_heavy), T.seq(_double))
    cost = tcomp.CostEstimate(flops=1e6, bytes=4096.0)
    tcomp.annotate(g, costs={_heavy: cost, _double: cost})
    tcomp.place(g, single_device_plan(device="cpu"), **place_kw)
    return [s.placement for s in tcomp._top_stages(g)[1:]], cost


@pytest.mark.parametrize("kw,batch", [({}, 8), ({"microbatch": 512}, 512),
                                      ({"device_batch": 64}, 64)])
def test_place_spreads_the_boundary_over_the_microbatch(kw, batch,
                                                        monkeypatch):
    placed, cost = _device_reasons(monkeypatch, **kw)
    calib = pm.get_calibration(measure=False)
    want = tcomp.device_item_time(cost, calib, 2, 1, batch)
    assert [p.target for p in placed] == ["device", "device"]
    assert all(f"roofline {want * 1e6:.1f}us" in p.reason for p in placed)
    # (3e-4 / 2 + 1e-4) / batch of dispatch an item, not 250 us
    once = tcomp.device_item_time(cost, calib, 2, 1, 1)
    assert once - want == pytest.approx(2.5e-4 * (1 - 1 / batch), rel=1e-6)
