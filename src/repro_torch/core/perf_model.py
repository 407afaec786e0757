"""Performance model — paper Sec. 13, with the H100 roofline.

The paper's algebra:
  * farm:     T(m tasks, nw workers) ~= T_seq / nw, bounded by emitter /
              collector service times and Amdahl's law;
  * pipeline: service time T_S = max_i T_Si; speedup = sum T_Si / max T_Si.

The compiler's ``annotate``/``place`` passes use that algebra for farm widths
and a roofline of the target card (:data:`H100_SXM`, NVIDIA's data-sheet
figures) for device time.  :func:`calibrate` measures the host constants —
one core's FLOP/s, the thread-queue hop, the process tier's shared-memory
hop (per item and batched) and its slab arena's bandwidth, the remote
tier's loopback network hop — and, on the card, the CUDA dispatch cost and
the device boundary's (the fused segment's marginal stage, the copy
bandwidths each way, the overlap efficiency), and caches them in the
port's own file ``torch_calibration.json``; the reference's
``calibration.json`` holds TPU-side constants and is never read.
:func:`observe` folds runtime stats (the adaptive runtime's Supervisor
samples them) into the same file: the shm and network hops, and an
observed per-callable cost table the next ``annotate`` reads before it
falls back to a sample probe.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import time
import warnings
from typing import Any, Callable, Dict, Optional, Sequence


# --------------------------------------------------------------------------
# Paper Sec. 13 algebra
# --------------------------------------------------------------------------
def farm_time(m_tasks: int, t_task: float, nw: int,
              t_emit: float = 0.0, t_collect: float = 0.0) -> float:
    """Completion time of m tasks on an nw-worker farm: workers process in
    parallel, but the emitter/collector are serial stages — the farm's
    service time is max(t_emit, t_task/nw, t_collect)."""
    service = max(t_emit, t_task / nw, t_collect)
    return m_tasks * service + t_task  # + one task latency (paper: latency
    # of a single task does not decrease)


def farm_speedup(m_tasks: int, t_task: float, nw: int,
                 t_emit: float = 0.0, t_collect: float = 0.0) -> float:
    return (m_tasks * t_task) / farm_time(m_tasks, t_task, nw, t_emit, t_collect)


def pipeline_service_time(stage_times: Sequence[float]) -> float:
    return max(stage_times)


def pipeline_time(m_tasks: int, stage_times: Sequence[float]) -> float:
    """m x T_S plus the fill latency sum(T_Si)."""
    return m_tasks * pipeline_service_time(stage_times) + sum(stage_times)


def pipeline_speedup(stage_times: Sequence[float], m_tasks: int = 10**9) -> float:
    """-> sum T_Si / max T_Si for long streams (paper's formula)."""
    seq = sum(stage_times)
    return (m_tasks * seq) / pipeline_time(m_tasks, stage_times)


def amdahl(serial_fraction: float, n: int) -> float:
    return 1.0 / (serial_fraction + (1.0 - serial_fraction) / n)


def choose_farm_width(t_task: float, n_max: int, t_emit: float = 0.0,
                      t_collect: float = 0.0,
                      overhead: float = 2e-5) -> int:
    """Smallest worker count whose per-item service time hits the farm's
    serial floor: service = max(t_emit, t_task/nw, t_collect), so adding
    workers beyond t_task/floor buys nothing (paper Sec. 13).  ``overhead``
    is the channel's own service time (queue push/pop) — the floor even for
    a free emitter.  Used by the graph compiler's ``place`` stage."""
    floor = max(t_emit, t_collect, overhead, 1e-9)
    w = math.ceil(t_task / floor)
    return max(1, min(w, max(1, n_max)))


def a2a_service_time(t_left: float, t_right: float, n_left: int,
                     n_right: int, hop: float = 0.0) -> float:
    """Steady-state per-item service time of an ``all_to_all`` stage: the
    slower side over its width, floored by twice the per-item channel hop."""
    return max(t_left / max(1, n_left), t_right / max(1, n_right),
               2.0 * hop)


def pipeline_bubble_fraction(n_stages: int, n_microbatches: int) -> float:
    """GPipe bubble: (S-1)/(M+S-1)."""
    return (n_stages - 1) / (n_microbatches + n_stages - 1)


def choose_microbatches(n_stages: int, max_bubble: float = 0.1,
                        max_micro: int = 256) -> int:
    """Smallest M with bubble fraction <= max_bubble."""
    m = math.ceil((n_stages - 1) * (1.0 - max_bubble) / max_bubble)
    return max(1, min(m, max_micro))


# --------------------------------------------------------------------------
# H100 roofline
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class HardwareSpec:
    name: str
    peak_flops_bf16: float   # per card, FLOP/s (dense tensor cores)
    hbm_bw: float            # per card, B/s
    link_bw: float           # NVLink, per direction, B/s
    hbm_bytes: float
    net_bw: float            # the network between nodes, per card, each way
    cards_per_node: int      # cards that NVLink joins
    peak_flops_tf32: float
    peak_flops_f32: float    # outside the tensor cores
    sms: int
    smem_per_block: int      # bytes a block may opt in to


# NVIDIA's H100 SXM data sheet: 989 TFLOP/s dense bf16, 495 TF32, 67 f32,
# 3.35 TB/s HBM3, 900 GB/s NVLink (450 GB/s each way), 80 GB; rates at the
# 700 W limit.  The DGX H100 data sheet: 8 GPUs a node on NVLink, and 8
# ConnectX-7 ports of 400 Gb/s InfiniBand NDR, one a GPU (50 GB/s each
# way).  The Hopper tuning guide: 132 SMs, 227 KB of shared memory a block
H100_SXM = HardwareSpec(
    name="h100_sxm",
    peak_flops_bf16=989e12,
    hbm_bw=3.35e12,
    link_bw=450e9,
    hbm_bytes=80e9,
    net_bw=50e9,
    cards_per_node=8,
    peak_flops_tf32=495e12,
    peak_flops_f32=67e12,
    sms=132,
    smem_per_block=232448,
)


@dataclasses.dataclass
class RooflineTerms:
    """The three terms, in seconds, per step, per card."""
    compute_s: float
    memory_s: float
    collective_s: float
    flops_total: float = 0.0
    bytes_total: float = 0.0
    coll_bytes: float = 0.0      # over NVLink, a card
    coll_bytes_net: float = 0.0  # over the network between nodes, a card
    model_flops: float = 0.0
    model_flops_s: float = 0.0   # time to run model_flops at peak

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def step_time_s(self) -> float:
        """Optimistic (perfect-overlap) step time = max of terms."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def roofline_fraction(self) -> float:
        """useful-compute fraction: model-FLOPs-at-peak time / step time."""
        if self.step_time_s == 0 or not self.model_flops:
            return 0.0
        return self.model_flops_s / self.step_time_s


def roofline(flops_total: float, bytes_total: float,
             coll_bytes_per_card: float, n_cards: int,
             hw: HardwareSpec = H100_SXM,
             coll_bytes_net_per_card: float = 0.0,
             model_flops: float = 0.0) -> RooflineTerms:
    """flops_total/bytes_total are totals over the cards; collective bytes
    are per-card link traffic (:func:`collective_link_bytes`): over NVLink
    inside a node, and over the network for a group that spans nodes (the
    reference's DCI term)."""
    net_s = coll_bytes_net_per_card / hw.net_bw if coll_bytes_net_per_card \
        else 0.0
    return RooflineTerms(
        flops_total / (n_cards * hw.peak_flops_bf16),
        bytes_total / (n_cards * hw.hbm_bw),
        coll_bytes_per_card / hw.link_bw + net_s,
        flops_total=flops_total, bytes_total=bytes_total,
        coll_bytes=coll_bytes_per_card,
        coll_bytes_net=coll_bytes_net_per_card, model_flops=model_flops,
        model_flops_s=model_flops / (n_cards * hw.peak_flops_bf16))


# ring-model per-card traffic for each collective kind -----------------------
def collective_link_bytes(kind: str, operand_bytes: float,
                          group_size: int) -> float:
    """Per-card bytes that traverse links for one collective, ring
    algorithm.  ``operand_bytes`` is the per-card operand (the local
    shard for an all-gather)."""
    n = max(group_size, 1)
    if n == 1:
        return 0.0
    if kind == "all-reduce":
        return 2.0 * operand_bytes * (n - 1) / n
    if kind in ("all-gather",):
        # operand is the local shard; each card receives (n-1) shards
        return operand_bytes * (n - 1)
    if kind in ("reduce-scatter",):
        return operand_bytes * (n - 1) / n
    if kind in ("all-to-all",):
        return operand_bytes * (n - 1) / n
    if kind in ("collective-permute", "collective-permute-start"):
        return operand_bytes
    return operand_bytes


# --------------------------------------------------------------------------
# Calibration — measured constants for the compiler's place pass
# --------------------------------------------------------------------------
@dataclasses.dataclass
class HostCalibration:
    """The cost constants ``place`` consumes.  ``source`` records where they
    came from: baked-in ``default``s, a fresh ``measured`` run, or the
    on-disk ``cached`` result of an earlier run on this machine."""

    peak_flops: float           # useful numpy FLOP/s of one host core
    queue_hop_s: float          # per-item thread-tier SPSC push+pop cost
    device_dispatch_s: float    # per-microbatch host<->device boundary cost
    # per-item process-lane (shm ring) hop cost
    proc_hop_s: float = 2e-4
    # per-item network-lane (TCP frame) hop cost
    net_hop_s: float = 5e-4
    # per-item cost of the *vectored* process lane (push_many/pop_many
    # amortize the index traffic and the pickling over a batch) — what the
    # batched farm transport actually pays per item
    shm_batched_hop_s: float = 5e-5
    # streaming bandwidth of the slab arena (oversize-ndarray path), GB/s
    arena_bw_gbs: float = 2.0
    # marginal per-stage cost of one extra stage inside a fused device
    # segment: the port's segment runs eagerly, so about one kernel launch
    # a stage, measured as (t_chain(K) - t_chain(1))/(K-1) on the card
    fused_segment_s: float = 2e-6
    # host<->device boundary bandwidths (GB/s), each through the boundary
    # node's own copy path (staging on the host included), and the share
    # of the smaller of transfer and compute the overlapped boundary hides
    h2d_bw_gbs: float = 8.0
    d2h_bw_gbs: float = 8.0
    overlap_eff: float = 0.5
    source: str = "default"

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)

    def proc_hop_effective_s(self) -> float:
        """The per-item process-lane cost placement should charge.  The
        farm transport is batched, so the amortized hop is the honest
        per-item price; capped by ``proc_hop_s`` so a noisy batched probe
        can never make the process tier look *worse* than per-item."""
        return min(self.proc_hop_s, self.shm_batched_hop_s)

    def boundary_time(self, transfer_s: float, compute_s: float) -> float:
        """Cost of one fused device run behind the overlapped boundary:
        ``max(transfer, compute)`` plus the unhidden share of the smaller."""
        lo, hi = min(transfer_s, compute_s), max(transfer_s, compute_s)
        eff = min(1.0, max(0.0, self.overlap_eff))
        return hi + (1.0 - eff) * lo


DEFAULT_CALIBRATION = HostCalibration(
    peak_flops=5e10, queue_hop_s=2e-5, device_dispatch_s=2e-5,
    source="default")

# version 3: net_hop_s (the remote tier) and the device boundary measured
# on the card (fused_segment_s, h2d_bw_gbs, d2h_bw_gbs, overlap_eff)
# joined; version 2: the process tier's proc_hop_s, shm_batched_hop_s and
# arena_bw_gbs — older caches must miss cleanly
_CALIB_VERSION = 3
_calibration: Optional[HostCalibration] = None


def _calib_cache_path() -> str:
    """``REPRO_FF_CACHE`` (the cache directory both packages honour) >
    ``XDG_CACHE_HOME`` > ``~/.cache``; the port's file is
    ``torch_calibration.json``."""
    base = os.environ.get("REPRO_FF_CACHE")
    if not base:
        xdg = os.environ.get("XDG_CACHE_HOME",
                             os.path.join(os.path.expanduser("~"), ".cache"))
        base = os.path.join(xdg, "repro_ff")
    return os.path.join(base, "torch_calibration.json")


def _measure_peak_flops() -> float:
    import numpy as np
    n = 192
    a = np.random.default_rng(0).standard_normal((n, n)).astype(np.float32)
    best = float("inf")
    for _ in range(5):
        t0 = time.perf_counter()
        a @ a
        best = min(best, time.perf_counter() - t0)
    return 2.0 * n ** 3 / max(best, 1e-9)


def _measure_queue_hop() -> float:
    from .queues import SPSCQueue
    q = SPSCQueue(256)
    n = 20_000
    t0 = time.perf_counter()
    for i in range(n):
        q.try_push(i)
        q.try_pop()
    return max((time.perf_counter() - t0) / n, 1e-9)


def _echo_main(in_lane, out_lane) -> None:
    """Calibration child: bounce items straight back (proc-lane hop probe)."""
    from .node import EOS
    while True:
        item = in_lane.pop()
        if item is EOS:
            break
        out_lane.push(item)
    out_lane.push_eos()


def _measure_proc_hop(n: int = 200) -> float:
    import numpy as np
    from .process import _mp_context, _quiet_fork
    from .shm import ShmSPSCQueue
    ping = ShmSPSCQueue(capacity=16)
    pong = ShmSPSCQueue(capacity=16)
    proc = _mp_context().Process(target=_echo_main, args=(ping, pong),
                                 daemon=True, name="ff-calibrate-echo")
    with _quiet_fork():
        proc.start()
    payload = np.arange(64, dtype=np.float32)
    try:
        ping.push(payload, timeout=5.0)         # warm both directions
        pong.pop(timeout=5.0)
        # streaming, not ping-pong: the farm emitter pushes a stream while
        # the collector drains, so the relevant hop cost is the pipelined
        # per-item cost, not the one-item round-trip latency.  Items ride
        # bare, like the farm protocol, so this measures the raw-slab path.
        sent = recv = 0
        deadline = time.monotonic() + 10.0
        t0 = time.perf_counter()
        while recv < n:
            progressed = False
            if sent < n and ping.try_push(payload):
                sent += 1
                progressed = True
            ok, _ = pong.try_pop()
            if ok:
                recv += 1
                progressed = True
            if not progressed:
                if time.monotonic() > deadline:
                    raise TimeoutError("proc-hop calibration stalled")
                time.sleep(1e-6)
        rtt = 2.0 * (time.perf_counter() - t0) / n  # keep rtt/2 == per hop
    finally:
        try:
            ping.push_eos(timeout=1.0)
        except TimeoutError:
            pass
        proc.join(timeout=5.0)
        if proc.is_alive():
            proc.terminate()
        ping.destroy()
        pong.destroy()
    return max(rtt / 2.0, 1e-9)


def _echo_many_main(in_lane, out_lane, batch: int) -> None:
    """Calibration child: bounce items back in vectored batches (batched
    proc-lane hop probe — same pop_many/push_many path the farm workers use)."""
    from .node import EOS
    done = False
    while not done:
        out = []
        for item, _seq in in_lane.pop_many(batch):
            if item is EOS:
                done = True
                break
            out.append(item)
        if out:
            out_lane.push_many(out)
    out_lane.push_eos()


def _measure_shm_batched_hop(n: int = 2000, batch: int = 32) -> float:
    """Per-item cost of the *vectored* process lane: same streaming echo
    shape as :func:`_measure_proc_hop`, but both sides move items with
    ``try_push_many``/``try_pop_many`` so the index traffic and the pickling
    amortize over the batch.  This is what a batched farm hop actually costs
    per item, and what ``place`` should charge for the process tier."""
    from .process import _mp_context, _quiet_fork
    from .shm import ShmSPSCQueue
    ping = ShmSPSCQueue(capacity=64)
    pong = ShmSPSCQueue(capacity=64)
    proc = _mp_context().Process(target=_echo_many_main,
                                 args=(ping, pong, batch),
                                 daemon=True, name="ff-calibrate-echo-many")
    with _quiet_fork():
        proc.start()
    items = list(range(batch))                  # small items: the batch win
    try:
        ping.push_many(items, timeout=5.0)      # warm both directions
        got = 0
        deadline = time.monotonic() + 5.0
        while got < batch:
            got += len(pong.try_pop_many(batch))
            if time.monotonic() > deadline:
                raise TimeoutError("batched-hop calibration warmup stalled")
        sent = recv = 0
        deadline = time.monotonic() + 10.0
        t0 = time.perf_counter()
        while recv < n:
            progressed = False
            if sent < n:
                k = ping.try_push_many(items[:min(batch, n - sent)])
                sent += k
                progressed = progressed or k > 0
            k = len(pong.try_pop_many(batch))
            recv += k
            progressed = progressed or k > 0
            if not progressed:
                if time.monotonic() > deadline:
                    raise TimeoutError("batched-hop calibration stalled")
                time.sleep(1e-6)
        rtt = 2.0 * (time.perf_counter() - t0) / n  # keep rtt/2 == per hop
    finally:
        try:
            ping.push_eos(timeout=1.0)
        except TimeoutError:
            pass
        proc.join(timeout=5.0)
        if proc.is_alive():
            proc.terminate()
        ping.destroy()
        pong.destroy()
    return max(rtt / 2.0, 1e-9)


def _measure_arena_bw(nbytes: int = 4 << 20, reps: int = 5) -> float:
    """Streaming bandwidth (GB/s) of the slab-arena path: one oversize
    ndarray through an arena-backed lane per rep (producer copy in + consumer
    copy out), in-process so it measures memory bandwidth, not scheduling."""
    import numpy as np
    from .shm import ShmSPSCQueue
    q = ShmSPSCQueue(capacity=4, slot_bytes=1024, arena_bytes=2 * nbytes)
    try:
        a = np.zeros(nbytes // 4, dtype=np.float32)
        q.try_push(a)                           # warm the mappings
        q.try_pop()
        best = float("inf")
        for _ in range(reps):
            t0 = time.perf_counter()
            if not q.try_push(a):
                break
            ok, _ = q.try_pop()
            if not ok:
                break
            best = min(best, time.perf_counter() - t0)
        if not (best < float("inf")) or q.arena_pushes == 0:
            return DEFAULT_CALIBRATION.arena_bw_gbs
        return max(nbytes / best / 1e9, 1e-3)
    finally:
        q.destroy()


def _measure_net_hop(n: int = 200) -> float:
    """Per-item network-lane hop cost, measured over loopback TCP with the
    actual frame codec of ``core/net.py`` (raw-ndarray fast path).  Streamed
    pipelined like :func:`_measure_proc_hop` — the remote farm's emitter and
    collector overlap, so the relevant figure is the per-item cost of a full
    round trip divided by two, not one-frame latency."""
    import socket
    import struct
    import threading

    import numpy as np
    try:
        from .net import (TAG_EOS, decode_payload, encode_frame, encode_item,
                          read_frame)
        from .shm import _SLOT_FMT
        ls = socket.create_server(("127.0.0.1", 0))
        port = ls.getsockname()[1]

        def _echo() -> None:
            conn, _peer = ls.accept()
            try:
                conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                while True:
                    fr = read_frame(conn)
                    if fr is None or fr[0] == TAG_EOS:
                        return
                    tag, payload, seq = fr
                    conn.sendall(struct.pack(_SLOT_FMT, len(payload),
                                             tag, seq) + payload)
            finally:
                conn.close()

        echo = threading.Thread(target=_echo, daemon=True,
                                name="ff-calibrate-net-echo")
        echo.start()
        sock = socket.create_connection(("127.0.0.1", port), timeout=5.0)
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        frame = encode_item(np.arange(64, dtype=np.float32))
        try:
            sock.sendall(frame)                 # warm both directions
            read_frame(sock)
            t0 = time.perf_counter()

            def _send() -> None:
                for _ in range(n):
                    sock.sendall(frame)

            sender = threading.Thread(target=_send, daemon=True)
            sender.start()
            for _ in range(n):
                tag, payload, _seq = read_frame(sock)
                decode_payload(tag, payload)
            rtt = (time.perf_counter() - t0) / n
            sender.join(timeout=5.0)
            sock.sendall(encode_frame(TAG_EOS))
        finally:
            sock.close()
            ls.close()
            echo.join(timeout=5.0)
        return max(rtt / 2.0, 1e-9)
    except Exception:   # noqa: BLE001 - no loopback here: keep the default
        return DEFAULT_CALIBRATION.net_hop_s


def measure_cuda_dispatch(n: int = 200) -> float:
    """Seconds the card takes per launch of a tiny kernel, back to back,
    timed with CUDA events (what one extra device step costs)."""
    import torch
    x = torch.zeros(8, device="cuda")
    for _ in range(10):
        x.add_(1.0)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(n):
        x.add_(1.0)
    end.record()
    end.synchronize()
    return max(start.elapsed_time(end) * 1e-3 / n, 1e-9)


# The device boundary's constants, each timed through the path the boundary
# node (``compiler._DeviceStageNode``) really takes: its host stacking and
# side-stream copy in (``graph._to_device``), its pinned copy out
# (``graph._Landing``) and its copy streams (``graph._copy_streams``).
# Host time around a synchronise: the host pays for the staging too.
# Without a card each returns its default, as nothing here can be timed.
def _card() -> Any:
    import torch
    if not torch.cuda.is_available():
        return None
    return torch.device("cuda", torch.cuda.current_device())


def _host_best(fn: Callable[[], Any], reps: int) -> float:
    import torch
    fn()                                        # warm the path
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        best = min(best, time.perf_counter() - t0)
    return best


def _measure_fused_segment(k: int = 4) -> float:
    """Marginal per-stage cost inside one device segment: an eager
    ``k``-stage chain on the card against a 1-stage one (one kernel a
    stage), each synchronised, best of 5, the extra over ``k - 1``.  The
    port's fused segment runs eagerly, so this is about one launch a
    stage."""
    import torch
    dev = _card()
    if dev is None:
        return DEFAULT_CALIBRATION.fused_segment_s
    x = torch.zeros(8, device=dev)

    def chain(n: int) -> Callable[[], Any]:
        def run() -> Any:
            y = x
            for _ in range(n):
                y = y.mul(1.0001)
            return y
        return run

    t1 = _host_best(chain(1), 5)
    tk = _host_best(chain(k), 5)
    return max((tk - t1) / (k - 1), 1e-9)


_BOUNDARY_ROWS = 512     # items a measured microbatch stacks (phase 4's)


def _boundary_batch(nbytes: int) -> list:
    import numpy as np
    cols = max(1, nbytes // 4 // _BOUNDARY_ROWS)
    return list(np.zeros((_BOUNDARY_ROWS, cols), dtype=np.float32))


def _measure_h2d_bw(nbytes: int = 4 << 20, reps: int = 5) -> float:
    """Host->device boundary bandwidth (GB/s): an ``nbytes`` float32 batch
    of ``_BOUNDARY_ROWS`` items stacked and copied in by
    ``graph._to_device`` on an h2d side stream, best of ``reps`` on the
    host clock."""
    from .graph import _copy_streams, _to_device
    dev = _card()
    if dev is None:
        return DEFAULT_CALIBRATION.h2d_bw_gbs
    items = _boundary_batch(nbytes)
    h2d, _d2h = _copy_streams(dev, 2)
    best = _host_best(lambda: _to_device(items, dev, h2d), reps)
    return max(nbytes / max(best, 1e-9) / 1e9, 1e-3)


def _measure_d2h_bw(nbytes: int = 4 << 20, reps: int = 5) -> float:
    """Device->host boundary bandwidth (GB/s): an ``nbytes`` float32 batch
    on the card copied out through ``graph._Landing`` (a d2h side stream
    into pinned buffers, then the host copy out of them), best of
    ``reps`` on the host clock."""
    import torch

    from .graph import _copy_streams, _Landing
    dev = _card()
    if dev is None:
        return DEFAULT_CALIBRATION.d2h_bw_gbs
    ys = torch.zeros(nbytes // 4, dtype=torch.float32, device=dev)
    _h2d, d2h = _copy_streams(dev, 2)
    best = _host_best(lambda: _Landing(ys, d2h).wait(), reps)
    return max(nbytes / max(best, 1e-9) / 1e9, 1e-3)


def _measure_overlap_eff(k: int = 8, reps: int = 3,
                         nbytes: int = 4 << 20) -> float:
    """Overlap efficiency of the overlapped boundary on this card: ``k``
    microbatches (copy in, one matmul the size of the batch, copy out)
    submitted through the copy streams of ``graph._copy_streams`` with one
    wait at the end, against the same ``k`` each waited for before the next
    is submitted.  ``1 - window/serial`` is the share of the serial time
    the window hides, clamped to [0, 1]."""
    import torch

    from .graph import _copy_streams, _Landing, _to_device
    dev = _card()
    if dev is None:
        return DEFAULT_CALIBRATION.overlap_eff
    items = _boundary_batch(nbytes)
    cols = items[0].shape[0]
    w = torch.randn(cols, cols, generator=torch.Generator().manual_seed(0)
                    ).to(dev) * cols ** -0.5
    h2d, d2h = _copy_streams(dev, k)

    def submit() -> Any:
        return _Landing(torch.tanh(_to_device(items, dev, h2d) @ w), d2h)

    def serial() -> None:
        for _ in range(k):
            submit().wait()

    def window() -> None:
        for landing in [submit() for _ in range(k)]:
            landing.wait()

    t_serial = _host_best(serial, reps)
    t_window = _host_best(window, reps)
    if not 0.0 < t_serial < float("inf"):
        return DEFAULT_CALIBRATION.overlap_eff
    return min(1.0, max(0.0, 1.0 - t_window / t_serial))


def calibrate(cache: bool = True) -> HostCalibration:
    """Measure the constants on this machine and (optionally) persist them:
    one core's numpy FLOP/s, the thread-queue hop, the shared-memory
    process-lane hop per item and batched (an echo child forked for each),
    the slab arena's bandwidth, the loopback network-lane hop, and — where
    a CUDA device exists — the dispatch cost and the device boundary's
    (the fused segment's marginal stage, the copy bandwidths each way, the
    overlap efficiency).  An unwritable cache location keeps the constants
    in memory with a warning.  The file's observed-cost and autotune tables
    are kept."""
    global _calibration
    import torch
    c = HostCalibration(
        peak_flops=_measure_peak_flops(),
        queue_hop_s=_measure_queue_hop(),
        device_dispatch_s=(measure_cuda_dispatch()
                           if torch.cuda.is_available()
                           else DEFAULT_CALIBRATION.device_dispatch_s),
        proc_hop_s=_measure_proc_hop(),
        net_hop_s=_measure_net_hop(),
        shm_batched_hop_s=_measure_shm_batched_hop(),
        arena_bw_gbs=_measure_arena_bw(),
        fused_segment_s=_measure_fused_segment(),
        h2d_bw_gbs=_measure_h2d_bw(),
        d2h_bw_gbs=_measure_d2h_bw(),
        overlap_eff=_measure_overlap_eff(),
        source="measured")
    _calibration = c
    if cache:
        # the observed and autotune tables ride in the same file: a fresh
        # calibration must not erase what earlier runs observed
        _save_cache_tables("the calibration")
    return c


def _read_cache() -> dict:
    try:
        with open(_calib_cache_path()) as f:
            d = json.load(f)
    except (OSError, ValueError):
        return {}
    return d if isinstance(d, dict) and d.get("version") == _CALIB_VERSION \
        else {}


def _load_cached_calibration() -> Optional[HostCalibration]:
    d = _read_cache()
    if d.get("cpu_count") != os.cpu_count():
        return None
    try:
        return HostCalibration(
            **{f.name: float(d[f.name])
               for f in dataclasses.fields(HostCalibration)
               if f.name != "source"}, source="cached")
    except (KeyError, TypeError, ValueError):
        return None


def get_calibration(measure: bool = True) -> HostCalibration:
    """The process-wide calibration: memoized, then the on-disk cache, then a
    fresh :func:`calibrate` run (skipped when ``measure=False``, which
    returns the baked-in defaults instead)."""
    global _calibration
    if _calibration is not None:
        return _calibration
    cached = _load_cached_calibration()
    if cached is not None:
        _calibration = cached
        return cached
    if not measure:
        return DEFAULT_CALIBRATION
    return calibrate()


def fn_key(fn) -> Optional[str]:
    """Stable-ish identity for a worker callable in the observed-cost table
    (``module.qualname``), as the farms' stats report it.  None for objects
    without one (partials, odd callables) — those simply never match an
    observation."""
    mod = getattr(fn, "__module__", None)
    qn = getattr(fn, "__qualname__", None)
    if not mod or not qn:
        return None
    return f"{mod}.{qn}"


def reset_calibration() -> None:
    """Drop the in-memory calibration (tests)."""
    global _calibration
    _calibration = None


# --------------------------------------------------------------------------
# Online refinement — runner stats fed back into the calibration cache
# --------------------------------------------------------------------------
# ``observe()`` folds runtime stats (sampled by core/runtime.Supervisor, or
# passed in by hand) into the channel constants (the shared-memory hop EMA)
# and into a per-callable table of measured service times and GIL signals,
# so the *next* compile()'s annotate/place pass starts from what actually
# happened rather than a fresh sample probe.  The table is keyed by
# ``fn_key`` (module.qualname: stable across runs of the same code,
# best-effort across edits) and persists in the port's own cache file.

_OBSERVE_MIN_ITEMS = 8      # ignore records with fewer processed items
_observed: Optional[Dict[str, dict]] = None


def _load_observed() -> Dict[str, dict]:
    global _observed
    if _observed is None:
        d = _read_cache()
        obs = d.get("observed")
        _observed = ({str(k): dict(v) for k, v in obs.items()
                      if isinstance(v, dict)}
                     if isinstance(obs, dict)
                     and d.get("cpu_count") == os.cpu_count() else {})
    return _observed


def lookup_observed(key: Optional[str],
                    min_items: int = _OBSERVE_MIN_ITEMS) -> Optional[dict]:
    """The observed cost record for a callable key, or None when there is no
    (sufficiently substantiated) history.  Consumed by the compiler's
    ``annotate`` stage: a callable with runtime history no longer needs a
    ``sample=`` probe to be cost-placed."""
    if not key:
        return None
    rec = _load_observed().get(key)
    if rec and rec.get("items", 0) >= min_items \
            and float(rec.get("t_task", 0.0)) > 0.0:
        return dict(rec)
    return None


def reset_observed() -> None:
    """Drop the in-memory observed-cost table (tests)."""
    global _observed
    _observed = None


def _save_cache_tables(what: str = "observed costs") -> None:
    """Persist the calibration and the observed and autotune tables into
    the one cache file; a read-only location degrades to in-memory with a
    warning."""
    path = _calib_cache_path()
    c = get_calibration(measure=False)
    try:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w") as f:
            json.dump({"version": _CALIB_VERSION,
                       "cpu_count": os.cpu_count(), **c.as_dict(),
                       "observed": _load_observed(),
                       "autotune": _load_autotune()}, f)
    except OSError as e:
        warnings.warn(
            f"perf_model: calibration cache {path!r} is not writable ({e}); "
            f"keeping {what} in memory only",
            RuntimeWarning, stacklevel=2)


def _save_observed() -> None:
    _save_cache_tables("observed costs")


def _stat_records(x, out: list) -> None:
    """Collect node-stat dicts from an arbitrarily nested stats() tree."""
    if isinstance(x, dict):
        if "svc_cpu_ema_s" in x or "hop_ema_s" in x or "fn_key" in x:
            out.append(x)
        for v in x.values():
            _stat_records(v, out)
    elif isinstance(x, (list, tuple)):
        for v in x:
            _stat_records(v, out)


def observe(stats: dict, alpha: float = 0.25, write: bool = False) -> int:
    """Fold one ``runner.stats()`` snapshot (or any nested stats tree) into
    the calibration state; returns the number of facts absorbed.

    - farm records carrying a ``fn_key`` and a per-item CPU-time EMA update
      the observed per-callable service time — thread-tier records from the
      parent's own measurement, process-tier records from the worker-side
      :class:`~repro_torch.core.shm.WorkerStats` CPU clocks shipped back
      over the result lanes; a thread record's ``gil_ratio`` (CPU/wall)
      measured under >=2 concurrently active workers also settles the
      callable's GIL signal — below 0.7 the workers were serializing on the
      GIL (``releases_gil=False``), above 0.9 they truly ran in parallel
      (``True``); remote-tier records carry the same worker-side CPU clocks
      shipped back over the network lanes;
    - process-tier records with a parent-side ``hop_ema_s`` refine the
      calibrated shared-memory lane hop with an EMA; remote-tier records
      refine the network-lane hop (``net_hop_s``) the same way.

    ``write=True`` persists the refreshed calibration + observed table into
    the on-disk cache (the supervisor writes once at ``stop()``; periodic
    in-memory merges stay cheap)."""
    global _calibration
    recs: list = []
    _stat_records(stats, recs)
    table = _load_observed()
    absorbed = 0
    for r in recs:
        items = int(r.get("items", 0) or 0)
        if items < _OBSERVE_MIN_ITEMS:
            continue
        key = r.get("fn_key")
        cpu = float(r.get("svc_cpu_ema_s", 0.0) or 0.0)
        backend = r.get("backend")
        if key and cpu > 0.0 and backend in ("thread", "process", "remote"):
            prev = table.get(key)
            rg = prev.get("releases_gil") if prev else None
            ratio = r.get("gil_ratio")     # thread records only
            if ratio is not None and int(r.get("active", 1) or 1) >= 2:
                if ratio < 0.7:
                    rg = False
                elif ratio > 0.9:
                    rg = True
            t = cpu if prev is None else \
                (1.0 - alpha) * float(prev["t_task"]) + alpha * cpu
            table[key] = {"t_task": t, "releases_gil": rg,
                          "items": max(items, prev["items"] if prev else 0)}
            absorbed += 1
        hop = float(r.get("hop_ema_s", 0.0) or 0.0)
        if hop > 0.0 and backend in ("process", "remote"):
            c = get_calibration(measure=False)
            if backend == "process":
                c = dataclasses.replace(
                    c, proc_hop_s=(1.0 - alpha) * c.proc_hop_s + alpha * hop,
                    source="observed")
            else:
                c = dataclasses.replace(
                    c, net_hop_s=(1.0 - alpha) * c.net_hop_s + alpha * hop,
                    source="observed")
            _calibration = c
            absorbed += 1
    if write and absorbed:
        _save_observed()
    return absorbed


# --------------------------------------------------------------------------
# Autotuned window depths (and, later, tiles), kept in the same cache file
# --------------------------------------------------------------------------
_autotune: Optional[Dict[str, dict]] = None


def _load_autotune() -> Dict[str, dict]:
    global _autotune
    if _autotune is None:
        at = _read_cache().get("autotune")
        _autotune = ({str(k): dict(v) for k, v in at.items()
                      if isinstance(v, dict)} if isinstance(at, dict) else {})
    return _autotune


def lookup_autotuned(key: Optional[str]) -> Optional[dict]:
    """The autotuned record for a key (e.g. ``"device_overlap:window"``),
    or None — callers fall back to their default and never sweep."""
    if not key:
        return None
    rec = _load_autotune().get(key)
    return dict(rec) if rec else None


def record_autotuned(entries: Dict[str, dict], write: bool = True) -> int:
    """Merge sweep winners into the autotune table; ``write=True`` persists
    them (with the calibration + observed tables) into the on-disk cache.
    Returns the number of records absorbed."""
    table = _load_autotune()
    n = 0
    for k, v in entries.items():
        if isinstance(v, dict):
            table[str(k)] = dict(v)
            n += 1
    if write and n:
        _save_cache_tables("autotune results")
    return n


def reset_autotuned() -> None:
    """Drop the in-memory autotune table (tests)."""
    global _autotune
    _autotune = None
