"""L1/L2 — streaming-network channels (FastFlow Sec. 2, layers 1-2).

FastFlow's first layer is a lock-free SPSC ring buffer on shared memory; its
second layer composes SPMC/MPSC/MPMC networks out of SPSC queues.  On the host
side of this framework the same structure carries data-pipeline batches and
serving requests.  This module is the *thread-tier* instance: CPython's GIL
makes single-word index updates atomic, so the ring below is wait-free in the
same sense as FastFlow's — the producer only writes ``_tail``, the consumer
only writes ``_head``, and neither takes a lock on the fast path.

The host tier has three backends, all carrying the same channel structure:

- **threads** (this module): cheapest hop; real parallelism only for stages
  that release the GIL (I/O, large BLAS calls, jitted device dispatch);
- **processes** (``core/shm.py``): the same fixed-slot SPSC ring laid out in
  ``multiprocessing.shared_memory`` — FastFlow's actual multicore story —
  so CPU-bound Python/numpy stages scale with cores; the staged compiler's
  ``place`` pass picks it from a measured GIL-sensitivity signal and
  startup-calibrated hop costs (``perf_model.calibrate``);
- **device** (``core/device.py``, ``kernels/``): collective_permute ring
  edges and Pallas double-buffered VMEM tiles, the mesh-side analogue.
"""

from __future__ import annotations

import threading
import time
from typing import Any, List, Optional, Sequence


class QueueClosed(Exception):
    """Raised when pushing to / popping from a closed-and-drained queue."""


class SPSCQueue:
    """Bounded single-producer single-consumer ring buffer.

    Wait-free push/pop (no locks on the fast path); ``push``/``pop`` offer
    blocking convenience wrappers with exponential backoff, mirroring
    FastFlow's ``ff_send_out(task, retry, ticks)`` semantics.
    """

    def __init__(self, capacity: int = 512):
        if capacity < 2:
            raise ValueError("capacity must be >= 2")
        self._cap = capacity
        self._buf: List[Any] = [None] * capacity
        self._head = 0  # consumer-owned
        self._tail = 0  # producer-owned
        self._closed = False
        self.max_depth = 0              # producer-side high-water mark

    # -- non-blocking primitives (the lock-free layer) ----------------------
    def try_push(self, item: Any) -> bool:
        nxt = (self._tail + 1) % self._cap
        if nxt == self._head:           # full
            return False
        self._buf[self._tail] = item
        self._tail = nxt                # single atomic publish
        depth = (nxt - self._head) % self._cap
        if depth > self.max_depth:
            self.max_depth = depth
        return True

    def try_pop(self) -> tuple[bool, Any]:
        if self._head == self._tail:    # empty
            return False, None
        item = self._buf[self._head]
        self._buf[self._head] = None
        self._head = (self._head + 1) % self._cap
        return True, item

    def __len__(self) -> int:
        return (self._tail - self._head) % self._cap

    @property
    def capacity(self) -> int:
        return self._cap - 1

    def empty(self) -> bool:
        return self._head == self._tail

    # -- blocking wrappers ---------------------------------------------------
    def push(self, item: Any, timeout: Optional[float] = None) -> None:
        deadline = None if timeout is None else time.monotonic() + timeout
        delay = 1e-6
        while True:
            # closed first: a closed queue refuses new items even when slots
            # remain (the stream is ended; accepting would strand the item)
            if self._closed:
                raise QueueClosed("push to closed queue")
            if self.try_push(item):
                return
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError("SPSC push timed out")
            time.sleep(delay)
            delay = min(delay * 2, 1e-3)

    def pop(self, timeout: Optional[float] = None) -> Any:
        deadline = None if timeout is None else time.monotonic() + timeout
        delay = 1e-6
        while True:
            ok, item = self.try_pop()
            if ok:
                return item
            if self._closed:
                raise QueueClosed("pop from closed empty queue")
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError("SPSC pop timed out")
            time.sleep(delay)
            delay = min(delay * 2, 1e-3)

    def close(self) -> None:
        self._closed = True

    @property
    def closed(self) -> bool:
        return self._closed

    def drained(self) -> bool:
        """Closed with nothing left to pop."""
        return self._closed and self._head == self._tail


class SPMCQueue:
    """Single producer, multiple consumers: one SPSC lane per consumer.

    The producer selects the destination lane; the default policy is
    round-robin (FastFlow's default farm scheduling).  ``select`` may be
    overridden by a load balancer (see core/skeletons.py).
    """

    def __init__(self, n_consumers: int, capacity: int = 512):
        self.lanes = [SPSCQueue(capacity) for _ in range(n_consumers)]
        self._rr = 0

    def push_to(self, idx: int, item: Any, timeout: Optional[float] = None) -> None:
        self.lanes[idx].push(item, timeout)

    def push_rr(self, item: Any, timeout: Optional[float] = None) -> int:
        idx = self._rr
        self.lanes[idx].push(item, timeout)
        self._rr = (self._rr + 1) % len(self.lanes)
        return idx

    def push_ondemand(self, item: Any, threshold: int = 1,
                      timeout: Optional[float] = None) -> int:
        """FastFlow Sec. 8.3.2: deliver to the first lane with <= threshold
        queued items; BLOCK until a lane qualifies (the emitter waits for a
        worker to 'ask' — auto-scheduling)."""
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            for i, lane in enumerate(self.lanes):
                if len(lane) <= threshold and lane.try_push(item):
                    return i
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError("SPMC on-demand push timed out")
            time.sleep(1e-5)

    def broadcast(self, item: Any, timeout: Optional[float] = None) -> None:
        for lane in self.lanes:
            lane.push(item, timeout)

    def close_all(self) -> None:
        """Close every lane: consumers drain what is queued, then their
        ``pop`` raises :class:`QueueClosed`; further pushes are refused."""
        for lane in self.lanes:
            lane.close()


class MPSCQueue:
    """Multiple producers, single consumer: one SPSC lane per producer; the
    consumer drains lanes fairly (FastFlow collector gathering policy)."""

    def __init__(self, n_producers: int, capacity: int = 512):
        self.lanes = [SPSCQueue(capacity) for _ in range(n_producers)]
        self._next = 0

    def lane(self, idx: int) -> SPSCQueue:
        return self.lanes[idx]

    def try_pop_any(self) -> tuple[bool, Any, int]:
        n = len(self.lanes)
        for off in range(n):
            i = (self._next + off) % n
            ok, item = self.lanes[i].try_pop()
            if ok:
                self._next = (i + 1) % n
                return True, item, i
        return False, None, -1

    def pop_any(self, timeout: Optional[float] = None) -> tuple[Any, int]:
        deadline = None if timeout is None else time.monotonic() + timeout
        delay = 1e-6
        while True:
            ok, item, i = self.try_pop_any()
            if ok:
                return item, i
            if all(lane.drained() for lane in self.lanes):
                raise QueueClosed("pop from closed and drained MPSC network")
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError("MPSC pop timed out")
            time.sleep(delay)
            delay = min(delay * 2, 1e-3)

    def close_all(self) -> None:
        """Close every producer lane; once drained, ``pop_any`` raises
        :class:`QueueClosed` instead of spinning to ``TimeoutError``."""
        for lane in self.lanes:
            lane.close()


class MPMCQueue:
    """Multiple producers, multiple consumers, composed of SPSC lanes
    (producer i -> consumer j), as in FastFlow layer 2.  Device-side this is
    the all-to-all used by the MoE farm."""

    def __init__(self, n_producers: int, n_consumers: int, capacity: int = 128):
        self.grid = [[SPSCQueue(capacity) for _ in range(n_consumers)]
                     for _ in range(n_producers)]
        self._next = [0] * n_consumers

    def push(self, producer: int, consumer: int, item: Any,
             timeout: Optional[float] = None) -> None:
        self.grid[producer][consumer].push(item, timeout)

    def pop(self, consumer: int, timeout: Optional[float] = None) -> tuple[Any, int]:
        deadline = None if timeout is None else time.monotonic() + timeout
        delay = 1e-6
        n_prod = len(self.grid)
        while True:
            for off in range(n_prod):
                i = (self._next[consumer] + off) % n_prod
                ok, item = self.grid[i][consumer].try_pop()
                if ok:
                    self._next[consumer] = (i + 1) % n_prod
                    return item, i
            if all(row[consumer].drained() for row in self.grid):
                raise QueueClosed(
                    "pop from closed and drained MPMC column")
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError("MPMC pop timed out")
            time.sleep(delay)
            delay = min(delay * 2, 1e-3)

    def close_all(self) -> None:
        """Close every lane in the grid; a consumer whose column is closed
        and drained gets :class:`QueueClosed` from ``pop`` instead of
        spinning to ``TimeoutError``."""
        for row in self.grid:
            for lane in row:
                lane.close()
