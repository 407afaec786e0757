"""FastFlow *software accelerator* mode (paper Sec. 9), with a CUDA device
as the accelerator.

Port of ``src/repro/core/accelerator.py:JaxAccelerator``.  The paper's
accelerator replaces ``y = f(x)`` with::

    acc.run_then_freeze(); acc.offload(x); ...; ok, y = acc.load_result()

Here ``f`` is a PyTorch function of tensors.  A dispatcher thread issues
each call on a CUDA stream of its own and never waits for the card: the
stream is the offload queue, as JAX's asynchronous dispatch is in the
reference.  A bounded host SPSC queue gives the back-pressure, so the host
cannot run unboundedly ahead of the device — the role of the bounded
lock-free queue in FastFlow.

Numpy and CPU-tensor inputs are copied into pinned memory and from there to
the card with ``non_blocking=True`` on a second stream, so the next task's
copy overlaps this task's call, which waits for its own copy's event; an
event recorded after ``f`` marks the result ready.  ``load_result`` makes the
caller's current stream wait on that event (where the reference blocks in
``jax.block_until_ready``) and marks the result's tensors as used there, so
the caching allocator does not hand their memory to the dispatcher's
stream while the caller's work still reads them.  On the CPU
(``device="cpu"``) the dispatcher calls ``f`` inline.
"""

from __future__ import annotations

import collections
import threading
import time
import traceback
from typing import Any, Callable, Optional

import numpy as np
import torch

from .node import EOS
from .plan import resolve_device
from .queues import SPSCQueue
from .tree import canonical_dtype, tree_leaves, tree_map


class _Offloaded:
    """One result in flight: the value ``fn`` returned and the event
    recorded after it on the dispatcher's stream (None on the CPU)."""

    __slots__ = ("value", "event")

    def __init__(self, value: Any, event: Optional[torch.cuda.Event]):
        self.value, self.event = value, event


class TorchAccelerator:
    """Offload ``fn(*task)`` calls onto a CUDA device asynchronously.

    - ``run_then_freeze()``  start the dispatcher thread
    - ``offload(task)``      enqueue a task (a tuple of args for ``fn``)
    - ``offload(FF_EOS)``    signal end-of-stream
    - ``load_result()``      blocking: (ok, result); ok=False after EOS
    - ``load_result_nb()``   non-blocking variant
    - ``wait()``             join; returns 0/-1 like run_and_wait_end

    ``device`` defaults to ``cuda:0`` and raises without CUDA unless the
    caller names the CPU.  Numpy arrays among a task's leaves reach ``fn``
    as tensors on the device (64-bit types narrowed as ``jnp.asarray``
    narrows them), CPU tensors are copied there, and other leaves pass as
    they are."""

    def __init__(self, fn: Callable, max_inflight: int = 8,
                 device: Any = None):
        self._fn = fn
        self.device = resolve_device(device)
        self._in: SPSCQueue = SPSCQueue(max(2, max_inflight))
        self._out: SPSCQueue = SPSCQueue(4096)
        self._thread: Optional[threading.Thread] = None
        self.error: Optional[BaseException] = None
        self._t0 = self._t1 = 0.0
        self.offloaded = 0

    # -- paper API -------------------------------------------------------------
    def run_then_freeze(self) -> int:
        self._t0 = time.perf_counter()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="torch-accelerator")
        self._thread.start()
        return 0

    def offload(self, task: Any) -> None:
        if task is not EOS:
            # the call is ordered after what the caller's stream queued
            # before the offload: device inputs, and tensors ``fn`` reads
            # from its closure
            ready = None
            if self.device.type == "cuda":
                ready = torch.cuda.Event()
                ready.record(torch.cuda.current_stream(self.device))
            task = (task, ready)
        self._in.push(task)
        if task is not EOS:
            self.offloaded += 1

    def load_result(self, timeout: Optional[float] = None) -> tuple[bool, Any]:
        item = self._out.pop(timeout)
        if item is EOS:
            return False, None
        return True, self._ready(item)

    def load_result_nb(self) -> tuple[bool, Any]:
        ok, item = self._out.try_pop()
        if not ok or item is EOS:
            return False, None
        return True, self._ready(item)

    def wait(self, timeout: Optional[float] = None) -> int:
        if self._thread is not None:
            self._thread.join(timeout)
        self._t1 = time.perf_counter()
        return -1 if self.error is not None else 0

    def ffTime(self) -> float:
        return (self._t1 - self._t0) * 1e3

    # -- the caller's side ---------------------------------------------------
    def _ready(self, item: _Offloaded) -> Any:
        """The result, ordered after ``fn`` on the caller's current stream."""
        if item.event is None:
            return item.value
        stream = torch.cuda.current_stream(self.device)
        stream.wait_event(item.event)
        for t in tree_leaves(item.value):
            if isinstance(t, torch.Tensor) and t.is_cuda:
                t.record_stream(stream)
        return item.value

    # -- dispatcher ----------------------------------------------------------
    def _to_device(self, x: Any, stream: Optional[torch.cuda.Stream],
                   held: list) -> Any:
        """A task's leaf as ``fn`` takes it; a host tensor is copied on the
        current (copy) stream and marked as used on ``stream``, which
        reads it."""
        if isinstance(x, np.ndarray):
            x = torch.from_numpy(np.ascontiguousarray(
                x, dtype=canonical_dtype(x.dtype)))
        if not isinstance(x, torch.Tensor) or stream is None:
            return x
        if not x.is_cuda:
            pinned = x.pin_memory()
            held.append(pinned)
            x = pinned.to(self.device, non_blocking=True)
        x.record_stream(stream)
        return x

    def _loop(self) -> None:
        cuda = self.device.type == "cuda"
        stream = copy = None
        # pinned host buffers, each kept until the event after its copy
        held: collections.deque = collections.deque()
        try:
            if cuda:
                torch.cuda.set_device(self.device)
                stream = torch.cuda.Stream(self.device)
                copy = torch.cuda.Stream(self.device)
            while True:
                task = self._in.pop()
                if task is EOS:
                    break
                task, ready = task
                args = task if isinstance(task, tuple) else (task,)
                if not cuda:
                    self._out.push(_Offloaded(
                        self._fn(*tree_map(
                            lambda x: self._to_device(x, None, []), args)),
                        None))
                    continue
                while held and held[0][0].query():
                    held.popleft()
                buffers: list = []
                with torch.cuda.stream(copy):
                    copy.wait_event(ready)
                    dev_args = tree_map(
                        lambda x: self._to_device(x, stream, buffers), args)
                    copied = torch.cuda.Event()
                    copied.record(copy)
                held.append((copied, buffers))
                with torch.cuda.stream(stream):
                    stream.wait_event(copied)
                    # queued on the stream, not waited for
                    result = self._fn(*dev_args)
                    event = torch.cuda.Event()
                    event.record(stream)
                self._out.push(_Offloaded(result, event))
        except BaseException as e:  # noqa: BLE001 - reported through wait()
            self.error = e
            traceback.print_exc()
        finally:
            self._out.push(EOS)
            # the last copies may still be running: their pinned buffers
            # outlive them
            if held:
                held[-1][0].synchronize()
            held.clear()
