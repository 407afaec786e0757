"""Host data pipeline = an FFGraph program carrying real traffic.

Port of ``src/repro/data/pipeline.py`` (``_ReaderNode``,
``_DevicePutNode``, ``DataPipeline``, ``make_pipeline``).  A building-blocks
pipeline feeds the training loop:

    pipeline( Reader source[, compute stage], DevicePut stage )

compiled through the staged graph compiler (``FFGraph.compile``).  The
reader and the device-put boundary stay host-placed (stateful nodes over
SPSC queues), and the runner's bounded results queue gives back-pressure:
the device never waits on the host unless the host falls behind, and the
host never runs unboundedly ahead.

The device put copies each batch into pinned host memory and from there to
the card with ``non_blocking=True``, on a CUDA stream of its own, and
records an event after the copies.  ``get()`` makes the caller's current
stream wait on that event (and marks the tensors as used there), so the
step that reads the batch is ordered after its copy whatever stream the
training loop runs on, while the copy of the next batch overlaps the step.
The pinned buffers travel with the batch until ``get()`` has ordered it;
PyTorch's pinned-memory allocator then keeps each buffer from reuse until
its copy has run.

Where the reference places an optional pure ``compute`` stage after the
device put (so its compiler may place it on the mesh), the port runs it
before: it transforms the host batch, and the compiler may still place it
on the card (its results come back to the host).

With ``compute_workers > 1`` the compute stage becomes a *process-placed
farm* before the device put, as in the reference: OS-process workers over
shared-memory SPSC lanes (``core.process.ProcessFarmNode``), so CPU-bound
augmentation scales with cores instead of serializing on the GIL.  The
process farm's collector reorders by sequence number, which is what
licenses farming here at all: the training loop consumes an ordered stream
and the checkpoint cursor assumes it (a *thread* farm's collector is
arrival-ordered and must keep width 1).  The workers are forked from a
process that may have initialised CUDA, so ``compute`` must be a numpy
function of the batch dict and never touch torch; only the parent's device
put makes tensors.

With ``adaptive=True`` the farm lowers into an
:class:`~repro_torch.core.runtime.AdaptiveFarmNode` and a
:class:`~repro_torch.core.runtime.Supervisor` samples the runner: it
re-places the compute farm live (width, thread/process tier) from observed
stats and feeds ``perf_model.observe`` so the next compile's placement
improves.  The ordered-stream contract holds: an adaptive farm's collector
is sequence-ordered on both tiers.  ``stop()`` joins the supervisor and
persists what it observed.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Union

import numpy as np
import torch

from ..core.compiler import CompileConfig
from ..core.graph import (FFGraph, farm as ff_farm, pipeline as ff_pipeline,
                          seq as ff_seq)
from ..core.node import FFNode
from ..core.plan import resolve_device, single_device_plan
from ..core.runtime import Supervisor
from ..core.tree import canonical_dtype

class _ReaderNode(FFNode):
    def __init__(self, source, n_batches: Optional[int]):
        super().__init__()
        self.source = source
        self.n = n_batches
        self.emitted = 0

    def svc(self, _):
        if self.n is not None and self.emitted >= self.n:
            return None
        self.emitted += 1
        return self.source.next_batch()


class _Staged:
    """A batch whose copies to the card are queued on the device-put
    node's stream: the device tensors, the event recorded after the
    copies, and the pinned host buffers they are copied from."""

    __slots__ = ("tensors", "event", "pinned")

    def __init__(self, tensors: Dict[str, torch.Tensor], event, pinned):
        self.tensors, self.event, self.pinned = tensors, event, pinned

    def ready(self) -> Dict[str, torch.Tensor]:
        """The tensors, ordered after their copies on the current stream."""
        stream = torch.cuda.current_stream(self.event.device)
        stream.wait_event(self.event)
        for t in self.tensors.values():
            t.record_stream(stream)
        return self.tensors


class _DevicePutNode(FFNode):
    """Moves a host batch onto the device, each array in the type
    ``jnp.asarray`` gives it (the emitter's scatter on one device)."""

    def __init__(self, device: torch.device):
        super().__init__()
        self.device = device
        self._stream = None

    def svc(self, batch):
        host = {k: torch.from_numpy(np.ascontiguousarray(
                    v, dtype=canonical_dtype(np.asarray(v).dtype)))
                for k, v in batch.items()}
        if self.device.type != "cuda":
            return {k: t.to(self.device, copy=True) for k, t in host.items()}
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        pinned = {k: t.pin_memory() for k, t in host.items()}
        with torch.cuda.stream(self._stream):
            out = {k: t.to(self.device, non_blocking=True)
                   for k, t in pinned.items()}
            event = torch.cuda.Event()
            event.record(self._stream)
        return _Staged(out, event, pinned)


class DataPipeline:
    """run_then_freeze()-style accelerator interface: the training loop just
    calls ``get()``; EOS -> None.  ``self.graph`` is the FFGraph program and
    ``self.placements`` the compiler's per-stage decisions.  ``device``
    defaults to ``cuda:0`` and raises without a card unless the caller
    names the CPU.

    ``shm_slot_bytes`` sizes the process farm's shared-memory slots (a
    pickled batch dict rides one slot: the default 1 MiB holds ~256k int32
    tokens); ``transport`` (a :class:`~repro_torch.core.shm.TransportConfig`
    or a dict of its fields) tunes its lanes in full and overrides it."""

    def __init__(self, source, device: Any = None,
                 n_batches: Optional[int] = None, prefetch: int = 2,
                 compute: Optional[Callable] = None, plan=None,
                 compute_workers: Union[int, str] = 1,
                 shm_slot_bytes: int = 1 << 20, adaptive: bool = False,
                 transport: Optional[Any] = None):
        self.source = source
        self.device = resolve_device(device)
        placements = None
        stages = [_ReaderNode(source, n_batches)]
        if compute is not None and compute_workers not in (None, 1):
            # a farm is only admissible here when its collector keeps the
            # stream ordered: the process tier reorders by sequence
            # number, so pin the stage there.  Worker processes transform
            # raw numpy batches; only the parent touches the card.
            stages.append(ff_farm(compute, n=compute_workers))
            placements = {compute: "host_process"}
        elif compute is not None:
            stages.append(ff_seq(compute, pure=True))
        stages.append(_DevicePutNode(self.device))
        self.graph: FFGraph = ff_pipeline(*stages)
        self._runner = self.graph.compile(config=CompileConfig(
            plan=plan if compute is not None else None,
            capacity=max(2, prefetch), results_capacity=max(2, prefetch),
            device_batch=1, placements=placements,
            shm_slot_bytes=shm_slot_bytes, adaptive=adaptive,
            transport=transport, overlap=True, inflight=max(2, prefetch)))
        self.placements = getattr(self._runner, "placements", [])
        self.supervisor = None
        if adaptive:
            self.supervisor = Supervisor(self._runner)

    def start(self) -> "DataPipeline":
        self._runner.start_stream()
        if self.supervisor is not None:
            self.supervisor.start()
        return self

    def get(self, timeout: Optional[float] = None):
        item = self._runner.get(timeout)
        return item.ready() if isinstance(item, _Staged) else item

    def state(self) -> dict:
        # NOTE: prefetched-but-unconsumed batches are re-generated on
        # restore; the source cursor is saved *behind* the prefetch depth.
        return self.source.state()

    def stats(self) -> dict:
        """Runner stats: per-node service-time EMA, items, lane depths."""
        s = self._runner.stats()
        if self.supervisor is not None:
            s["supervisor"] = self.supervisor.stats()
        return s

    def replacement_events(self):
        """Re-placement events (for the launcher's placement report)."""
        if self.supervisor is not None:
            return list(self.supervisor.events)
        return self._runner.replacement_events()

    def stop(self) -> None:
        """Join the supervisor and persist what it observed.  Idempotent;
        the stream itself drains on its own (sources are finite, or the
        process exits with the daemon threads)."""
        if self.supervisor is not None:
            self.supervisor.stop()


def make_pipeline(source, plan=None, n_batches=None, prefetch: int = 2,
                  compute: Optional[Callable] = None,
                  compute_workers: Union[int, str] = 1,
                  adaptive: bool = False) -> DataPipeline:
    """A started :class:`DataPipeline` onto ``plan``'s device (default: the
    first CUDA device)."""
    plan = plan or single_device_plan()
    return DataPipeline(source, plan.device, n_batches, prefetch,
                        compute=compute, plan=plan,
                        compute_workers=compute_workers,
                        adaptive=adaptive).start()
