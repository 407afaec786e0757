"""Core of the PyTorch port — FastFlow's layered streaming-network model on
one CUDA device, behind the same building-blocks graph API and staged
compiler as the reference package ``repro.core``.

Layers ported so far:

* ``core.queues``, ``core.node``, ``core.skeletons`` — the thread-tier host
  runtime (SPSC rings, ``ff_node``, ``Pipeline``/``Farm``/``FFMap``), the
  reference's code, copied;
* ``core.graph`` — the IR, ``optimize()`` and :class:`HostRunner` (copied),
  plus the torch device lowering (:class:`DeviceRunner`);
* ``core.shm`` — the shared-memory rings of the process tier (the
  reference's code, copied: a ring of either package reads the other's);
* ``core.process`` — ``ProcessFarmNode`` and ``ProcessA2ANode``, farm and
  all-to-all workers as forked OS processes over those rings (copied;
  torch-free, so children forked after CUDA is up never touch it);
* ``core.compiler`` — ``normalize -> annotate -> place -> emit`` over the
  host-thread, host-process and device tiers, with fused device segments
  (``core.fuse``) behind an overlapped host<->device boundary;
* ``core.device`` — ``farm_map``, ``feedback_scan``, ``feedback_while`` and
  ``a2a_dispatch``, the last through the CUDA all-to-all kernels of
  ``kernels/a2a_fused.py``;
* ``core.plan`` — :func:`single_device_plan`, ``cuda:0`` unless the caller
  names another device (``device="cpu"`` for the CPU);
* ``core.perf_model`` — the Sec. 13 algebra, the H100 roofline and the
  calibrated host constants (the shm hop among them);
* ``core.accelerator`` — :class:`TorchAccelerator`, the paper's software
  accelerator (Sec. 9) on a CUDA stream;
* ``core.runtime`` — the adaptive runtime (copied): ``compile(adaptive=
  True)`` lowers eligible farms into :class:`AdaptiveFarmNode` stages
  whose thread (:class:`ThreadFarmNode`) or process engine a
  :class:`Supervisor` resizes and migrates while the stream runs, feeding
  what it observes back into ``perf_model``'s cost table.

The remote tier is a later slice.
"""

from .node import EOS, GO_ON, FFNode, FnNode
from .queues import MPMCQueue, MPSCQueue, QueueClosed, SPMCQueue, SPSCQueue
from .shm import (BatchedLaneWriter, ShmArena, ShmMPMCGrid, ShmMPSCQueue,
                  ShmSPMCQueue, ShmSPSCQueue, ShmUSPSCQueue, TransportConfig,
                  as_transport)
from .skeletons import (FF_EOS, AutoscaleLB, BroadcastLB, Farm, FFMap,
                        LoadBalancer, OnDemandLB, Pipeline, RoundRobinLB,
                        Skeleton, ThreadFarmNode)
from .graph import (A2ASkeleton, Deliver, DeviceRunner, FFGraph, GraphError,
                    HostRunner, Runner, StageHandle, all_to_all, farm, ffmap,
                    pipeline, seq)
from .process import ProcessA2ANode, ProcessFarmNode, WorkerCrashed
from .compiler import (CompileConfig, CostEstimate, HybridRunner, Placement,
                       ProcessRunner, annotate, compile_graph, emit, place)
from .accelerator import TorchAccelerator
from .runtime import (AdaptiveFarmNode, ReplacementEvent, SLOPolicy,
                      Supervisor)
from .plan import TorchPlan, single_device_plan
from .params import from_numpy
from . import device, perf_model

__all__ = [
    "EOS", "GO_ON", "FF_EOS", "FFNode", "FnNode",
    "SPSCQueue", "SPMCQueue", "MPSCQueue", "MPMCQueue", "QueueClosed",
    "ShmSPSCQueue", "ShmSPMCQueue", "ShmMPSCQueue", "ShmMPMCGrid",
    "ShmUSPSCQueue", "ShmArena", "TransportConfig", "BatchedLaneWriter",
    "as_transport",
    "Pipeline", "Farm", "FFMap", "Skeleton",
    "LoadBalancer", "RoundRobinLB", "OnDemandLB", "BroadcastLB",
    "AutoscaleLB", "ThreadFarmNode",
    "FFGraph", "GraphError", "Deliver", "Runner", "StageHandle",
    "HostRunner", "DeviceRunner", "HybridRunner", "ProcessRunner",
    "A2ASkeleton", "ProcessFarmNode", "ProcessA2ANode", "WorkerCrashed",
    "seq", "pipeline", "farm", "ffmap", "all_to_all",
    "CompileConfig", "CostEstimate", "Placement", "annotate", "place",
    "emit", "compile_graph",
    "TorchAccelerator", "AdaptiveFarmNode", "ReplacementEvent",
    "SLOPolicy", "Supervisor", "TorchPlan", "single_device_plan", "from_numpy",
    "device", "perf_model",
]
