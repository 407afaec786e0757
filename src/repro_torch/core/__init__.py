"""Core of the PyTorch port — FastFlow's layered streaming-network model on
one CUDA device, behind the same building-blocks graph API and staged
compiler as the reference package ``repro.core``.

Layers ported so far:

* ``core.queues``, ``core.node``, ``core.skeletons`` — the thread-tier host
  runtime (SPSC rings, ``ff_node``, ``Pipeline``/``Farm``/``FFMap``), the
  reference's code, copied;
* ``core.graph`` — the IR, ``optimize()`` and :class:`HostRunner` (copied),
  plus the torch device lowering (:class:`DeviceRunner`);
* ``core.compiler`` — ``normalize -> annotate -> place -> emit`` over the
  host-thread and device tiers, with fused device segments
  (``core.fuse``) behind an overlapped host<->device boundary;
* ``core.device`` — ``farm_map``, ``feedback_scan``, ``feedback_while`` and
  ``a2a_dispatch``, the last through the CUDA all-to-all kernels of
  ``kernels/a2a_fused.py``;
* ``core.plan`` — :func:`single_device_plan`, ``cuda:0`` unless the caller
  names another device (``device="cpu"`` for the CPU);
* ``core.perf_model`` — the Sec. 13 algebra and the H100 roofline.

The process and remote tiers, the adaptive runtime, the accelerator mode,
models and serving are later slices.
"""

from .node import EOS, GO_ON, FFNode, FnNode
from .queues import MPMCQueue, MPSCQueue, QueueClosed, SPMCQueue, SPSCQueue
from .skeletons import (FF_EOS, AutoscaleLB, BroadcastLB, Farm, FFMap,
                        LoadBalancer, OnDemandLB, Pipeline, RoundRobinLB,
                        Skeleton)
from .graph import (A2ASkeleton, Deliver, DeviceRunner, FFGraph, GraphError,
                    HostRunner, Runner, StageHandle, all_to_all, farm, ffmap,
                    pipeline, seq)
from .compiler import (CompileConfig, CostEstimate, HybridRunner, Placement,
                       annotate, compile_graph, emit, place)
from .plan import TorchPlan, single_device_plan
from .params import from_numpy
from . import device, perf_model

__all__ = [
    "EOS", "GO_ON", "FF_EOS", "FFNode", "FnNode",
    "SPSCQueue", "SPMCQueue", "MPSCQueue", "MPMCQueue", "QueueClosed",
    "Pipeline", "Farm", "FFMap", "Skeleton",
    "LoadBalancer", "RoundRobinLB", "OnDemandLB", "BroadcastLB",
    "AutoscaleLB",
    "FFGraph", "GraphError", "Deliver", "Runner", "StageHandle",
    "HostRunner", "DeviceRunner", "HybridRunner", "A2ASkeleton",
    "seq", "pipeline", "farm", "ffmap", "all_to_all",
    "CompileConfig", "CostEstimate", "Placement", "annotate", "place",
    "emit", "compile_graph",
    "TorchPlan", "single_device_plan", "from_numpy",
    "device", "perf_model",
]
