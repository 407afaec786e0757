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
  calibrated constants (the shm and network hops and the device
  boundary's copies among them);
* ``core.accelerator`` — :class:`TorchAccelerator`, the paper's software
  accelerator (Sec. 9) on a CUDA stream;
* ``core.runtime`` — the adaptive runtime (copied): ``compile(adaptive=
  True)`` lowers eligible farms into :class:`AdaptiveFarmNode` stages
  whose thread (:class:`ThreadFarmNode`) or process engine a
  :class:`Supervisor` resizes and migrates while the stream runs, feeding
  what it observes back into ``perf_model``'s cost table;
* ``core.net`` — the remote tier (copied): the shm slot protocol over TCP
  (:class:`NetLane`, credit windows and heartbeats), the worker pools of
  ``python -m repro_torch.launch.worker`` (:func:`worker_main`,
  :func:`spawn_loopback_pool`), and :class:`RemoteFarmNode`, a farm whose
  workers answer over the network — ``compile(remote_workers=[...])``
  places GIL-bound farms there (``host_remote``) in a
  :class:`RemoteRunner` or in front of the device's segments.
"""

import importlib

# each export and the submodule that defines it, imported on first use, so
# that a worker pool (``python -m repro_torch.launch.worker``), which needs
# ``core.net`` and the torch-free modules under it, never imports torch
_EXPORTS = {
    "node": ("EOS", "GO_ON", "FFNode", "FnNode"),
    "queues": ("MPMCQueue", "MPSCQueue", "QueueClosed", "SPMCQueue",
               "SPSCQueue"),
    "shm": ("BatchedLaneWriter", "ShmArena", "ShmMPMCGrid", "ShmMPSCQueue",
            "ShmSPMCQueue", "ShmSPSCQueue", "ShmUSPSCQueue",
            "TransportConfig", "as_transport"),
    "skeletons": ("FF_EOS", "AutoscaleLB", "BroadcastLB", "Farm", "FFMap",
                  "LoadBalancer", "OnDemandLB", "Pipeline", "RoundRobinLB",
                  "Skeleton", "ThreadFarmNode"),
    "graph": ("A2ASkeleton", "Deliver", "DeviceRunner", "FFGraph",
              "GraphError", "HostRunner", "Runner", "StageHandle",
              "all_to_all", "farm", "ffmap", "pipeline", "seq"),
    "process": ("ProcessA2ANode", "ProcessFarmNode", "WorkerCrashed"),
    "net": ("NetLane", "RemoteFarmNode", "RemoteStageHandle",
            "spawn_loopback_pool", "worker_main"),
    "compiler": ("CompileConfig", "CostEstimate", "HybridRunner",
                 "Placement", "ProcessRunner", "RemoteRunner", "annotate",
                 "compile_graph", "emit", "place"),
    "accelerator": ("TorchAccelerator",),
    "runtime": ("AdaptiveFarmNode", "ReplacementEvent", "SLOPolicy",
                "Supervisor"),
    "plan": ("TorchPlan", "single_device_plan"),
    "params": ("from_numpy",),
}
_HOME = {name: mod for mod, names in _EXPORTS.items() for name in names}
_SUBMODULES = ("device", "perf_model")


def __getattr__(name: str):
    if name in _SUBMODULES:
        return importlib.import_module(f".{name}", __name__)
    if name not in _HOME:
        raise AttributeError(f"module {__name__!r} has no attribute "
                             f"{name!r}")
    value = getattr(importlib.import_module(f".{_HOME[name]}", __name__),
                    name)
    globals()[name] = value
    return value


def __dir__():
    return sorted(set(globals()) | set(__all__))


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
    "NetLane", "RemoteFarmNode", "RemoteStageHandle", "RemoteRunner",
    "spawn_loopback_pool", "worker_main",
    "seq", "pipeline", "farm", "ffmap", "all_to_all",
    "CompileConfig", "CostEstimate", "Placement", "annotate", "place",
    "emit", "compile_graph",
    "TorchAccelerator", "AdaptiveFarmNode", "ReplacementEvent",
    "SLOPolicy", "Supervisor", "TorchPlan", "single_device_plan", "from_numpy",
    "device", "perf_model",
]
