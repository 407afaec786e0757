"""The dry run's step analysis: the collectives, FLOPs, bytes and memory
of one step as it runs.

Counterpart of ``src/repro/launch/hlo_analysis.py``, kept under its name.
There is no HLO here: the reference parses the compiled program's text,
the port watches its own eager step run once (``launch/dryrun.py`` runs it
on fake tensors, rank by rank) through recorders active while it runs:

* **collectives** — every named collective passes ``spmd._carry``, which
  hands it to :func:`~repro_torch.core.spmd.recording`: a record per call
  in the reference's names (``all-reduce``, ``all-gather``,
  ``reduce-scatter``, ``all-to-all``, ``collective-permute``) with the
  per-rank operand as ``parse_collectives`` defines it, the group size,
  the mesh axis, the per-card link bytes of
  :func:`~repro_torch.core.perf_model.collective_link_bytes`, and ``net``:
  the group's global ranks span more than one node of ``cards_per_node``
  consecutive ranks (the counterpart of the reference's ``dci``);
* **FLOPs and bytes** — a ``TorchDispatchMode`` sums each aten op's FLOPs
  by ``torch.utils.flop_counter``'s registered formulas (the op set and the
  decomposition ``FlopCounterMode`` uses) and the bytes each op that is not
  a view reads and writes: in eager every such op round-trips device
  memory.  The hand-written kernels do not pass the dispatcher: each
  wrapper's ``work()`` (``kernels/backend.py``) gives their FLOPs and
  bytes, and on fake tensors each launch a wrapper stands in for is
  counted here (the wrappers' own ``launches`` count real launches
  only);
* **memory** — the bytes of the live storages, the step's arguments
  included, and their peak over the step: the counterpart of the
  reference's argument + temp.  On the CUDA path the peak also holds the
  temporaries two ops' CUDA kernels make out of the dispatcher's sight
  (``_CUDA_TEMPS``, measured on the card).

Eager runs every layer, every microbatch and the backward's recompute as
often as they run, so every op is seen as often as it runs: there is no
``while`` body counted once, and no loop correction.
"""

from __future__ import annotations

import collections
import contextlib
import threading
import weakref
from typing import Any, Dict, List, Sequence, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from ..core import spmd
from ..core.perf_model import H100_SXM, HardwareSpec, collective_link_bytes
from ..kernels import backend

# the reference's HLO names of the port's collectives
KINDS = {"all_reduce": "all-reduce", "all_gather": "all-gather",
         "reduce_scatter": "reduce-scatter", "all_to_all": "all-to-all",
         "ppermute": "collective-permute"}

_aten = torch.ops.aten
_DEVICE = torch.ops.prim.device.default
# ops that write their first argument without reading it
_WRITE_ONLY = {_aten.copy_.default, _aten.fill_.Scalar, _aten.fill_.Tensor,
               _aten.zero_.default}
# ops that allocate without writing
_NO_TRAFFIC = {_aten.empty.memory_format, _aten.empty_strided.default,
               _aten.empty_like.default, _aten._unsafe_view.default}
# ops that read of their first argument only the rows they return
_GATHERS = {_aten.embedding.default, _aten.index_select.default,
            _aten.index.Tensor, _aten.gather.default}
# ops whose CUDA kernel makes a temporary the dispatcher never sees, read
# on an H100 by tools/dry_peak_gap.py: its bytes, held beside the op's
# outputs while it runs.  The softmax backward computes ``grad * output``
# first; logsumexp exponentiates ``self - max`` into a tensor of its own.
_CUDA_TEMPS = {
    _aten._softmax_backward_data.default:
        lambda grad, out, *_: grad.numel()
        * torch.promote_types(grad.dtype, out.dtype).itemsize,
    _aten.logsumexp.default:
        lambda x, *_, **__: x.numel() * x.element_size(),
}


def is_net(ranks: Sequence[int], cards_per_node: int) -> bool:
    """A group whose global ranks do not all sit in one node of
    ``cards_per_node`` consecutive ranks: its traffic crosses the
    network."""
    return len({r // cards_per_node for r in ranks}) > 1


def collective_record(op: str, operand_bytes: float, ranks: Sequence[int],
                      axis, cards_per_node: int) -> dict:
    """One collective's record, as ``parse_collectives`` makes one."""
    kind = KINDS[op]
    n = len(ranks)
    return {"kind": kind, "operand_bytes": float(operand_bytes),
            "group_size": n, "axis": axis,
            "link_bytes": collective_link_bytes(kind, operand_bytes, n),
            "net": is_net(ranks, cards_per_node)}


def total_link_bytes(colls: List[dict]) -> Tuple[float, float]:
    """(NVLink bytes, network bytes) a card."""
    nvlink = sum(c["link_bytes"] for c in colls if not c["net"])
    net = sum(c["link_bytes"] for c in colls if c["net"])
    return nvlink, net


def count_kinds(colls: List[dict]) -> Dict[str, int]:
    out: Dict[str, int] = {}
    for c in colls:
        out[c["kind"]] = out.get(c["kind"], 0) + 1
    return out


def _tensors(tree, out=None) -> List[torch.Tensor]:
    """The tensors of an op's arguments or results (tuples, lists and dicts
    of them), in order."""
    out = [] if out is None else out
    if isinstance(tree, torch.Tensor):
        out.append(tree)
    elif isinstance(tree, (list, tuple)):
        for t in tree:
            _tensors(t, out)
    elif isinstance(tree, dict):
        for t in tree.values():
            _tensors(t, out)
    return out


def _bytes(t: torch.Tensor) -> int:
    """The bytes an op moves for ``t``: its elements, or its storage where
    that is smaller (a broadcast view)."""
    return min(t.numel() * t.element_size(), t.untyped_storage().nbytes())


class StepAnalysis(TorchDispatchMode):
    """The recorders of one step: enter :meth:`recording` around the step
    (inside the ``FakeTensorMode`` it runs under), after :meth:`hold` has
    counted its arguments.  Read :attr:`collectives`, :attr:`flops`,
    :attr:`bytes` (aten ops), :attr:`kernels` (per kernel: calls, FLOPs,
    bytes), :attr:`launches` (per kernel: the launches fake tensors stood
    in for), :attr:`peak` and :attr:`live`.  ``cuda_temps`` counts
    ``_CUDA_TEMPS`` in the peak (the CUDA path's)."""

    def __init__(self, hw: HardwareSpec = H100_SXM,
                 cuda_temps: bool = False):
        super().__init__()
        self.hw = hw
        self.cuda_temps = cuda_temps
        self.collectives: List[dict] = []
        self.flops = 0
        self.bytes = 0
        self.flops_by_op: Dict[str, int] = collections.Counter()
        self.bytes_by_op: Dict[str, int] = collections.Counter()
        self.kernels: Dict[str, dict] = {}
        self.launches: Dict[str, int] = collections.Counter()
        self.live = 0
        self.peak = 0
        self._storages: Dict[int, int] = {}
        self._lock = threading.Lock()
        self._ops: Dict[Any, tuple] = {}

    # -- memory ------------------------------------------------------------
    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = id(st)
        with self._lock:
            if key in self._storages:
                return
            n = st.nbytes()
            self._storages[key] = n
            self.live += n
            self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._release, key)

    def _release(self, key: int) -> None:
        # a storage may die on another thread (autograd's device thread,
        # a process group's worker)
        with self._lock:
            self.live -= self._storages.pop(key)

    def hold(self, tree) -> int:
        """Count the storages of ``tree``'s tensors as live (the step's
        arguments); returns the bytes they add."""
        before = self.live
        for t in _tensors(tree):
            self._track(t)
        return self.live - before

    # -- the recorders -----------------------------------------------------
    def _collective(self, op, operand_bytes, ranks, axis) -> None:
        self.collectives.append(collective_record(
            op, operand_bytes, ranks, axis, self.hw.cards_per_node))

    def _kernel(self, name: str, work: backend.Work) -> None:
        k = self.kernels.setdefault(name, {"calls": 0, "flops": 0,
                                           "bytes": 0, "ops_s": 0.0})
        k["calls"] += 1
        k["flops"] += work.flops
        k["bytes"] += work.bytes
        k["ops_s"] += work.ops_s

    def _launch(self, name: str) -> None:
        self.launches[name] += 1

    @contextlib.contextmanager
    def recording(self):
        with contextlib.ExitStack() as stack:
            stack.enter_context(spmd.recording(self._collective))
            stack.enter_context(backend.noting(self._kernel, self._launch))
            stack.enter_context(self)
            yield self

    def _op(self, func) -> tuple:
        """What the counts need of an op, worked out once: whether it
        decomposes, its FLOP formula, whether it moves bytes and how."""
        info = self._ops.get(func)
        if info is None:
            packet = func._overloadpacket
            traffic = func.namespace == "aten" and not func.is_view \
                and func not in _NO_TRAFFIC
            info = self._ops[func] = (
                True,
                flop_registry.get(packet), str(packet), traffic,
                func in _WRITE_ONLY, func in _GATHERS, str(func))
        return info

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is _DEVICE:              # a fake tensor's ``.device``: most
            return func(*args)           # calls, and nothing to count
        kwargs = kwargs or {}
        decomposes, flop_fn, packet, traffic, write_only, gathers, name = \
            self._op(func)
        # decompose as FlopCounterMode does, so the two count the same ops
        if decomposes:
            with self:
                r = func.decompose(*args, **kwargs)
            if r is not NotImplemented:
                return r
            self._ops[func] = (False,) + self._ops[func][1:]
        out = func(*args, **kwargs)
        if flop_fn is not None:
            f = flop_fn(*args, **kwargs, out_val=out)
            self.flops += f
            self.flops_by_op[packet] += f
        outs = _tensors(out)
        if traffic:
            ins = _tensors(kwargs, _tensors(args))
            if write_only:
                ins = ins[1:]
            elif gathers and ins and outs:
                ins = ins[1:] + outs[:1]
            n = sum(_bytes(t) for t in ins) + sum(_bytes(t) for t in outs)
            self.bytes += n
            self.bytes_by_op[name] += n
        for t in outs:
            self._track(t)
        temp = _CUDA_TEMPS.get(func) if self.cuda_temps else None
        if temp is not None:
            n = temp(*args, **kwargs)
            with self._lock:
                self.peak = max(self.peak, self.live + n)
        return out

    # -- totals --------------------------------------------------------------
    def kernel_totals(self) -> Tuple[float, float]:
        """(FLOPs, bytes) of the hand-written kernels' calls."""
        return (sum(k["flops"] for k in self.kernels.values()),
                sum(k["bytes"] for k in self.kernels.values()))
