"""L2 — the "arbitrary streaming network" layer for the device side.

Port of ``src/repro/core/plan.py``.  A :class:`ShardingPlan` maps *logical*
tensor axes (batch, fsdp, tp, sp, cp, expert, ...) onto the axes of a
:class:`TorchMesh`.  The farm skeleton contributes the ``batch``/``fsdp``
mapping (emitter = scatter over the data axis, collector = gradient
reduction), the map skeleton ``tp``/``seq`` (Split/Compose over the model
axis), and the MoE farm ``expert`` (MPMC all-to-all).

The port is SPMD with one process per mesh position (``core/spmd.py``):
a live mesh wraps a ``torch.distributed`` ``DeviceMesh`` over the process
group, one sub-group per axis.  A mesh can also be *abstract* — a shape and
names with no ranks behind it — so that the specs of the production meshes
(16 x 16, 2 x 16 x 16) are computed without 256 processes.  The one-device
plan of the earlier slices stays: :func:`single_device_plan` is a
:class:`TorchPlan` over a one-device mesh whose ``shape`` is ``{"data":
1}``, the surface the compiler's ``place``/``_mesh_axis_size`` read.

Models never mention mesh axes directly; they name logical axes, and
:meth:`ShardingPlan.constrain` is the identity.  Inside a manual region
(``spmd.manual``: the train, prefill and decode steps over a live mesh)
every tensor is this rank's block, and the resharding GSPMD does for the
reference becomes explicit steps over the ``tp`` axis, each decided from
``spec_for_shape``/``_fit_dim`` so that a dim that does not divide stays
replicated: :meth:`ShardingPlan.seq_gather` (the sequence-parallel gather
at a block's entry, and context-parallel attention's gather of k/v),
:meth:`ShardingPlan.compose` (the row-parallel exit: a ``psum_scatter``
over the sequence, a ``psum`` when the sequence is not sharded),
:meth:`ShardingPlan.block` (a replicated tensor cut to its block) and
:meth:`ShardingPlan.seq_block` (a sequence-indexed input — ``embeds``,
``frames``, positions, M-RoPE's ids — cut to the rank's sequence block).
They run through ``core/spmd.py``'s differentiable collectives, so the
backward is their transpose; on a model axis of one rank, and outside a
manual region, each is the identity.  :meth:`ShardingPlan.gather_fsdp`
is ZeRO-3 at the layer: a weight the data axes split (``fsdp_params``) is
all-gathered over them where the model uses it, its gradient
reduce-scattered back by the gather's backward; the steps mark each
parameter block with its whole shape (:func:`mark_whole`), and
:data:`FSDP_GATHERED` counts the gathered bytes while they live.
"""

from __future__ import annotations

import dataclasses
import math
import threading
import weakref
from typing import Any, Dict, Optional, Sequence, Tuple

import torch


# Logical axis vocabulary ----------------------------------------------------
#   batch     global batch                     -> (pod, data)
#   fsdp      parameter shard dim (ZeRO-3)     -> data (optionally +pod)
#   tp        tensor-parallel dim (heads/ffn/vocab/experts)
#   sp        sequence dim of activations between blocks (Megatron-SP)
#   cp        sequence dim inside context-parallel attention
#   none      replicated

DEFAULT_RULES: Dict[str, Tuple[str, ...]] = {
    "batch": ("pod", "data"),
    "fsdp": ("data",),
    "tp": ("model",),
    "sp": ("model",),
    "cp": ("model",),
    "expert": ("model",),
    "layers": (),      # stacked layer dim — never sharded
    "none": (),
}


class P(tuple):
    """A partition spec: per tensor dim, ``None`` (replicated), one mesh
    axis name, or a tuple of them (major to minor) — the port's
    ``jax.sharding.PartitionSpec``."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


def spec_axes(entry) -> Tuple[str, ...]:
    """The mesh axes of one spec entry, as a tuple."""
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


@dataclasses.dataclass(frozen=True)
class TorchMesh:
    """Named mesh axes over ranks.  ``device`` is the device this process
    computes on (``None`` for an abstract mesh); ``device_mesh`` the live
    ``torch.distributed`` ``DeviceMesh`` (``None`` on one local device and
    on an abstract mesh).  Hashable by value, so equal one-device plans
    share the compiled-segment cache as equal JAX meshes do."""

    device: Optional[torch.device]
    axis_names: Tuple[str, ...] = ("data",)
    sizes: Optional[Tuple[int, ...]] = None          # None: every axis 1
    device_mesh: Any = dataclasses.field(default=None, compare=False,
                                         hash=False, repr=False)

    @property
    def shape(self) -> Dict[str, int]:
        sizes = self.sizes or (1,) * len(self.axis_names)
        return dict(zip(self.axis_names, sizes))

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    @property
    def live(self) -> bool:
        """Ranks stand behind the axes (a process group exists)."""
        return self.device_mesh is not None

    @property
    def abstract(self) -> bool:
        return self.device_mesh is None and self.size > 1

    def group(self, axis: str):
        """The process group of ``axis`` (this rank's row along it)."""
        if not self.live:
            raise RuntimeError(f"mesh axis {axis!r} has no ranks behind it")
        return self.device_mesh.get_group(axis)

    def coord(self, axis: str) -> int:
        """This rank's index along ``axis`` (0 on a mesh without ranks)."""
        if not self.live:
            return 0
        return int(self.device_mesh.get_local_rank(axis))


@dataclasses.dataclass(frozen=True)
class TorchPlan:
    mesh: TorchMesh

    @property
    def device(self) -> torch.device:
        return self.mesh.device

    def gather_fsdp(self, w, axes):
        """One device holds every weight whole: ``w`` itself."""
        return w


# the weights :meth:`ShardingPlan.gather_fsdp` gathered: the bytes alive
# now and their high-water mark (reset it with :func:`reset_fsdp_gathered`),
# the gathers and their bytes in all
FSDP_GATHERED = {"live": 0, "peak": 0, "gathers": 0, "bytes": 0}
_gathered_lock = threading.Lock()


def reset_fsdp_gathered() -> None:
    with _gathered_lock:
        FSDP_GATHERED.update(peak=FSDP_GATHERED["live"], gathers=0, bytes=0)


def _release(n: int) -> None:
    with _gathered_lock:
        FSDP_GATHERED["live"] -= n


def _held(t: torch.Tensor) -> torch.Tensor:
    """Count ``t``'s bytes as live until the tensor is freed (autograd
    keeps a tensor it saved for the backward alive)."""
    n = t.numel() * t.element_size()
    with _gathered_lock:
        FSDP_GATHERED["live"] += n
        FSDP_GATHERED["peak"] = max(FSDP_GATHERED["peak"],
                                    FSDP_GATHERED["live"])
        FSDP_GATHERED["gathers"] += 1
        FSDP_GATHERED["bytes"] += n
    weakref.finalize(t, _release, n)
    return t


def mark_whole(t: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """Mark ``t``, this rank's block of a parameter, with the parameter's
    whole ``shape``, by which :meth:`ShardingPlan.gather_fsdp` gathers it;
    returns ``t``."""
    t.whole_shape = tuple(shape)
    return t


def unbind_marked(t: torch.Tensor) -> list:
    """``t.unbind(0)``, each view marked with the whole shape of one
    layer where ``t`` (a stacked leaf) is marked."""
    views = list(t.unbind(0))
    shape = getattr(t, "whole_shape", None)
    if shape is not None:
        for v in views:
            mark_whole(v, shape[1:])
    return views


@dataclasses.dataclass(frozen=True)
class TorchSharding:
    """A spec on a mesh — the port's ``NamedSharding``.  ``placements``
    gives the DTensor placements (one per mesh axis, in the mesh's order);
    :meth:`local_slices` the index of this rank's block."""

    mesh: TorchMesh
    spec: P

    @property
    def placements(self) -> tuple:
        try:
            from torch.distributed.tensor import Replicate, Shard
        except ImportError:                          # torch < 2.5
            from torch.distributed._tensor import Replicate, Shard
        out = []
        for name in self.mesh.axis_names:
            dim = next((d for d, e in enumerate(self.spec)
                        if name in spec_axes(e)), None)
            out.append(Replicate() if dim is None else Shard(dim))
        return tuple(out)

    def shard_dims(self) -> Dict[int, Tuple[str, ...]]:
        """Tensor dim -> the mesh axes that split it (sizes above 1 or
        not)."""
        return {d: spec_axes(e) for d, e in enumerate(self.spec) if e}

    def block(self, dim: int, coords: Optional[Dict[str, int]] = None
              ) -> Tuple[int, int]:
        """(index, count) of this rank's block along ``dim``."""
        idx, n = 0, 1
        for a in spec_axes(self.spec[dim]) if dim < len(self.spec) else ():
            size = self.mesh.shape[a]
            c = coords[a] if coords is not None else self.mesh.coord(a)
            idx, n = idx * size + c, n * size
        return idx, n

    def local_shape(self, shape: Sequence[int],
                    coords: Optional[Dict[str, int]] = None) -> tuple:
        return tuple(s // self.block(d, coords)[1]
                     for d, s in enumerate(shape))

    def local_slices(self, shape: Sequence[int],
                     coords: Optional[Dict[str, int]] = None) -> tuple:
        """Slices of a global tensor of ``shape`` that this rank holds."""
        out = []
        for d, s in enumerate(shape):
            i, n = self.block(d, coords)
            out.append(slice(i * (s // n), (i + 1) * (s // n)))
        return tuple(out)

    def local_block(self, x):
        """This rank's block of the whole ``x`` (a tensor or a numpy array;
        a view)."""
        return x[self.local_slices(x.shape)]

    def gather(self, t: torch.Tensor, axes: Optional[Sequence[str]] = None
               ) -> torch.Tensor:
        """The whole tensor from this rank's block ``t``: all-gathered over
        each axis (of ``axes``, default all) that splits a dim, minor axis
        first.  The identity on a mesh without ranks."""
        if not self.mesh.live:
            return t
        from . import spmd
        for d, names in self.shard_dims().items():
            for a in reversed(names):
                if axes is None or a in axes:
                    t = spmd.gather_dim(t, self.mesh, a, d)
        return t


@dataclasses.dataclass
class ShardingPlan:
    """Logical-axis -> mesh-axis mapping plus activation-constraint policy."""

    mesh: TorchMesh
    rules: Dict[str, Tuple[str, ...]] = dataclasses.field(
        default_factory=lambda: dict(DEFAULT_RULES))
    # toggles used by the perf hillclimb
    sequence_parallel: bool = True      # shard residuals over model axis (SP)
    fsdp_params: bool = True            # ZeRO-3 weight sharding over data
    constrain_activations: bool = True

    def __post_init__(self):
        self._axis_names = set(self.mesh.axis_names)

    @property
    def device(self) -> Optional[torch.device]:
        return self.mesh.device

    # -- resolution ----------------------------------------------------------
    def axes(self, logical: Optional[str]):
        """Resolve a logical axis to mesh axes present in this mesh."""
        if logical is None or logical == "none":
            return None
        if logical == "sp" and not self.sequence_parallel:
            return None
        if logical not in self.rules:
            raise KeyError(f"unknown logical axis {logical!r}")
        names = tuple(a for a in self.rules[logical] if a in self._axis_names)
        if not names:
            return None
        return names if len(names) > 1 else names[0]

    def pspec(self, *logicals: Optional[str]) -> P:
        return P(*[self.axes(l) for l in logicals])

    def sharding(self, *logicals: Optional[str]) -> TorchSharding:
        return TorchSharding(self.mesh, self.pspec(*logicals))

    def _fit_dim(self, dim: int, logical: Optional[str]):
        """Mesh axes for one dim, dropping axes that don't divide it
        (partial sharding — e.g. batch=1 decode replicates over data)."""
        if logical == "fsdp" and not self.fsdp_params:
            return None
        ax = self.axes(logical)
        if ax is None:
            return None
        axes_t = ax if isinstance(ax, tuple) else (ax,)
        keep, prod = [], 1
        for a in axes_t:
            n = self.mesh.shape[a]
            if dim % (prod * n) == 0:
                keep.append(a)
                prod *= n
        if not keep:
            return None
        return tuple(keep) if len(keep) > 1 else keep[0]

    def spec_for_shape(self, shape: Sequence[int],
                       logicals: Sequence[Optional[str]]) -> P:
        return P(*[self._fit_dim(d, l) for d, l in zip(shape, logicals)])

    def constrain(self, x, *logicals: Optional[str]):
        """The identity: outside a manual region there is nothing to
        reshard (one device, or the global tensors a ``shard_map`` takes),
        and inside one the blocks take the transitions below explicitly."""
        return x

    # -- the transitions inside a manual region ------------------------------
    def model_axis(self) -> Optional[str]:
        """The mesh axis of ``tp`` when a manual region over this plan's
        live mesh makes every tensor this rank's block along it and it has
        more than one rank; else ``None``, and every transition below is
        the identity."""
        from . import spmd
        ax = self.axes("tp")
        if not isinstance(ax, str) or self.mesh.shape.get(ax, 1) == 1:
            return None
        if not self.mesh.live or ax not in spmd.manual_axes():
            return None
        return ax

    def seq_split(self, S: int) -> bool:
        """Whether the residual stream of a global sequence of ``S`` is
        sequence-sharded between blocks (Megatron-SP): the ``sp`` axis fits
        ``S`` — false at decode (S = 1), when ``S % tp != 0`` and without
        ``sequence_parallel``."""
        return self.model_axis() is not None and S > 1 \
            and self._fit_dim(S, "sp") is not None

    def seq_gather(self, x, sp: bool):
        """A block's entry: the sequence-sharded (B, S/tp, ...) ``x``
        all-gathered over the model axis on dim 1 (its transpose, the
        backward, reduce-scatters); ``x`` itself when ``sp`` is false.
        Context-parallel attention gathers its k and v so."""
        if not sp:
            return x
        from . import spmd
        return spmd.all_gather(x, self.model_axis(), axis_dim=1)

    def compose(self, o, sp: bool, w):
        """A block's row-parallel exit.  ``w`` is the def (global
        ``shape``, logical ``axes``) of the weight whose product gave ``o``
        (B, S, ...): where :meth:`model_split` splits it, ``o`` is a
        partial sum over the model axis (each rank's partial rounded to its
        type), reduce-scattered to this rank's sequence block under ``sp``,
        else summed (``psum``); where it stays replicated, ``o`` is whole,
        cut to the sequence block under ``sp``, else kept."""
        m = self.model_axis()
        if m is None:
            return o
        from . import spmd
        if not self.model_split(w.shape, w.axes):
            return self.block(o, 1, "sp") if sp else o
        # the partials summed in fp32 and rounded once, as XLA's CPU
        # backend promotes the reference's bf16 reduction (the compiled
        # all-reduce / reduce-scatter is f32, ``add.clone_promoted``)
        dt = o.dtype
        o = o.float()
        o = spmd.psum_scatter(o, m, scatter_dimension=1) if sp \
            else spmd.psum(o, m)
        return o.to(dt)

    def block(self, x, dim: int, logical: Optional[str] = "tp"):
        """This rank's block along ``dim`` of ``x``, replicated along the
        model axis: the model axis's share of ``spec_for_shape`` for that
        dim (``x`` itself where it does not divide, or names another
        axis)."""
        m = self.model_axis()
        if m is None or m not in spec_axes(self._fit_dim(x.shape[dim],
                                                         logical)):
            return x
        n = self.mesh.shape[m]
        size = x.shape[dim] // n
        return x.narrow(dim, self.mesh.coord(m) * size, size)

    def seq_block(self, x, sp: bool, dim: int = 1,
                  logical: Optional[str] = "sp"):
        """The rank's block of a sequence-indexed ``x`` whose ``dim`` is
        the whole sequence (the ``embeds`` or ``frames`` entering the
        residual stream; positions (B, S) and M-RoPE's ids (3, B, S) on
        dim 2 inside context-parallel attention, ``logical`` ``cp``), when
        ``sp`` says the sequence is split: :meth:`block` along ``dim``.
        ``x`` itself when it is not (a sequence the model axis does not
        divide stays whole on every rank)."""
        return self.block(x, dim, logical) if sp else x

    def model_split(self, shape: Sequence[int],
                    logicals: Sequence[Optional[str]]) -> Tuple[int, ...]:
        """The dims of a tensor of global ``shape`` (a parameter's def)
        that the model axis splits under ``spec_for_shape``."""
        ax = self.axes("tp")
        if not isinstance(ax, str):
            return ()
        spec = self.spec_for_shape(shape, logicals)
        return tuple(d for d, e in enumerate(spec) if ax in spec_axes(e))

    def gather_fsdp(self, w, axes: Sequence[Optional[str]]):
        """ZeRO-3 weight gather at the use site: drop the 'fsdp' dims.
        ``w`` is this rank's block of a parameter whose whole shape the
        steps marked (:func:`mark_whole`); inside a manual region over this
        plan's live mesh, with ``fsdp_params``, the data axes that
        ``spec_for_shape`` puts on its ``fsdp`` dims are all-gathered
        (minor axis first), the model axis's block kept.  The gather's
        backward reduce-scatters the gradient back to the block, summed
        over those ranks.  Anywhere else ``w`` itself.  Each weight
        gathered counts in :data:`FSDP_GATHERED` while it lives."""
        shape = getattr(w, "whole_shape", None)
        if shape is None or not self.fsdp_params or not self.mesh.live:
            return w
        from . import spmd
        manual = spmd.manual_axes()
        spec = self.spec_for_shape(shape, axes)
        out = w
        for d, logical in enumerate(axes):
            if logical != "fsdp":
                continue
            for a in reversed(spec_axes(spec[d])):
                if a in manual and self.mesh.shape[a] > 1:
                    out = spmd.all_gather(out, a, axis_dim=d)
        return w if out is w else _held(out)

    # -- parameter specs -------------------------------------------------------
    def param_spec(self, logical_axes: Sequence[Optional[str]],
                   shape: Optional[Sequence[int]] = None) -> P:
        """Spec for a parameter given per-dim logical names.  Honors the
        ``fsdp_params`` toggle; with a shape, drops non-dividing axes."""
        if shape is not None:
            return self.spec_for_shape(shape, logical_axes)
        out = []
        for l in logical_axes:
            if l == "fsdp" and not self.fsdp_params:
                out.append(None)
            else:
                out.append(self.axes(l))
        return P(*out)

    def sharding_for(self, logical_axes: Sequence[Optional[str]],
                     shape: Optional[Sequence[int]] = None) -> TorchSharding:
        return TorchSharding(self.mesh, self.param_spec(logical_axes, shape))

    def tree_shardings(self, logical_tree) -> Any:
        """Map a tree of per-dim logical-axis tuples to shardings (a tuple
        is a leaf)."""
        def walk(t):
            if isinstance(t, dict):
                return {k: walk(v) for k, v in t.items()}
            if isinstance(t, list):
                return [walk(v) for v in t]
            return TorchSharding(self.mesh, self.param_spec(t))
        return walk(logical_tree)

    # -- derived sizes ---------------------------------------------------------
    def axis_size(self, logical: str) -> int:
        ax = self.axes(logical)
        if ax is None:
            return 1
        if isinstance(ax, tuple):
            n = 1
            for a in ax:
                n *= self.mesh.shape[a]
            return n
        return self.mesh.shape[ax]

    @property
    def dp(self) -> int:
        return self.axis_size("batch")

    @property
    def tp(self) -> int:
        return self.axis_size("tp")


def model_plan(plan) -> Optional["ShardingPlan"]:
    """``plan`` when it is a :class:`ShardingPlan` whose model axis is
    manual with more than one rank (the blocks take their sharded forms),
    else ``None`` (the one-device forms, unchanged)."""
    axis = getattr(plan, "model_axis", None)
    return plan if axis is not None and axis() is not None else None


def resolve_device(device: Optional[Any] = None) -> torch.device:
    """``None`` means the first CUDA device, and raises without one: the
    CPU is used only when the caller names it."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: the port runs on the GPU by default; pass "
                "device=\"cpu\" to run it on the CPU")
        return torch.device("cuda", 0)
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", 0)
    return dev


def single_device_plan(device: Optional[Any] = None) -> TorchPlan:
    """A plan over one device: ``cuda:0`` unless ``device`` says otherwise
    (tests pass ``device="cpu"``)."""
    return TorchPlan(TorchMesh(resolve_device(device)))
