"""SPMD over ``torch.distributed``: one process per mesh position, the
port's counterpart of ``shard_map`` and of the reference's named ``lax``
collectives.

The reference is single-controller: a ``shard_map`` body calls ``psum``,
``all_gather``, ``ppermute`` ... over named mesh axes.  Here every rank is
a process; :func:`shard_map` takes *global* tensors, as the reference's
does (every rank holds the same global value), gives ``fn`` this rank's
blocks by ``in_specs`` and assembles its outputs by ``out_specs``: a dim
named by an axis is all-gathered over that axis's group, ``P()`` is
replicated.  Inside ``fn`` every axis of the mesh is *manual*: a nested
:func:`shard_map` (the vocab-parallel loss inside the data-parallel train
step) neither slices nor gathers over an axis that is already manual.

Gradients.  Every collective is a ``torch.autograd.Function`` whose
backward is its transpose: ``psum`` -> ``psum``, ``all_gather`` ->
``psum_scatter``, ``psum_scatter`` -> ``all_gather``, ``ppermute`` -> the
inverse permutation, ``all_to_all`` -> the inverse exchange; ``pmax``
carries none (the reference stops the gradient there).  Taken alone, that
differentiates the sum over ranks of each rank's copy of the output, so
:func:`shard_map` scales a replicated output's cotangent by 1 / (ranks
over which it is replicated), and the backward of its input slicing sums
a replicated input's cotangent over the ranks and gathers a sharded one:
``torch.autograd.grad`` of a replicated loss then gives, on every rank,
the gradient of the global function.

Backend and transport.  Ranks on distinct GPUs use NCCL; ranks that share
one device, and ranks on the CPU, use gloo.  gloo carries the collectives
for CUDA tensors itself, through host memory, except point-to-point sends
(``ppermute``): those go to pinned host memory and back here, explicitly
(``HOST_ROUTED``).  :data:`ROUTES` counts, per collective, the calls each
transport carried, :data:`ROUTE_SECONDS` their host time.  Compute never
leaves the device.  Rendezvous is a ``file://`` store under a temporary
directory, never a fixed TCP port.

The dry run (``launch/dryrun.py``) joins torch's ``fake`` process group
(:func:`init_fake`): one process is one rank of a world of 256 or 512,
every group and collective is the real code path, and a collective moves
nothing.  While :func:`recording` is active, :func:`_carry` hands every
collective it carries to the recorder: its name, its per-rank operand
bytes, the global ranks of its group and its mesh axis.

    results = spmd.launch(fn, 2, *args)     # fn(*args) on two GPU ranks
    results = spmd.launch(fn, 2, *args, device="cpu")    # on CPU ranks
"""

from __future__ import annotations

import contextlib
import datetime
import math
import os
import pickle
import queue as queue_mod
import tempfile
import threading
import time
import traceback
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from .plan import P, TorchMesh, resolve_device, spec_axes
from .tree import tree_map

# collectives that go through pinned host memory when gloo has CUDA
# tensors: point-to-point sends, which gloo does not carry for a CUDA
# tensor (``python3 tools/probe_gloo.py`` on an H100, torch 2.11: the send
# aborts the process).  gloo carries the others at 0.7-1.8 GB/s of a
# rank's 512 MB operand, 2-14% above this module's own pinned route
HOST_ROUTED = frozenset({"ppermute"})

# per collective and transport ("nccl", "gloo", "gloo-cuda", "host"): calls,
# and the host seconds they took (not kept for NCCL, which does not block
# the host)
ROUTES: Dict[str, Dict[str, int]] = {}
ROUTE_SECONDS: Dict[str, Dict[str, float]] = {}

_STATE: Dict[str, Any] = {"backend": None, "device": None}
# the one-tensor reduce-scatter under its newer name where torch has it
_REDUCE_SCATTER = getattr(dist, "reduce_scatter_single", None) or \
    dist.reduce_scatter_tensor
_LOCAL = threading.local()


# ---------------------------------------------------------------------------
# process groups
# ---------------------------------------------------------------------------
def pick_backend(device: torch.device, world: int) -> str:
    """NCCL for ranks on distinct GPUs; gloo for the CPU and for ranks
    that share one GPU (NCCL refuses two ranks on one device)."""
    if device.type == "cuda" and world <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def rank_device(device: Any, rank: int, world: int) -> torch.device:
    """The device of ``rank``: the CPU when asked; else ``cuda:rank`` while
    there are enough cards, and ``cuda:0`` for every rank when there are
    not."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return dev
    n = torch.cuda.device_count()
    if n == 0:
        raise RuntimeError("no CUDA device: pass device=\"cpu\"")
    return torch.device("cuda", rank if world <= n else 0)


def init(rank: int, world: int, init_method: str, device: Any,
         timeout_s: float = 600.0) -> None:
    """Join the process group as ``rank`` of ``world`` and take this
    rank's device."""
    dev = rank_device(device, rank, world)
    backend = pick_backend(dev, world)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=timeout_s))
    _STATE.update(backend=backend, device=dev)


def init_from_env(device: Any = None) -> None:
    """Join the group ``torchrun`` describes (``RANK``, ``WORLD_SIZE``,
    ``MASTER_ADDR``/``MASTER_PORT``), on the GPU unless ``device`` names
    the CPU."""
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    local = int(os.environ.get("LOCAL_RANK", rank))
    dev = rank_device(resolve_device(device), local, int(os.environ.get(
        "LOCAL_WORLD_SIZE", world)))
    backend = pick_backend(dev, world)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method="env://", rank=rank,
                            world_size=world)
    _STATE.update(backend=backend, device=dev)


def init_fake(rank: int, world: int, device: Any) -> None:
    """Join torch's ``fake`` process group as ``rank`` of ``world`` (no
    peer, no card: every collective returns at once and moves nothing),
    computing on ``device``, which is never made current.  The dry run's
    world; :func:`finish` leaves it."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=world)
    _STATE.update(backend="fake", device=torch.device(device))


def finish() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()
    _STATE.update(backend=None, device=None)


def backend() -> Optional[str]:
    return _STATE["backend"]


def current_device() -> Optional[torch.device]:
    return _STATE["device"]


def world() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def _rank_main(rank, world_size, rdv, device, fn, args, out, timeout_s):
    try:
        init(rank, world_size, f"file://{rdv}", device, timeout_s)
        # pickled here: a tensor put on the queue as it is would travel as
        # shared memory that dies with this process
        result = pickle.dumps(fn(*args))
        out.put((rank, True, result))
    except BaseException:                     # noqa: BLE001 - sent back
        out.put((rank, False, traceback.format_exc()))
    finally:
        try:
            finish()
        except Exception:                     # noqa: BLE001
            pass


def launch(fn: Callable, world_size: int, *args, device: Any = None,
           timeout_s: float = 600.0) -> list:
    """Run ``fn(*args)`` in ``world_size`` fresh processes (the *spawn*
    start method: CUDA may be up in the caller), each one rank of a new
    process group; returns their results in rank order.  The ranks run on
    the GPU unless ``device`` names the CPU, and without a GPU that is an
    error.  ``fn`` must be importable by name (a module-level function).
    Raises if a rank fails or the run passes ``timeout_s``; every process
    is stopped on return."""
    import torch.multiprocessing as mp
    device = resolve_device(device)
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    with tempfile.TemporaryDirectory(prefix="repro_spmd-") as tmp:
        rdv = os.path.join(tmp, "rendezvous")
        procs = [ctx.Process(target=_rank_main, daemon=True,
                             args=(r, world_size, rdv, device, fn, args,
                                   out, timeout_s))
                 for r in range(world_size)]
        for p in procs:
            p.start()
        results: Dict[int, Any] = {}
        errors = []
        deadline = time.monotonic() + timeout_s
        try:
            while len(results) + len(errors) < world_size:
                try:
                    rank, ok, val = out.get(timeout=1.0)
                except queue_mod.Empty:
                    dead = [r for r, p in enumerate(procs)
                            if p.exitcode not in (None, 0)
                            and r not in results]
                    if dead:             # killed before it could report
                        errors.append(f"rank {dead[0]} exited with code "
                                      f"{procs[dead[0]].exitcode}")
                        break
                    if time.monotonic() > deadline:
                        raise TimeoutError(
                            f"{world_size - len(results)} of {world_size} "
                            f"ranks gave no result in {timeout_s} s"
                        ) from None
                    continue
                if ok:
                    results[rank] = pickle.loads(val)
                else:
                    errors.append(f"rank {rank}:\n{val}")
                    break
            if errors:
                raise RuntimeError("a rank failed:\n" + "\n".join(errors))
        finally:
            for p in procs:
                p.join(timeout=30 if not errors else 5)
            for p in procs:
                if p.is_alive():
                    p.terminate()
                    p.join(5)
    return [results[r] for r in range(world_size)]


# ---------------------------------------------------------------------------
# manual axes and the mesh in use
# ---------------------------------------------------------------------------
def _frames() -> list:
    if not hasattr(_LOCAL, "frames"):
        _LOCAL.frames = []
    return _LOCAL.frames


@contextlib.contextmanager
def manual(mesh: TorchMesh, axes: Sequence[str]):
    """Inside, ``axes`` of ``mesh`` are manual: tensors are this rank's
    blocks along them, and the collectives below name them."""
    _frames().append((mesh, frozenset(axes)))
    try:
        yield
    finally:
        _frames().pop()


def frames() -> tuple:
    """This thread's manual regions, innermost last: what :func:`within`
    takes to enter them again elsewhere."""
    return tuple(_frames())


@contextlib.contextmanager
def within(saved: tuple):
    """Inside, the manual regions ``saved`` (from :func:`frames`) hold in
    this thread as they held where they were saved: the backward pass
    recomputes a checkpointed block on autograd's device thread, which
    would otherwise run it outside every manual region."""
    own = _frames()
    if own == list(saved):
        yield
        return
    before = list(own)
    own[:] = list(saved)
    try:
        yield
    finally:
        own[:] = before


def manual_axes() -> frozenset:
    out = frozenset()
    for _, axes in _frames():
        out |= axes
    return out


def current_mesh() -> Optional[TorchMesh]:
    frames = _frames()
    return frames[-1][0] if frames else None


def manual_size(axes) -> int:
    """The product of the sizes of the manual axes among ``axes``."""
    mesh, man = current_mesh(), manual_axes()
    if mesh is None:
        return 1
    return math.prod(mesh.shape[a] for a in _names(axes) if a in man)


def _names(axis) -> Tuple[str, ...]:
    if axis is None:
        return ()
    return tuple(axis) if isinstance(axis, (tuple, list)) else (axis,)


def _mesh_for(axis) -> Optional[TorchMesh]:
    mesh = current_mesh()
    if mesh is None and _names(axis):
        raise RuntimeError(f"collective over {axis!r} outside shard_map")
    return mesh


# ---------------------------------------------------------------------------
# transports
# ---------------------------------------------------------------------------
def _count(op: str, route: str) -> None:
    ROUTES.setdefault(op, {}).setdefault(route, 0)
    ROUTES[op][route] += 1


def _route(op: str, t: torch.Tensor) -> str:
    b = _STATE["backend"] or (dist.get_backend() if dist.is_initialized()
                              else "gloo")
    if b in ("nccl", "fake"):
        return b
    if not t.is_cuda:
        return "gloo"
    return "host" if op in HOST_ROUTED else "gloo-cuda"


def _pinned(t: torch.Tensor) -> torch.Tensor:
    h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    h.copy_(t)
    return h


_RECORDERS: list = []


@contextlib.contextmanager
def recording(sink: Callable):
    """Inside, every collective :func:`_carry` carries first calls
    ``sink(op, operand_bytes, ranks, axis)``: the collective's name, this
    rank's operand in bytes (the shard an all-gather sends, the whole
    input of a reduce-scatter), the global ranks of its group and its mesh
    axis."""
    _RECORDERS.append(sink)
    try:
        yield
    finally:
        _RECORDERS.remove(sink)


def _carry(op: str, t: torch.Tensor, body: Callable, out_shape=None,
           group=None, axis: Optional[str] = None) -> torch.Tensor:
    """Run ``body(src, dst) -> None`` (a blocking collective over
    ``group``, the process group of mesh axis ``axis``) for ``t``: on the
    device, or through pinned host memory where the backend does not carry
    ``op`` for a CUDA tensor.  Returns the destination."""
    route = _route(op, t)
    _count(op, route)
    quiet = contextlib.nullcontext()
    if _RECORDERS:
        from torch.utils._python_dispatch import _disable_current_modes
        ranks = tuple(dist.get_process_group_ranks(group))
        for sink in _RECORDERS:
            sink(op, t.numel() * t.element_size(), ranks, axis)
        # the transport's own work (gloo copies into the outputs, NCCL
        # does not) is the collective's, not the step's ops: hidden from
        # the recorders' dispatch modes
        quiet = _disable_current_modes()
    shape = t.shape if out_shape is None else out_shape
    t0 = time.perf_counter()
    if route != "host":
        src = t.contiguous()
        dst = torch.empty(shape, dtype=t.dtype, device=t.device)
        with quiet:
            body(src, dst)
    else:
        src = _pinned(t.contiguous())
        host = torch.empty(shape, dtype=t.dtype, pin_memory=True)
        with quiet:
            body(src, host)
        dst = host.to(t.device)
    if route not in ("nccl", "fake"):
        sec = ROUTE_SECONDS.setdefault(op, {})
        sec[route] = sec.get(route, 0.0) + time.perf_counter() - t0
    return dst


def _all_reduce(x: torch.Tensor, mesh: TorchMesh, axes, op) -> torch.Tensor:
    for a in _names(axes):
        g = mesh.group(a)

        def body(src, dst, g=g):
            dst.copy_(src)
            dist.all_reduce(dst, op=op, group=g)
        x = _carry("all_reduce", x, body, group=g, axis=a)
    return x


def _all_gather(x: torch.Tensor, mesh: TorchMesh, axis: str, dim: int
                ) -> torch.Tensor:
    n = mesh.shape[axis]
    g = mesh.group(axis)
    xm = x.movedim(dim, 0)
    shape = (n * xm.shape[0],) + tuple(xm.shape[1:])

    def body(src, dst):
        dist.all_gather(list(dst.chunk(n)), src, group=g)
    out = _carry("all_gather", xm, body, shape, group=g, axis=axis)
    # contiguous in the operand's layout: a product over a permuted view
    # could take another GEMM (and round otherwise) than over the whole
    return out.movedim(0, dim).contiguous()


def _reduce_scatter(x: torch.Tensor, mesh: TorchMesh, axis: str, dim: int
                    ) -> torch.Tensor:
    n = mesh.shape[axis]
    g = mesh.group(axis)
    xm = x.movedim(dim, 0)
    if xm.shape[0] % n:
        raise ValueError(f"psum_scatter: dim of {xm.shape[0]} over {n}")
    shape = (xm.shape[0] // n,) + tuple(xm.shape[1:])

    def body(src, dst):
        _REDUCE_SCATTER(dst, src, group=g)
    out = _carry("reduce_scatter", xm, body, shape, group=g, axis=axis)
    return out.movedim(0, dim).contiguous()


def _all_to_all(x: torch.Tensor, mesh: TorchMesh, axis: str,
                split_axis: int, concat_axis: int) -> torch.Tensor:
    n = mesh.shape[axis]
    g = mesh.group(axis)
    xm = x.movedim(split_axis, 0)
    if xm.shape[0] % n:
        raise ValueError(f"all_to_all: dim of {xm.shape[0]} over {n}")

    def body(src, dst):
        dist.all_to_all_single(dst, src, group=g)
    got = _carry("all_to_all", xm, body, group=g, axis=axis)
    # block j came from rank j: put it back in place of the split dim,
    # then concatenate the blocks along concat_axis
    blocks = [b.movedim(0, split_axis) for b in got.chunk(n)]
    return torch.cat(blocks, dim=concat_axis)


def _ppermute(x: torch.Tensor, mesh: TorchMesh, axis: str,
              perm: Sequence[Tuple[int, int]]) -> torch.Tensor:
    g = mesh.group(axis)
    ranks = dist.get_process_group_ranks(g)
    me = mesh.coord(axis)
    dst_of = {s: d for s, d in perm}
    src_of = {d: s for s, d in perm}

    def body(src, dst):
        if dst_of.get(me) == me:                 # a stage's edge to itself
            dst.copy_(src)
            return
        ops = []
        if me in dst_of:
            ops.append(dist.P2POp(dist.isend, src, ranks[dst_of[me]], g))
        if me in src_of:
            ops.append(dist.P2POp(dist.irecv, dst, ranks[src_of[me]], g))
        else:
            dst.zero_()
        if ops:
            for w in dist.batch_isend_irecv(ops):
                w.wait()
    return _carry("ppermute", x, body, group=g, axis=axis)


def all_sum(x: torch.Tensor, mesh: TorchMesh, axes) -> torch.Tensor:
    """The sum of ``x`` over the ranks of ``axes`` (no gradient)."""
    return _all_reduce(x, mesh, axes, dist.ReduceOp.SUM) if _names(axes) \
        else x


def all_min(x: torch.Tensor, mesh: TorchMesh, axes) -> torch.Tensor:
    """The elementwise minimum of ``x`` over the ranks of ``axes`` (no
    gradient)."""
    return _all_reduce(x, mesh, axes, dist.ReduceOp.MIN) if _names(axes) \
        else x


def gather_dim(x: torch.Tensor, mesh: TorchMesh, axis: str, dim: int
               ) -> torch.Tensor:
    """The ranks' blocks of ``axis`` concatenated along ``dim`` (no
    gradient)."""
    return _all_gather(x, mesh, axis, dim)


def scatter_sum(x: torch.Tensor, mesh: TorchMesh, axis: str, dim: int
                ) -> torch.Tensor:
    """The sum over the ranks of ``axis``, this rank's block along ``dim``
    (no gradient)."""
    return _reduce_scatter(x, mesh, axis, dim)


# ---------------------------------------------------------------------------
# differentiable collectives
# ---------------------------------------------------------------------------
class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return _all_reduce(x, mesh, axes, dist.ReduceOp.SUM)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.mesh, ctx.axes, dist.ReduceOp.SUM), \
            None, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return _all_gather(x, mesh, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter(g, ctx.mesh, ctx.axis, ctx.dim), None, \
            None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return _reduce_scatter(x, mesh, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.mesh, ctx.axis, ctx.dim), None, None, \
            None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, split_axis, concat_axis):
        ctx.args = (mesh, axis, split_axis, concat_axis)
        return _all_to_all(x, mesh, axis, split_axis, concat_axis)

    @staticmethod
    def backward(ctx, g):
        mesh, axis, split_axis, concat_axis = ctx.args
        return _all_to_all(g, mesh, axis, concat_axis, split_axis), None, \
            None, None, None


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, perm):
        ctx.args = (mesh, axis, perm)
        return _ppermute(x, mesh, axis, perm)

    @staticmethod
    def backward(ctx, g):
        mesh, axis, perm = ctx.args
        inv = tuple((d, s) for s, d in perm)
        return _ppermute(g, mesh, axis, inv), None, None, None


def _live(axis) -> Optional[TorchMesh]:
    """The mesh whose groups carry a collective over ``axis``, or ``None``
    where the collective is the identity (no ranks behind the mesh)."""
    mesh = _mesh_for(axis)
    if mesh is None or not mesh.live or not _names(axis):
        return None
    return mesh


def axis_index(axis: str) -> int:
    """This rank's index along ``axis``."""
    mesh = _mesh_for(axis)
    return 0 if mesh is None else mesh.coord(axis)


def axis_size(axis) -> int:
    mesh = _mesh_for(axis)
    if mesh is None:
        return 1
    return math.prod(mesh.shape[a] for a in _names(axis))


def psum(x: torch.Tensor, axis) -> torch.Tensor:
    mesh = _live(axis)
    return x if mesh is None else _PSum.apply(x, mesh, _names(axis))


def pmean(x: torch.Tensor, axis) -> torch.Tensor:
    return psum(x, axis) / axis_size(axis)


def pmax(x: torch.Tensor, axis) -> torch.Tensor:
    """The maximum over ``axis``; no gradient flows through it."""
    mesh = _live(axis)
    x = x.detach()
    return x if mesh is None else _all_reduce(x, mesh, _names(axis),
                                              dist.ReduceOp.MAX)


def all_gather(x: torch.Tensor, axis: str, axis_dim: int = 0,
               tiled: bool = True) -> torch.Tensor:
    """Concatenate the ranks' blocks along ``axis_dim`` (``tiled``); not
    tiled, stack them on a new leading dim."""
    if not tiled:
        x = x.unsqueeze(axis_dim)
    mesh = _live(axis)
    return x if mesh is None else _AllGather.apply(x, mesh, axis, axis_dim)


def psum_scatter(x: torch.Tensor, axis: str, scatter_dimension: int = 0,
                 tiled: bool = True) -> torch.Tensor:
    mesh = _live(axis)
    if mesh is None:
        return x if tiled else x.squeeze(scatter_dimension)
    out = _ReduceScatter.apply(x, mesh, axis, scatter_dimension)
    return out if tiled else out.squeeze(scatter_dimension)


def all_to_all(x: torch.Tensor, axis: str, split_axis: int,
               concat_axis: int) -> torch.Tensor:
    """``lax.all_to_all(..., tiled=True)``: block j of ``split_axis`` goes
    to rank j, the blocks received are concatenated along
    ``concat_axis``."""
    mesh = _live(axis)
    if mesh is None:
        return x
    return _AllToAll.apply(x, mesh, axis, split_axis, concat_axis)


def ppermute(x: torch.Tensor, axis: str,
             perm: Sequence[Tuple[int, int]]) -> torch.Tensor:
    """Send this rank's ``x`` along the (source, destination) pairs of
    ``perm``; a rank that no pair targets receives zeros."""
    mesh = _live(axis)
    if mesh is None:
        src_of = {d: s for s, d in perm}
        return x if src_of.get(0) == 0 else torch.zeros_like(x)
    return _PPermute.apply(x, mesh, axis, tuple(perm))


# ---------------------------------------------------------------------------
# shard_map
# ---------------------------------------------------------------------------
class _Split(torch.autograd.Function):
    """This rank's block of a global tensor.  Backward: the cotangent
    blocks gathered over the axes that split the tensor and summed over
    the other (non-manual) axes of the mesh."""

    @staticmethod
    def forward(ctx, x, mesh, spec, free):
        ctx.mesh, ctx.spec, ctx.free = mesh, spec, free
        idx = []
        for d, e in enumerate(spec):
            axes = [a for a in spec_axes(e) if a in free]
            i, n = 0, 1
            for a in axes:
                i, n = i * mesh.shape[a] + mesh.coord(a), n * mesh.shape[a]
            size = x.shape[d] // n
            idx.append(slice(i * size, (i + 1) * size))
        return x[tuple(idx)].clone()

    @staticmethod
    def backward(ctx, g):
        mesh, spec, free = ctx.mesh, ctx.spec, ctx.free
        used = set()
        for d, e in enumerate(spec):
            axes = [a for a in spec_axes(e) if a in free]
            used.update(axes)
            for a in reversed(axes):             # minor axis first
                g = _all_gather(g, mesh, a, d)
        rest = tuple(a for a in mesh.axis_names if a in free
                     and a not in used)
        if rest:
            g = _all_reduce(g, mesh, rest, dist.ReduceOp.SUM)
        return g, None, None, None


class _Scale(torch.autograd.Function):
    """The identity, with its cotangent scaled: a replicated output's
    cotangent reaches every rank's copy."""

    @staticmethod
    def forward(ctx, x, factor):
        ctx.factor = factor
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.factor, None


def _pad_spec(spec, ndim: int) -> tuple:
    spec = tuple(spec)
    return spec + (None,) * (ndim - len(spec))


def _split(x, mesh, spec, free):
    if not isinstance(x, torch.Tensor):
        return x
    return _Split.apply(x, mesh, _pad_spec(spec, x.dim()), free)


def _assemble(y, mesh, spec, free):
    if not isinstance(y, torch.Tensor):
        return y
    spec = _pad_spec(spec, y.dim())
    for d, e in enumerate(spec):
        axes = [a for a in spec_axes(e) if a in free]
        for a in reversed(axes):                 # minor axis first
            y = _AllGather.apply(y, mesh, a, d)
    # every free rank now holds the whole output: each rank's copy takes
    # 1 / (free ranks) of the cotangent, so their sum is the cotangent
    rep = math.prod(mesh.shape[a] for a in mesh.axis_names if a in free)
    return _Scale.apply(y, 1.0 / rep) if rep > 1 and y.requires_grad else y


def _specs_like(tree, specs):
    """One spec per leaf: a :class:`P` applies to every leaf of its
    subtree."""
    if isinstance(specs, P) or specs is None:
        return tree_map(lambda _: specs if specs is not None else P(), tree)
    if isinstance(tree, dict):
        return {k: _specs_like(v, specs[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [_specs_like(v, s) for v, s in zip(tree, specs)]
        return type(tree)(out) if isinstance(tree, list) else tuple(out)
    return specs


def shard_map(fn: Callable, mesh: TorchMesh, in_specs, out_specs
              ) -> Callable:
    """``fn`` over this rank's blocks of global inputs (``in_specs``, one
    per argument, a :class:`P` or a tree of them), its outputs assembled
    by ``out_specs``.  On a mesh without ranks (one device) the blocks are
    the whole tensors and the collectives inside are identities."""
    def run(*args):
        if not mesh.live:
            if mesh.size > 1:
                raise RuntimeError("shard_map over an abstract mesh: no "
                                   "ranks behind its axes")
            with manual(mesh, mesh.axis_names):
                return fn(*args)
        free = frozenset(mesh.axis_names) - manual_axes()
        specs = in_specs if isinstance(in_specs, (list, tuple)) \
            and not isinstance(in_specs, P) else (in_specs,) * len(args)
        local = [tree_map(lambda t, s: _split(t, mesh, s, free), a,
                          _specs_like(a, s)) for a, s in zip(args, specs)]
        with manual(mesh, mesh.axis_names):
            out = fn(*local)
        return tree_map(lambda t, s: _assemble(t, mesh, s, free), out,
                        _specs_like(out, out_specs))
    return run

