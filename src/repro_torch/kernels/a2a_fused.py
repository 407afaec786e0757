"""The fused all-to-all hop: route, expert compute, combine.

Port of ``src/repro/kernels/a2a_fused.py:a2a_fused``.  The TPU kernel traces
the user's expert functions into its body; a CUDA kernel cannot call Python,
so the hop is three parts (see ``csrc/a2a_fused.cu`` for the kernels' design
and bounds):

1. :func:`a2a_route` — softmax + top-1 route and first-come capacity
   positions, a CUDA kernel: the top-1 case of the router's multi-block
   scan (``csrc/route_scan.cuh``, grid by ``router_topk.launch_plan``);
2. the expert compute — every expert applied to every token with
   ``torch.func.vmap``, as the TPU kernel computes all and then selects;
3. :func:`a2a_combine` — the routed output selected per token and tokens
   past capacity zero-filled, a CUDA kernel.

Each kernel wrapper runs its plain PyTorch version (``*_plain``) for a CPU
tensor and launches the kernel for a CUDA tensor; ``launches`` on the
wrapper counts the kernel launches (a fake CUDA tensor launches nothing
and hands the launch to ``backend.note_launch``);
``route_work``/``combine_work`` are the bounds' operations and bytes.
"""

from __future__ import annotations

import ctypes
import math
from typing import Callable, Sequence, Tuple

import torch

from . import backend
from ..core.perf_model import H100_SXM
from .router_topk import launch_plan, workspace


def _lib() -> ctypes.CDLL:
    lib = backend.load("a2a_fused")
    if not getattr(lib, "_ff_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.a2a_route_smem_bytes.argtypes = [i, i, i]
        lib.a2a_route_smem_bytes.restype = ctypes.c_longlong
        lib.a2a_route_launch.argtypes = [p, i, i, i, i, i, i] + [p] * 5
        lib.a2a_route_launch.restype = i
        lib.a2a_combine_launch.argtypes = [p, p, p, p, ctypes.c_longlong,
                                           ctypes.c_longlong, i, p]
        lib.a2a_combine_launch.restype = i
        lib._ff_typed = True
    return lib


# ---------------------------------------------------------------------------
# route: softmax + top-1 + first-come lane position
# ---------------------------------------------------------------------------
def a2a_route_plain(logits: torch.Tensor, capacity: int
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of :func:`a2a_route`, with the kernel's arithmetic:
    ``exp(x - max)`` summed left to right, divided, argmax of the
    probabilities (first index on ties)."""
    x = logits.to(torch.float32)
    T, E = x.shape
    u = torch.exp(x - x.amax(dim=-1, keepdim=True))
    s = u[:, 0]
    for j in range(1, E):
        s = s + u[:, j]
    idx = torch.argmax(u / s[:, None], dim=-1)
    # compared with the experts, not F.one_hot, which reads the indices'
    # range on the host
    onehot = (idx[:, None] == torch.arange(E, device=idx.device)).to(
        torch.int32)
    pos = (torch.cumsum(onehot, dim=0) * onehot).sum(-1) - 1
    return idx.to(torch.int32), pos.to(torch.int32), pos < capacity


def a2a_route(logits: torch.Tensor, capacity: int
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """logits ``(T, E)`` -> ``(idx (T,) int32, pos (T,) int32, keep (T,)
    bool)``: each token's expert, its first-come rank in that expert's lane,
    and whether that rank is below ``capacity``."""
    if logits.dim() != 2 or logits.shape[1] < 1:
        raise ValueError(f"a2a_route needs logits (T, E>=1), got "
                         f"{tuple(logits.shape)}")
    if backend.noted():
        backend.note("a2a_route", route_work(*logits.shape))
    if not backend.use_kernel(logits):
        return a2a_route_plain(logits, capacity)
    T, E = logits.shape
    if T >= 2 ** 31:
        raise ValueError(f"a2a_route takes fewer than 2**31 tokens (got {T})")
    plan = launch_plan(T, E, 1)
    x = logits.to(torch.float32).contiguous()
    idx = torch.empty(T, dtype=torch.int32, device=x.device)
    pos = torch.empty(T, dtype=torch.int32, device=x.device)
    keep = torch.empty(T, dtype=torch.bool, device=x.device)
    if T == 0:
        return idx, pos, keep
    ws = workspace(plan, x.device)
    cap = max(-2 ** 31, min(int(capacity), 2 ** 31 - 1))
    if backend.is_fake(x):
        backend.note_launch("a2a_route")
        return idx, pos, keep
    err = _lib().a2a_route_launch(
        x.data_ptr(), T, E, cap, plan.blocks, plan.tokens_per_block,
        plan.threads, idx.data_ptr(), pos.data_ptr(), keep.data_ptr(),
        None if ws is None else ws.data_ptr(),
        backend.current_stream(x.device))
    a2a_route.launches += 1
    backend.check(err, "a2a_route")
    return idx, pos, keep


a2a_route.launches = 0


def route_work(T: int, E: int) -> backend.Work:
    """fp32 logits read once, idx and pos (4 bytes) and keep (1) written
    once a token; a sub, exp, add, div and compare an element, in fp32."""
    ops = T * E * 5
    return backend.Work(ops, T * E * 4 + T * (4 + 4 + 1),
                        ops / H100_SXM.peak_flops_f32)


# ---------------------------------------------------------------------------
# combine: select the routed expert's output, zero-fill the dropped tokens
# ---------------------------------------------------------------------------
def a2a_combine_plain(ys: torch.Tensor, idx: torch.Tensor,
                      keep: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`a2a_combine`."""
    T = idx.shape[0]
    sel = ys[idx.long(), torch.arange(T, device=ys.device)]
    mask = keep.reshape((T,) + (1,) * (sel.dim() - 1))
    return torch.where(mask, sel, torch.zeros((), dtype=sel.dtype,
                                              device=sel.device))


def a2a_combine(ys: torch.Tensor, idx: torch.Tensor,
                keep: torch.Tensor) -> torch.Tensor:
    """ys ``(E, T, *out)``, idx ``(T,)`` int32 in ``[0, E)``, keep ``(T,)``
    bool -> ``(T, *out)``: ``out[t] = ys[idx[t], t]`` where ``keep[t]``,
    else zeros.  Pure selection: no arithmetic touches the values."""
    if ys.dim() < 2 or idx.shape != (ys.shape[1],) or keep.shape != idx.shape:
        raise ValueError(f"a2a_combine: ys {tuple(ys.shape)}, idx "
                         f"{tuple(idx.shape)}, keep {tuple(keep.shape)}")
    if backend.noted():
        backend.note("a2a_combine", combine_work(
            ys.shape[1], math.prod(ys.shape[2:]) * ys.element_size()))
    if not backend.use_kernel(ys):
        return a2a_combine_plain(ys, idx, keep)
    if idx.dtype != torch.int32 or keep.dtype != torch.bool:
        raise TypeError("a2a_combine needs idx int32 and keep bool")
    if idx.device != ys.device or keep.device != ys.device:
        raise ValueError("a2a_combine: ys, idx and keep on different devices")
    ys = ys.contiguous()
    idx = idx.contiguous()
    keep = keep.contiguous()
    T = ys.shape[1]
    out = torch.empty(ys.shape[1:], dtype=ys.dtype, device=ys.device)
    row_bytes = math.prod(ys.shape[2:]) * ys.element_size()
    if T == 0 or row_bytes == 0:
        return out
    if backend.is_fake(ys):
        backend.note_launch("a2a_combine")
        return out
    unit = next(u for u in (16, 8, 4, 2, 1)
                if row_bytes % u == 0 and ys.data_ptr() % u == 0
                and out.data_ptr() % u == 0)
    err = _lib().a2a_combine_launch(
        ys.data_ptr(), idx.data_ptr(), keep.data_ptr(), out.data_ptr(),
        T, row_bytes, unit, backend.current_stream(ys.device))
    a2a_combine.launches += 1
    backend.check(err, "a2a_combine")
    return out


a2a_combine.launches = 0


def combine_work(T: int, row_bytes: int, kept=None) -> backend.Work:
    """idx (4 bytes) and keep (1) read a token, the ``kept`` tokens' rows
    read (all ``T`` unless the data says how many), every row written; no
    arithmetic."""
    kept = T if kept is None else kept
    return backend.Work(0, T * (4 + 1) + kept * row_bytes + T * row_bytes,
                        0.0)


# ---------------------------------------------------------------------------
# the whole hop
# ---------------------------------------------------------------------------
def a2a_fused(logits: torch.Tensor, xs: torch.Tensor,
              expert_fns: Sequence[Callable], capacity: int
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """logits ``(T, E)``; xs ``(T, *item)`` already left-mapped items;
    ``expert_fns`` the E right workers (per-item torch functions agreeing on
    output shape/dtype).  Returns ``(out (T, *expert_out), keep (T,))`` with
    over-capacity tokens zero-filled and ``keep=False``."""
    T, E = logits.shape
    if len(expert_fns) != E:
        raise ValueError(f"logits width {E} != {len(expert_fns)} experts")
    ys = [torch.func.vmap(fn)(xs) for fn in expert_fns]
    if any(y.shape != ys[0].shape or y.dtype != ys[0].dtype for y in ys[1:]):
        raise ValueError("a2a experts must agree on output shape/dtype: "
                         f"{[(tuple(y.shape[1:]), str(y.dtype)) for y in ys]}")
    idx, _pos, keep = a2a_route(logits, capacity)
    return a2a_combine(torch.stack(ys), idx, keep), keep
