"""MoE top-K router with first-come capacity positions.

Port of ``src/repro/kernels/router_topk.py:router_topk`` as wrapped by
``src/repro/kernels/ops.py:router_topk`` (routing carries no gradient: the
logits are detached, as the reference stops the gradient).  The CUDA kernel
is ``csrc/router_topk.cu`` (its header gives the design and the bound).

:func:`router_topk` runs :func:`router_topk_plain` for CPU tensors and
launches the kernel for CUDA tensors; ``router_topk.launches`` counts the
launches.  The plain version repeats the kernel's arithmetic (``exp(x -
max)`` summed left to right, repeated argmax with the first index on ties,
the weights' sum taken in k order), so on the card the two agree exactly on
``idx``, ``pos`` and ``keep``.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Tuple

import torch

from . import backend

_SMEM_MAX = 232448          # bytes of shared memory one Hopper block may use
MAX_K = 8
_count_lock = threading.Lock()


def _lib() -> ctypes.CDLL:
    lib = backend.load("router_topk")
    if not getattr(lib, "_ff_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.router_topk_smem_bytes.argtypes = [i, i]
        lib.router_topk_smem_bytes.restype = ctypes.c_longlong
        lib.router_topk_launch.argtypes = [p, i, i, i, i, p, p, p, p, p]
        lib.router_topk_launch.restype = i
        lib._ff_typed = True
    return lib


Routing = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def router_topk_plain(logits: torch.Tensor, top_k: int,
                      capacity: int) -> Routing:
    """Plain version of :func:`router_topk`, with the kernel's arithmetic."""
    x = logits.detach().float()
    T, E = x.shape
    u = torch.exp(x - x.amax(dim=-1, keepdim=True))
    s = u[:, 0]
    for j in range(1, E):
        s = s + u[:, j]
    masked = u / s[:, None]
    ws, idxs = [], []
    for _ in range(top_k):
        i = torch.argmax(masked, dim=-1, keepdim=True)
        ws.append(masked.gather(1, i))
        idxs.append(i)
        masked = masked.scatter(1, i, -1.0)      # below every probability
    total = ws[0]
    for w in ws[1:]:
        total = total + w
    w = torch.cat(ws, dim=1) / torch.clamp(total, min=1e-9)
    idx = torch.cat(idxs, dim=1)
    onehot = torch.nn.functional.one_hot(idx.reshape(-1), E).to(torch.int32)
    pos = (torch.cumsum(onehot, dim=0) * onehot).sum(-1) - 1
    pos = pos.reshape(T, top_k).to(torch.int32)
    return w, idx.to(torch.int32), pos, pos < capacity


def router_topk(logits: torch.Tensor, top_k: int, capacity: int) -> Routing:
    """logits ``(T, E)`` -> ``(w (T,K) float32, idx (T,K) int32, pos (T,K)
    int32, keep (T,K) bool)``: each token's top-K experts and renormalised
    weights, each (token, k) entry's first-come position in its expert's
    lane, and whether that position is below ``capacity``."""
    if logits.dim() != 2 or logits.shape[1] < 1:
        raise ValueError(f"router_topk needs logits (T, E>=1), got "
                         f"{tuple(logits.shape)}")
    T, E = logits.shape
    if not 1 <= top_k <= min(E, MAX_K):
        raise ValueError(f"router_topk takes 1 <= top_k <= min(E, {MAX_K}); "
                         f"got top_k={top_k}, E={E}")
    if not backend.use_kernel(logits):
        return router_topk_plain(logits, top_k, capacity)
    if T >= 2 ** 31 // top_k:
        raise ValueError(f"router_topk: too many tokens ({T})")
    lib = _lib()
    smem = lib.router_topk_smem_bytes(E, top_k)
    if smem > _SMEM_MAX:
        raise ValueError(f"router_topk: {E} experts need {smem} bytes of "
                         f"shared memory, more than the {_SMEM_MAX} a block "
                         f"has")
    x = logits.detach().float().contiguous()
    w = torch.empty(T, top_k, dtype=torch.float32, device=x.device)
    idx = torch.empty(T, top_k, dtype=torch.int32, device=x.device)
    pos = torch.empty(T, top_k, dtype=torch.int32, device=x.device)
    keep = torch.empty(T, top_k, dtype=torch.bool, device=x.device)
    if T == 0:
        return w, idx, pos, keep
    cap = max(-2 ** 31, min(int(capacity), 2 ** 31 - 1))
    err = lib.router_topk_launch(x.data_ptr(), T, E, top_k, cap, w.data_ptr(),
                                 idx.data_ptr(), pos.data_ptr(),
                                 keep.data_ptr(),
                                 backend.current_stream(x.device))
    with _count_lock:
        router_topk.launches += 1
    backend.check(err, "router_topk")
    return w, idx, pos, keep


router_topk.launches = 0
