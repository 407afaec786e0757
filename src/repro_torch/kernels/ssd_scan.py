"""Chunked gated linear recurrence (SSD / Mamba2 / mLSTM core), forward
kernel plus recompute backward.

Port of ``src/repro/kernels/ssd_scan.py:ssd_scan`` as wrapped by
``src/repro/kernels/ops.py:ssd_scan``.  The CUDA kernel is
``csrc/ssd_scan.cu`` (its header gives the design and the bound).

    h_t = exp(log_a_t) h_{t-1} + k_t v_t^T ;   y_t = q_t . h_t

:func:`ssd_scan` runs the plain PyTorch version (:func:`ssd_scan_plain`, a
chunkwise loop with the TPU kernel's arithmetic) for CPU tensors and launches
the kernel for CUDA tensors; ``ssd_scan.launches`` counts the launches.
Where it differs from the TPU kernel: it can return the final fp32 state
(prefill hands it to decode), it takes any S (the tail chunk is masked), q
and k may have G < H heads (read as head ``h // (H/G)``), and ``out_dtype``
overrides the output type (the model path keeps y in fp32).  As in the
reference, the backward pass has no kernel: it recomputes through the plain
version (``ops.py`` does the same through ``ref.ssd_scan_ref``).
"""

from __future__ import annotations

import ctypes
import threading
from typing import Dict, Optional

import torch

from . import backend

CLIP = (-60.0, 0.0)              # the TPU kernel's exponent clip
P_TILES = (64, 32, 16)           # the kernel's P-tile template sizes
_TILE, _NB = 64, 64              # csrc/ssd_scan.cu: kTile, kNB
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_count_lock = threading.Lock()
_limits: Dict[int, tuple] = {}


def _lib() -> ctypes.CDLL:
    lib = backend.load("ssd_scan")
    if not getattr(lib, "_ff_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.ssd_scan_launch.argtypes = [p] * 6 + [i] * 13 + [p]
        lib.ssd_scan_launch.restype = i
        lib.ssd_scan_smem_optin.argtypes = [ctypes.POINTER(i)]
        lib.ssd_scan_smem_optin.restype = i
        lib._ff_typed = True
    return lib


def _exp_clip(x: torch.Tensor) -> torch.Tensor:
    return torch.exp(torch.clamp(x, *CLIP))


def ssd_scan_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   log_a: torch.Tensor, chunk: int = 128, *,
                   out_dtype: Optional[torch.dtype] = None):
    """Plain version: the chunks in a Python loop, each chunk's Q x Q
    scores whole, in fp32.  Returns ``(y, state)``: y ``(B,H,S,P)`` in
    ``out_dtype`` (default q's type) and the final state ``(B,H,N,P)`` in
    fp32.  The tail chunk is padded with steps of log_a 0 and zero q, k, v,
    which leave the state as it is."""
    B, G, S, N = q.shape
    H, P = v.shape[1], v.shape[3]
    out_dtype = out_dtype or q.dtype
    if G != H:
        q = q.repeat_interleave(H // G, dim=1)
        k = k.repeat_interleave(H // G, dim=1)
    h = torch.zeros((B, H, N, P), dtype=torch.float32, device=q.device)
    if S == 0:
        return torch.zeros((B, H, 0, P), dtype=out_dtype, device=q.device), h
    Q = min(chunk, S)
    pad = -S % Q
    qf, kf, vf = (torch.nn.functional.pad(t.float(), (0, 0, 0, pad))
                  for t in (q, k, v))
    la = torch.nn.functional.pad(log_a.float(), (0, pad))
    mask = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=q.device))
    ys = []
    for c0 in range(0, S + pad, Q):
        qc, kc, vc = (t[:, :, c0:c0 + Q] for t in (qf, kf, vf))
        cum = torch.cumsum(la[:, :, c0:c0 + Q], dim=-1)     # inclusive
        tot = cum[..., -1]
        s = torch.einsum("bhtn,bhsn->bhts", qc, kc)
        decay = _exp_clip(cum[..., :, None] - cum[..., None, :])
        w = torch.where(mask, s * decay, torch.zeros((), device=q.device))
        y = torch.einsum("bhts,bhsp->bhtp", w, vc) \
            + _exp_clip(cum)[..., None] * torch.einsum("bhtn,bhnp->bhtp", qc, h)
        dk = _exp_clip(tot[..., None] - cum)[..., None] * kc
        h = _exp_clip(tot)[..., None, None] * h \
            + torch.einsum("bhsn,bhsp->bhnp", dk, vc)
        ys.append(y)
    return torch.cat(ys, dim=2)[:, :, :S].to(out_dtype), h


def _check(q, k, v, log_a) -> None:
    if q.dim() != 4 or k.shape != q.shape or v.dim() != 4:
        raise ValueError(f"ssd_scan needs q, k (B,G,S,N) and v (B,H,S,P); "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, G, S, _N = q.shape
    H = v.shape[1]
    if v.shape[0] != B or v.shape[2] != S or G < 1 or H % G:
        raise ValueError(f"ssd_scan: v {tuple(v.shape)} does not fit q "
                         f"{tuple(q.shape)} (same B and S, G | H)")
    if tuple(log_a.shape) != (B, H, S):
        raise ValueError(f"ssd_scan: log_a {tuple(log_a.shape)}, expected "
                         f"{(B, H, S)}")


def smem_bytes(N: int, pt: int, Q: int) -> int:
    """Dynamic shared memory of one block (csrc/ssd_scan.cu's layout)."""
    return 4 * (N * pt + 2 * _TILE * (_NB + 1) + _TILE * pt
                + _TILE * (_TILE + 1) + Q)


def _device_limits(device: torch.device) -> tuple:
    """(SM count, shared memory a block may opt in to), read once; the
    opt-in size comes from the kernel's library, which raises its launch
    limit to the same attribute."""
    idx = device.index if device.index is not None else \
        torch.cuda.current_device()
    if idx not in _limits:
        optin = ctypes.c_int(0)
        with torch.cuda.device(idx):
            backend.check(_lib().ssd_scan_smem_optin(ctypes.byref(optin)),
                          "ssd_scan")
        _limits[idx] = (torch.cuda.get_device_properties(idx)
                        .multi_processor_count, optin.value)
    return _limits[idx]


def p_tile(B: int, H: int, P: int, N: int, Q: int, sms: int,
           smem_limit: int) -> int:
    """The P-tile width: the smallest template that covers P, halved while
    half as many blocks again would still fit one wave of the card's SMs
    (more blocks for a small B x H, at the cost of scoring once per tile),
    and halved further if the state slice does not fit shared memory."""
    pt = next((t for t in reversed(P_TILES) if t >= P), P_TILES[0])
    while pt > P_TILES[-1] and 2 * B * H * -(-P // pt) <= sms:
        pt //= 2
    while pt > P_TILES[-1] and smem_bytes(N, pt, Q) > smem_limit:
        pt //= 2
    if smem_bytes(N, pt, Q) > smem_limit:
        raise ValueError(f"ssd_scan kernel: N {N} and chunk {Q} need "
                         f"{smem_bytes(N, pt, Q)} bytes of shared memory, "
                         f"more than the card's {smem_limit}")
    return pt


def _launch(q, k, v, log_a, chunk: int, out_dtype: torch.dtype):
    B, G, S, N = q.shape
    H, P = v.shape[1], v.shape[3]
    for name, t in (("q", q), ("k", k), ("v", v), ("log_a", log_a)):
        if t.dtype not in _DTYPES:
            raise TypeError(f"ssd_scan kernel takes float32 or bfloat16 "
                            f"tensors; {name} is {t.dtype}")
        if t.device != q.device:
            raise ValueError("ssd_scan: inputs on different devices")
        if not t.is_contiguous():
            raise ValueError(f"ssd_scan kernel takes contiguous tensors; "
                             f"{name} is not")
    if k.dtype != q.dtype:
        raise TypeError(f"ssd_scan kernel takes q and k of one type; got "
                        f"{q.dtype}, {k.dtype}")
    if out_dtype not in _DTYPES:
        raise TypeError(f"ssd_scan kernel writes float32 or bfloat16, not "
                        f"{out_dtype}")
    if chunk < 1 or max(B, H, S, N, P) >= 2 ** 31:
        raise ValueError(f"ssd_scan: sizes out of range (B {B}, H {H}, "
                         f"S {S}, N {N}, P {P}, chunk {chunk})")
    y = torch.empty((B, H, S, P), dtype=out_dtype, device=q.device)
    if S == 0 or B == 0 or N == 0 or P == 0:
        return y, torch.zeros((B, H, N, P), dtype=torch.float32,
                              device=q.device)
    state = torch.empty((B, H, N, P), dtype=torch.float32, device=q.device)
    Q = min(chunk, S)
    sms, smem_limit = _device_limits(q.device)
    pt = p_tile(B, H, P, N, Q, sms, smem_limit)
    err = _lib().ssd_scan_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), log_a.data_ptr(),
        y.data_ptr(), state.data_ptr(), B, H, G, S, N, P, Q, pt,
        smem_bytes(N, pt, Q), _DTYPES[q.dtype], _DTYPES[v.dtype],
        _DTYPES[log_a.dtype], _DTYPES[out_dtype],
        backend.current_stream(q.device))
    with _count_lock:
        ssd_scan.launches += 1
    backend.check(err, "ssd_scan")
    return y, state


class _SSDScan(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, log_a, chunk, out_dtype):
        ctx.save_for_backward(q, k, v, log_a)
        ctx.chunk, ctx.out_dtype = chunk, out_dtype
        if backend.use_kernel(q):
            return _launch(q, k, v, log_a, chunk, out_dtype)
        return ssd_scan_plain(q, k, v, log_a, chunk, out_dtype=out_dtype)

    @staticmethod
    def backward(ctx, gy, gstate):
        q, k, v, log_a = ctx.saved_tensors
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(True) for t in (q, k, v, log_a)]
            y, state = ssd_scan_plain(*leaves, ctx.chunk,
                                      out_dtype=ctx.out_dtype)
            grads = torch.autograd.grad((y, state), leaves, (gy, gstate),
                                        allow_unused=True)
        return tuple(grads) + (None, None)


def ssd_scan(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             log_a: torch.Tensor, chunk: int = 128, *,
             out_dtype: Optional[torch.dtype] = None,
             return_state: bool = False):
    """q, k ``(B,G,S,N)``; v ``(B,H,S,P)``; log_a ``(B,H,S)`` with ``G | H``
    -> y ``(B,H,S,P)`` in ``out_dtype`` (default q's type), and with
    ``return_state`` also the final fp32 state ``(B,H,N,P)``.  Chunks of
    ``min(chunk, S)`` steps; any S.  The kernel takes float32 or bfloat16
    inputs and N as far as its (N, P-tile) state slice fits shared memory
    (at chunk 256: N 645 with 64-column tiles, 2772 with 16)."""
    _check(q, k, v, log_a)
    y, state = _SSDScan.apply(q, k, v, log_a, int(chunk),
                              out_dtype or q.dtype)
    return (y, state) if return_state else y


ssd_scan.launches = 0
