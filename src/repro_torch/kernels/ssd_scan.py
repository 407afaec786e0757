"""Chunked gated linear recurrence (SSD / Mamba2 / mLSTM core), forward
kernel plus recompute backward.

Port of ``src/repro/kernels/ssd_scan.py:ssd_scan`` as wrapped by
``src/repro/kernels/ops.py:ssd_scan``.  The CUDA kernel is
``csrc/ssd_scan.cu`` (its header gives the design and the bound).

    h_t = exp(log_a_t) h_{t-1} + k_t v_t^T ;   y_t = q_t . h_t

:func:`ssd_scan` runs the plain PyTorch version (:func:`ssd_scan_plain`, a
chunkwise loop with the TPU kernel's arithmetic) for CPU tensors and launches
the kernel for CUDA tensors; ``ssd_scan.launches`` counts the launches (a
fake CUDA tensor launches nothing and hands the launch to
``backend.note_launch``, its grid planned for an H100 SXM's SMs and shared
memory; :func:`work` is the bound's operations and bytes).
Where it differs from the TPU kernel: it can return the final fp32 state
(prefill hands it to decode), it takes any S (the tail chunk is masked), q
and k may have G < H heads (read as head ``h // (H/G)``), and ``out_dtype``
overrides the output type (the model path keeps y in fp32).  The kernel
runs a block per (b, h, chunk), the chunks of a head chained through the
state; the wrapper allocates the chunk states, the last of which is the
final state, and the kernel's zeroed ticket and flags.  As in the
reference, the backward pass has no kernel: it recomputes through the plain
version and takes its VJP, the port of ``ops.py``'s VJP rule
(``_ssd_bwd_rule``: ``jax.vjp`` of ``ref.ssd_scan_ref``), with the final
state's cotangent added (autograd hands zeros when the state is unused).
The profiler sees it as the range ``ssd_scan.recompute_backward``.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Dict, NamedTuple, Optional

import torch

from . import backend
from ..core.perf_model import H100_SXM

CLIP = (-60.0, 0.0)              # the TPU kernel's exponent clip
TILE, LD_F32, LD_W = 64, 72, 68  # csrc/ssd_scan.cu: kT, kLdF, kLdW
THREADS = 256                    # csrc/ssd_scan.cu: kThreads
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


def score_tiles(P: int, Q: int) -> int:
    """Weighted-score tiles a block keeps in shared memory: one, or every
    key tile of the chunk when P spans several 64-column tiles (so the
    scores are not recomputed for each of them)."""
    return -(-Q // TILE) if P > TILE else 1


def smem_bytes(P: int, Q: int) -> int:
    """Dynamic shared memory of one block (csrc/ssd_scan.cu's layout): the
    cumsum and its two exponentials, the score tiles, two buffers of two
    staged tiles, the block's ticket."""
    qp = -(-Q // TILE) * TILE
    return 4 * (3 * qp + score_tiles(P, Q) * TILE * LD_W
                + 4 * TILE * LD_F32 + 1)


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


class LaunchPlan(NamedTuple):
    blocks: int          # one per (b, h, chunk)
    score_tiles: int     # weighted-score tiles kept in shared memory
    smem: int            # dynamic shared memory of a block, bytes
    waves: float         # blocks over the blocks the card holds at once


def launch_plan(B: int, H: int, S: int, P: int, Q: int, sms: int,
                smem_limit: int) -> LaunchPlan:
    """One block per (b, h, chunk), so B*H*ceil(S/Q) blocks fill the card
    without a P split (Zamba2 at B 1, S 2048: 512 blocks on 132 SMs) and the
    scores of a chunk are computed once; the chunks of a head chain through
    the state.  Raises if a block's shared memory, set by the chunk (and by
    P > 64, which keeps every score tile of the chunk), exceeds the card's
    opt-in limit.  ``waves`` counts the blocks an SM holds by shared memory
    (228 KB an SM on an H100) and threads (2048)."""
    smem = smem_bytes(P, Q)
    if smem > smem_limit:
        raise ValueError(f"ssd_scan kernel: chunk {Q} with P {P} needs "
                         f"{smem} bytes of shared memory, more than the "
                         f"card's {smem_limit}")
    blocks = -(-S // Q) * B * H
    if blocks >= 2 ** 31:
        raise ValueError(f"ssd_scan: sizes out of range ({blocks} chunks "
                         f"of {Q} steps over B*H)")
    per_sm = max(1, min((smem_limit + 1024) // (smem + 1024),
                        2048 // THREADS))
    return LaunchPlan(blocks, score_tiles(P, Q), smem,
                      blocks / (sms * per_sm))


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
    Q = min(chunk, S)
    fake = backend.is_fake(q)
    limits = (H100_SXM.sms, H100_SXM.smem_per_block) if fake \
        else _device_limits(q.device)
    plan = launch_plan(B, H, S, P, Q, *limits)
    # the chunks' states (the last is the final state), then the zeroed
    # int32 words of the kernel's block ticket and chunk flags
    nc, words = -(-S // Q), B * H * N * P
    buf = torch.empty(nc * words + 1 + nc * B * H, dtype=torch.float32,
                      device=q.device)
    buf[nc * words:].view(torch.int32).zero_()
    if fake:
        backend.note_launch("ssd_scan")
    else:
        err = _lib().ssd_scan_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), log_a.data_ptr(),
            y.data_ptr(), buf.data_ptr(), B, H, G, S, N, P, Q,
            plan.score_tiles, plan.smem, _DTYPES[q.dtype], _DTYPES[v.dtype],
            _DTYPES[log_a.dtype], _DTYPES[out_dtype],
            backend.current_stream(q.device))
        with _count_lock:
            ssd_scan.launches += 1
        backend.check(err, "ssd_scan")
    state = buf[(nc - 1) * words:nc * words].view(B, H, N, P)
    # a copy, so the other chunks' states are not kept alive with it
    return y, (state.clone() if nc > 1 else state)


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
        with torch.enable_grad(), torch.profiler.record_function(
                "ssd_scan.recompute_backward"):
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
    inputs, any N and P, and a chunk as far as a block's shared memory
    holds it (:func:`smem_bytes`: at P <= 64 a chunk of 11712 steps, at
    P > 64 of 512).  bf16 q/k score on the tensor cores, f32 q/k by fp32
    FMAs; every product with an f32 operand keeps fp32 accuracy (3xTF32 on
    the tensor cores)."""
    _check(q, k, v, log_a)
    if backend.noted():
        B, G, S, N = q.shape
        backend.note("ssd_scan", work(
            B, v.shape[1], G, S, N, v.shape[3], chunk, q.dtype, v.dtype,
            log_a.dtype, out_dtype or q.dtype))
    y, state = _SSDScan.apply(q, k, v, log_a, int(chunk),
                              out_dtype or q.dtype)
    return (y, state) if return_state else y


ssd_scan.launches = 0


def work(B: int, H: int, G: int, S: int, N: int, P: int, chunk: int,
         q_dtype: torch.dtype, v_dtype: torch.dtype, la_dtype: torch.dtype,
         out_dtype: torch.dtype) -> backend.Work:
    """The causal half (pairs s <= t) of each chunk's scores q.k, a
    product of two bf16 inputs exact in fp32, at the tensor cores' bf16
    rate (the FMA units' for f32 q/k); then the causal half of the
    decay-weighted sum over v and the two (Q,N)x(N,P)-sized products with
    the fp32 state, which keep fp32 accuracy as 3xTF32 on the tensor
    cores (the kernel's way, and the fastest the card has): three TF32
    products each.  q, k, v, log_a read once; y and the final fp32 state
    written once."""
    Q = min(chunk, S)
    chunk_heads = -(-S // Q) * B * H if S else 0
    score = chunk_heads * Q * (Q + 1) * N
    f32 = chunk_heads * (Q * (Q + 1) * P + 4 * Q * N * P)
    nbytes = 2 * B * G * S * N * q_dtype.itemsize \
        + B * H * S * P * (v_dtype.itemsize + out_dtype.itemsize) \
        + B * H * S * la_dtype.itemsize + B * H * N * P * 4
    qk_rate = H100_SXM.peak_flops_bf16 if q_dtype == torch.bfloat16 \
        else H100_SXM.peak_flops_f32
    return backend.Work(score + f32, nbytes,
                        score / qk_rate + 3 * f32 / H100_SXM.peak_flops_tf32)
