"""Chunked gated linear recurrence (SSD / Mamba2 / mLSTM core), forward
and backward kernels.

Port of ``src/repro/kernels/ssd_scan.py:ssd_scan`` as wrapped by
``src/repro/kernels/ops.py:ssd_scan``.  The CUDA kernels are
``csrc/ssd_scan.cu`` (forward) and ``csrc/ssd_scan_bwd.cu`` (backward);
their headers give the designs and the bounds.

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
overrides the output type (the model path keeps y in fp32).  bf16 q/k
(the model path's) run ``ssd_scan_kernel_wgmma``: a block per (b, h, chunk,
P tile of :func:`launch_plan`'s ``p_tile`` columns), the chunks of a head
chained through the state per P tile; f32 q/k run ``ssd_scan_kernel`` (a
block per (b, h, chunk)).  The wrapper allocates the final state, the other
chunks' states and the kernel's zeroed ticket and flags.
The backward (:func:`ssd_scan_bwd`, the profiler's range
``ssd_scan.backward``) computes what the reference's VJP rule computes
(``ops.py``'s ``_ssd_bwd_rule``: ``jax.vjp`` of ``ref.ssd_scan_ref``),
with the final state's cotangent added (autograd hands zeros when the
state is unused): :func:`ssd_scan_bwd_plain` for CPU tensors, for CUDA
tensors the kernels of ``csrc/ssd_scan_bwd.cu``, which recompute the
chunks' states and keep nothing from the forward (``ssd_scan_bwd.launches``
counts their calls; :func:`work_backward` is their bound).
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
THREADS = 256                    # csrc/ssd_scan.cu: kThreads (f32 q/k)
# csrc/ssd_scan.cu's bf16 kernel (namespace wg): one block an SM (its
# registers), bf16 slabs of 64 x 64 (8 KB), a query block of 128 rows, two
# tf32 operand tiles in flight, and a k ring of 4 slabs (3 or 2 where the
# query block leaves no room)
WG_SLAB, WG_F_STAGES, WG_K_STAGES = 64 * 128, 2, (4, 3, 2)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_count_lock = threading.Lock()
_limits: Dict[int, tuple] = {}


def _lib() -> ctypes.CDLL:
    lib = backend.load("ssd_scan")
    if not getattr(lib, "_ff_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.ssd_scan_launch.argtypes = [p] * 6 + [i] * 12 + [p]
        lib.ssd_scan_launch.restype = i
        lib.ssd_scan_wgmma_launch.argtypes = [p] * 8 + [i] * 12 + [p]
        lib.ssd_scan_wgmma_launch.restype = i
        lib.ssd_scan_wgmma_smem.argtypes = [i] * 4
        lib.ssd_scan_wgmma_smem.restype = ctypes.c_longlong
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


def _in_clip(x: torch.Tensor) -> torch.Tensor:
    """1 where an exponent lies inside the clip (its gradient passes, as
    ``torch.clamp``'s does), else 0."""
    return ((x >= CLIP[0]) & (x <= CLIP[1])).float()


def ssd_scan_bwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       log_a: torch.Tensor, gy: torch.Tensor,
                       gstate: Optional[torch.Tensor], chunk: int = 128):
    """Plain version of the backward kernel: the gradients of
    :func:`ssd_scan_plain`'s ``(y, state)`` for cotangents ``gy`` and
    ``gstate`` (the final state's; ``None`` is zero), as ``(dq, dk, dv,
    dlog_a)`` in the types of q, k, v and log_a.  The kernel's
    decomposition, in fp32:  the chunks' entering states h_in by the
    forward chain, the gradients of the states they leave, dh_out, by the
    reverse chain  dh_in = e^tot dh_out + (diag(e^cum) q)^T dy  (the last
    chunk's dh_out is ``gstate``), then per chunk, with A = (q k^T) masked
    to s <= t, D_ts = e^(cum_t - cum_s), W = A D, dW = (dy v^T) masked:
    dq = (dW D) k + diag(e^cum) dy h_in^T,  dk = (dW D)^T q +
    diag(e^(tot - cum)) v dh_out^T,  dv = W^T dy + diag(e^(tot - cum)) k
    dh_out, and dcum from dW W's row and column sums, the inter term and
    the state terms (the last step also takes tot's), every exponential
    clipped as the forward clips it and passing no gradient where it is
    clipped; dlog_a is dcum's reverse cumsum within its chunk.  At G < H
    each head's dq and dk are rounded to q's type (as autograd rounds them
    where the forward widens q and k for each head), then each group's
    heads summed in order in fp32 and rounded once more."""
    B, G, S, N = q.shape
    H, P = v.shape[1], v.shape[3]
    dev = q.device
    if S == 0:
        return (torch.zeros_like(q), torch.zeros_like(k),
                torch.zeros_like(v), torch.zeros_like(log_a))
    Q = min(chunk, S)
    pad = -S % Q
    nc = (S + pad) // Q
    rep = H // G

    def chunks(t, feat=True):
        t = torch.nn.functional.pad(t.float(), (0, 0, 0, pad) if feat
                                    else (0, pad))
        return t.reshape(t.shape[:2] + (nc, Q) + t.shape[3:])
    qc = chunks(q.repeat_interleave(rep, dim=1))            # (B,H,nc,Q,N)
    kc = chunks(k.repeat_interleave(rep, dim=1))
    vc, gc = chunks(v), chunks(gy)                          # (B,H,nc,Q,P)
    cum = torch.cumsum(chunks(log_a, feat=False), dim=-1)   # (B,H,nc,Q)
    tot = cum[..., -1]
    e_cum, e_rem = _exp_clip(cum), _exp_clip(tot[..., None] - cum)
    e_tot = _exp_clip(tot)[..., None, None]
    inc = torch.einsum("bhcsn,bhcsp->bhcnp", kc, e_rem[..., None] * vc)
    up = torch.einsum("bhctn,bhctp->bhcnp", qc, e_cum[..., None] * gc)
    h_in, dh_out = torch.empty_like(inc), torch.empty_like(inc)
    h = torch.zeros((B, H, N, P), dtype=torch.float32, device=dev)
    for c in range(nc):
        h_in[:, :, c] = h
        h = e_tot[:, :, c] * h + inc[:, :, c]
    dh = (torch.zeros_like(h) if gstate is None else gstate.float())
    for c in reversed(range(nc)):
        dh_out[:, :, c] = dh
        dh = e_tot[:, :, c] * dh + up[:, :, c]

    mask = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=dev))
    x = cum[..., :, None] - cum[..., None, :]               # (B,H,nc,t,s)
    D = torch.where(mask, _exp_clip(x), 0.0)
    W = torch.einsum("bhctn,bhcsn->bhcts", qc, kc) * D
    dW = torch.where(mask, torch.einsum("bhctp,bhcsp->bhcts", gc, vc), 0.0)
    dA = dW * D
    gq = torch.einsum("bhctp,bhcnp->bhctn", gc, h_in)      # dy h_in^T
    gk = torch.einsum("bhcsp,bhcnp->bhcsn", vc, dh_out)    # v dh_out^T
    dq = torch.einsum("bhcts,bhcsn->bhctn", dA, kc) + e_cum[..., None] * gq
    dk = torch.einsum("bhcts,bhctn->bhcsn", dA, qc) + e_rem[..., None] * gk
    dv = torch.einsum("bhcts,bhctp->bhcsp", W, gc) \
        + e_rem[..., None] * torch.einsum("bhcsn,bhcnp->bhcsp", kc, dh_out)
    ww = dW * W * _in_clip(x)
    st = e_rem * _in_clip(tot[..., None] - cum) * (kc * gk).sum(-1)
    dcum = ww.sum(-1) - ww.sum(-2) - st \
        + e_cum * _in_clip(cum) * (qc * gq).sum(-1)
    dcum[..., -1] += st.sum(-1) + _exp_clip(tot) * _in_clip(tot) \
        * (h_in * dh_out).sum((-2, -1))
    dla = torch.flip(torch.cumsum(torch.flip(dcum, [-1]), -1), [-1])

    def unchunk(t):
        t = t.reshape(t.shape[:2] + (nc * Q,) + t.shape[4:])
        return t[:, :, :S]

    def group_sum(t):
        t = unchunk(t).to(q.dtype).float().reshape(B, G, rep, S, N)
        out = t[:, :, 0]
        for r in range(1, rep):
            out = out + t[:, :, r]
        return out.to(q.dtype)
    return (group_sum(dq), group_sum(dk), unchunk(dv).to(v.dtype),
            unchunk(dla).to(log_a.dtype))


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
    """f32 q/k: weighted-score tiles a block keeps in shared memory: one,
    or every key tile of the chunk when P spans several 64-column tiles (so
    the scores are not recomputed for each of them)."""
    return -(-Q // TILE) if P > TILE else 1


def smem_bytes(P: int, Q: int) -> int:
    """f32 q/k: dynamic shared memory of one block (csrc/ssd_scan.cu's
    layout): the cumsum and its two exponentials, the score tiles, two
    buffers of two staged tiles, the block's ticket."""
    qp = -(-Q // TILE) * TILE
    return 4 * (3 * qp + score_tiles(P, Q) * TILE * LD_W
                + 4 * TILE * LD_F32 + 1)


def p_tile(P: int) -> int:
    """bf16 q/k: the state columns a block owns, 64, or 8 for P <= 8
    (xLSTM's normaliser): wgmma's n is at least 8."""
    return 8 if P <= 8 else 64


def wgmma_smem_bytes(N: int, Q: int, pt: int, k_stages: int) -> int:
    """bf16 q/k: dynamic shared memory of one block (csrc/ssd_scan.cu's
    ``wg::smem_layout``): 1024 bytes to align the tiles, the 128-row query
    block's n slabs (16 KB each), the k ring, the two tf32 operand tiles
    (hi and lo, pt x 64 each), the builders' two staging tiles (64 x pt
    fp32), the two halves' exchange when N fits one 64-row M-block, the
    cumsum and its two exponentials over whole 128-row blocks, the
    mbarriers and the ticket."""
    nN = -(-N // 64)
    return (1024 + nN * 2 * WG_SLAB + k_stages * WG_SLAB
            + WG_F_STAGES * 2 * pt * 256 + 2 * 64 * pt * 4
            + (64 * pt * 4 if nN == 1 else 0)
            + 3 * (-(-Q // 128) * 128) * 4
            + 8 * (2 * k_stages + 2 * WG_F_STAGES + 4) + 16)


def wgmma_fits(N: int, Q: int, P: int, smem_limit: int) -> bool:
    """Whether the bf16 kernel's block holds N (padded to 8) at chunk Q
    with its shallowest rings; else bf16 q/k take the f32-q/k kernel."""
    return wgmma_smem_bytes(-(-N // 8) * 8, Q, p_tile(P),
                            WG_K_STAGES[-1]) <= smem_limit


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
    blocks: int          # one per (b, h, chunk, P tile)
    p_tile: int          # state columns a block owns (f32 q/k: all of P)
    smem: int            # dynamic shared memory of a block, bytes
    waves: float         # blocks over the blocks the card holds at once
    k_stages: int        # bf16 q/k: the k ring's stages (f32 q/k: 0)
    score_tiles: int     # f32 q/k: weighted-score tiles kept (bf16 q/k: 0)


def launch_plan(B: int, H: int, S: int, N: int, P: int, Q: int, sms: int,
                smem_limit: int, qk_dtype: torch.dtype = torch.bfloat16
                ) -> LaunchPlan:
    """bf16 q/k: one block per (b, h, chunk, P tile of :func:`p_tile`
    columns), 384 threads and one block an SM (its registers): B*H*chunks
    blocks, times ceil(P/64) at P > 64 (xLSTM's P 384: 6 tiles, 192 blocks
    at B1 H4 S2048 where a block per chunk gave 32), times 1 at P <= 64
    (Zamba2's 512 already fill the card).  A block keeps its 128-row query
    block resident, every n slab of it, so N bounds its shared memory: the
    k ring takes 4 stages, 3 or 2 where 4 do not fit (xLSTM's N 384: 3);
    raises where 2 do not.
    f32 q/k: one block per (b, h, chunk), the P tiles in its loop; the chunk
    (and P > 64, which keeps every score tile of the chunk) bounds its
    shared memory; raises where it does not fit.  ``waves`` counts the
    blocks an SM holds by shared memory and threads (and, bf16, by
    registers: one)."""
    chunks = -(-S // Q) * B * H
    if qk_dtype == torch.bfloat16:
        pt = p_tile(P)
        fits = [ks for ks in WG_K_STAGES
                if wgmma_smem_bytes(N, Q, pt, ks) <= smem_limit]
        if not fits:
            raise ValueError(
                f"ssd_scan kernel: N {N} with chunk {Q} needs "
                f"{wgmma_smem_bytes(N, Q, pt, WG_K_STAGES[-1])} bytes of "
                f"shared memory, more than the card's {smem_limit}")
        blocks = chunks * -(-P // pt)
        if blocks >= 2 ** 31:
            raise ValueError(f"ssd_scan: sizes out of range ({blocks} "
                             f"blocks)")
        return LaunchPlan(blocks, pt, wgmma_smem_bytes(N, Q, pt, fits[0]),
                          blocks / sms, fits[0], 0)
    smem = smem_bytes(P, Q)
    if smem > smem_limit:
        raise ValueError(f"ssd_scan kernel: chunk {Q} with P {P} needs "
                         f"{smem} bytes of shared memory, more than the "
                         f"card's {smem_limit}")
    if chunks >= 2 ** 31:
        raise ValueError(f"ssd_scan: sizes out of range ({chunks} chunks "
                         f"of {Q} steps over B*H)")
    per_sm = max(1, min((smem_limit + 1024) // (smem + 1024),
                        2048 // THREADS))
    return LaunchPlan(chunks, P, smem, chunks / (sms * per_sm), 0,
                      score_tiles(P, Q))


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
    if q.dtype == torch.bfloat16:
        if wgmma_fits(N, Q, P, limits[1]):
            return _launch_wgmma(q, k, v, log_a, Q, y, fake, limits)
        # an N whose 128-row query block a block cannot hold: the f32-q/k
        # kernel, on q and k in f32 (exact), which holds any N
        q, k = q.float(), k.float()
    plan = launch_plan(B, H, S, N, P, Q, *limits, qk_dtype=q.dtype)
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
            plan.score_tiles, plan.smem, _DTYPES[v.dtype],
            _DTYPES[log_a.dtype], _DTYPES[out_dtype],
            backend.current_stream(q.device))
        with _count_lock:
            ssd_scan.launches += 1
        backend.check(err, "ssd_scan")
    state = buf[(nc - 1) * words:nc * words].view(B, H, N, P)
    # a copy, so the other chunks' states are not kept alive with it
    return y, (state.clone() if nc > 1 else state)


def _launch_wgmma(q, k, v, log_a, Q: int, y, fake: bool, limits: tuple):
    """bf16 q/k.  The tensor maps want N a multiple of 8 and 16-byte
    aligned q and k: other q and k are copied with N padded by zero
    columns (which add nothing to a score or a state row, and give zero
    rows of the state, cut off after)."""
    B, G, S, N = q.shape
    H, P = v.shape[1], v.shape[3]
    n8 = -(-N // 8) * 8
    if n8 != N or (not fake and (q.data_ptr() % 16 or k.data_ptr() % 16)):
        q, k = (torch.nn.functional.pad(t, (0, n8 - N)) for t in (q, k))
    plan = launch_plan(B, H, S, n8, P, Q, *limits)
    nc, npt = -(-S // Q), -(-P // plan.p_tile)
    state = torch.empty((B, H, n8, P), dtype=torch.float32, device=q.device)
    # the chunk states but the last, as h^T (P, N), then the zeroed int32
    # words of the block ticket and the flags (chunk, b * H + h, P tile)
    words = B * H * n8 * P
    buf = torch.empty((nc - 1) * words + 1 + nc * B * H * npt,
                      dtype=torch.float32, device=q.device)
    buf[(nc - 1) * words:].view(torch.int32).zero_()
    if fake:
        backend.note_launch("ssd_scan")
    else:
        err = _lib().ssd_scan_wgmma_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), log_a.data_ptr(),
            y.data_ptr(), state.data_ptr(), buf.data_ptr(),
            buf[(nc - 1) * words:].data_ptr(), B, H, G, S, n8, P, Q,
            plan.p_tile, plan.k_stages, _DTYPES[v.dtype],
            _DTYPES[log_a.dtype], _DTYPES[y.dtype],
            backend.current_stream(q.device))
        with _count_lock:
            ssd_scan.launches += 1
        backend.check(err, "ssd_scan")
    return y, (state if n8 == N else state[:, :, :N].contiguous())


class _SSDScan(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, log_a, chunk, out_dtype):
        ctx.save_for_backward(q, k, v, log_a)
        ctx.chunk = chunk
        if backend.use_kernel(q):
            return _launch(q, k, v, log_a, chunk, out_dtype)
        return ssd_scan_plain(q, k, v, log_a, chunk, out_dtype=out_dtype)

    @staticmethod
    def backward(ctx, gy, gstate):
        q, k, v, log_a = ctx.saved_tensors
        with torch.profiler.record_function("ssd_scan.backward"):
            return ssd_scan_bwd(q, k, v, log_a, gy, gstate, ctx.chunk) \
                + (None, None)


def _lib_bwd() -> ctypes.CDLL:
    lib = backend.load("ssd_scan_bwd")
    if not getattr(lib, "_ff_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        strides = ctypes.POINTER(ctypes.c_longlong)
        lib.ssd_scan_bwd_launch.argtypes = [p] * 11 + [strides] * 2 \
            + [i] * 11 + [p]
        lib.ssd_scan_bwd_launch.restype = i
        lib.ssd_scan_bwd_smem.argtypes = [i]
        lib.ssd_scan_bwd_smem.restype = ctypes.c_longlong
        lib._ff_typed = True
    return lib


def bwd_smem_bytes(Q: int) -> int:
    """The backward's largest dynamic shared memory of a block at chunk Q
    (csrc/ssd_scan_bwd.cu's ``ssd_scan_bwd_smem``): the chunk kernel's six
    fp32 64 x 68 tiles, the row and column sums, and the cumsum and each
    row's sum of dW W over whole 64-row tiles; the states kernel's four
    tiles, that cumsum and the chunk's two exponentials; or the finishing
    kernel's dcum and state terms, Q each."""
    qp = -(-Q // TILE) * TILE
    return 4 * max(6 * TILE * LD_W + 6 * TILE + 2 * qp,
                   4 * TILE * LD_W + qp + 2 * Q, 2 * Q)


def bwd_workspace(B: int, H: int, G: int, S: int, N: int, P: int,
                  Q: int) -> int:
    """fp32 words of the backward's workspace (csrc/ssd_scan_bwd.cu's
    ``Args``): every chunk's state slot twice (h_in, dh_out), each step's
    partial sums of dcum (two, and two per 64-column n slab), each chunk's
    e^tot <h_in, dh_out> per chain block of 1024 state elements and its
    tot, the per-head fp32 dq that the chunks' sums go into, and at G < H
    the per-head fp32 dk that the group sum reads."""
    nc, ns = -(-S // Q), -(-N // TILE)
    splits = -(-(N * P) // 1024)
    return B * H * (2 * nc * N * P + S * (2 + 2 * ns) + nc * (splits + 1)
                    + S * N * (2 if G != H else 1))


def _launch_bwd(q, k, v, log_a, gy, gstate, chunk: int):
    B, G, S, N = q.shape
    H, P = v.shape[1], v.shape[3]
    for name, t in (("q", q), ("k", k), ("v", v), ("log_a", log_a),
                    ("gy", gy)):
        if t.dtype not in _DTYPES:
            raise TypeError(f"ssd_scan backward takes float32 or bfloat16 "
                            f"tensors; {name} is {t.dtype}")
        if t.device != q.device:
            raise ValueError("ssd_scan backward: inputs on different devices")
        if name != "gy" and not t.is_contiguous():
            raise ValueError(f"ssd_scan backward takes contiguous q, k, v "
                             f"and log_a; {name} is not")
    if k.dtype != q.dtype:
        raise TypeError(f"ssd_scan backward takes q and k of one type; got "
                        f"{q.dtype}, {k.dtype}")
    if tuple(gy.shape) != (B, H, S, P):
        raise ValueError(f"ssd_scan backward: dy {tuple(gy.shape)}, "
                         f"expected {(B, H, S, P)}")
    if gstate is not None and (tuple(gstate.shape) != (B, H, N, P)
                               or gstate.dtype != torch.float32
                               or gstate.device != q.device):
        raise ValueError(f"ssd_scan backward: the state's cotangent is "
                         f"float32 {(B, H, N, P)} on q's device; got "
                         f"{gstate.dtype} {tuple(gstate.shape)}")
    dq, dk = torch.empty_like(q), torch.empty_like(k)
    dv, dla = torch.empty_like(v), torch.empty_like(log_a)
    if min(B, H, S, N, P) == 0:
        for t in (dq, dk, dv, dla):
            t.zero_()
        return dq, dk, dv, dla
    Q = min(chunk, S)
    if chunk < 1 or max(B, H, S, N, P) >= 2 ** 31 or \
            bwd_smem_bytes(Q) > H100_SXM.smem_per_block:
        raise ValueError(f"ssd_scan backward: sizes out of range (B {B}, H "
                         f"{H}, S {S}, N {N}, P {P}, chunk {chunk})")
    ws = torch.empty(bwd_workspace(B, H, G, S, N, P, Q), dtype=torch.float32,
                     device=q.device)
    if backend.is_fake(q):
        backend.note_launch("ssd_scan_bwd")
        return dq, dk, dv, dla
    st = (ctypes.c_longlong * 4)
    err = _lib_bwd().ssd_scan_bwd_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), log_a.data_ptr(),
        gy.data_ptr(), gstate.data_ptr() if gstate is not None else None,
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), dla.data_ptr(),
        ws.data_ptr(), st(*gy.stride()),
        st(*(gstate.stride() if gstate is not None else (0,) * 4)),
        B, H, G, S, N, P, Q, _DTYPES[q.dtype], _DTYPES[v.dtype],
        _DTYPES[log_a.dtype], _DTYPES[gy.dtype],
        backend.current_stream(q.device))
    with _count_lock:
        ssd_scan_bwd.launches += 1
    backend.check(err, "ssd_scan_bwd")
    return dq, dk, dv, dla


def ssd_scan_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 log_a: torch.Tensor, gy: torch.Tensor,
                 gstate: Optional[torch.Tensor], chunk: int = 128) -> tuple:
    """The gradients ``(dq, dk, dv, dlog_a)`` of :func:`ssd_scan`'s ``(y,
    state)`` at q, k, v, log_a for cotangents ``gy`` (any strides) and
    ``gstate`` (the final state's, fp32; ``None`` is zero), in the inputs'
    types: :func:`ssd_scan_bwd_plain` for CPU tensors, the kernels of
    ``csrc/ssd_scan_bwd.cu`` for CUDA tensors (one count in
    ``ssd_scan_bwd.launches`` a call)."""
    _check(q, k, v, log_a)
    if backend.noted():
        B, G, S, N = q.shape
        backend.note("ssd_scan_bwd", work_backward(
            B, v.shape[1], G, S, N, v.shape[3], chunk, q.dtype, v.dtype,
            log_a.dtype, gy.dtype))
    if backend.use_kernel(q):
        return _launch_bwd(q, k, v, log_a, gy, gstate, chunk)
    return ssd_scan_bwd_plain(q, k, v, log_a, gy, gstate, chunk)


def ssd_scan(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             log_a: torch.Tensor, chunk: int = 128, *,
             out_dtype: Optional[torch.dtype] = None,
             return_state: bool = False):
    """q, k ``(B,G,S,N)``; v ``(B,H,S,P)``; log_a ``(B,H,S)`` with ``G | H``
    -> y ``(B,H,S,P)`` in ``out_dtype`` (default q's type), and with
    ``return_state`` also the final fp32 state ``(B,H,N,P)``.  Chunks of
    ``min(chunk, S)`` steps; any S.  The kernel takes float32 or bfloat16
    inputs and any N and P.  bf16 q/k (the model path's) run on Hopper's
    warpgroup tensor cores where a block's shared memory holds its 128-row
    query block (:func:`wgmma_fits`: N up to 384 at chunk 256), else in
    f32 as f32 q/k do: by fp32 FMAs, a chunk as far as :func:`smem_bytes`
    holds it (at P <= 64 a chunk of 11712 steps, at P > 64 of 512).  Every
    product with an f32 operand keeps fp32 accuracy (tf32 hi and lo parts
    on the tensor cores)."""
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
ssd_scan_bwd.launches = 0


def work(B: int, H: int, G: int, S: int, N: int, P: int, chunk: int,
         q_dtype: torch.dtype, v_dtype: torch.dtype, la_dtype: torch.dtype,
         out_dtype: torch.dtype) -> backend.Work:
    """The causal half (pairs s <= t) of each chunk's scores q.k, a
    product of two bf16 inputs exact in fp32, at the tensor cores' bf16
    rate (the FMA units' for f32 q/k); then the causal half of the
    decay-weighted sum over v and the two (Q,N)x(N,P)-sized products with
    the fp32 state, which keep fp32 accuracy in TF32 products on the
    tensor cores (the kernel's way, and the fastest the card has): three
    where both operands are fp32, two where one is bf16 and so exact in
    TF32 (q in q.h_in, v in W.v and dk^T.v).  q, k, v, log_a read once; y
    and the final fp32 state written once."""
    Q = min(chunk, S)
    chunk_heads = -(-S // Q) * B * H if S else 0
    score = chunk_heads * Q * (Q + 1) * N
    with_v = chunk_heads * (Q * (Q + 1) * P + 2 * Q * N * P)
    with_q = chunk_heads * 2 * Q * N * P
    nbytes = 2 * B * G * S * N * q_dtype.itemsize \
        + B * H * S * P * (v_dtype.itemsize + out_dtype.itemsize) \
        + B * H * S * la_dtype.itemsize + B * H * N * P * 4
    qk_rate = H100_SXM.peak_flops_bf16 if q_dtype == torch.bfloat16 \
        else H100_SXM.peak_flops_f32

    def products(dtype):
        return 2 if dtype == torch.bfloat16 else 3
    tf32 = products(v_dtype) * with_v + products(q_dtype) * with_q
    return backend.Work(score + with_v + with_q, nbytes,
                        score / qk_rate + tf32 / H100_SXM.peak_flops_tf32)


def work_backward(B: int, H: int, G: int, S: int, N: int, P: int, chunk: int,
                  q_dtype: torch.dtype, v_dtype: torch.dtype,
                  la_dtype: torch.dtype, gy_dtype: torch.dtype
                  ) -> backend.Work:
    """The backward's least work: per chunk the causal halves of the five
    Q x Q products (the scores q.k again, dy.v, and the three that give dq,
    dk and dv's W^T dy) and the five (Q,N)x(N,P)-sized products (the state
    increment, the reverse chain's term, dy h_in^T, v dh_out^T, k dh_out),
    each product with an fp32 operand at fp32 accuracy as TF32 parts on the
    tensor cores: three where both operands are fp32, two where one is
    bf16 (exact in TF32); the scores of bf16 q, k at the bf16 rate.  q, k,
    v, log_a, dy and the final state's cotangent read once; dq, dk, dv and
    dlog_a written once."""
    Q = min(chunk, S)
    chunk_heads = -(-S // Q) * B * H if S else 0
    causal, state = chunk_heads * Q * (Q + 1), chunk_heads * 2 * Q * N * P
    bf = torch.bfloat16
    qk, vb, gb = q_dtype == bf, v_dtype == bf, gy_dtype == bf

    def parts(*exact):            # TF32 products for fp32 accuracy
        return 1 + sum(not e for e in exact)
    score = causal * N
    tf32 = (causal * P * parts(gb, vb) + causal * N * 2 * parts(False, qk)
            + causal * P * parts(False, gb)
            + state * (3 * parts(qk, False) + parts(gb, False)
                       + parts(vb, False)))
    flops = score + causal * (2 * P + 2 * N) + 5 * state
    nbytes = 2 * (2 * B * G * S * N * q_dtype.itemsize
                  + B * H * S * (P * v_dtype.itemsize + la_dtype.itemsize)) \
        + B * H * S * P * gy_dtype.itemsize + B * H * N * P * 4
    if qk:
        score_s = score / H100_SXM.peak_flops_bf16
    else:
        tf32 += score * parts(False, False)
        score_s = 0.0
    return backend.Work(flops, nbytes,
                        score_s + tf32 / H100_SXM.peak_flops_tf32)
