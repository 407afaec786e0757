"""Blocked (flash) GQA attention: the forward kernel and the backward's.

Port of ``src/repro/kernels/flash_attention.py:flash_attention`` as wrapped
by ``src/repro/kernels/ops.py:flash_attention``.  The CUDA kernel is
``csrc/flash_attention.cu`` (its header gives the design and the bound).
The kernel is chosen by type, not as a fallback: bfloat16 runs on Hopper's
warpgroup tensor cores (``wgmma`` fed by TMA, fp32 accumulation; P V at the
reference's fp32 precision, P split into two bf16 halves, hi and lo, whose
products sum into one fp32 accumulator), float32 on the FMA units, since
TF32 tensor cores would miss the f32 tolerance.  :func:`launch_plan` is the
bf16 kernel's tiling and its split over the keys for calls whose grid
cannot fill the card (Whisper's cross attention at 1 or 32 queries);
a split call's scratch is allocated here, one launch all the same.

:func:`flash_attention` runs the plain PyTorch version
(:func:`flash_attention_plain`, the reference's ``ref.attention_ref`` with
queries aligned to the end of the keys) for CPU tensors and launches the
kernel for CUDA tensors; ``flash_attention.launches`` counts the launches.
A fake CUDA tensor (the dry run's) launches nothing and hands the launch
to ``backend.note_launch`` (``backend``'s docstring); :func:`work` is the
operations and bytes behind the kernel's bound.

The backward.  The reference has no backward kernel: ``ops.py``'s VJP rule
(``_fa_bwd``) is ``jax.vjp`` of ``ref.attention_ref``.  The port computes
that VJP without the score matrix: where autograd will take the gradient,
the forward also keeps each row's fp32 log-sum-exp (B, H, Sq), and
:func:`flash_attention_bwd` recomputes P from it, tile by tile, in a dq
kernel and then a dk/dv kernel for CUDA tensors, or in
:func:`flash_attention_bwd_plain`, the same decomposition in fp32 torch,
for CPU tensors.  :func:`bwd_plan` picks the kernels by type and head
dim: bf16 at D 16-128 ``csrc/flash_attention_bwd_wgmma.cu`` (``wgmma``
fed by TMA), bf16 at D 256 and f32 ``csrc/flash_attention_bwd.cu``
(``mma.sync``; the FMA units).  ``flash_attention_bwd.launches`` counts
its calls on the card; :func:`work_backward` is its bound; the profiler
sees it as the range ``flash_attention.backward``.
"""

from __future__ import annotations

import ctypes
import threading
from typing import NamedTuple

import numpy as np
import torch

from . import backend
from ..core.perf_model import H100_SXM

NEG_INF = -2.0e38
HEAD_DIMS = (16, 32, 64, 128, 256)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_count_lock = threading.Lock()

# the bf16 kernel's tiling (csrc/flash_attention.cu: kWgBQ, WgTile<D>):
# query rows a block, keys a KV tile and ring stages by head dim
BLOCK_Q = 128
BLOCK_K = {16: 128, 32: 128, 64: 128, 128: 128, 256: 64}
STAGES = {16: 4, 32: 4, 64: 4, 128: 3, 256: 2}
SMS = 132                   # an H100 SXM's SMs: one block each at a time


def _lib() -> ctypes.CDLL:
    lib = backend.load("flash_attention")
    if not getattr(lib, "_ff_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.flash_attention_launch.argtypes = [p] * 5 + [i] * 9 + [p]
        lib.flash_attention_launch.restype = i
        lib.flash_attention_split_launch.argtypes = \
            [p] * 5 + [i] * 9 + [p, p, p]
        lib.flash_attention_split_launch.restype = i
        lib.flash_attention_tiling.argtypes = [i, i]
        lib.flash_attention_tiling.restype = ctypes.c_longlong
        lib._ff_typed = True
    return lib


class LaunchPlan(NamedTuple):
    block_q: int           # query rows a block (two warpgroups of 64)
    block_k: int           # keys a KV tile
    stages: int            # K/V tiles in flight
    smem: int              # dynamic shared memory of a block, bytes
    q_tiles: int           # ceil(Sq / block_q)
    kv_tiles: int          # ceil(Sk / block_k)
    splits: int            # key splits, 1 unless two fit in one wave
    tiles_per_split: int   # split s takes KV tiles [s per, (s + 1) per)
    blocks: int            # B * H * q_tiles * splits
    partial_floats: int    # the splits' fp32 O, m and l; 0 unsplit
    tickets: int           # int32 tickets, one a (b, h, q tile); 0 unsplit


def launch_plan(B: int, H: int, Hkv: int, Sq: int, Sk: int,
                D: int) -> LaunchPlan:
    """The bf16 kernel's grid for q ``(B, H, Sq, D)`` against ``Sk`` keys
    of ``Hkv`` heads: one block of 128 query rows a (b, h, q tile), each
    over every KV tile of :data:`BLOCK_K` keys its rows reach.  Where two
    splits of that grid still fit in one wave of :data:`SMS` blocks (a
    block fills an SM) and the keys span two tiles or more, the keys are
    split ``SMS // grid`` ways, at most one a tile, then as few as cover
    the tiles at ``ceil(kv_tiles / splits)`` each, so no split is empty: a
    rank's Whisper cross attention, B8 H8 at Sq 1 against 1500 frames, 64
    blocks, takes 2 splits of 12 tiles in one wave.  A grid of 67-131
    blocks is not split: a second wave of half the work costs more than
    the SMs it leaves idle (B8 H16 at Sq 1, 128 blocks, is slower in two
    splits than in one on an H100: ``tools/flash_variants.py``)."""
    if D not in BLOCK_K:
        raise ValueError(f"flash_attention kernel takes head dims "
                         f"{HEAD_DIMS}, got {D}")
    bk = BLOCK_K[D]
    q_tiles = -(-Sq // BLOCK_Q)
    kv_tiles = -(-Sk // bk)
    grid = B * H * q_tiles
    splits = 1
    if 2 * grid <= SMS and kv_tiles >= 2:
        splits = min(SMS // max(grid, 1), kv_tiles)
    per = -(-kv_tiles // splits)
    splits = -(-kv_tiles // per)
    if q_tiles * splits > 65535:
        raise ValueError(f"flash_attention: {q_tiles} query tiles x "
                         f"{splits} splits exceed the grid's 65535")
    smem = 1024 + 2 * D * (BLOCK_Q + 2 * STAGES[D] * bk) + 256
    split = splits > 1
    return LaunchPlan(BLOCK_Q, bk, STAGES[D], smem, q_tiles, kv_tiles,
                      splits, per, grid * splits,
                      B * H * splits * Sq * (D + 2) if split else 0,
                      B * H * q_tiles if split else 0)


def split_keys(plan: LaunchPlan, Sk: int) -> list:
    """The key ranges ``(start, stop)`` of each split's KV tiles, split by
    split and tile by tile, as the kernel walks them."""
    bk, per = plan.block_k, plan.tiles_per_split
    return [[(t * bk, min((t + 1) * bk, Sk))
             for t in range(s * per, min((s + 1) * per, plan.kv_tiles))]
            for s in range(plan.splits)]


def _mask(Sq: int, Sk: int, causal: bool, window: int,
          device) -> torch.Tensor:
    """(Sq, Sk): the keys each query sees, queries aligned to the end of
    the keys."""
    qpos = torch.arange(Sq, device=device)[:, None] + (Sk - Sq)
    kpos = torch.arange(Sk, device=device)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=device)
    if causal:
        mask &= kpos <= qpos
    if window and window > 0:
        mask &= kpos > qpos - window
    return mask


def _plain(q, k, v, causal, window, with_lse):
    B, H, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    if Hkv != H:
        k = k.repeat_interleave(H // Hkv, dim=1)
        v = v.repeat_interleave(H // Hkv, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) \
        / torch.sqrt(torch.tensor(float(D)))
    mask = _mask(Sq, Sk, causal, window, q.device)
    s = torch.where(mask[None, None], s,
                    torch.tensor(NEG_INF, device=q.device))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)
    if not with_lse:
        return o
    lse = torch.logsumexp(s, dim=-1)
    return o, torch.where(mask.any(-1)[None, None], lse,
                          torch.tensor(float("inf"), device=q.device))


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool = True, window: int = 0
                          ) -> torch.Tensor:
    """Plain version: the whole score matrix in fp32, GQA by repeating the
    KV heads, queries aligned to the end of the keys."""
    return _plain(q, k, v, causal, window, False)


def flash_attention_lse_plain(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, causal: bool = True,
                              window: int = 0) -> tuple:
    """:func:`flash_attention_plain`'s output and each row's fp32
    log-sum-exp, ``(B, H, Sq)``: natural base, of the scaled scores
    ``q.k / sqrt(D)`` the row sees; ``+inf`` for a row that sees no key
    (a causal call with Sq > Sk), so that ``exp(s - lse)`` is 0 there."""
    return _plain(q, k, v, causal, window, True)


def no_key_rows(Sq: int, Sk: int, causal: bool) -> int:
    """The leading query rows that see no key: ``Sq - Sk`` of a causal
    call with Sq > Sk, else 0.  The reference's softmax over such a row's
    all-NEG_INF scores is uniform, so its gradient reaches no q and no k,
    and each key's v takes ``do / Sk`` of the row."""
    return max(0, Sq - Sk) if causal else 0


def flash_attention_bwd_plain(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, o: torch.Tensor,
                              lse: torch.Tensor, do: torch.Tensor,
                              causal: bool = True, window: int = 0) -> tuple:
    """Plain version of the backward, the decomposition the kernel
    computes, in fp32: P = exp(S / sqrt(D) - lse) on the keys a row sees
    (0 elsewhere), dP = dO V^T, the row's delta = rowsum(P o dP) (the
    recomputed fp32 P and dP, not dO.O from the bf16 o, which puts dq 5-10x
    further from the reference: the kernel's header), dS =
    P o (dP - delta) / sqrt(D); dq = dS K, each query head's dk = dS^T Q
    and dv = P^T dO (plus ``do / Sk`` of each row that sees no key,
    :func:`no_key_rows`), rounded to the inputs' type head by head and
    summed over a GQA group in fp32, as autograd of
    :func:`flash_attention_plain` does (``repeat_interleave``, then
    ``.float()``).  ``o``, the forward's output, is read neither here
    nor by the kernel (delta comes from P and dP)."""
    del o
    B, H, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    G = H // Hkv
    kf = k.float().repeat_interleave(G, dim=1)
    vf = v.float().repeat_interleave(G, dim=1)
    qf, dof = q.float(), do.float()
    s = torch.einsum("bhqd,bhkd->bhqk", qf, kf) \
        / torch.sqrt(torch.tensor(float(D)))
    mask = _mask(Sq, Sk, causal, window, q.device)[None, None]
    p = torch.where(mask, torch.exp(s - lse.float()[..., None]),
                    torch.zeros((), device=q.device))
    dp = torch.einsum("bhqd,bhkd->bhqk", dof, vf)
    delta = (p * dp).sum(-1, keepdim=True)
    ds = p * (dp - delta) / torch.sqrt(torch.tensor(float(D)))
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, kf)
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, qf)
    dv = torch.einsum("bhqk,bhqd->bhkd", p, dof)
    n0 = no_key_rows(Sq, Sk, causal)
    if n0:
        dv = dv + dof[:, :, :n0].sum(2, keepdim=True) / Sk

    def group(t, dtype):
        t = t.to(dtype)
        if G == 1:
            return t
        return t.float().view(B, Hkv, G, Sk, D).sum(2).to(dtype)
    return dq.to(q.dtype), group(dk, k.dtype), group(dv, v.dtype)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"flash_attention needs q (B,H,Sq,D), k and v "
                         f"(B,Hkv,Sk,D); got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, H, _Sq, D = q.shape
    if k.shape[0] != B or k.shape[3] != D or k.shape[1] < 1 \
            or H % k.shape[1]:
        raise ValueError(f"flash_attention: k/v {tuple(k.shape)} do not fit "
                         f"q {tuple(q.shape)} (same B and D, Hkv | H)")


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            causal: bool, window: int, with_lse: bool = False):
    B, H, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_attention kernel takes head dims "
                         f"{HEAD_DIMS}, got {D}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention kernel takes float32 or bfloat16 "
                        f"q, k, v of one type; got {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    if k.device != q.device or v.device != q.device:
        raise ValueError("flash_attention: q, k and v on different devices")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention kernel takes contiguous q, k, v")
    fake = backend.is_fake(q)
    if q.dtype == torch.bfloat16 and not fake and any(t.data_ptr() % 16
                                                      for t in (q, k, v)):
        raise ValueError("flash_attention kernel takes 16-byte aligned "
                         "bfloat16 q, k, v (its copies are 16 bytes wide)")
    if max(Sq, Sk, B, H) >= 2 ** 31 or Sk < 1:
        raise ValueError(f"flash_attention: sizes out of range "
                         f"(B {B}, H {H}, Sq {Sq}, Sk {Sk})")
    o = torch.empty_like(q)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device) \
        if with_lse else None
    if Sq == 0 or B == 0:
        return (o, lse) if with_lse else o
    plan = launch_plan(B, H, Hkv, Sq, Sk, D) if q.dtype == torch.bfloat16 \
        else None
    part = tickets = None
    if plan is not None and plan.splits > 1:
        # the splits' scratch, before the fake branch: the dry run's peak
        # holds it; the tickets zeroed on the stream, one set a call
        part = torch.empty(plan.partial_floats, dtype=torch.float32,
                           device=q.device)
        tickets = torch.zeros(plan.tickets, dtype=torch.int32,
                              device=q.device)
    if fake:
        backend.note_launch("flash_attention")
        return (o, lse) if with_lse else o
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr() if with_lse else None, B, H, Hkv, Sq, Sk, D,
            int(bool(causal)), int(window))
    if part is not None:
        err = _lib().flash_attention_split_launch(
            *args, plan.splits, part.data_ptr(), tickets.data_ptr(),
            backend.current_stream(q.device))
    else:
        err = _lib().flash_attention_launch(
            *args, _DTYPES[q.dtype], backend.current_stream(q.device))
    with _count_lock:
        flash_attention.launches += 1
    backend.check(err, "flash_attention")
    return (o, lse) if with_lse else o


# -- the backward ------------------------------------------------------------
def _lib_bwd() -> ctypes.CDLL:
    lib = backend.load("flash_attention_bwd")
    if not getattr(lib, "_ff_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        strides = ctypes.POINTER(ctypes.c_longlong)
        lib.flash_attention_bwd_launch.argtypes = [p] * 9 + [strides] \
            + [i] * 9 + [p]
        lib.flash_attention_bwd_launch.restype = i
        lib.flash_attention_bwd_tiling.argtypes = [i, i, i]
        lib.flash_attention_bwd_tiling.restype = ctypes.c_longlong
        lib._ff_typed = True
    return lib


def _lib_bwd_wgmma() -> ctypes.CDLL:
    lib = backend.load("flash_attention_bwd_wgmma")
    if not getattr(lib, "_ff_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        strides = ctypes.POINTER(ctypes.c_longlong)
        lib.flash_attention_bwd_wgmma_launch.argtypes = [p] * 9 \
            + [strides] + [i] * 8 + [p]
        lib.flash_attention_bwd_wgmma_launch.restype = i
        lib.flash_attention_bwd_wgmma_tiling.argtypes = [i, i]
        lib.flash_attention_bwd_wgmma_tiling.restype = ctypes.c_longlong
        lib._ff_typed = True
    return lib


# the backward kernels' tiling by head dim (csrc/flash_attention_bwd_wgmma.cu
# Wt<D>; csrc/flash_attention_bwd.cu BT (bf16, D 256 only) and FT<D>): (dq
# rows, dq keys a K/V tile, its stages, dk/dv keys, dk/dv queries a Q/dO
# tile, its stages, threads a dk/dv block)
_BWD_TILES = {
    "wgmma": {D: (128, 64, 3 if D > 64 else 4,
                  128, 32 if D > 64 else 64, 3 if D > 64 else 4, 384)
              for D in (16, 32, 64, 128)},
    "mma": {256: (64, 32, 1, 64, 32, 1, 256)},
    "fma": {D: (64, 16 if D >= 256 else 32 if D >= 128 else 64, 1,
                64, 16 if D >= 256 else 32 if D >= 128 else 64, 1, 256)
            for D in HEAD_DIMS},
}


class BwdPlan(NamedTuple):
    kernel: str        # "wgmma" (bf16, csrc/flash_attention_bwd_wgmma.cu),
                       # "mma" (bf16, mma.sync) or "fma" (f32; both
                       # csrc/flash_attention_bwd.cu)
    dq_rows: int       # query rows a dq block
    dq_keys: int       # keys a K/V tile of the dq kernel
    dq_stages: int     # its K/V tiles in flight
    dq_smem: int       # the dq kernel's dynamic shared memory, bytes
    kv_keys: int       # keys a dk/dv block
    kv_queries: int    # query rows a Q/dO tile of the dk/dv kernel
    kv_stages: int     # its Q/dO tiles in flight
    kv_smem: int       # the dk/dv kernel's dynamic shared memory, bytes
    kv_threads: int    # threads a dk/dv block
    dq_grid: tuple     # (x, y, z): (query tiles, H, B)
    kv_grid: tuple     # (key tiles, Hkv, B)
    workspace: int     # fp32 words (:func:`bwd_workspace`)


def _bwd_smem(kernel: str, D: int, tiles: tuple) -> tuple:
    """The dq and dk/dv kernels' dynamic shared memory in bytes (the
    sources' DQ_SMEM and KV_SMEM)."""
    rows, bk, dst, keys, bq, kst, _ = tiles
    if kernel == "wgmma":
        # 1024 bytes to align the tiles, Q and dO (K and V) of 128 rows,
        # the ring of K and V (Q and dO) tiles, each Q/dO stage's lse and
        # delta, the no-key rows' dv, the mbarriers
        return (1024 + 2 * rows * D * 2 + dst * 2 * bk * D * 2 + 256,
                1024 + 2 * keys * D * 2 + kst * 2 * bq * D * 2
                + kst * 2 * bq * 4 + D * 4 + 256)
    if kernel == "mma":
        ld = D + 8                     # a row padded by 16 bytes
        return (2 * (2 * rows * ld + dst * 2 * bk * ld),
                2 * (2 * keys * ld + kst * 2 * bq * ld)
                + 4 * (kst * 2 * bq + D))
    ld = D + 1
    return (4 * (2 * rows * ld + 2 * bk * ld + rows * (bk + 1)),
            4 * (2 * keys * ld + 2 * bq * ld + 2 * keys * (bq + 1)
                 + 2 * bq + D))


def bwd_plan(B: int, H: int, Hkv: int, Sq: int, Sk: int, D: int,
             dtype: torch.dtype) -> BwdPlan:
    """Which kernels take a backward call and how: a pure function of the
    shapes and the type.  bf16 at D 16-128 (Zamba2's and Whisper's D 64,
    Mixtral's D 128) goes to the ``wgmma`` kernels fed by TMA
    (csrc/flash_attention_bwd_wgmma.cu: blocks of 128 query rows or 128
    keys, two consumer warpgroups of 64, a ring of K/V or Q/dO tiles);
    bf16 at D 256 (Gemma-7B) to the ``mma.sync`` kernels of
    csrc/flash_attention_bwd.cu, whose dk/dv kernel splits D's columns
    over two warps (on ``wgmma`` a warpgroup's dk and dv of 64 keys would
    take 256 fp32 registers a thread); f32 to the same file's kernels on
    the FMA units (TF32 would miss the f32 tolerance).  A dispatch by type
    and shape, not a fallback: the call launches the plan's kernels or
    raises."""
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_attention backward takes head dims "
                         f"{HEAD_DIMS}, got {D}")
    if dtype not in _DTYPES:
        raise TypeError(f"flash_attention backward takes float32 or "
                        f"bfloat16, got {dtype}")
    if dtype == torch.float32:
        kernel = "fma"
    else:
        kernel = "wgmma" if D <= 128 else "mma"
    tiles = _BWD_TILES[kernel][D]
    rows, bk, dst, keys, bq, kst, threads = tiles
    dq_smem, kv_smem = _bwd_smem(kernel, D, tiles)
    return BwdPlan(kernel, rows, bk, dst, dq_smem, keys, bq, kst, kv_smem,
                   threads, (-(-Sq // rows), H, B), (-(-Sk // keys), Hkv, B),
                   bwd_workspace(B, H, Hkv, Sq, Sk, D, dtype))


def bwd_library_tiling(kernel: str, D: int) -> tuple:
    """The tiling of ``kernel`` at head dim ``D`` as its library reports it
    (the card's builds), in :class:`BwdPlan`'s order: (dq rows, dq keys,
    dq stages, dq smem, dk/dv keys, dk/dv queries, dk/dv stages, dk/dv
    smem, dk/dv threads)."""
    if kernel == "wgmma":
        return tuple(_lib_bwd_wgmma().flash_attention_bwd_wgmma_tiling(D, i)
                     for i in range(9))
    lib = _lib_bwd()
    dtype = 1 if kernel == "mma" else 0
    return tuple(lib.flash_attention_bwd_tiling(D, dtype, i)
                 for i in range(9))


def bwd_workspace(B: int, H: int, Hkv: int, Sq: int, Sk: int, D: int,
                  dtype: torch.dtype) -> int:
    """fp32 words of the backward's workspace: each query row's delta
    (B, H, Sq), which the dq kernel writes and the dk/dv kernel reads, and
    for bf16 inputs with a GQA group (H > Hkv) the group's fp32 sums of
    dk and dv (B, Hkv, Sk, D each), into which each query head's gradient
    goes rounded to bf16."""
    sums = 2 * B * Hkv * Sk * D if H != Hkv and dtype == torch.bfloat16 \
        else 0
    return B * H * Sq + sums


def _launch_bwd(q, k, v, o, lse, do, causal: bool, window: int) -> tuple:
    B, H, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_attention backward takes head dims "
                         f"{HEAD_DIMS}, got {D}")
    for name, t in (("k", k), ("v", v), ("o", o), ("do", do)):
        if t.dtype != q.dtype:
            raise TypeError(f"flash_attention backward takes q, k, v, o and "
                            f"do of one type; {name} is {t.dtype}, q "
                            f"{q.dtype}")
    if q.dtype not in _DTYPES:
        raise TypeError(f"flash_attention backward takes float32 or "
                        f"bfloat16, got {q.dtype}")
    if tuple(o.shape) != tuple(q.shape) or tuple(do.shape) != tuple(q.shape) \
            or tuple(lse.shape) != (B, H, Sq) or lse.dtype != torch.float32:
        raise ValueError(f"flash_attention backward: o and do must be "
                         f"{tuple(q.shape)} and lse float32 {(B, H, Sq)}; "
                         f"got {tuple(o.shape)}, {tuple(do.shape)}, "
                         f"{lse.dtype} {tuple(lse.shape)}")
    if any(t.device != q.device for t in (k, v, o, lse, do)):
        raise ValueError("flash_attention backward: inputs on different "
                         "devices")
    # q, k, v and lse as the forward takes and leaves them; dO at any
    # strides whose rows are contiguous and 16-byte aligned (the model's
    # transposed cotangent), else copied; o is not read (delta comes from
    # P and dP)
    if not all(t.is_contiguous() for t in (q, k, v, lse)):
        raise ValueError("flash_attention backward takes contiguous q, k, "
                         "v and lse")
    fake = backend.is_fake(q)
    if q.dtype == torch.bfloat16 and not fake and any(t.data_ptr() % 16
                                                      for t in (q, k, v)):
        raise ValueError("flash_attention backward takes 16-byte aligned "
                         "bfloat16 q, k, v (its copies are 16 bytes wide)")
    eb = do.element_size()
    if not fake and (do.stride(3) != 1 or do.data_ptr() % 16 or any(
            st * eb % 16 for st in do.stride()[:3])):
        do = do.contiguous() if not do.is_contiguous() else do.clone()
    if max(Sq, Sk, B, H) >= 2 ** 31 or Sk < 1:
        raise ValueError(f"flash_attention backward: sizes out of range "
                         f"(B {B}, H {H}, Sq {Sq}, Sk {Sk})")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if Sq == 0 or B == 0:
        return dq, dk.zero_(), dv.zero_()
    plan = bwd_plan(B, H, Hkv, Sq, Sk, D, q.dtype)
    # before the fake branch: the dry run's peak holds the workspace
    ws = torch.empty(plan.workspace, dtype=torch.float32, device=q.device)
    if fake:
        backend.note_launch("flash_attention_bwd")
        return dq, dk, dv
    st = ctypes.c_longlong * 4
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), lse.data_ptr(),
            do.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            ws.data_ptr(), st(*do.stride()), B, H, Hkv, Sq, Sk, D,
            int(bool(causal)), int(window))
    if plan.kernel == "wgmma":
        err = _lib_bwd_wgmma().flash_attention_bwd_wgmma_launch(
            *ptrs, backend.current_stream(q.device))
    else:
        err = _lib_bwd().flash_attention_bwd_launch(
            *ptrs, _DTYPES[q.dtype], backend.current_stream(q.device))
    with _count_lock:
        flash_attention_bwd.launches += 1
    backend.check(err, "flash_attention_bwd")
    return dq, dk, dv


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                        causal: bool = True, window: int = 0) -> tuple:
    """The gradients ``(dq, dk, dv)`` of :func:`flash_attention` at q, k, v
    for the cotangent ``do`` (any strides), given the forward's output
    ``o`` and fp32 log-sum-exp ``lse`` (:func:`flash_attention_lse_plain`'s
    convention), in the inputs' type: :func:`flash_attention_bwd_plain`
    for CPU tensors, for CUDA tensors the kernels :func:`bwd_plan` picks
    (a dq kernel, then a dk/dv kernel; one count in
    ``flash_attention_bwd.launches`` a call)."""
    _check(q, k, v)
    if backend.noted():
        backend.note("flash_attention_bwd", work_backward(
            q.shape, k.shape[1], k.shape[2], q.dtype, causal, window))
    if backend.use_kernel(q):
        return _launch_bwd(q, k, v, o, lse, do, bool(causal), int(window))
    return flash_attention_bwd_plain(q, k, v, o, lse, do, causal, window)


def flash_attention_with_lse(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, causal: bool = True,
                             window: int = 0) -> tuple:
    """The forward and its row statistic, outside autograd: ``(o, lse)``,
    o as :func:`flash_attention` gives it and lse as
    :func:`flash_attention_lse_plain` defines it; the kernel for CUDA
    tensors (one launch), the plain version for CPU tensors."""
    _check(q, k, v)
    if backend.use_kernel(q):
        return _launch(q, k, v, bool(causal), int(window), True)
    return flash_attention_lse_plain(q, k, v, causal, window)


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, window, with_lse):
        ctx.causal, ctx.window = causal, window
        if not with_lse:
            if backend.use_kernel(q):
                return _launch(q, k, v, causal, window)
            return flash_attention_plain(q, k, v, causal, window)
        o, lse = flash_attention_with_lse(q, k, v, causal, window)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.mark_non_differentiable(lse)
        return o, lse

    @staticmethod
    def backward(ctx, g, _glse=None):
        q, k, v, o, lse = ctx.saved_tensors
        with torch.profiler.record_function("flash_attention.backward"):
            grads = flash_attention_bwd(q, k, v, o, lse, g, ctx.causal,
                                        ctx.window)
        return grads + (None, None, None)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """q ``(B,H,Sq,D)``; k, v ``(B,Hkv,Sk,D)`` with ``Hkv | H`` -> ``(B,H,Sq,D)``
    in q's type.  Queries are aligned to the end of the keys (self-attention
    when Sq == Sk, chunked prefill when Sq < Sk); ``window > 0`` adds the
    sliding-window mask.  Any Sq and Sk; the kernel takes D in
    ``HEAD_DIMS`` and float32 or bfloat16: a bfloat16 CUDA tensor runs on
    the tensor cores (``wgmma``; keys split as :func:`launch_plan` says), a
    float32 one on the FMA units (a dispatch by type: TF32 would miss the
    f32 tolerance).  Where autograd will take the gradient (grad mode on
    and an input that requires it) the forward also keeps each row's
    log-sum-exp for :func:`flash_attention_bwd`."""
    _check(q, k, v)
    if backend.noted():
        backend.note("flash_attention", work(
            q.shape, k.shape[1], k.shape[2], q.dtype, causal, window))
    with_lse = torch.is_grad_enabled() and any(
        t.requires_grad for t in (q, k, v))
    out = _FlashAttention.apply(q, k, v, bool(causal), int(window), with_lse)
    return out[0] if with_lse else out


def visible_pairs(Sq: int, Sk: int, causal: bool, window: int) -> int:
    """(query, key) pairs the mask admits, queries aligned to the end of
    the keys: the kernel's work, whatever tiles it skips."""
    qpos = np.arange(Sq, dtype=np.int64) + (Sk - Sq)
    hi = np.minimum(qpos, Sk - 1) if causal else np.full(Sq, Sk - 1)
    lo = np.maximum(qpos - window + 1, 0) if window and window > 0 \
        else np.zeros(Sq, dtype=np.int64)
    return int(np.clip(hi - lo + 1, 0, None).sum())


def work(q_shape, Hkv: int, Sk: int, dtype: torch.dtype,
         causal: bool = True, window: int = 0) -> backend.Work:
    """The kernel's work for q ``(B, H, Sq, D)`` against ``Sk`` keys of
    ``Hkv`` heads: q.k and p.v, 2 FLOP a multiply-add each, over the pairs
    the mask admits, on the tensor cores in bf16 (the FMA units in f32);
    q, k, v read once and o written once."""
    B, H, Sq, D = q_shape
    flops = 4 * D * visible_pairs(Sq, Sk, causal, window) * B * H
    nbytes = dtype.itemsize * (2 * B * H * Sq * D + 2 * B * Hkv * Sk * D)
    rate = H100_SXM.peak_flops_bf16 if dtype == torch.bfloat16 \
        else H100_SXM.peak_flops_f32
    return backend.Work(flops, nbytes, flops / rate)


def work_backward(q_shape, Hkv: int, Sk: int, dtype: torch.dtype,
                  causal: bool = True, window: int = 0) -> backend.Work:
    """The backward's least work for q ``(B, H, Sq, D)`` against ``Sk``
    keys of ``Hkv`` heads: five products over the pairs the mask admits,
    2 FLOP a multiply-add (q.k again, dO.v, and the three that give dv =
    P^T dO, dk = dS^T Q and dq = dS K); its time on the tensor cores
    counts the form the kernel issues in bf16: the last three have an
    fp32 operand (P or dS) split into two bf16 halves, two products each,
    so eight products' time at the bf16 rate (the FMA units' five at the
    f32 rate for f32 inputs).  The kernel's second sweep over the scores
    for each row's delta is its own choice and not counted.  q, k, v, o
    and dO read once with the fp32 lse; dq, dk and dv written once."""
    B, H, Sq, D = q_shape
    product = 2 * D * visible_pairs(Sq, Sk, causal, window) * B * H
    q_like = B * H * Sq * D
    kv = B * Hkv * Sk * D
    nbytes = dtype.itemsize * (4 * q_like + 4 * kv) + 4 * B * H * Sq
    if dtype == torch.bfloat16:
        ops_s = 8 * product / H100_SXM.peak_flops_bf16
    else:
        ops_s = 5 * product / H100_SXM.peak_flops_f32
    return backend.Work(5 * product, nbytes, ops_s)


flash_attention.launches = 0
flash_attention_bwd.launches = 0
