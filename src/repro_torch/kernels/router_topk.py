"""MoE top-K router with first-come capacity positions.

Port of ``src/repro/kernels/router_topk.py:router_topk`` as wrapped by
``src/repro/kernels/ops.py:router_topk``.  The CUDA kernel is
``csrc/router_topk.cu`` over ``csrc/route_scan.cuh`` (its header gives the
design and the bound); ``a2a_fused.a2a_route`` is its top-1 case.

The choice of experts, the positions and the keep flags carry no gradient,
as in the reference.  The weights do: the model trains through them as the
reference's ``src/repro/models/moe.py:_route`` does, whose ``lax.top_k`` of
the softmax passes the combine's gradient back to the router.  The
reference has no backward kernel for that (``ops.py`` stops the gradient
of its Pallas router), so the backward pass is the VJP XLA gives
``_route``'s weights, recomputed in plain PyTorch from the logits at the
chosen experts (:func:`routing_weights`).

:func:`router_topk` runs :func:`router_topk_plain` for CPU tensors and
launches the kernel for CUDA tensors; ``router_topk.launches`` counts the
launches.  The plain version repeats the kernel's arithmetic (``exp(x -
max)`` summed left to right, repeated argmax with the first index on ties,
the weights' sum taken in k order), so on the card the two agree exactly on
``idx``, ``pos`` and ``keep``.  A fake CUDA tensor launches nothing and
hands the launch to ``backend.note_launch``; :func:`work` is the bound's
operations and bytes.
:func:`launch_plan` is the kernel's grid, and :func:`tile_positions` its
decomposition of the positions (per-tile ranks, a look-back over the
tiles' histograms) in plain PyTorch.
"""

from __future__ import annotations

import ctypes
import threading
from typing import NamedTuple, Optional, Sequence, Tuple

import torch

from . import backend
from ..core.perf_model import H100_SXM

_SMEM_MAX = 232448          # bytes of shared memory one Hopper block may use
MAX_K = 8
THREAD_PATH_MAX_E = 32      # csrc/route_scan.cuh: kThreadPathMaxE
MAX_THREADS = 512           # csrc/route_scan.cuh: kMaxThreads
WINDOW = 32                 # csrc/route_scan.cuh: kWindow
WARPS = 8                   # a block's warps on the warp-per-token path
# tokens a block routes: a thread per token for E <= 32, else a warp per
# token over 2 tokens a warp; and the T up to which one block of a thread
# per token takes them all (no workspace, no look-back).  Chosen by
# measurement on an H100 (PERF.md section 6, tools/time_routing.py --sweep).
TOKENS_PER_BLOCK = {"thread": 256, "warp": 16}
ONE_BLOCK_MAX_T = MAX_THREADS
_count_lock = threading.Lock()


def _lib() -> ctypes.CDLL:
    lib = backend.load("router_topk")
    if not getattr(lib, "_ff_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.router_topk_smem_bytes.argtypes = [i, i, i, i]
        lib.router_topk_smem_bytes.restype = ctypes.c_longlong
        lib.router_topk_launch.argtypes = [p, i, i, i, i, i, i, i] + [p] * 6
        lib.router_topk_launch.restype = i
        lib._ff_typed = True
    return lib


class LaunchPlan(NamedTuple):
    blocks: int            # ceil(T / tokens_per_block), one tile each
    tokens_per_block: int  # the tile: the path's, or T for one block
    threads: int           # a block's threads, a multiple of 32
    smem: int              # dynamic shared memory of a block, bytes
    workspace_words: int   # int32 ticket, flags, histograms; 0 for 1 block


def smem_bytes(tt: int, E: int, K: int, threads: int) -> int:
    """Shared memory of a block (csrc/route_scan.cuh's layout): the tile's
    rows at an odd stride, the row sums, the entries' experts, weights and
    ranks, per-warp counts, the histogram and prefix, 4 broadcast words."""
    return 4 * (tt * ((E | 1) + 1 + 3 * K) + (threads // 32 + 2) * E + 4)


def _threads(tt: int, warp_path: bool) -> int:
    return 32 * min(WARPS, tt) if warp_path else 32 * -(-tt // 32)


def launch_plan(T: int, E: int, K: int) -> LaunchPlan:
    """The kernel's grid for logits ``(T, E)`` and top-``K``: tiles of
    :data:`TOKENS_PER_BLOCK` tokens (by path), one block each, so T >= 2
    tiles launches several blocks; a T under one tile gets one block sized
    to it (decode's T = 8: one warp, no workspace), and so does any T up to
    :data:`ONE_BLOCK_MAX_T` on the thread-per-token path (the tile is then
    T).  On the warp path a tile too wide for shared memory is halved, down
    to one token a warp; raises if even that does not fit, whatever T is
    (at K 8, past ~3200 experts)."""
    warp = E > THREAD_PATH_MAX_E
    full = TOKENS_PER_BLOCK["warp" if warp else "thread"]
    need = smem_bytes(full, E, K, _threads(full, warp))
    while warp and need > _SMEM_MAX and full > WARPS:   # wide E: halve it
        full //= 2
        need = smem_bytes(full, E, K, _threads(full, warp))
    if need > _SMEM_MAX:
        raise ValueError(f"routing over {E} experts needs {need} bytes of "
                         f"shared memory for a tile of {full} tokens, more "
                         f"than the {_SMEM_MAX} a block has")
    tt = max(1, min(full, T))
    if not warp and T <= ONE_BLOCK_MAX_T:
        tt = max(1, T)                   # one block takes them all
    blocks = -(-T // tt)
    words = 1 + blocks + 2 * blocks * E if blocks > 1 else 0
    if words >= 2 ** 31:
        raise ValueError(f"router: {T} tokens of {E} experts need a "
                         f"workspace of {words} words")
    threads = _threads(tt, warp)
    return LaunchPlan(blocks, tt, threads, smem_bytes(tt, E, K, threads),
                      words)


def workspace(plan: LaunchPlan,
              device: torch.device) -> Optional[torch.Tensor]:
    """The kernel's int32 workspace for one call, None for one block: a
    fresh buffer from PyTorch's allocator with its ticket and flags zeroed
    on the current stream (one fill kernel), so CUDA-graph replays and
    launches on concurrent streams never share one."""
    if not plan.workspace_words:
        return None
    ws = torch.empty(plan.workspace_words, dtype=torch.int32, device=device)
    ws[:1 + plan.blocks].zero_()
    return ws


def tile_positions(experts: torch.Tensor, n_experts: int, plan: LaunchPlan,
                   inclusive_ready: Optional[Sequence[bool]] = None
                   ) -> torch.Tensor:
    """The kernel's positions, phase by phase in plain PyTorch: experts
    ``(T, K)`` -> positions ``(T, K)``.  Per tile, its entries in flattened
    (token, k) order are ranked in chunks of ``plan.threads``: the rank
    among same-expert lanes of a warp, plus the counts of earlier warps,
    plus a cursor carried over the chunks (which ends as the tile's
    histogram).  Then each tile adds the entries of earlier tiles by the
    kernel's look-back: windows of :data:`WINDOW` tiles back to the nearest
    tile whose inclusive prefix was ready (``inclusive_ready[b]``, default
    none: every histogram is summed)."""
    T, K = experts.shape
    E, tt, nt = n_experts, plan.tokens_per_block, plan.threads
    flat = experts.reshape(-1).long()
    ranks = torch.empty_like(flat)
    hists = []
    for base in range(0, T, tt):
        ent = flat[base * K:min(T, base + tt) * K]
        cursor = torch.zeros(E, dtype=torch.long)
        for c0 in range(0, ent.numel(), nt):
            chunk = ent[c0:c0 + nt]
            pad = torch.full((-chunk.numel() % 32,), -1, dtype=torch.long)
            lanes = torch.cat([chunk, pad]).reshape(-1, 32)      # (warps, 32)
            onehot = torch.nn.functional.one_hot(lanes.clamp(min=0), E) \
                * (lanes >= 0)[..., None]
            wrank = (torch.cumsum(onehot, 1) - onehot).gather(
                2, lanes.clamp(min=0)[..., None])[..., 0]
            wcount = onehot.sum(1)                               # (warps, E)
            before = torch.cumsum(wcount, 0) - wcount
            r = cursor[lanes.clamp(min=0)] + wrank \
                + before.gather(1, lanes.clamp(min=0))
            ranks[base * K + c0:base * K + c0 + chunk.numel()] = \
                r.reshape(-1)[:chunk.numel()]
            cursor += wcount.sum(0)
        hists.append(cursor)
    ready = list(inclusive_ready) if inclusive_ready is not None \
        else [False] * len(hists)
    inclusive = torch.cumsum(torch.stack(hists), 0) if hists else None
    pos = torch.empty_like(flat)
    for b, base in enumerate(range(0, T, tt)):
        prefix, hi = torch.zeros(E, dtype=torch.long), b
        while hi > 0:
            lo = max(0, hi - WINDOW)
            near = next((j for j in range(hi - 1, lo - 1, -1) if ready[j]),
                        None)
            stop = lo if near is None else near + 1
            for j in range(stop, hi):
                prefix += hists[j]
            if near is not None:
                prefix += inclusive[near]
                break
            hi = lo
        sl = slice(base * K, min(T, base + tt) * K)
        pos[sl] = prefix[flat[sl]] + ranks[sl]
    return pos.reshape(T, K).to(torch.int32)


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
    # compared with the experts, not F.one_hot, which reads the indices'
    # range on the host
    onehot = (idx.reshape(-1, 1) == torch.arange(E, device=idx.device)
              ).to(torch.int32)
    pos = (torch.cumsum(onehot, dim=0) * onehot).sum(-1) - 1
    pos = pos.reshape(T, top_k).to(torch.int32)
    return w, idx.to(torch.int32), pos, pos < capacity


def routing_weights(logits: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The reference's differentiable weights at the chosen experts:
    ``softmax(logits)`` gathered at ``idx`` over ``max(sum, 1e-9)``, as
    ``src/repro/models/moe.py:_route`` computes them."""
    w = torch.softmax(logits.float(), dim=-1).gather(1, idx.long())
    return w / torch.clamp(w.sum(-1, keepdim=True), min=1e-9)


class _RouterTopK(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits, top_k, capacity):
        if backend.use_kernel(logits):
            if logits.shape[0] >= 2 ** 31 // top_k:
                raise ValueError(f"router_topk: too many tokens "
                                 f"({logits.shape[0]})")
            plan = launch_plan(*logits.shape, top_k)
            out = _launch(logits.detach().float().contiguous(), top_k,
                          capacity, plan)
        else:
            out = router_topk_plain(logits, top_k, capacity)
        ctx.save_for_backward(logits, out[1])
        ctx.mark_non_differentiable(*out[1:])
        return out

    @staticmethod
    def backward(ctx, gw, _gidx, _gpos, _gkeep):
        logits, idx = ctx.saved_tensors
        with torch.enable_grad(), torch.profiler.record_function(
                "router_topk.backward"):
            x = logits.detach().requires_grad_(True)
            (g,) = torch.autograd.grad(routing_weights(x, idx), x, gw)
        return g, None, None


def router_topk(logits: torch.Tensor, top_k: int, capacity: int) -> Routing:
    """logits ``(T, E)`` -> ``(w (T,K) float32, idx (T,K) int32, pos (T,K)
    int32, keep (T,K) bool)``: each token's top-K experts and renormalised
    weights, each (token, k) entry's first-come position in its expert's
    lane, and whether that position is below ``capacity``.  ``w`` carries
    the gradient of :func:`routing_weights` back to ``logits``."""
    if logits.dim() != 2 or logits.shape[1] < 1:
        raise ValueError(f"router_topk needs logits (T, E>=1), got "
                         f"{tuple(logits.shape)}")
    T, E = logits.shape
    if not 1 <= top_k <= min(E, MAX_K):
        raise ValueError(f"router_topk takes 1 <= top_k <= min(E, {MAX_K}); "
                         f"got top_k={top_k}, E={E}")
    if backend.noted():
        backend.note("router_topk", work(T, E, top_k))
    return _RouterTopK.apply(logits, top_k, capacity)


def work(T: int, E: int, K: int) -> backend.Work:
    """fp32 logits read once; w, idx, pos (4 bytes) and keep (1) written
    once a (token, k); a max, sub, exp, add and div an element and a
    compare an element a pick, in fp32."""
    ops = T * E * (5 + K)
    return backend.Work(ops, T * E * 4 + T * K * (4 + 4 + 4 + 1),
                        ops / H100_SXM.peak_flops_f32)


def _launch(x: torch.Tensor, top_k: int, capacity: int,
            plan: LaunchPlan) -> Routing:
    """Launch the kernel on ``plan``'s grid, with a :func:`workspace` of
    its own."""
    T, E = x.shape
    w = torch.empty(T, top_k, dtype=torch.float32, device=x.device)
    idx = torch.empty(T, top_k, dtype=torch.int32, device=x.device)
    pos = torch.empty(T, top_k, dtype=torch.int32, device=x.device)
    keep = torch.empty(T, top_k, dtype=torch.bool, device=x.device)
    if T == 0:
        return w, idx, pos, keep
    ws = workspace(plan, x.device)
    cap = max(-2 ** 31, min(int(capacity), 2 ** 31 - 1))
    if backend.is_fake(x):
        backend.note_launch("router_topk")
        return w, idx, pos, keep
    err = _lib().router_topk_launch(
        x.data_ptr(), T, E, top_k, cap, plan.blocks, plan.tokens_per_block,
        plan.threads, w.data_ptr(), idx.data_ptr(), pos.data_ptr(),
        keep.data_ptr(), None if ws is None else ws.data_ptr(),
        backend.current_stream(x.device))
    with _count_lock:
        router_topk.launches += 1
    backend.check(err, "router_topk")
    return w, idx, pos, keep


router_topk.launches = 0
