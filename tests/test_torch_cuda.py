"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here but one needs a CUDA device and skips without one (the
one checks in plain Python that the ``ssd_scan`` cases reach every branch
of the kernel's tiling).  The routing kernels (``router_topk``,
``a2a_route``), the split form of ``flash_attention`` and ``ssd_scan``'s
chain of chunks are also held at their tiles' edges, under CUDA-graph
replay and on two streams at once.
The module
imports only torch and the port, so on a machine without JAX it runs as

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py
"""

import pytest
import torch

from ssd_bwd_cases import BWD_BAD_IDS, BWD_BAD_SHAPES, bwd_bad_inputs
from repro_torch.kernels.a2a_fused import (a2a_combine, a2a_combine_plain,
                                           a2a_route, a2a_route_plain)
from repro_torch.kernels import flash_attention as flash_module
from repro_torch.kernels.flash_attention import (HEAD_DIMS, flash_attention,
                                                 flash_attention_plain)
from repro_torch.kernels.flash_attention import launch_plan as flash_plan
from repro_torch.kernels.gelu_stepwise import (gelu_stepwise,
                                               gelu_stepwise_bwd,
                                               gelu_stepwise_plain,
                                               gelu_stepwise_vjp_plain)
from repro_torch.kernels.silu_stepwise import (silu_stepwise,
                                               silu_stepwise_bwd,
                                               silu_stepwise_plain,
                                               silu_stepwise_vjp_plain)
from repro_torch.kernels import a2a_fused as a2a_module
from repro_torch.kernels import router_topk as router_module
from repro_torch.kernels.router_topk import (ONE_BLOCK_MAX_T,
                                             THREAD_PATH_MAX_E,
                                             TOKENS_PER_BLOCK, router_topk,
                                             router_topk_plain)
from repro_torch.kernels.router_topk import launch_plan as route_plan
from repro_torch.kernels import ssd_scan as ssd_module
from repro_torch.kernels.ssd_scan import launch_plan, ssd_scan, \
    ssd_scan_bwd, ssd_scan_bwd_plain, ssd_scan_plain, wgmma_fits

torch.set_num_threads(1)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels run only on the "
                    "card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("E", [2, 8, 64, 256])
def test_route_kernel_matches_plain(cuda, E):
    g = torch.Generator().manual_seed(E)
    logits = torch.randn(4099, E, generator=g).to(cuda)
    for cap in (4099, max(1, 4099 // E - 3), 1):
        got = a2a_route(logits, cap)
        want = a2a_route_plain(logits, cap)
        for a, b in zip(got, want):
            assert torch.equal(a, b)


@pytest.mark.cuda
def test_route_kernel_counts_launches_and_rejects_too_many_experts(cuda):
    a2a_route.launches = 0
    a2a_route(torch.zeros(8, 4, device=cuda), 8)
    assert a2a_route.launches == 1
    with pytest.raises(ValueError, match="shared memory"):
        a2a_route(torch.zeros(2, 4096, device=cuda), 2)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int32])
def test_combine_kernel_matches_plain(cuda, dtype):
    g = torch.Generator().manual_seed(0)
    logits = torch.randn(1000, 8, generator=g).to(cuda)
    idx, _pos, keep = a2a_route(logits, 100)
    for item in ((), (5,), (3, 64)):
        ys = (torch.randint(-9, 9, (8, 1000) + item, generator=g)
              .to(dtype).to(cuda))
        out = a2a_combine(ys, idx, keep)
        assert torch.equal(out, a2a_combine_plain(ys, idx, keep))


FLASH_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
FLASH_SCALE_TOL = 5e-2          # bf16, of the output's scale


# (B, H, Hkv, Sq, Sk, D, causal, window): ragged q and kv tails, chunked
# prefill with a window, a length past the window and no mask at every head
# dim; then Gemma-7B's prefill attention (H16/16 of D 256, causal, no
# window: S 2048, a ragged 5000, and a chunk of 512 queries on 4096 keys);
# then chip_smoke.py phase 5e's: Qwen2-VL's prefill (H12/2, a GQA group of
# 6), Whisper's encoder (every key, 1500 frames at B8 and its enc_len 4096)
# and its cross attention (32 and 1 queries against 1500 frames)
FLASH_KERNEL_CASES = [
    (2, H, Hkv, Sq, Sk, D, causal, window) for D in (16, 32, 64, 128, 256)
    for H, Hkv, Sq, Sk, causal, window in ((4, 2, 130, 130, True, 0),
                                           (4, 1, 37, 300, True, 64),
                                           (2, 2, 200, 200, True, 50),
                                           (4, 4, 65, 65, False, 0))
] + [(1, 16, 16, Sq, Sk, 256, True, 0)
     for Sq, Sk in ((2048, 2048), (5000, 5000), (512, 4096))
] + [(1, 12, 2, 2048, 2048, 128, True, 0),
     (8, 16, 16, 1500, 1500, 64, False, 0),
     (1, 16, 16, 4096, 4096, 64, False, 0),
     (8, 16, 16, 32, 1500, 64, False, 0),
     (8, 16, 16, 1, 1500, 64, False, 0)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,Hkv,Sq,Sk,D,causal,window", FLASH_KERNEL_CASES)
def test_flash_kernel_matches_plain(cuda, dtype, B, H, Hkv, Sq, Sk, D, causal,
                                    window):
    g = torch.Generator().manual_seed(D + Sq)
    q = torch.randn(B, H, Sq, D, generator=g).to(dtype).to(cuda)
    k = torch.randn(B, Hkv, Sk, D, generator=g).to(dtype).to(cuda)
    v = torch.randn(B, Hkv, Sk, D, generator=g).to(dtype).to(cuda)
    got = flash_attention(q, k, v, causal, window)
    want = flash_attention_plain(q, k, v, causal, window)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == q.shape
    torch.testing.assert_close(got.float(), want.float(),
                               rtol=FLASH_TOL[dtype], atol=FLASH_TOL[dtype])
    if dtype == torch.bfloat16:
        # against the output's scale, and a planted dropped key tail past
        # it (chip_smoke.py's FLASH_SCALE_TOL)
        err = (got.float() - want.float()).abs().max() / want.abs().max()
        assert float(err) <= FLASH_SCALE_TOL
        if not causal and Sk >= 1500:
            keep = Sk - (Sk % 64 or 64)
            drop = flash_attention_plain(q, k[:, :, :keep], v[:, :, :keep],
                                         False, 0).float()
            fault = (got.float() - drop).abs().max() / drop.abs().max()
            assert float(fault) > FLASH_SCALE_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("D", [16, 32, 64, 128, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,Hkv,Sq,Sk,causal,window", [
    (1, 2, 2, 1, 1, True, 0),        # one query, one key
    (2, 4, 2, 15, 15, True, 0),      # under one mma fragment
    (1, 4, 1, 17, 129, True, 0),     # q_offset 112: off the 64-key tile
    (1, 2, 2, 63, 63, False, 0),
    (1, 4, 2, 65, 65, True, 7),      # the window's edge inside a tile
    (1, 4, 4, 129, 129, True, 100),
    (1, 2, 1, 1, 65, True, 0),       # one query at the end of 65 keys
    (1, 8, 2, 100, 1000, True, 300),
    (2, 2, 2, 65, 129, False, 0),
    (1, 4, 2, 129, 200, True, 33),
    (1, 12, 2, 65, 129, True, 0),    # a GQA group of 6
    (1, 2, 2, 1, 65, False, 0),      # one query, every key
    (1, 4, 2, 127, 127, True, 0),    # the bf16 kernel's q tile - 1
    (1, 2, 2, 128, 255, True, 0),    # the q tile, two KV tiles - 1
    (1, 4, 1, 129, 257, False, 0),   # the q tile + 1, two KV tiles + 1
    (1, 2, 2, 256, 256, True, 0),    # two q tiles, whole KV tiles
    (1, 4, 2, 200, 300, True, 90),   # window edges at keys 11 and 139
])
def test_flash_kernel_matches_plain_at_tile_edges(cuda, D, dtype, B, H, Hkv,
                                                  Sq, Sk, causal, window):
    """Lengths, offsets and window edges that cut the kernels' tiles (the
    f32 kernel's 64 rows, the bf16 kernel's 128 query rows in warpgroups of
    64 and its KV tiles of 128 keys, 64 at D 256) and 16-row fragments."""
    g = torch.Generator().manual_seed(D * 1000 + Sq * 7 + Sk)
    q = torch.randn(B, H, Sq, D, generator=g).to(dtype).to(cuda)
    k = torch.randn(B, Hkv, Sk, D, generator=g).to(dtype).to(cuda)
    v = torch.randn(B, Hkv, Sk, D, generator=g).to(dtype).to(cuda)
    got = flash_attention(q, k, v, causal, window)
    want = flash_attention_plain(q, k, v, causal, window)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == q.shape
    assert bool(torch.isfinite(got.float()).all())
    torch.testing.assert_close(got.float(), want.float(),
                               rtol=FLASH_TOL[dtype], atol=FLASH_TOL[dtype])


@pytest.mark.cuda
def test_flash_kernel_counts_launches_and_rejects_what_it_cannot_take(cuda):
    q = torch.zeros(1, 2, 8, 16, device=cuda)
    flash_attention.launches = 0
    flash_attention(q, q, q)
    assert flash_attention.launches == 1
    with pytest.raises(ValueError, match="head dims"):
        z = torch.zeros(1, 2, 8, 48, device=cuda)
        flash_attention(z, z, z)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        h = q.half()
        flash_attention(h, h, h)
    with pytest.raises(ValueError, match="contiguous"):
        t = torch.zeros(1, 8, 2, 16, device=cuda).transpose(1, 2)
        flash_attention(t, t, t)
    with pytest.raises(ValueError, match="aligned"):
        a = torch.zeros(1 * 2 * 8 * 16 + 1, device=cuda,
                        dtype=torch.bfloat16)[1:].view(1, 2, 8, 16)
        flash_attention(a, a, a)
    assert flash_attention.launches == 1


# (B, H, Hkv, Sq, Sk, D, causal, window) where the bf16 kernel splits the
# keys (chip_smoke.py's FLASH_SPLITS): 1, 32 and 64 queries against 1500
# and 4096 keys, a last split every key of which is masked for some rows,
# an uneven last split, D 256 at one query
FLASH_SPLIT_CASES = [(B, H, H, Sq, Sk, 64, False, 0)
                     for B, H in ((8, 8), (1, 16)) for Sq in (1, 32, 64)
                     for Sk in (1500, 4096)] + [
    (1, 4, 2, 64, 4128, 64, True, 0),
    (1, 4, 4, 32, 4112, 128, True, 0),
    (1, 20, 4, 32, 4096, 64, False, 0),
    (1, 2, 2, 1, 1500, 256, False, 0)]


def _flash_inputs(cuda, B, H, Hkv, Sq, Sk, D, seed):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(shape, generator=g).to(torch.bfloat16).to(cuda)
            for shape in ((B, H, Sq, D), (B, Hkv, Sk, D), (B, Hkv, Sk, D))]


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,Hkv,Sq,Sk,D,causal,window", FLASH_SPLIT_CASES)
def test_flash_kernel_matches_plain_where_it_splits(cuda, B, H, Hkv, Sq, Sk,
                                                    D, causal, window):
    """The split form (launch_plan's splits > 1, merged in the same launch)
    against the plain version, one launch a call."""
    assert flash_plan(B, H, Hkv, Sq, Sk, D).splits > 1
    q, k, v = _flash_inputs(cuda, B, H, Hkv, Sq, Sk, D, Sq + Sk + D)
    before = flash_attention.launches
    got = flash_attention(q, k, v, causal, window)
    assert flash_attention.launches == before + 1
    want = flash_attention_plain(q, k, v, causal, window)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got.float()).all())
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2,
                               atol=2e-2)
    err = (got.float() - want.float()).abs().max() / want.abs().max()
    assert float(err) <= FLASH_SCALE_TOL


@pytest.mark.cuda
def test_flash_library_tiling_is_the_plans(cuda):
    """The library's tiling (csrc/flash_attention.cu) is launch_plan's."""
    lib = flash_module._lib()
    for D in HEAD_DIMS:
        plan = flash_plan(1, 1, 1, 1, 1, D)
        got = tuple(lib.flash_attention_tiling(D, i) for i in range(4))
        assert got == (plan.block_q, plan.block_k, plan.stages, plan.smem)


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,Hkv,Sq,Sk,D,causal", [
    (8, 8, 8, 1, 1500, 64, False), (1, 4, 2, 64, 4128, 64, True)])
def test_flash_split_replays_in_a_cuda_graph(cuda, B, H, Hkv, Sq, Sk, D,
                                             causal):
    """A split call captured in a CUDA graph and replayed three times gives
    the same output each time, the eager call's: the capture holds the
    tickets' zeroing, so every replay merges afresh."""
    q, k, v = _flash_inputs(cuda, B, H, Hkv, Sq, Sk, D, 7)
    want = flash_attention(q, k, v, causal, 0)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        flash_attention(q, k, v, causal, 0)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = flash_attention(q, k, v, causal, 0)
    for _ in range(3):
        out.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, want)


@pytest.mark.cuda
def test_flash_split_on_two_streams_at_once(cuda):
    """Split calls on two streams at once give what the same calls give one
    after the other: each call has its own scratch and tickets."""
    a = _flash_inputs(cuda, 8, 8, 8, 1, 1500, 64, 8)
    b = _flash_inputs(cuda, 1, 16, 16, 32, 4096, 64, 9)
    want_a = flash_attention(*a, False, 0)
    want_b = flash_attention(*b, False, 0)
    torch.cuda.synchronize()
    s1, s2 = torch.cuda.Stream(), torch.cuda.Stream()
    for s in (s1, s2):
        s.wait_stream(torch.cuda.current_stream())
    got = []
    for _ in range(4):
        with torch.cuda.stream(s1):
            ga = flash_attention(*a, False, 0)
        with torch.cuda.stream(s2):
            gb = flash_attention(*b, False, 0)
        got.append((ga, gb))
    torch.cuda.synchronize()
    for ga, gb in got:
        assert torch.equal(ga, want_a) and torch.equal(gb, want_b)


STEPWISE_SHAPES = [
    ((1,), 0), ((7,), 0), ((3, 37, 64), 0),       # under and off a vector
    ((8, 1, 4096), 0),                             # a decode step
    ((5, 333), 1),                                 # an unaligned view
    ((1 << 20,), -1),                              # magnitudes 2**-140..2**100
]


def _stepwise_inputs(cuda, dtype, shape, offset, seed):
    """x and dy of ``shape`` on the card (views at ``offset`` elements into
    their storage); offset -1 draws x's magnitudes from 2**-140 to
    2**100."""
    g = torch.Generator().manual_seed(seed)
    n = 1
    for d in shape:
        n *= d
    out = []
    for scale in (4.0, 1.0):
        flat = torch.randn(n + max(offset, 0), generator=g) * scale
        if offset < 0 and not out:
            flat = flat * torch.exp2(torch.randint(-140, 100, flat.shape,
                                                   generator=g).float())
        out.append(flat.to(dtype).to(cuda)[max(offset, 0):].view(shape))
    return out


def _same(got, want):
    """Bit for bit, a NaN equal to a NaN."""
    return got.dtype == want.dtype and got.shape == want.shape and (
        torch.equal(got, want) or (
            torch.equal(got.isnan(), want.isnan())
            and torch.equal(got[~got.isnan()], want[~want.isnan()])))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,offset", STEPWISE_SHAPES + [
    ((2, 1500, 4096), 0),                          # Whisper's MLP
    ((2567, 24576), 0),                            # Gemma-7B's prefill
])
def test_gelu_kernel_matches_plain(cuda, dtype, shape, offset):
    """Bit for bit the plain versions' eager ops, forward (nine) and
    backward (XLA's VJP): each step rounds to the type in both (the
    kernels' products and sums are not contracted into FMAs), wide values
    included: subnormal products, overflow to infinity, roundings that
    carry into the exponent (offset -1)."""
    x, dy = _stepwise_inputs(cuda, dtype, shape, offset,
                             len(shape) * 100 + shape[-1])
    got, want = gelu_stepwise(x), gelu_stepwise_plain(x)
    dx, dx_plain = gelu_stepwise_bwd(x, dy), gelu_stepwise_vjp_plain(x, dy)
    torch.cuda.synchronize()
    assert _same(got, want) and _same(dx, dx_plain)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,offset", STEPWISE_SHAPES + [
    ((8, 1568, 14336), 0),           # Mixtral's experts, a 5000-token prefill
    ((4, 2048, 4096), 0),            # Zamba2's Mamba2 gate at B4 x S2048
])
def test_silu_kernel_matches_plain(cuda, dtype, shape, offset):
    """Bit for bit the plain versions' eager ops, forward and backward
    (expf and the correctly rounded reciprocal, as torch's exp and
    reciprocal compute them), wide values included."""
    x, dy = _stepwise_inputs(cuda, dtype, shape, offset,
                             len(shape) * 100 + shape[-1] + 1)
    got, want = silu_stepwise(x), silu_stepwise_plain(x)
    dx, dx_plain = silu_stepwise_bwd(x, dy), silu_stepwise_vjp_plain(x, dy)
    torch.cuda.synchronize()
    assert _same(got, want) and _same(dx, dx_plain)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["gelu", "silu"])
def test_gelu_kernel_counts_launches_and_rejects_what_it_cannot_take(
        cuda, kernel):
    """Each direction counts its own launches; the backward through
    autograd launches the backward kernel once (the gradient of ``sum``
    is an expanded, not contiguous, tensor: the autograd function makes it
    contiguous) and equals the plain VJP."""
    fwd, bwd, vjp = {
        "gelu": (gelu_stepwise, gelu_stepwise_bwd, gelu_stepwise_vjp_plain),
        "silu": (silu_stepwise, silu_stepwise_bwd, silu_stepwise_vjp_plain),
    }[kernel]
    x = torch.randn(4, 8, device=cuda, dtype=torch.bfloat16)
    fwd.launches = bwd.launches = 0
    fwd(x)
    assert (fwd.launches, bwd.launches) == (1, 0)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fwd(x.half())
    with pytest.raises(ValueError, match="contiguous"):
        fwd(x.t())
    with pytest.raises(ValueError, match="contiguous"):
        bwd(x.t(), x.t())
    with pytest.raises(ValueError, match="one type and shape"):
        bwd(x, x.float())
    assert (fwd.launches, bwd.launches) == (1, 0)
    a = x.float().requires_grad_(True)
    fwd(a).sum().backward()
    assert (fwd.launches, bwd.launches) == (2, 1)
    assert torch.equal(a.grad, vjp(x.float(), torch.ones_like(a)))


@pytest.mark.cuda
@pytest.mark.parametrize("T", [1, 8, 37, 2048, 5000])
@pytest.mark.parametrize("E,K", [(8, 2), (64, 8), (256, 8), (256, 4),
                                 (384, 1), (384, 8)])
def test_router_kernel_matches_plain(cuda, T, E, K):
    g = torch.Generator().manual_seed(T * E + K)
    logits = (torch.randn(T, E, generator=g) * 2).to(cuda)
    for cap in (T, max(1, T * K // E // 2), 1):
        got = router_topk(logits, K, cap)
        want = router_topk_plain(logits, K, cap)
        w, idx, pos, keep = got
        assert torch.equal(idx, want[1]) and torch.equal(pos, want[2])
        assert torch.equal(keep, want[3])
        torch.testing.assert_close(w, want[0], rtol=0, atol=1.2e-7)


@pytest.mark.cuda
def test_router_kernel_counts_launches_and_rejects_too_many_experts(cuda):
    router_topk.launches = 0
    router_topk(torch.zeros(8, 4, device=cuda), 2, 8)
    assert router_topk.launches == 1
    with pytest.raises(ValueError, match="shared memory"):
        router_topk(torch.zeros(2, 8192, device=cuda), 2, 2)


# -- the routing kernels' many blocks (csrc/route_scan.cuh) --------------------
def _tile(E):
    return TOKENS_PER_BLOCK["warp" if E > THREAD_PATH_MAX_E else "thread"]


def _edge_ts(E):
    """T at the tiles' edges (tt - 1, tt, tt + 1, 3 tt + 5) and at the
    one-block case's (its largest T and the next)."""
    tt = _tile(E)
    one = ONE_BLOCK_MAX_T if E <= THREAD_PATH_MAX_E else tt
    return sorted({tt - 1, tt, tt + 1, 3 * tt + 5, one, one + 1})


# those T for E in {1, 8, 384} and K in {1, 2, 8}; then chip_smoke.py's
# ROUTER_CASES: (5000, 384, 8), and Kimi-K2's E 384 top-8 at the serving
# engine's decode batch, its timed 2048 tokens and the prompt lengths that
# chip_smoke.py's phase 5d prefills
ROUTE_EDGE_CASES = [(T, E, K)
                    for E, K in ((1, 1), (8, 1), (8, 2), (8, 8), (384, 1),
                                 (384, 2), (384, 8))
                    for T in _edge_ts(E)]
FAMILY_LENS = (2567, 1947, 1582, 882, 993, 218, 318, 147)
ROUTER_SMOKE_CASES = [(8, 8, 2), (300, 8, 2), (512, 8, 2), (2048, 8, 2),
                      (5000, 8, 2), (8, 64, 8),
                      (2048, 64, 8), (2048, 256, 8), (5000, 256, 4),
                      (5000, 384, 8), (8, 384, 8), (2048, 384, 8)] + [
                          (T, 384, 8) for T in FAMILY_LENS]


def _route_logits(T, E, one_expert, device, seed=0):
    """Logits at scale 2 from a seed; with ``one_expert`` every token's
    first pick is expert 0 (a +30 bias)."""
    g = torch.Generator().manual_seed(seed + T * 1000 + E)
    x = torch.randn(T, E, generator=g) * 2
    if one_expert:
        x[:, 0] += 30.0
    return x.to(device)


def _router_equal(got, want):
    w, idx, pos, keep = got
    assert torch.equal(idx, want[1]) and torch.equal(pos, want[2])
    assert torch.equal(keep, want[3])
    torch.testing.assert_close(w, want[0], rtol=0, atol=1.2e-7)


@pytest.mark.cuda
@pytest.mark.parametrize("one_expert", [False, True])
@pytest.mark.parametrize("T,E,K", ROUTE_EDGE_CASES + ROUTER_SMOKE_CASES)
def test_router_kernel_matches_plain_at_tile_edges(cuda, T, E, K,
                                                   one_expert):
    logits = _route_logits(T, E, one_expert, cuda)
    for cap in (0, 1, T):
        _router_equal(router_topk(logits, K, cap),
                      router_topk_plain(logits, K, cap))


@pytest.mark.cuda
@pytest.mark.parametrize("one_expert", [False, True])
@pytest.mark.parametrize("T,E", sorted({(T, E) for T, E, _ in
                                        ROUTE_EDGE_CASES + ROUTER_SMOKE_CASES}
                                       | {(512, 8), (4096, 8)}))
def test_route_kernel_matches_plain_at_tile_edges(cuda, T, E, one_expert):
    logits = _route_logits(T, E, one_expert, cuda, seed=1)
    for cap in (0, 1, T):
        for a, b in zip(a2a_route(logits, cap), a2a_route_plain(logits, cap)):
            assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("E", [8, 384])
def test_route_kernel_nan_rows(cuda, E):
    """NaN counts as the maximum: a row with a NaN (or an infinite logit,
    whose softmax is NaN) routes to its first NaN probability, as the
    plain version's argmax does, in every tile."""
    tt = _tile(E)
    logits = _route_logits(3 * tt + 5, E, False, cuda, seed=2)
    logits[0, 3] = float("nan")
    logits[tt - 1, E - 1] = float("nan")
    logits[tt, :] = float("nan")
    logits[2 * tt + 1, 5] = float("inf")
    logits[-1, 0] = float("-inf")
    for cap in (1, 3 * tt + 5):
        got = a2a_route(logits, cap)
        want = a2a_route_plain(logits, cap)
        for a, b in zip(got, want):
            assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["router_topk", "a2a_route"])
@pytest.mark.parametrize("T,E,K", [(5000, 8, 2), (777, 5, 2), (300, 384, 8)])
def test_routing_kernels_take_an_unaligned_view(cuda, kernel, T, E, K):
    """Logits that start 4 bytes past an allocation (a contiguous view):
    the tiles are staged by 4-byte loads instead of 16-byte ones."""
    flat = _route_logits(T * E + 1, 1, False, cuda, seed=7)[:, 0]
    logits = flat[1:].view(T, E)
    assert logits.data_ptr() % 16 != 0
    for cap in (1, T // 2):
        got = _routing_call(kernel, logits, K, cap)
        want = _routing_plain(kernel, logits, K, cap)
        if kernel == "router_topk":
            _router_equal(got, want)
        else:
            for a, b in zip(got, want):
                assert torch.equal(a, b)


def _routing_call(kernel, logits, K, cap):
    if kernel == "router_topk":
        return router_topk(logits, K, cap)
    return a2a_route(logits, cap)


def _routing_plain(kernel, logits, K, cap):
    if kernel == "router_topk":
        return router_topk_plain(logits, K, cap)
    return a2a_route_plain(logits, cap)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["router_topk", "a2a_route"])
@pytest.mark.parametrize("E,K", [(8, 2), (384, 8)])
def test_routing_kernels_replay_in_a_cuda_graph(cuda, kernel, E, K):
    """One multi-block call captured in a CUDA graph and replayed three
    times gives the same outputs each time: the capture holds the
    workspace's zeroing, so every replay starts with a fresh ticket."""
    T, cap = 5000, 1000
    logits = _route_logits(T, E, False, cuda, seed=3)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        _routing_call(kernel, logits, K, cap)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = _routing_call(kernel, logits, K, cap)
    want = _routing_plain(kernel, logits, K, cap)
    for _ in range(3):
        for o in outs:
            o.zero_()
        graph.replay()
        torch.cuda.synchronize()
        if kernel == "router_topk":
            _router_equal(outs, want)
        else:
            for a, b in zip(outs, want):
                assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["router_topk", "a2a_route"])
@pytest.mark.parametrize("E,K", [(8, 2), (384, 8)])
def test_routing_kernels_on_two_streams_at_once(cuda, kernel, E, K):
    """Launches on two streams at once give what the same launches give
    one after the other: each call has its own workspace."""
    T, cap = 5000, 700
    a = _route_logits(T, E, False, cuda, seed=4)
    b = _route_logits(T, E, True, cuda, seed=5)
    want_a = _routing_call(kernel, a, K, cap)
    want_b = _routing_call(kernel, b, K, cap)
    torch.cuda.synchronize()
    s1, s2 = torch.cuda.Stream(), torch.cuda.Stream()
    for s in (s1, s2):
        s.wait_stream(torch.cuda.current_stream())
    got = []
    for _ in range(4):
        with torch.cuda.stream(s1):
            ga = _routing_call(kernel, a, K, cap)
        with torch.cuda.stream(s2):
            gb = _routing_call(kernel, b, K, cap)
        got.append((ga, gb))
    torch.cuda.synchronize()
    for ga, gb in got:
        for x, y in zip(ga + gb, want_a + want_b):
            assert torch.equal(x, y)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["router_topk", "a2a_route"])
@pytest.mark.parametrize("E", [8, 384])
def test_routing_kernels_run_many_blocks(cuda, kernel, E):
    """At T >= 2 tiles the launch runs plan.blocks blocks: each takes one
    ticket, and every tile but the last publishes its inclusive prefix
    (flag 2) for the tiles after it.  The library's shared-memory size
    equals the plan's."""
    K = 2 if kernel == "router_topk" else 1
    T = 2 * _tile(E) + 5
    plan = route_plan(T, E, K)
    assert plan.blocks == 3 and plan.workspace_words > 0
    logits = _route_logits(T, E, False, cuda, seed=6)
    ws = torch.zeros(plan.workspace_words, dtype=torch.int32, device=cuda)
    idx, pos = (torch.empty(T, K, dtype=torch.int32, device=cuda)
                for _ in range(2))
    keep = torch.empty(T, K, dtype=torch.bool, device=cuda)
    stream = torch.cuda.current_stream().cuda_stream
    common = (plan.blocks, plan.tokens_per_block, plan.threads)
    if kernel == "router_topk":
        lib = router_module._lib()
        w = torch.empty(T, K, device=cuda)
        assert lib.router_topk_smem_bytes(plan.tokens_per_block, E, K,
                                          plan.threads) == plan.smem
        err = lib.router_topk_launch(
            logits.data_ptr(), T, E, K, T, *common, w.data_ptr(),
            idx.data_ptr(), pos.data_ptr(), keep.data_ptr(), ws.data_ptr(),
            stream)
        want = router_topk_plain(logits, K, T)[2]
    else:
        lib = a2a_module._lib()
        assert lib.a2a_route_smem_bytes(plan.tokens_per_block, E,
                                        plan.threads) == plan.smem
        err = lib.a2a_route_launch(
            logits.data_ptr(), T, E, T, *common, idx.data_ptr(),
            pos.data_ptr(), keep.data_ptr(), ws.data_ptr(), stream)
        want = a2a_route_plain(logits, T)[1][:, None]
    assert err == 0
    torch.cuda.synchronize()
    assert int(ws[0]) == plan.blocks
    assert ws[1:1 + plan.blocks].tolist() == [2] * (plan.blocks - 1) + [0]
    assert torch.equal(pos, want)


@pytest.mark.cuda
def test_decode_step_and_slot_insert_never_wait_on_the_card(cuda):
    """The engine's decode tick and slot insert only queue work: no read of
    a device value, no blocking copy, no synchronize."""
    import dataclasses

    import numpy as np

    from repro_torch.configs import get
    from repro_torch.core.plan import single_device_plan
    from repro_torch.runtime.steps import (init_state, make_decode_step,
                                           make_prefill_step)
    from repro_torch.serving.engine import _BatchState, _insert, _to_device
    cfg = dataclasses.replace(get("mixtral-8x7b").reduced(), n_layers=2)
    plan = single_device_plan(cuda)
    params = init_state(cfg, plan, torch.Generator(device=cuda)
                        .manual_seed(0))["params"]
    prompt = torch.arange(40, device=cuda, dtype=torch.int32)[None]
    _, cache1 = make_prefill_step(cfg, plan, 32)(params, {"tokens": prompt})
    decode = make_decode_step(cfg, plan, 32)
    st = _BatchState(cfg, 3, 32, cuda)
    st.active_mask[:] = True
    tok = torch.tensor([[7]], dtype=torch.int32)
    decode(params, st.caches, {"token": st.cur_tok, "pos": st.pos})
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        _insert(st, cache1, 1, tok, 40)
        for _ in range(3):
            nt, _, st.caches = decode(params, st.caches,
                                      {"token": st.cur_tok, "pos": st.pos})
            st.cur_tok = nt
            st.pos = st.pos + _to_device(st.active_mask.astype(np.int32),
                                         cuda)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert st.pos.tolist() == [3, 43, 3]


# y and state against the plain version: both sum in fp32 in other orders
# (f32: 1e-4 of the output's scale), and a bf16 y may round to the other
# side of a bf16 step (2**-7 relative) on top
SSD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2.0 ** -7}


def _ssd_inputs(g, B, H, G, S, N, P, qk_dtype, v_dtype, device):
    q = (torch.randn(B, G, S, N, generator=g) * 0.3).to(qk_dtype).to(device)
    k = (torch.randn(B, G, S, N, generator=g) * 0.3).to(qk_dtype).to(device)
    v = torch.randn(B, H, S, P, generator=g).to(v_dtype).to(device)
    la = (-torch.rand(B, H, S, generator=g) * 0.2).to(device)
    return q, k, v, la


def _held(got, want, tol):
    scale = float(want.abs().max())
    torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                               atol=1e-4 * max(scale, 1.0))


# (B, H, G, S, N, P, chunk)
SSD_KERNEL_CASES = [
    (1, 64, 1, 600, 64, 64, 256),    # Zamba2's heads, ragged S
    (1, 8, 1, 100, 64, 64, 256),     # S < chunk
    (4, 64, 1, 300, 64, 64, 256),    # Zamba2 at B 4: the 64-column P tile
    (2, 3, 3, 256, 32, 64, 128),     # tests/test_kernels.py's grid
    (1, 4, 4, 300, 384, 384, 256),   # xLSTM's mLSTM: N = P = 384
    (1, 4, 4, 300, 384, 1, 256),     # its P = 1 normaliser
    (2, 4, 2, 77, 16, 24, 32),       # groups, P not a tile multiple
    (1, 64, 1, 265, 64, 64, 256),    # Zamba2, a tail chunk of 9 steps
    (4, 64, 1, 133, 64, 64, 128),    # at B 4, a tail chunk of 5 steps
    (1, 2, 1, 200, 72, 130, 96),     # N, P past a 64 tile, not multiples
    (1, 2, 2, 300, 64, 63, 256),     # P one under the 64-column tile
    (1, 2, 2, 300, 64, 65, 256),     # one over: two P tiles
    (1, 2, 2, 300, 64, 7, 256),      # the 8-column tile, P 7
    (1, 2, 2, 300, 64, 9, 256),      # P 9: one 64-column tile
    (1, 2, 2, 2048, 384, 1, 256),    # xLSTM's normaliser on a rank
    (1, 2, 2, 255, 384, 384, 256),   # N 384 at S = chunk - 1
    (1, 2, 2, 257, 384, 384, 256),   # and at S = chunk + 1
    (1, 2, 1, 1280, 64, 64, 64),     # a chain of 20 chunks
    (1, 2, 2, 70, 5, 3, 32),         # N 5: q, k padded to 8 columns
    (1, 1, 1, 300, 448, 64, 256),    # N 448: bf16 q/k in the f32 kernel
]


def test_ssd_kernel_cases_reach_every_p_tile():
    """Every branch of the bf16 kernel's tiling (launch_plan's, on an H100:
    132 SMs, 232448 bytes of opt-in shared memory a block) is held against
    the plain version by some case: one and several chunks (the state
    chain), one and several 128-row query blocks in a chunk, a tail tile,
    one 64-row M-block of N (its k-steps split between the warpgroups) and
    several, one and several P tiles, the 8- and the 64-column tile, P off
    the tile's width, v's tiles by TMA (rows of 16-byte multiples) and
    read by the builders (P 1, 3, 5, 7 ...), N padded to 8 columns, q/k
    groups, and an N the block cannot hold (bf16 q/k in the f32-q/k
    kernel).  The f32-q/k kernel runs the same cases."""
    seen = set()
    for B, H, G, S, N, P, chunk in SSD_KERNEL_CASES:
        Q = min(chunk, S)
        seen.add(("wgmma", wgmma_fits(N, Q, P, 232448)))
        if not wgmma_fits(N, Q, P, 232448):
            continue
        plan = launch_plan(B, H, S, -(-N // 8) * 8, P, Q, 132, 232448)
        seen |= {("chunks", -(-S // Q) > 1), ("query blocks", Q > 128),
                 ("tail", S % 64 != 0), ("n slabs", N > 64),
                 ("p tiles", plan.blocks > -(-S // Q) * B * H),
                 ("8-column tile", plan.p_tile == 8),
                 ("P off the tile", P % plan.p_tile != 0),
                 ("v by TMA", P % 4 == 0), ("N padded", N % 8 != 0),
                 ("groups", G < H)}
    assert seen == {(what, b) for what, _ in seen for b in (True, False)}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,G,S,N,P,chunk", SSD_KERNEL_CASES)
def test_ssd_kernel_matches_plain(cuda, dtype, B, H, G, S, N, P, chunk):
    g = torch.Generator().manual_seed(S + N + P)
    q, k, v, la = _ssd_inputs(g, B, H, G, S, N, P, dtype, dtype, cuda)
    y, state = ssd_scan(q, k, v, la, chunk, return_state=True)
    py, pstate = ssd_scan_plain(q, k, v, la, chunk)
    torch.cuda.synchronize()
    assert y.dtype == dtype and y.shape == (B, H, S, P)
    assert state.dtype == torch.float32 and state.shape == (B, H, N, P)
    _held(y, py, SSD_TOL[dtype])
    _held(state, pstate, SSD_TOL[torch.float32])


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,G,S,N,P", [
    (1, 64, 1, 333, 64, 64)] + [(1, 4, 4, S, 384, P)
                                for S in (2048,) + FAMILY_LENS
                                for P in (384, 1)])
def test_ssd_kernel_model_path_types(cuda, B, H, G, S, N, P):
    """The blocks' call, bf16 q/k, fp32 v and log_a, fp32 y: Zamba2's
    prefill (one group of q/k for 64 heads) and xLSTM-125m's mLSTM prefill
    (4 heads of N = P = 384 and the P = 1 normaliser) at the served prompt
    lengths."""
    g = torch.Generator().manual_seed(7 if S == 333 else S + P)
    q, k, v, la = _ssd_inputs(g, B, H, G, S, N, P, torch.bfloat16,
                              torch.float32, cuda)
    y, state = ssd_scan(q, k, v, la, 256, out_dtype=torch.float32,
                        return_state=True)
    py, pstate = ssd_scan_plain(q, k, v, la, 256, out_dtype=torch.float32)
    torch.cuda.synchronize()
    assert y.dtype == torch.float32
    _held(y, py, SSD_TOL[torch.float32])
    _held(state, pstate, SSD_TOL[torch.float32])


@pytest.mark.cuda
def test_ssd_kernel_counts_launches_and_rejects_what_it_cannot_take(cuda):
    z = torch.zeros(1, 2, 8, 16, device=cuda)
    la = torch.zeros(1, 2, 8, device=cuda)
    ssd_scan.launches = 0
    ssd_scan(z, z, z, la)
    assert ssd_scan.launches == 1
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        h = z.half()
        ssd_scan(h, h, h, la)
    with pytest.raises(ValueError, match="contiguous"):
        t = torch.zeros(1, 8, 2, 16, device=cuda).transpose(1, 2)
        ssd_scan(t, t, t, la)
    with pytest.raises(ValueError, match="shared memory"):
        big = torch.zeros(1, 1, 1024, 8, device=cuda)
        ssd_scan(big, big, torch.zeros(1, 1, 1024, 128, device=cuda),
                 torch.zeros(1, 1, 1024, device=cuda), 1024)
    assert ssd_scan.launches == 1


@pytest.mark.cuda
def test_ssd_library_smem_is_the_plans(cuda):
    """The bf16 kernel's shared memory (csrc/ssd_scan.cu's layout) is
    launch_plan's formula, at every depth of its k ring and both tiles."""
    lib = ssd_module._lib()
    for N, Q in ((64, 256), (384, 256), (8, 64), (72, 96)):
        for pt in (8, 64):
            for ks in ssd_module.WG_K_STAGES:
                assert lib.ssd_scan_wgmma_smem(N, Q, pt, ks) == \
                    ssd_module.wgmma_smem_bytes(N, Q, pt, ks)


def _ssd_model_call(case, seed, cuda):
    B, H, G, S, N, P = case
    g = torch.Generator().manual_seed(seed)
    q, k, v, la = _ssd_inputs(g, B, H, G, S, N, P, torch.bfloat16,
                              torch.float32, cuda)
    return lambda: ssd_scan(q, k, v, la, 256, out_dtype=torch.float32,
                            return_state=True)


@pytest.mark.cuda
@pytest.mark.parametrize("case", [(1, 64, 1, 2048, 64, 64),
                                  (1, 4, 4, 2048, 384, 384),
                                  (1, 4, 4, 2048, 384, 1)])
def test_ssd_kernel_replays_in_a_cuda_graph(cuda, case):
    """A call captured in a CUDA graph and replayed three times gives the
    eager call's y and state each time: the capture holds the zeroing of
    the ticket and the chain's flags, so every replay chains afresh."""
    call = _ssd_model_call(case, 11, cuda)
    want = call()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        call()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = call()
    for _ in range(3):
        for o in outs:
            o.zero_()
        graph.replay()
        torch.cuda.synchronize()
        for a, b in zip(outs, want):
            assert torch.equal(a, b)


@pytest.mark.cuda
def test_ssd_kernel_on_two_streams_at_once(cuda):
    """Calls on two streams at once give what the same calls give one after
    the other: each call has its own chunk states, ticket and flags."""
    a = _ssd_model_call((1, 64, 1, 2048, 64, 64), 12, cuda)
    b = _ssd_model_call((1, 4, 4, 2048, 384, 384), 13, cuda)
    want_a, want_b = a(), b()
    torch.cuda.synchronize()
    s1, s2 = torch.cuda.Stream(), torch.cuda.Stream()
    for s in (s1, s2):
        s.wait_stream(torch.cuda.current_stream())
    got = []
    for _ in range(4):
        with torch.cuda.stream(s1):
            ga = a()
        with torch.cuda.stream(s2):
            gb = b()
        got.append((ga, gb))
    torch.cuda.synchronize()
    for ga, gb in got:
        for x, y in zip(ga + gb, want_a + want_b):
            assert torch.equal(x, y)


# (B, H, G, S, N, P, chunk, qk/v/dy dtype or None for the model types) of
# the backward: Zamba2's and xLSTM's training calls (on all heads and a
# rank's), ragged S, S under a chunk, G < H, N and P past and off a tile,
# P 1, f32 and bf16 throughout, and a chunk of 8192 (every kernel's shared
# memory past the 48 KB a block gets without opting in)
SSD_BWD_KERNEL_CASES = [
    (4, 64, 1, 2048, 64, 64, 256, None),
    (1, 4, 4, 2048, 384, 384, 256, None),
    (1, 2, 2, 2048, 384, 1, 256, None),
    (1, 64, 1, 600, 64, 64, 256, torch.float32),
    (1, 8, 1, 100, 64, 64, 256, torch.bfloat16),
    (4, 64, 1, 133, 64, 64, 128, torch.float32),
    (1, 4, 2, 300, 64, 63, 256, torch.bfloat16),
    (1, 2, 1, 200, 72, 130, 96, torch.float32),
    (1, 2, 2, 257, 384, 384, 256, None),
    (1, 1, 1, 64, 8, 8, 64, torch.float32),
    (1, 2, 1, 8200, 16, 8, 8192, torch.float32),
]


def _ssd_bwd_inputs(case, cuda, state: bool):
    """The forward's inputs, dy in y's type (f32 for the model types) and
    the final state's fp32 cotangent (zero, as training hands it, or
    drawn)."""
    B, H, G, S, N, P, _, dtype = case
    g = torch.Generator().manual_seed(S + N + P + H)
    q, k, v, la = _ssd_inputs(g, B, H, G, S, N, P, dtype or torch.bfloat16,
                              dtype or torch.float32, cuda)
    if dtype is not None:
        la = la.to(dtype)
    gy = torch.randn(B, H, S, P, generator=g).to(dtype or torch.float32)
    gs = torch.randn(B, H, N, P, generator=g) * state
    return q, k, v, la, gy.to(cuda), gs.to(cuda)


@pytest.mark.cuda
@pytest.mark.parametrize("state", [False, True])
@pytest.mark.parametrize("case", SSD_BWD_KERNEL_CASES)
def test_ssd_bwd_kernel_matches_plain_and_repeats_bit_for_bit(cuda, case,
                                                              state):
    """``ssd_scan_bwd`` against ``ssd_scan_bwd_plain`` (f32 gradients
    within 1e-4 of their scale: sums in other orders; bf16 within 2**-7 of
    it: a group's dq and dk sum each head's gradient rounded to bf16, and a
    head the two round to either side of a step moves the sum by the
    head's step), each gradient in its input's type and shape, and a second
    call equal bit for bit (no atomics, every sum in a fixed order)."""
    args = _ssd_bwd_inputs(case, cuda, state) + (case[6],)
    got = ssd_scan_bwd(*args)
    again = ssd_scan_bwd(*args)
    want = ssd_scan_bwd_plain(*args)
    torch.cuda.synchronize()
    for a, b, w, x in zip(got, again, want, args[:4]):
        assert a.dtype == x.dtype and a.shape == x.shape
        assert torch.equal(a, b)
        assert bool(torch.isfinite(a).all())
        scale = float(w.float().abs().max())
        torch.testing.assert_close(a.float(), w.float(),
                                   rtol=SSD_TOL[a.dtype],
                                   atol=SSD_TOL[a.dtype] * max(scale, 1e-30))


@pytest.mark.cuda
@pytest.mark.parametrize("case", SSD_BWD_KERNEL_CASES[:3])
def test_ssd_bwd_kernel_replays_in_a_cuda_graph(cuda, case):
    """A backward captured in a CUDA graph and replayed gives the eager
    call's gradients bit for bit."""
    args = _ssd_bwd_inputs(case, cuda, True) + (case[6],)
    want = ssd_scan_bwd(*args)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        ssd_scan_bwd(*args)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = ssd_scan_bwd(*args)
    for _ in range(2):
        for o in outs:
            o.zero_()
        graph.replay()
        torch.cuda.synchronize()
        for a, b in zip(outs, want):
            assert torch.equal(a, b)


@pytest.mark.cuda
def test_ssd_autograd_on_the_card_launches_the_backward_kernel(cuda):
    """Autograd through ``ssd_scan`` on CUDA tensors runs the backward
    kernel once a call, with dy at the strides the model path hands it
    (y transposed back to (B,S,H,P)), and gives its gradients."""
    case = (1, 8, 1, 300, 64, 64, 256, None)
    q, k, v, la, _, _ = _ssd_bwd_inputs(case, cuda, False)
    leaves = [t.requires_grad_(True) for t in (q, k, v, la)]
    gy = torch.randn(1, 300, 8, 64, device=cuda)
    ssd_scan_bwd.launches = 0
    y = ssd_scan(*leaves, 256, out_dtype=torch.float32).transpose(1, 2)
    grads = torch.autograd.grad(y, leaves, gy)
    assert ssd_scan_bwd.launches == 1
    want = ssd_scan_bwd(q, k, v, la, gy.transpose(1, 2).contiguous(),
                        torch.zeros(1, 8, 64, 64, device=cuda), 256)
    for a, b in zip(grads, want):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_ssd_bwd_counts_launches_and_rejects_what_it_cannot_take(cuda):
    z = torch.zeros(1, 2, 8, 16, device=cuda)
    la = torch.zeros(1, 2, 8, device=cuda)
    ssd_scan_bwd.launches = 0
    ssd_scan_bwd(z, z, z, la, z, None, 4)
    assert ssd_scan_bwd.launches == 1
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        h = z.half()
        ssd_scan_bwd(h, h, h, la, z, None, 4)
    with pytest.raises(ValueError, match="contiguous"):
        t = torch.zeros(1, 8, 2, 16, device=cuda).transpose(1, 2)
        ssd_scan_bwd(t, t, t, la, z, None, 4)
    with pytest.raises(ValueError, match="out of range"):
        big = torch.zeros(1, 1, 65536, 8, device=cuda)
        lb = torch.zeros(1, 1, 65536, device=cuda)
        ssd_scan_bwd(big, big, big, lb, big, None, 65536)
    assert ssd_scan_bwd.launches == 1


@pytest.mark.cuda
@pytest.mark.parametrize("bad", BWD_BAD_SHAPES, ids=BWD_BAD_IDS)
def test_ssd_bwd_rejects_shapes_that_do_not_fit_on_the_card(cuda, bad):
    """On CUDA tensors too the backward refuses q, k, v, log_a that do not
    fit one another, and launches nothing."""
    ssd_scan_bwd.launches = 0
    with pytest.raises(ValueError, match="ssd_scan"):
        ssd_scan_bwd(*bwd_bad_inputs(bad[1:], cuda), None, 4)
    assert ssd_scan_bwd.launches == 0


@pytest.mark.cuda
def test_ssd_bwd_library_smem_is_the_wrappers(cuda):
    """The backward's largest shared memory (csrc/ssd_scan_bwd.cu) is the
    wrapper's formula."""
    lib = ssd_module._lib_bwd()
    for Q in (1, 64, 100, 256, 4096, 8192):
        assert lib.ssd_scan_bwd_smem(Q) == ssd_module.bwd_smem_bytes(Q)


@pytest.mark.cuda
def test_hybrid_decode_step_and_slot_insert_never_wait_on_the_card(cuda):
    """Zamba2's decode step (plain Mamba2 recurrence and the shared block
    on the ring) and the slot insert of its fp32 ssm state only queue
    work."""
    import numpy as np

    from repro_torch.configs import get
    from repro_torch.core.plan import single_device_plan
    from repro_torch.runtime.steps import (init_state, make_decode_step,
                                           make_prefill_step)
    from repro_torch.serving.engine import _BatchState, _insert, _to_device
    cfg = get("zamba2-1.2b").reduced()
    plan = single_device_plan(cuda)
    params = init_state(cfg, plan, torch.Generator(device=cuda)
                        .manual_seed(0))["params"]
    prompt = torch.arange(40, device=cuda, dtype=torch.int32)[None]
    ssd_scan.launches = 0
    _, cache1 = make_prefill_step(cfg, plan, 32)(params, {"tokens": prompt})
    assert ssd_scan.launches == sum(c for k, c in cfg.segments
                                    if k == "mamba2")
    decode = make_decode_step(cfg, plan, 32)
    st = _BatchState(cfg, 3, 32, cuda)
    st.active_mask[:] = True
    tok = torch.tensor([[7]], dtype=torch.int32)
    decode(params, st.caches, {"token": st.cur_tok, "pos": st.pos})
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        _insert(st, cache1, 1, tok, 40)
        for _ in range(3):
            nt, _, st.caches = decode(params, st.caches,
                                      {"token": st.cur_tok, "pos": st.pos})
            st.cur_tok = nt
            st.pos = st.pos + _to_device(st.active_mask.astype(np.int32),
                                         cuda)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert st.pos.tolist() == [3, 43, 3]


@pytest.mark.cuda
def test_xlstm_decode_step_and_slot_insert_never_wait_on_the_card(cuda):
    """xLSTM's prefill runs ``ssd_scan`` twice per mLSTM layer; its decode
    step (plain mLSTM and sLSTM steps, written in place) and the slot
    insert of the fp32 ``C``, ``n``, ``c`` states only queue work."""
    import numpy as np

    from repro_torch.configs import get
    from repro_torch.core.plan import single_device_plan
    from repro_torch.runtime.steps import (init_state, make_decode_step,
                                           make_prefill_step)
    from repro_torch.serving.engine import _BatchState, _insert, _to_device
    cfg = get("xlstm-125m").reduced()
    plan = single_device_plan(cuda)
    params = init_state(cfg, plan, torch.Generator(device=cuda)
                        .manual_seed(0))["params"]
    prompt = torch.arange(40, device=cuda, dtype=torch.int32)[None]
    ssd_scan.launches = 0
    _, cache1 = make_prefill_step(cfg, plan, 32)(params, {"tokens": prompt})
    assert ssd_scan.launches == 2 * sum(c for k, c in cfg.segments
                                        if k == "mlstm")
    decode = make_decode_step(cfg, plan, 32)
    st = _BatchState(cfg, 3, 32, cuda)
    st.active_mask[:] = True
    tok = torch.tensor([[7]], dtype=torch.int32)
    decode(params, st.caches, {"token": st.cur_tok, "pos": st.pos})
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        _insert(st, cache1, 1, tok, 40)
        for _ in range(3):
            nt, _, st.caches = decode(params, st.caches,
                                      {"token": st.cur_tok, "pos": st.pos})
            st.cur_tok = nt
            st.pos = st.pos + _to_device(st.active_mask.astype(np.int32),
                                         cuda)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert st.pos.tolist() == [3, 43, 3]
    assert bool(torch.isfinite(st.caches["mlstm"]["C"]).all())


# -- the training path ------------------------------------------------------------
def _chip_smoke():
    """``chip_smoke.py`` from the repo's root, for its card-against-CPU
    parity runs (one implementation for the script and these tests)."""
    import importlib.util
    import pathlib
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["zamba2-1.2b", "mixtral-8x7b"])
def test_train_loss_and_grads_on_the_card_match_the_cpu(cuda, arch):
    """Reduced config, one loss and gradient through the kernels (each runs
    twice a block: forward and checkpoint recompute; Zamba2's shared block
    adds its gelu) against the plain
    versions on the CPU, at the CPU parity tests' bf16 tolerances, the CPU
    routing to the card's experts: the card's experts the top-K of its own
    logits, the two runs' router logits within 2e-2 of their rms and the
    flips within 2% of the tokens (``chip_smoke.parity_faults``)."""
    from repro_torch.configs import get
    smoke = _chip_smoke()
    r = smoke.card_cpu_parity(arch, 2, cuda)
    assert r["ran"] == smoke.nonzero(
        smoke.train_launches_per_step(get(arch).reduced()))
    assert smoke.parity_faults(r) == [], r


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["qwen2-vl-2b", "whisper-medium"])
def test_front_end_models_on_the_card_match_the_cpu(cuda, arch):
    """Reduced Qwen2-VL (12/2 heads, vision embeddings and M-RoPE ids) and
    Whisper (frames, the nested cache), block by block: each block's
    prefill and decode step through the kernels against the plain versions
    on the CPU given the CPU's input, and the logits, within 3e-2 of their
    scale (``chip_smoke.front_end_parity``, which phase 5e runs), with the
    attention kernel's and the gelu's launches."""
    smoke = _chip_smoke()
    r = smoke.front_end_parity(arch, cuda)
    assert r["ran"] == smoke.parity_launches(arch)
    assert r["err"] <= smoke.MODEL_TOL, r


@pytest.mark.cuda
def test_router_weight_gradient_through_the_kernel_is_the_recompute(cuda):
    T, E, K = 4096, 8, 2
    g = torch.Generator().manual_seed(11)
    logits = (torch.randn(T, E, generator=g) * 2).to(cuda).requires_grad_(True)
    gw = torch.randn(T, K, generator=g).to(cuda)
    router_topk.launches = 0
    w, idx, _, _ = router_topk(logits, K, T)
    assert router_topk.launches == 1 and w.requires_grad
    (got,) = torch.autograd.grad(w, logits, gw)
    x = logits.detach().requires_grad_(True)
    (want,) = torch.autograd.grad(router_module.routing_weights(x, idx), x,
                                  gw)
    assert torch.equal(got, want)
    assert torch.equal(idx, router_topk_plain(logits, K, T)[1])


@pytest.mark.cuda
def test_data_pipeline_batches_are_ordered_on_a_side_stream(cuda):
    """``get()`` orders the batch's copy before work on the caller's current
    stream, whichever stream that is."""
    from repro_torch.data import DataPipeline, SyntheticLMSource
    pipe = DataPipeline(SyntheticLMSource(1000, 512, 16, seed=4), cuda,
                        n_batches=8, prefetch=2).start()
    ref = SyntheticLMSource(1000, 512, 16, seed=4)
    side = torch.cuda.Stream(cuda)
    with torch.cuda.stream(side):
        for _ in range(8):
            b = pipe.get(timeout=30)
            assert b["tokens"].device == cuda
            got = (b["tokens"].long() * 3).cpu()
            assert torch.equal(got, torch.from_numpy(
                ref.next_batch()["tokens"]).long() * 3)
    assert pipe.get(timeout=30) is None


@pytest.mark.cuda
def test_accelerator_results_equal_synchronous_calls(cuda):
    """``TorchAccelerator`` on the card: its dispatcher queues each call on
    a stream of its own, from pinned copies of numpy inputs, and the
    results, ordered on the caller's stream, equal the same calls made
    synchronously, bit for bit."""
    import numpy as np
    from repro_torch.core import FF_EOS, TorchAccelerator
    w = torch.randn(512, 512, generator=torch.Generator().manual_seed(9)) \
        .to(cuda)

    def fn(x):
        return torch.relu(x @ w).sum(dim=1)

    xs = [np.random.default_rng(i).standard_normal((256, 512))
          .astype(np.float32) for i in range(16)]
    want = [fn(torch.from_numpy(x).to(cuda)) for x in xs]
    acc = TorchAccelerator(fn, max_inflight=4, device=cuda)
    acc.run_then_freeze()
    for x in xs:
        acc.offload(x)
    acc.offload(FF_EOS)
    got = []
    while True:
        ok, r = acc.load_result(timeout=60)
        if not ok:
            break
        got.append(r.clone())          # on the caller's stream
    assert acc.wait(60) == 0 and acc.error is None
    assert len(got) == len(want)
    for g, e in zip(got, want):
        assert g.device == cuda and torch.equal(g, e)


def _numpy_square(x):
    import numpy as np
    return np.square(x) + 1.0


@pytest.mark.cuda
def test_process_farm_forked_after_cuda_init_runs_to_the_end(cuda):
    """A ``host_process`` farm whose workers fork after CUDA is up in the
    parent: its numpy workers never touch the card and finish the stream,
    in order."""
    import numpy as np
    import repro_torch.core as T
    torch.cuda.init()
    torch.ones(1, device=cuda).sum().item()     # a live context
    xs = [np.full(64, i, np.float32) for i in range(40)]
    r = T.pipeline(T.farm(_numpy_square, n=3)).compile(
        config=T.CompileConfig(placements={0: "host_process"}))
    assert type(r).__name__ == "ProcessRunner"
    out = r.run(xs, timeout=60)
    assert len(out) == len(xs)
    for o, x in zip(out, xs):
        np.testing.assert_array_equal(o, _numpy_square(x))


def _two_ranks_on_one_card():
    """Run in each of two ranks that share ``cuda:0`` over gloo (the twin of
    ``tests/test_torch_spmd.py``'s CPU ranks): the named collectives on CUDA
    tensors, ``farm_map`` against this rank's own whole-batch call, and two
    steps of reduced Mixtral with fsdp_params against the one-device step,
    the kernels launched."""
    import dataclasses
    from repro_torch.configs import get
    from repro_torch.core import device as D
    from repro_torch.core import spmd
    from repro_torch.core.plan import P, ShardingPlan, single_device_plan
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import router_topk as RT
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.optim.schedules import cosine_warmup
    from repro_torch.runtime.steps import init_state, make_train_step
    dev = spmd.current_device()
    r = spmd.rank()
    mesh = make_host_mesh(data=2)
    out = {"device": str(dev), "backend": spmd.backend()}

    def coll(x):
        s = spmd.psum_scatter(x, "data", 0)
        a = spmd.all_to_all(x, "data", 0, 0)
        pp = spmd.ppermute(x, "data", [(0, 1), (1, 0)])
        return s, a, pp
    x = torch.arange(8.0, device=dev) + 100 * r
    # each rank's own x (not one global value): the outputs stay per rank
    s, a, pp = spmd.shard_map(coll, mesh, P(), (P(), P(), P()))(x)
    out["coll"] = [t.cpu().tolist() for t in (s, a, pp)]
    g = torch.Generator(device=dev).manual_seed(0)
    xs = torch.randn(8, 64, generator=g, device=dev)
    w = torch.randn(64, 64, generator=g, device=dev) / 8
    got = D.farm_map(lambda v: torch.tanh(v @ w), mesh)(xs)
    out["farm_err"] = float((got - torch.tanh(xs @ w)).abs().max())
    cfg = dataclasses.replace(get("mixtral-8x7b").reduced(), n_layers=1)
    toks = torch.randint(0, cfg.vocab, (2, 4, 64), generator=g, device=dev,
                         dtype=torch.int32)
    losses = {}
    for name, plan in (("one", single_device_plan(dev)),
                       ("fsdp", ShardingPlan(mesh))):
        st = init_state(cfg, plan, torch.Generator(device=dev).manual_seed(1))
        step = make_train_step(cfg, plan, cosine_warmup(1e-3, 20, 2))
        FA.flash_attention.launches = RT.router_topk.launches = 0
        losses[name] = []
        for i in range(2):
            st, m = step(st, {"tokens": toks[i]})
            losses[name].append(float(m["loss"]))
        out[f"{name}_launches"] = (FA.flash_attention.launches,
                                   RT.router_topk.launches)
    out["losses"] = losses
    out["routes"] = {k: dict(v) for k, v in spmd.ROUTES.items()}
    return out


@pytest.mark.cuda
def test_two_ranks_share_the_card_over_gloo(cuda):
    """Two spawned ranks on ``cuda:0`` (gloo; where gloo carries no
    collective for CUDA tensors, pinned host memory): collectives exact,
    farm_map within 1e-5 (f32 products of half the rows), the fsdp train
    step's losses within 1e-3 relative of the one-device step's (the
    router's capacity is per rank's tokens), kernels launched in both."""
    from repro_torch.core import spmd
    res = spmd.launch(_two_ranks_on_one_card, 2, device="cuda",
                      timeout_s=300)
    base = [float(i) for i in range(8)]
    for r, out in enumerate(res):
        assert out["device"] == "cuda:0" and out["backend"] == "gloo"
        s, a, pp = out["coll"]
        assert s == [base[i] + base[i] + 100 for i in range(4 * r, 4 * r + 4)]
        assert a == [v + 100 * k for k in (0, 1)
                     for v in base[4 * r:4 * r + 4]]
        assert pp == [v + 100 * (1 - r) for v in base]
        assert out["farm_err"] <= 1e-5
        one, fsdp = out["losses"]["one"], out["losses"]["fsdp"]
        assert all(abs(a / b - 1) <= 1e-3 for a, b in zip(fsdp, one))
        assert all(n > 0 for n in out["fsdp_launches"])
    assert res[0]["losses"]["fsdp"] == res[1]["losses"]["fsdp"]
