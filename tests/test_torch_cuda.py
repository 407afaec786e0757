"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here but one needs a CUDA device and skips without one (the
one checks in plain Python that the ``ssd_scan`` cases reach every branch
of the kernel's tiling).  The module
imports only torch and the port, so on a machine without JAX it runs as

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py
"""

import pytest
import torch

from repro_torch.kernels.a2a_fused import (a2a_combine, a2a_combine_plain,
                                           a2a_route, a2a_route_plain)
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_plain)
from repro_torch.kernels.router_topk import router_topk, router_topk_plain
from repro_torch.kernels.ssd_scan import launch_plan, ssd_scan, \
    ssd_scan_plain

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


@pytest.mark.cuda
@pytest.mark.parametrize("D", [16, 32, 64, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H,Hkv,Sq,Sk,causal,window", [
    (4, 2, 130, 130, True, 0),       # ragged q and kv tails
    (4, 1, 37, 300, True, 64),       # chunked prefill, window
    (2, 2, 200, 200, True, 50),      # longer than the window
    (4, 4, 65, 65, False, 0),
])
def test_flash_kernel_matches_plain(cuda, D, dtype, H, Hkv, Sq, Sk, causal,
                                    window):
    g = torch.Generator().manual_seed(D + Sq)
    q = torch.randn(2, H, Sq, D, generator=g).to(dtype).to(cuda)
    k = torch.randn(2, Hkv, Sk, D, generator=g).to(dtype).to(cuda)
    v = torch.randn(2, Hkv, Sk, D, generator=g).to(dtype).to(cuda)
    got = flash_attention(q, k, v, causal, window)
    want = flash_attention_plain(q, k, v, causal, window)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == q.shape
    torch.testing.assert_close(got.float(), want.float(),
                               rtol=FLASH_TOL[dtype], atol=FLASH_TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("D", [16, 32, 64, 128])
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
])
def test_flash_kernel_matches_plain_at_tile_edges(cuda, D, dtype, B, H, Hkv,
                                                  Sq, Sk, causal, window):
    """Lengths, offsets and window edges that cut the kernels' 64-row tiles
    and 16-row mma fragments."""
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


@pytest.mark.cuda
@pytest.mark.parametrize("T", [1, 8, 37, 2048, 5000])
@pytest.mark.parametrize("E,K", [(8, 2), (64, 8), (256, 8), (384, 1)])
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
]


def test_ssd_kernel_cases_reach_every_p_tile():
    """Every branch of the kernel's 64 x 64 tiling is held against the
    plain version by some case (on an H100: 132 SMs, 232448 bytes of
    opt-in shared memory a block): one and several chunks (the state
    chain), one and several query tiles in a chunk, a tail tile, one and
    several N and P tiles (P > 64 keeps every score tile), widths that are
    not a multiple of the 16-byte copies, and q/k groups."""
    seen = set()
    for B, H, G, S, N, P, chunk in SSD_KERNEL_CASES:
        Q = min(chunk, S)
        plan = launch_plan(B, H, S, P, Q, 132, 232448)
        seen |= {("chunks", -(-S // Q) > 1), ("t tiles", Q > 64),
                 ("tail", S % 64 != 0), ("n tiles", N > 64),
                 ("p tiles", plan.score_tiles > 1), ("scalar copies",
                                                     P % 8 != 0),
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
def test_ssd_kernel_model_path_types(cuda):
    """Zamba2's prefill: bf16 q/k of one group, fp32 v and log_a, fp32 y."""
    g = torch.Generator().manual_seed(7)
    q, k, v, la = _ssd_inputs(g, 1, 64, 1, 333, 64, 64, torch.bfloat16,
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
