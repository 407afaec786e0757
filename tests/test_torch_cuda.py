"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA device and skips without one.  The module
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
