"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA device and skips without one.  The module
imports only torch and the port, so on a machine without JAX it runs as

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py
"""

import pytest
import torch

from repro_torch.kernels.a2a_fused import (a2a_combine, a2a_combine_plain,
                                           a2a_route, a2a_route_plain)

torch.set_num_threads(1)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the a2a kernels run only on the card")
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
