"""The port's ``router_topk`` against the reference's, on the CPU.

On a CPU tensor the port's wrapper runs its plain version; the reference's
``repro.kernels.ops.router_topk`` runs the Pallas kernel in interpret mode.
Experts, positions and keep flags must be equal, the weights within 1e-6
(``tests/test_kernels.py:81-108``).  The kernel itself is held against the
plain version on the card (``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.ops import router_topk as jrouter
from repro_torch.core.device import expert_capacity
from repro_torch.kernels.router_topk import router_topk, router_topk_plain

torch.set_num_threads(1)


def _logits(seed, T, E, scale=1.0):
    a = np.random.default_rng(seed).standard_normal((T, E),
                                                    dtype=np.float32) * scale
    return jnp.asarray(a), torch.from_numpy(a)


def _assert_same(got, want):
    w, i, p, keep = got
    wr, ir, pr, keepr = (np.asarray(t) for t in want)
    assert i.dtype == torch.int32 and p.dtype == torch.int32
    assert keep.dtype == torch.bool and w.dtype == torch.float32
    assert np.array_equal(i.numpy(), ir)
    assert np.array_equal(p.numpy(), pr)
    assert np.array_equal(keep.numpy(), keepr)
    np.testing.assert_allclose(w.numpy(), wr, rtol=1e-5, atol=1e-6)


# the grid of tests/test_kernels.py:81-85
@pytest.mark.parametrize("T,E,K,C,bt", [
    (256, 8, 2, 80, 128),
    (512, 16, 4, 150, 256),
    (128, 4, 1, 40, 128),
])
def test_router_matches_pallas_kernel(T, E, K, C, bt):
    jl, tl = _logits(T + E, T, E)
    _assert_same(router_topk(tl, K, C), jrouter(jl, K, C, bt))


# T the Pallas kernel does not take (block_t | T), E and K up to the
# kernel's limits, capacities from the model's formula
@pytest.mark.parametrize("T,E,K", [(1, 8, 2), (37, 8, 2), (300, 64, 8),
                                   (77, 256, 8), (1000, 8, 2)])
def test_router_ragged_matches_reference_oracle(T, E, K):
    jl, tl = _logits(T * E, T, E, scale=2.0)
    C = expert_capacity(T, E, K, 1.25)
    _assert_same(router_topk(tl, K, C), jref.router_topk_ref(jl, K, C))


def test_router_capacity_never_exceeded():
    """tests/test_kernels.py:97-108: per-expert kept count <= capacity and
    kept slots unique, on skewed logits where tokens are dropped."""
    T, E, K, C = 512, 8, 2, 64
    _, tl = _logits(0, T, E, scale=3.0)
    _w, i, p, keep = (t.numpy() for t in router_topk(tl, K, C))
    for e in range(E):
        kept = keep & (i == e)
        assert kept.sum() <= C
        slots = p[kept]
        assert len(set(slots.tolist())) == len(slots)
    assert keep.sum() > 0 and (~keep).sum() > 0


def test_router_takes_no_gradient_and_launches_nothing_on_cpu():
    _, tl = _logits(3, 16, 4)
    tl.requires_grad_(True)
    before = router_topk.launches
    w, *_ = router_topk(tl, 2, 8)
    assert not w.requires_grad
    assert router_topk.launches == before
    for a, b in zip(router_topk(tl, 2, 8), router_topk_plain(tl, 2, 8)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("K,E", [(0, 4), (5, 4), (9, 16)])
def test_router_rejects_top_k_out_of_range(K, E):
    with pytest.raises(ValueError, match="top_k"):
        router_topk(torch.zeros(4, E), K, 4)
