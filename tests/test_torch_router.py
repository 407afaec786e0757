"""The port's ``router_topk`` against the reference's, on the CPU.

On a CPU tensor the port's wrapper runs its plain version; the reference's
``repro.kernels.ops.router_topk`` runs the Pallas kernel in interpret mode.
Experts, positions and keep flags must be equal, the weights within 1e-6
(``tests/test_kernels.py:81-108``).  The kernel itself is held against the
plain version on the card (``tests/test_torch_cuda.py``, ``chip_smoke.py``);
here its grid (``launch_plan``) and its decomposition of the positions into
per-tile ranks and a look-back over the tiles (``tile_positions``) are held
to the plain version and to the Pallas kernel at the tiles' edges.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.ops import router_topk as jrouter
from repro_torch.core.device import expert_capacity
from repro_torch.kernels.router_topk import (MAX_THREADS, ONE_BLOCK_MAX_T,
                                             THREAD_PATH_MAX_E,
                                             TOKENS_PER_BLOCK, launch_plan,
                                             router_topk, router_topk_plain,
                                             smem_bytes, tile_positions)

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
    """The routing itself (experts, positions, keep) takes no gradient; the
    weights do, as the reference's ``_route`` weights do (their gradient is
    held to the reference in ``tests/test_torch_train.py``)."""
    _, tl = _logits(3, 16, 4)
    tl.requires_grad_(True)
    before = router_topk.launches
    w, idx, pos, keep = router_topk(tl, 2, 8)
    assert w.requires_grad
    assert not (idx.requires_grad or pos.requires_grad or keep.requires_grad)
    assert router_topk.launches == before
    for a, b in zip(router_topk(tl, 2, 8), router_topk_plain(tl, 2, 8)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("K,E", [(0, 4), (5, 4), (9, 16)])
def test_router_rejects_top_k_out_of_range(K, E):
    with pytest.raises(ValueError, match="top_k"):
        router_topk(torch.zeros(4, E), K, 4)


# -- the kernel's block decomposition ------------------------------------------
# csrc/route_scan.cuh splits T into tiles of tt tokens, one block each (tt
# 256 on the thread-per-token path, E <= 32, where one block takes any T up
# to 512; 16 on the warp-per-token path), ranks each tile's entries on its
# own and adds earlier tiles' histograms by a look-back.  launch_plan is its
# grid and tile_positions its arithmetic.
EDGE_EK = [(1, 1), (8, 1), (8, 2), (8, 8), (384, 1), (384, 2), (384, 8)]


def _tile(E):
    return TOKENS_PER_BLOCK["warp" if E > THREAD_PATH_MAX_E else "thread"]


def _one_block_max(E):
    return ONE_BLOCK_MAX_T if E <= THREAD_PATH_MAX_E else _tile(E)


def edge_ts(E):
    """T at the edges of the tiles and of the one-block case: tt - 1, tt,
    tt + 1, 3 tt + 5, and the largest T of one block and the next."""
    tt, one = _tile(E), _one_block_max(E)
    return sorted({tt - 1, tt, tt + 1, 3 * tt + 5, one, one + 1})


EDGE_CASES = [(T, E, K) for E, K in EDGE_EK for T in edge_ts(E)]


def _edge_logits(seed, T, E, one_expert):
    """Logits at scale 2; with ``one_expert`` every token's first pick is
    expert 0 (a +30 bias), the most skewed load."""
    a = np.random.default_rng(seed).standard_normal((T, E),
                                                    dtype=np.float32) * 2
    if one_expert:
        a[:, 0] += 30.0
    return a


@pytest.mark.parametrize("T,E,K", [(8, 8, 2), (127, 8, 2), (256, 8, 2),
                                   (512, 8, 2), (513, 8, 2), (1859, 8, 2),
                                   (5000, 8, 2), (15, 384, 8), (31, 384, 8),
                                   (5000, 384, 8), (2048, 256, 8), (1, 1, 1),
                                   (0, 8, 2)])
def test_launch_plan_tiles_the_tokens(T, E, K):
    plan = launch_plan(T, E, K)
    tt = plan.tokens_per_block
    assert tt == (max(1, T) if T <= _one_block_max(E) else _tile(E))
    assert plan.blocks == -(-T // tt)
    assert plan.blocks * tt >= T
    assert (plan.blocks > 1) == (T > _one_block_max(E))
    if T >= 2 * tt:
        assert plan.blocks >= 2
    assert plan.threads % 32 == 0 and 32 <= plan.threads <= MAX_THREADS
    if E <= THREAD_PATH_MAX_E:           # a thread per token
        assert plan.threads >= plan.tokens_per_block
    assert plan.smem == smem_bytes(plan.tokens_per_block, E, K, plan.threads)
    # one block (decode's T = 8) needs no workspace: ticket, flags, and a
    # histogram and an inclusive prefix per tile otherwise
    assert plan.workspace_words == (0 if plan.blocks <= 1 else
                                    1 + plan.blocks * (1 + 2 * E))


def test_launch_plan_sizes_decode_down_and_refuses_too_many_experts():
    decode = launch_plan(8, 8, 2)
    assert (decode.blocks, decode.threads, decode.workspace_words) == (1, 32,
                                                                       0)
    wide = launch_plan(4096, 3000, 8)    # the tile halves until it fits
    assert wide.tokens_per_block < _tile(3000) and wide.smem <= 232448
    with pytest.raises(ValueError, match="shared memory"):
        launch_plan(2, 8192, 2)


@pytest.mark.parametrize("one_expert", [False, True])
@pytest.mark.parametrize("T,E,K", EDGE_CASES)
def test_tile_positions_equal_plain_and_pallas_at_tile_edges(T, E, K,
                                                             one_expert):
    """The two phases (per-tile ranks, the look-back over the tiles'
    histograms, with every pattern of tiles whose inclusive prefix is
    ready) give the plain version's positions, and the Pallas kernel's in
    interpret mode on its own experts; capacities 0, 1 and T."""
    a = _edge_logits(T * 7 + E + K, T, E, one_expert)
    _w, idx, pos, _keep = router_topk_plain(torch.from_numpy(a), K, T)
    plan = launch_plan(T, E, K)
    rng = np.random.default_rng(T)
    for ready in (None, [True] * plan.blocks,
                  list(rng.random(plan.blocks) < 0.5)):
        assert torch.equal(tile_positions(idx, E, plan, ready), pos)
    for cap in (0, 1, T):
        got = router_topk(torch.from_numpy(a), K, cap)
        assert torch.equal(got[3], pos < cap)
    _jw, jidx, jpos, jkeep = (np.asarray(t) for t in
                              jrouter(jnp.asarray(a), K, 1, T))
    emul = tile_positions(torch.from_numpy(jidx.copy()), E, plan).numpy()
    assert np.array_equal(emul, jpos)
    assert np.array_equal(emul < 1, jkeep)
    if one_expert:
        assert (idx[:, 0] == 0).all()


def test_tile_positions_look_back_crosses_windows():
    """More tiles than one look-back window (32): a tile with no ready
    inclusive prefix in its window walks back window after window."""
    T, E, K = 40 * _tile(8) + 3, 8, 2
    a = _edge_logits(1, T, E, False)
    _w, idx, pos, _ = router_topk_plain(torch.from_numpy(a), K, T)
    plan = launch_plan(T, E, K)
    assert plan.blocks > 32
    for ready in (None, [b % 37 == 0 for b in range(plan.blocks)]):
        assert torch.equal(tile_positions(idx, E, plan, ready), pos)
